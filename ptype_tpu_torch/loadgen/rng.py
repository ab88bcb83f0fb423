"""The ONE seeded randomness home for the load-generation plane — the
port's copy of ``ptype_tpu/loadgen/rng.py``, drawing exactly what the
reference draws for the same seed.

Every draw in ``ptype_tpu_torch.loadgen`` — arrival gaps, family picks,
prompt/output lengths, prefix token content — flows through a
:class:`TraceRng`; no other module of the package draws. The point is
replay: a traffic trace is evidence (the capacity frontier,
the spike drill, a chaos-soak composition all cite one), and evidence
must be reproducible from ``(seed,)`` alone, the same determinism
discipline the chaos plan rides (:mod:`ptype_tpu_torch.chaos`).

Streams are *forked by tag*, not shared: the schedule and the request
population draw from independent children of the root seed
(``fork("schedule")`` / ``fork("population")``), so changing how many
timestamps a process draws cannot shift which prompts the population
samples — two traces with the same seed and different rates still
carry the same request mix. Child seeds derive through SHA-256, which
is stable across Python builds (``hash()`` is salted per process and
would silently break replay).
"""

from __future__ import annotations

import hashlib
import math
import random


def _derive(seed, salt: str) -> int:
    h = hashlib.sha256(f"{seed}\x00{salt}".encode()).digest()
    return int.from_bytes(h[:8], "big")


class TraceRng:
    """A seeded, forkable draw stream (stdlib Mersenne under the hood;
    the distribution helpers the traffic models need, nothing more)."""

    def __init__(self, seed, salt: str = ""):
        self.seed = seed
        self.salt = salt
        self._r = random.Random(_derive(seed, salt))

    def fork(self, tag) -> "TraceRng":
        """An independent child stream: deterministic in ``(seed,
        salt, tag)``, unaffected by how much this stream has drawn."""
        return TraceRng(self.seed, f"{self.salt}/{tag}")

    # ------------------------------------------------------- raw draws

    def random(self) -> float:
        return self._r.random()

    def uniform(self, a: float, b: float) -> float:
        return self._r.uniform(a, b)

    def randint(self, a: int, b: int) -> int:
        return self._r.randint(a, b)

    def expovariate(self, rate: float) -> float:
        return self._r.expovariate(rate)

    def lognormal(self, mu: float, sigma: float) -> float:
        return self._r.lognormvariate(mu, sigma)

    # ------------------------------------------------ shaped helpers

    def heavy_len(self, mu: float, sigma: float, lo: int,
                  hi: int) -> int:
        """A heavy-tailed integer length: lognormal body clamped to
        ``[lo, hi]`` — the prompt/output-length shape serving traces
        show (most requests short, a fat tail of huge ones)."""
        return max(lo, min(hi, int(round(self.lognormal(mu, sigma)))))

    def pick_weighted(self, pairs):
        """One item from ``[(item, weight), ...]``."""
        total = math.fsum(w for _, w in pairs)
        x = self._r.random() * total
        acc = 0.0
        for item, w in pairs:
            acc += w
            if x < acc:
                return item
        return pairs[-1][0]

    def token_row(self, n: int, vocab: int) -> list[int]:
        """``n`` token ids in ``[1, vocab)`` (0 is reserved for pad)."""
        return [self._r.randrange(1, vocab) for _ in range(n)]
