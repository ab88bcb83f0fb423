"""Shared jittered exponential backoff for retry/poll loops — the
port's copy of ``ptype_tpu/retry.py``.

Every retry loop in ``ptype_tpu_torch/`` rides :class:`Backoff` instead of a
bare ``time.sleep`` (lint rule PT002, tools/ptlint): an immediate or
fixed-interval re-fire sends a whole fleet back into a dying node set
in lockstep, which is exactly the thundering herd the reference's
round-robin retry was built to avoid. Jitter decorrelates the herd;
the cap bounds the worst-case reaction time once the peer is back.

The delay sequence is ``min(cap, base * factor**n)``, scaled by a
uniform jitter in ``[1 - jitter, 1]`` — "full jitter below the
ceiling", so the configured cap is also the hard upper bound of any
single sleep.
"""

from __future__ import annotations

import random
import time


class Backoff:
    """Iterative jittered exponential backoff.

    ``base=cap`` degenerates to a constant-with-jitter poll interval —
    the right shape for bounded-deadline barrier polls (checkpoint.py).
    A seeded ``rng`` makes the delay sequence reproducible (chaos
    drills); the default draws from the module-level PRNG.
    """

    def __init__(self, base: float = 0.05, cap: float = 2.0,
                 factor: float = 2.0, jitter: float = 0.5,
                 rng: random.Random | None = None):
        if base <= 0 or cap < base:
            raise ValueError(f"Backoff: need 0 < base <= cap, "
                             f"got base={base} cap={cap}")
        if not 0.0 <= jitter <= 1.0:
            raise ValueError(f"Backoff: jitter must be in [0, 1], "
                             f"got {jitter}")
        self.base = base
        self.cap = cap
        self.factor = factor
        self.jitter = jitter
        self._rng = rng
        self._n = 0

    def next_delay(self) -> float:
        """The next delay in the sequence (advances the attempt count)."""
        raw = min(self.cap, self.base * (self.factor ** self._n))
        self._n += 1
        if not self.jitter:
            return raw
        rnd = self._rng.random() if self._rng is not None else random.random()
        return raw * (1.0 - self.jitter * rnd)

    def sleep(self, delay: float | None = None) -> float:
        """Sleep for ``delay`` (default: the next delay in the
        sequence); returns the time slept."""
        d = self.next_delay() if delay is None else delay
        time.sleep(d)
        return d

    def wait(self, event, delay: float | None = None) -> bool:
        """Backoff-shaped ``event.wait``: park for the next delay (or
        ``delay``) unless the event fires first; returns its state —
        the close-aware variant of :meth:`sleep` for monitor loops."""
        d = self.next_delay() if delay is None else delay
        return event.wait(d)

    def reset(self) -> None:
        """Back to the base delay (call after a success so the next
        failure burst starts fast again)."""
        self._n = 0
