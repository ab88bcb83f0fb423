"""Arrival processes and request populations — the trace half of the
load plane; the port's copy of ``ptype_tpu/loadgen/arrivals.py``.

A :class:`TrafficTrace` is the unit of replay: a seeded, materialized
schedule of :class:`Arrival` records (when each request fires, and
exactly what it is). Same seed → identical timestamps AND identical
request population, so a capacity number, a spike drill, or a chaos
soak composed over a trace can be re-run bit-for-bit from the seed in
its report (the same contract the chaos plan's ``FaultPlan`` keeps).

Three arrival processes cover the regimes the serving stack must be
measured in:

- ``poisson`` — memoryless steady load; the frontier sweep's default
  (offered rate is the one knob, which is what a rate sweep wants).
- ``bursty`` — a two-state Markov-modulated Poisson process (on/off):
  exponential dwell in a quiet state and a burst state, Poisson within
  each. Exercises admission, shedding, and an autoscaler's
  spike-to-capacity lag at controllable steepness.
- ``diurnal`` — an inhomogeneous Poisson replay of a compressed
  daily cycle: a sinusoidal rate envelope raised to a sharpness power
  so the peak narrows into a rush-hour spike, sampled exactly by
  thinning. The spike drill replays one of these against a static and
  an elastic fleet and compares TTFT tails from the *same* trace.

Request populations mix three shared-prefix families (chat / RAG /
agentic tool-loop) with heavy-tailed lognormal prompt/output lengths,
so prefix-affinity routing, disagg prefill/decode splits, and KV
pressure are all exercised by synthetic traffic the way production
traffic exercises them. Prefix token *content* is deterministic in
``(family, prefix_id)`` — two arrivals in the same prefix group carry
an identical real token prefix, not just an affinity label.

Every draw goes through the package's seeded RNG home
(:mod:`ptype_tpu_torch.loadgen.rng`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from ptype_tpu_torch.loadgen.rng import TraceRng


@dataclass(frozen=True)
class Arrival:
    """One scheduled request: its firing offset and its identity."""

    seq: int
    t: float          #: schedule offset (s) from trace start
    family: str       #: "chat" | "rag" | "agent"
    prefix_id: int    #: shared-prefix group within the family
    prompt_len: int   #: total prompt tokens (shared prefix + suffix)
    prefix_len: int   #: tokens shared verbatim across the group
    max_new: int      #: decode budget

    @property
    def affinity_key(self) -> str:
        """The gateway routing key: one per shared-prefix group, so
        affinity routing lands the group on one replica's KV cache."""
        return f"{self.family}:{self.prefix_id:04d}"


@dataclass(frozen=True)
class FamilySpec:
    """One population family's shape knobs (lognormal ``mu``/``sigma``
    are of the token counts; the clamp bounds keep the tail heavy but
    finite)."""

    name: str
    weight: float
    prefix_pool: int     #: distinct shared prefixes in the family
    prefix_len: int      #: tokens shared verbatim per group
    prompt_mu: float     #: lognormal body of the unique suffix length
    prompt_sigma: float
    prompt_max: int
    out_mu: float        #: lognormal body of the decode budget
    out_sigma: float
    out_max: int


#: Chat: mid prompts, mid outputs, a handful of system prompts shared
#: very widely — the prefix-cache bread and butter.
CHAT = FamilySpec("chat", weight=0.5, prefix_pool=4, prefix_len=32,
                  prompt_mu=3.2, prompt_sigma=0.9, prompt_max=512,
                  out_mu=3.2, out_sigma=0.7, out_max=256)
#: RAG: long stuffed-context prompts (the heavy tail lives here),
#: short grounded answers, more distinct prefixes (one per corpus).
RAG = FamilySpec("rag", weight=0.3, prefix_pool=8, prefix_len=96,
                 prompt_mu=4.8, prompt_sigma=1.1, prompt_max=2048,
                 out_mu=2.6, out_sigma=0.6, out_max=128)
#: Agentic tool loop: few prefixes (the agent scaffold), many short
#: turns against the same prefix — KV-reuse and TPOT pressure.
AGENT = FamilySpec("agent", weight=0.2, prefix_pool=2, prefix_len=64,
                   prompt_mu=2.8, prompt_sigma=0.6, prompt_max=256,
                   out_mu=2.2, out_sigma=0.5, out_max=64)

DEFAULT_MIX: tuple[FamilySpec, ...] = (CHAT, RAG, AGENT)


# ------------------------------------------------------------ schedules


def poisson_schedule(rng: TraceRng, rate_rps: float,
                     duration_s: float) -> list[float]:
    """Homogeneous Poisson arrivals over ``[0, duration_s)``."""
    out, t = [], 0.0
    if rate_rps <= 0:
        return out
    while True:
        t += rng.expovariate(rate_rps)
        if t >= duration_s:
            return out
        out.append(t)


def bursty_schedule(rng: TraceRng, duration_s: float, *,
                    base_rps: float, burst_rps: float,
                    mean_on_s: float = 0.5,
                    mean_off_s: float = 1.0) -> list[float]:
    """Markov-modulated on/off Poisson: exponential dwell times in a
    quiet (``base_rps``) and a burst (``burst_rps``) state."""
    out: list[float] = []
    t, on = 0.0, False
    while t < duration_s:
        dwell = rng.expovariate(
            1.0 / (mean_on_s if on else mean_off_s))
        end = min(duration_s, t + dwell)
        rate = burst_rps if on else base_rps
        if rate > 0:
            tick = t
            while True:
                tick += rng.expovariate(rate)
                if tick >= end:
                    break
                out.append(tick)
        t, on = end, not on
    return out


def diurnal_schedule(rng: TraceRng, duration_s: float, *,
                     trough_rps: float, peak_rps: float,
                     period_s: float | None = None,
                     sharpness: float = 4.0) -> list[float]:
    """Inhomogeneous Poisson replay of a compressed daily cycle,
    sampled exactly by thinning: rate(t) = trough + (peak - trough) ·
    (½ − ½cos(2πt/period))^sharpness. Sharpness narrows the peak into
    a rush-hour spike (at period/2) without moving the trough."""
    period = duration_s if period_s is None else period_s

    def rate(t: float) -> float:
        env = (0.5 - 0.5 * math.cos(2 * math.pi * t / period))
        return trough_rps + (peak_rps - trough_rps) * env ** sharpness

    out, t = [], 0.0
    if peak_rps <= 0:
        return out
    while True:
        t += rng.expovariate(peak_rps)
        if t >= duration_s:
            return out
        if rng.random() * peak_rps < rate(t):
            out.append(t)


_SCHEDULES = {"poisson", "bursty", "diurnal"}


# ---------------------------------------------------------- population


def _sample_request(rng: TraceRng,
                    mix: tuple[FamilySpec, ...]) -> tuple:
    fam = rng.pick_weighted([(f, f.weight) for f in mix])
    prefix_id = rng.randint(0, fam.prefix_pool - 1)
    suffix = rng.heavy_len(fam.prompt_mu, fam.prompt_sigma, 1,
                           fam.prompt_max)
    max_new = rng.heavy_len(fam.out_mu, fam.out_sigma, 1, fam.out_max)
    return (fam.name, prefix_id, fam.prefix_len + suffix,
            fam.prefix_len, max_new)


@dataclass(frozen=True)
class TrafficTrace:
    """A seeded, fully materialized arrival schedule + population."""

    seed: object
    process: str
    duration_s: float
    arrivals: tuple[Arrival, ...]

    def offered_rps(self) -> float:
        return (len(self.arrivals) / self.duration_s
                if self.duration_s > 0 else 0.0)

    def at_rate(self, rate_rps: float) -> "TrafficTrace":
        """The SAME trace replayed at a different offered rate: the
        schedule is affinely compressed/stretched; the population —
        every prompt, prefix group, and decode budget, in order — is
        untouched. This is what lets one seeded trace back every
        point of a capacity frontier ('the same traffic, faster')."""
        cur = self.offered_rps()
        if cur <= 0 or rate_rps <= 0:
            return self
        k = cur / rate_rps
        arrivals = tuple(
            Arrival(a.seq, a.t * k, a.family, a.prefix_id,
                    a.prompt_len, a.prefix_len, a.max_new)
            for a in self.arrivals)
        return TrafficTrace(self.seed, self.process,
                            self.duration_s * k, arrivals)


def synth_trace(seed, *, process: str = "poisson",
                duration_s: float = 10.0,
                mix: tuple[FamilySpec, ...] = DEFAULT_MIX,
                **kw) -> TrafficTrace:
    """Build a trace. ``kw`` are the process's rate knobs
    (``rate_rps`` for poisson; ``base_rps``/``burst_rps``/dwell means
    for bursty; ``trough_rps``/``peak_rps``/``sharpness`` for
    diurnal). Schedule and population draw from independent forks of
    the seed, so the same seed at a different rate still samples the
    same request mix per arrival index."""
    if process not in _SCHEDULES:
        raise ValueError(f"unknown arrival process {process!r}; "
                         f"pick one of {sorted(_SCHEDULES)}")
    root = TraceRng(seed, salt="loadgen")
    sched_rng = root.fork("schedule")
    if process == "poisson":
        times = poisson_schedule(sched_rng, duration_s=duration_s,
                                 rate_rps=kw.pop("rate_rps"))
    elif process == "bursty":
        times = bursty_schedule(sched_rng, duration_s, **kw)
    else:
        times = diurnal_schedule(sched_rng, duration_s, **kw)
    pop_rng = root.fork("population")
    arrivals = []
    for i, t in enumerate(times):
        fam, pid, plen, pfx, max_new = _sample_request(pop_rng, mix)
        arrivals.append(Arrival(i, t, fam, pid, plen, pfx, max_new))
    return TrafficTrace(seed, process, duration_s, tuple(arrivals))


def prompt_tokens(arr: Arrival, vocab: int = 32000):
    """Materialize the arrival's prompt as a ``(1, prompt_len)`` int32
    row. The shared-prefix portion is deterministic in ``(family,
    prefix_id)`` — every arrival in a group carries an identical real
    token prefix, so paged-KV prefix caching sees genuine reuse — and
    the suffix is deterministic in ``seq``."""
    import numpy as np

    pfx_rng = TraceRng(f"{arr.family}:{arr.prefix_id}", salt="prefix")
    sfx_rng = TraceRng(arr.seq, salt="suffix")
    row = (pfx_rng.token_row(arr.prefix_len, vocab)
           + sfx_rng.token_row(arr.prompt_len - arr.prefix_len,
                               vocab))
    return np.asarray([row], np.int32)
