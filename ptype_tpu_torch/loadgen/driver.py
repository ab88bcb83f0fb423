"""Open-loop (and reference closed-loop) traffic drivers — the port's
copy of ``ptype_tpu/loadgen/driver.py``.

The open-loop driver is the whole point of the plane: it issues
requests **on the trace's schedule, whether or not prior requests
completed**. A closed-loop driver (N workers, each waiting for its
response before sending the next) self-throttles exactly in the
overload regime the SLO rules, an autoscaler, and the disagg router
exist for — offered load silently sags to match capacity and the
measured tail flatters the fleet. The MLPerf server scenario is
open-loop for the same reason.

Never-closed-loop contract, mechanically enforced:

- The issue loop only ever *sleeps until the next scheduled arrival*;
  it never waits on a completion.
- In-flight requests live in a **bounded ledger** (``max_inflight``).
  When the bound is hit, the arrival is refused and recorded as an
  ``overrun`` outcome — refusing is honest (the fleet was offered a
  request it never saw, and goodput accounts it), waiting is not.
- When the loop itself falls behind schedule by more than
  ``overrun_tolerance_s`` (driver starvation, a chaos delay), the
  issue still happens but ``loadgen.overrun`` counts it and
  ``loadgen.issue_lag_ms`` records the slip — a loaded driver can
  never silently degrade into a closed-loop one; the evidence is in
  the series.

Chaos seam (site table: :mod:`ptype_tpu_torch.chaos`): each arrival passes
``chaos.hit("loadgen.issue", key=<seq>)`` before issue — ``drop``
swallows the arrival (recorded as ``dropped``), ``delay`` stalls the
issue (surfacing as overrun/lag, exactly like a wedged driver host).
Every answered request reports ``chaos.note_ok`` so drills can assert
paired recovery, and traffic replay composes with the chaos soak.

Targets are callables ``target(arrival) -> result``: a raw token
array (tokens counted from its shape), or a dict with optional
``tokens`` / ``ttft_ms`` / ``tpot_ms`` keys when the target can
report first-token timing, plus ``stages`` / ``trace_id`` when it can
report the gateway's per-stage wall split (the ledger prices those
against the TTFT stage budgets to blame each SLO-bad request on a
culprit stage). :func:`gateway_target` adapts an
:class:`~ptype_tpu_torch.gateway.InferenceGateway` and reports all five.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

from ptype_tpu_torch import chaos, lockcheck, threadpool
from ptype_tpu_torch.errors import ShedError
from ptype_tpu_torch.loadgen.arrivals import TrafficTrace, prompt_tokens
from ptype_tpu_torch.loadgen.ledger import Outcome, TrafficLedger

SITE = "loadgen.issue"


@dataclass
class DriverConfig:
    max_inflight: int = 512          #: bounded in-flight ledger
    overrun_tolerance_s: float = 0.02
    deadline_s: float = 10.0         #: per-request gateway deadline
    join_timeout_s: float = 60.0     #: post-trace drain budget


def _parse_result(res) -> tuple[int, float | None, float | None]:
    """(tokens, ttft_ms, tpot_ms) from a target's return value: a dict,
    or anything with a ``shape`` (a numpy array, or a tensor — on any
    device: only its shape is read)."""
    if isinstance(res, dict):
        return (int(res.get("tokens", 0) or 0),
                res.get("ttft_ms"), res.get("tpot_ms"))
    shape = getattr(res, "shape", None)
    if shape:
        n = 1
        for d in shape:
            n *= int(d)
        return n, None, None
    return 0, None, None


class OpenLoopDriver:
    """Replay a :class:`TrafficTrace` against a target, open-loop."""

    def __init__(self, trace: TrafficTrace, target, *,
                 ledger: TrafficLedger | None = None,
                 cfg: DriverConfig | None = None):
        self.trace = trace
        self.target = target
        self.cfg = cfg or DriverConfig()
        self.ledger = ledger if ledger is not None else TrafficLedger(
            offered_rps=trace.offered_rps())
        self._lock = lockcheck.lock("loadgen.driver")

    def run(self) -> TrafficLedger:
        cfg, led = self.cfg, self.ledger
        t0 = time.monotonic()
        # Arrivals in flight, each on a reused worker thread (a new
        # thread's first run can wait a whole scheduling slice on a busy
        # host, and the pacer would wait with it).
        fired = threadpool.Group()
        for arr in self.trace.arrivals:
            sched = t0 + arr.t
            delay = sched - time.monotonic()
            if delay > 0:
                # The open-loop pacer: sleeping to the next scheduled
                # arrival IS the algorithm, not a retry poll.
                time.sleep(delay)
            led.offered()
            key = f"{arr.seq:06d}"
            f = chaos.hit(SITE, key)
            if f is not None:
                if f.action == "drop":
                    led.record(Outcome(arr.seq, arr.family, "dropped",
                                       t_offered=arr.t))
                    continue
                f.sleep()  # "delay": a wedged driver host
            lag = time.monotonic() - sched
            if lag > cfg.overrun_tolerance_s:
                led.overrun(lag_ms=lag * 1000.0)
            if led.inflight(0) >= cfg.max_inflight:
                # Bound hit: refuse, record, move on. NEVER wait — a
                # waiting open-loop driver is a closed-loop driver.
                led.record(Outcome(arr.seq, arr.family, "overrun",
                                   t_offered=arr.t))
                continue
            led.issued(lag * 1000.0)
            fired.spawn(self._fire, arr, t0, key)
        fired.wait(cfg.join_timeout_s)
        led.seal(time.monotonic() - t0)
        return led

    def _fire(self, arr, t0: float, key: str) -> None:
        led = self.ledger
        led.inflight(+1)
        issued = time.monotonic() - t0
        try:
            try:
                res = self.target(arr)
            except ShedError:
                led.record(Outcome(arr.seq, arr.family, "shed",
                                   t_offered=arr.t, t_issued=issued,
                                   t_done=time.monotonic() - t0))
                return
            except Exception:
                led.record(Outcome(arr.seq, arr.family, "error",
                                   t_offered=arr.t, t_issued=issued,
                                   t_done=time.monotonic() - t0))
                return
            done = time.monotonic() - t0
            chaos.note_ok(SITE, key)
            tokens, ttft_ms, tpot_ms = _parse_result(res)
            if (tpot_ms is None and ttft_ms is not None
                    and tokens > 1):
                tpot_ms = max(0.0, ((done - issued) * 1000.0
                                    - ttft_ms)) / (tokens - 1)
            stages = trace_id = None
            if isinstance(res, dict):
                stages = res.get("stages")
                trace_id = res.get("trace_id")
            led.record(Outcome(arr.seq, arr.family, "ok",
                               t_offered=arr.t, t_issued=issued,
                               t_done=done, tokens=tokens,
                               ttft_ms=ttft_ms, tpot_ms=tpot_ms,
                               stages=stages, trace_id=trace_id))
        finally:
            led.inflight(-1)


class ClosedLoopDriver:
    """The self-throttling reference: ``concurrency`` workers, each
    waiting for its response before taking the next arrival. Exists
    so the open-vs-closed blind spot is *demonstrated* on the same
    fleet (tests, docs) — never use this to measure capacity."""

    def __init__(self, trace: TrafficTrace, target, *,
                 concurrency: int = 4,
                 ledger: TrafficLedger | None = None):
        self.trace = trace
        self.target = target
        self.concurrency = int(concurrency)
        self.ledger = ledger if ledger is not None else TrafficLedger()
        self._lock = lockcheck.lock("loadgen.closed_driver")
        self._next = 0

    def run(self) -> TrafficLedger:
        t0 = time.monotonic()
        arrivals = self.trace.arrivals

        def worker():
            while True:
                with self._lock:
                    i = self._next
                    self._next += 1
                if i >= len(arrivals):
                    return
                arr = arrivals[i]
                self.ledger.offered()
                self.ledger.issued(0.0)
                issued = time.monotonic() - t0
                try:
                    res = self.target(arr)
                except ShedError:
                    self.ledger.record(Outcome(
                        arr.seq, arr.family, "shed", t_offered=issued,
                        t_issued=issued,
                        t_done=time.monotonic() - t0))
                    continue
                except Exception:
                    self.ledger.record(Outcome(
                        arr.seq, arr.family, "error",
                        t_offered=issued, t_issued=issued,
                        t_done=time.monotonic() - t0))
                    continue
                tokens, ttft_ms, tpot_ms = _parse_result(res)
                self.ledger.record(Outcome(
                    arr.seq, arr.family, "ok", t_offered=issued,
                    t_issued=issued, t_done=time.monotonic() - t0,
                    tokens=tokens, ttft_ms=ttft_ms, tpot_ms=tpot_ms))

        workers = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.concurrency)]
        for w in workers:
            w.start()
        for w in workers:
            w.join()
        self.ledger.seal(time.monotonic() - t0)
        return self.ledger


def gateway_target(gw, *, deadline_s: float | None = None,
                   vocab: int = 32000):
    """Adapt an :class:`~ptype_tpu_torch.gateway.InferenceGateway` into a
    driver target: real prompt tokens (shared prefixes intact, numpy
    int32 as in the reference), affinity-keyed routing, typed sheds
    propagated. Replies land on the gateway's device (``cuda`` unless
    the gateway was built with another); only their shape is read."""

    def target(arr):
        prompt = prompt_tokens(arr, vocab=vocab)
        out = gw.generate(prompt, arr.max_new,
                          deadline_s=deadline_s,
                          affinity_key=arr.affinity_key)
        tokens, _, _ = _parse_result(out)
        rep = {"tokens": tokens}
        # The SLO tracker stamps its thread-local with the request the
        # calling thread just finished — gw.generate ran right here,
        # so this is OUR request's stage split and trace id, with no
        # tracing dependency and no extra RPC.
        slo = getattr(gw, "slo", None)
        last = slo.last_request() if slo is not None else None
        if last is not None:
            rep["stages"] = last.get("stages")
            rep["trace_id"] = last.get("trace_id")
            if last.get("ttft_ms") is not None:
                rep["ttft_ms"] = last["ttft_ms"]
            if last.get("tpot_ms") is not None:
                rep["tpot_ms"] = last["tpot_ms"]
        return rep

    return target
