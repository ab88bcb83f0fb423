"""The TrafficLedger: per-request outcomes + the ``loadgen.*`` series —
the port's copy of ``ptype_tpu/loadgen/ledger.py``.

Where the serving ledger (:mod:`ptype_tpu_torch.health.serving`) records
what the *fleet* did, the traffic ledger records what was *asked of
it* and what came back — from the open-loop driver's vantage point,
which is the only vantage that sees offered-vs-achieved: a request
that was scheduled but never answered (shed, errored, dropped by a
chaos fault, or refused at the in-flight bound) still exists here.

Outcome statuses:

==========  =========================================================
``ok``      answered; TTFT/TPOT/e2e recorded and SLO-attributed
``shed``    typed :class:`~ptype_tpu_torch.errors.ShedError` from the stack
``error``   any other failure out of the target
``dropped`` a ``loadgen.issue`` chaos fault swallowed the arrival
``overrun`` the bounded in-flight ledger was full at issue time —
            the driver refused to issue rather than wait (waiting is
            how an open-loop harness silently becomes closed-loop)
==========  =========================================================

Metric names (flat, one traffic plane per registry — pass a private
registry per sweep point so counters never bleed across points, or
the node's registry so the sampler publishes the series):

==============================  ======================================
``loadgen.offered``             arrivals that reached issue time (ctr)
``loadgen.issued``              actually handed to the target (ctr)
``loadgen.answered``            ``ok`` outcomes (ctr)
``loadgen.shed``                typed sheds (ctr)
``loadgen.errors``              non-shed failures (ctr)
``loadgen.dropped``             chaos-dropped arrivals (ctr)
``loadgen.overrun``             late or bound-refused issues (ctr)
``loadgen.slo_good``            answered AND met TTFT+TPOT SLOs (ctr)
``loadgen.slo_bad``             everything else offered (ctr)
``loadgen.slo_bad.<culprit>``   slo_bad attributed to its culprit
                                stage (gateway stage timings priced
                                against the TTFT stage budgets); a
                                shed blames ``queue-wait``, other
                                non-answers blame their status (ctr)
``loadgen.inflight``            open requests at the driver (gauge)
``loadgen.offered_rps``         the schedule's target rate (gauge)
``loadgen.knee_rps``            last measured capacity knee (gauge,
                                stamped by the frontier sweep)
``loadgen.ttft_ms``             per-request TTFT (histogram)
``loadgen.tpot_ms``             per-request TPOT (histogram)
``loadgen.e2e_ms``              per-request e2e (histogram)
``loadgen.issue_lag_ms``        scheduled-vs-actual issue lag (hist)
==============================  ======================================

SLO attribution: a request is **good** only if it was answered and
met both the TTFT and TPOT SLOs. When the target cannot report a
per-request TTFT (a non-streaming path), the e2e latency stands in as
a conservative upper bound — TTFT ≤ e2e always, so the substitution
can only *under*-count goodput, never inflate it. A TPOT SLO with no
TPOT sample (single-token request) counts as met.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

from ptype_tpu_torch import lockcheck
from ptype_tpu_torch import metrics as metrics_mod


@dataclass
class Outcome:
    """One request's fate, stamped from the driver's clock (seconds
    from driver start, so offered-vs-achieved is directly readable)."""

    seq: int
    family: str
    status: str                  # ok|shed|error|dropped|overrun
    t_offered: float             # scheduled issue offset
    t_issued: float | None = None
    t_done: float | None = None
    tokens: int = 0
    ttft_ms: float | None = None
    tpot_ms: float | None = None
    #: Gateway stage decomposition of this request's wall (name → ms),
    #: read off the SLO tracker's thread-local by the driver target —
    #: no tracing dependency, works on every answered request.
    stages: dict | None = None
    #: The request's trace id when tracing was armed — links an SLO-bad
    #: outcome to its replayable waterfall.
    trace_id: str | None = None

    @property
    def e2e_ms(self) -> float | None:
        if self.t_issued is None or self.t_done is None:
            return None
        return (self.t_done - self.t_issued) * 1000.0


class TrafficLedger:
    """Outcome sink + ``loadgen.*`` publisher for one traffic run."""

    def __init__(self, *, slo_ttft_ms: float | None = None,
                 slo_tpot_ms: float | None = None,
                 registry: metrics_mod.MetricsRegistry | None = None,
                 offered_rps: float | None = None):
        # Default to a PRIVATE registry: a frontier sweep builds one
        # ledger per rate point, and cumulative counters must not
        # bleed between points. Pass the node's registry to publish.
        self._reg = (registry if registry is not None
                     else metrics_mod.MetricsRegistry())
        self.slo_ttft_ms = slo_ttft_ms
        self.slo_tpot_ms = slo_tpot_ms
        reg = self._reg
        self.c_offered = reg.counter("loadgen.offered")
        self.c_issued = reg.counter("loadgen.issued")
        self.c_answered = reg.counter("loadgen.answered")
        self.c_shed = reg.counter("loadgen.shed")
        self.c_errors = reg.counter("loadgen.errors")
        self.c_dropped = reg.counter("loadgen.dropped")
        self.c_overrun = reg.counter("loadgen.overrun")
        self.c_good = reg.counter("loadgen.slo_good")
        self.c_bad = reg.counter("loadgen.slo_bad")
        self.g_inflight = reg.gauge("loadgen.inflight")
        self.g_offered_rps = reg.gauge("loadgen.offered_rps")
        if offered_rps is not None:
            self.g_offered_rps.set(float(offered_rps))
        self.h_ttft = reg.histogram("loadgen.ttft_ms")
        self.h_tpot = reg.histogram("loadgen.tpot_ms")
        self.h_e2e = reg.histogram("loadgen.e2e_ms")
        self.h_lag = reg.histogram("loadgen.issue_lag_ms")
        self._lock = lockcheck.lock("loadgen.ledger")
        self._outcomes: list[Outcome] = []
        self._inflight = 0
        self._wall_s: float | None = None
        # Stage budgets for culprit attribution: the TTFT SLO
        # decomposed per stage (lazy import keeps loadgen light for
        # targets that never price stages).
        self._budgets: dict | None = None
        if slo_ttft_ms is not None:
            from ptype_tpu_torch.health import forensics
            self._budgets = forensics.stage_budgets_ms(slo_ttft_ms)
        self._culprits: dict[str, int] = {}

    @property
    def registry(self) -> metrics_mod.MetricsRegistry:
        return self._reg

    # ------------------------------------------------------- intake

    def offered(self) -> None:
        self.c_offered.add(1)

    def overrun(self, lag_ms: float | None = None) -> None:
        self.c_overrun.add(1)
        if lag_ms is not None:
            self.h_lag.observe(lag_ms)

    def inflight(self, delta: int) -> int:
        with self._lock:
            self._inflight += delta
            n = self._inflight
        self.g_inflight.set(n)
        return n

    def issued(self, lag_ms: float) -> None:
        self.c_issued.add(1)
        self.h_lag.observe(max(0.0, lag_ms))

    def good(self, out: Outcome) -> bool:
        """SLO attribution (see module docstring for the fallback)."""
        if out.status != "ok":
            return False
        if self.slo_ttft_ms is not None:
            ttft = out.ttft_ms if out.ttft_ms is not None else out.e2e_ms
            if ttft is None or ttft > self.slo_ttft_ms:
                return False
        if (self.slo_tpot_ms is not None and out.tpot_ms is not None
                and out.tpot_ms > self.slo_tpot_ms):
            return False
        return True

    def culprit_of(self, out: Outcome) -> str | None:
        """The stage (or status) to blame for an SLO-bad outcome: the
        gateway's per-request stage split priced against the TTFT
        stage budgets when the target reported one; a shed blames
        ``queue-wait`` (the admission gate IS queue pressure); other
        non-answers blame their status so nothing vanishes."""
        if self.good(out):
            return None
        if out.stages:
            from ptype_tpu_torch.health import forensics
            return forensics.culprit_stage(out.stages, self._budgets)
        if out.status == "shed":
            return "queue-wait"
        return out.status if out.status != "ok" else "unattributed"

    def record(self, out: Outcome) -> None:
        if out.status == "ok":
            self.c_answered.add(1)
            e2e = out.e2e_ms
            if e2e is not None:
                self.h_e2e.observe(e2e, out.trace_id)
                ttft = (out.ttft_ms if out.ttft_ms is not None
                        else e2e)
                self.h_ttft.observe(ttft, out.trace_id)
            if out.tpot_ms is not None:
                self.h_tpot.observe(out.tpot_ms, out.trace_id)
        elif out.status == "shed":
            self.c_shed.add(1)
        elif out.status == "error":
            self.c_errors.add(1)
        elif out.status == "dropped":
            self.c_dropped.add(1)
        elif out.status == "overrun":
            self.c_overrun.add(1)
        if self.good(out):
            self.c_good.add(1)
        else:
            self.c_bad.add(1)
            culprit = self.culprit_of(out)
            if culprit:
                self._reg.counter(f"loadgen.slo_bad.{culprit}").add(1)
                with self._lock:
                    self._culprits[culprit] = (
                        self._culprits.get(culprit, 0) + 1)
        with self._lock:
            self._outcomes.append(out)

    def seal(self, wall_s: float) -> None:
        """Stamp the run's wall clock (achieved-rate denominator)."""
        with self._lock:
            self._wall_s = float(wall_s)

    # ----------------------------------------------------- readouts

    def outcomes(self) -> list[Outcome]:
        with self._lock:
            return list(self._outcomes)

    def _pct(self, vals: list[float], p: float) -> float | None:
        if not vals:
            return None
        vals = sorted(vals)
        i = min(len(vals) - 1, int(round((p / 100.0) * (len(vals) - 1))))
        return vals[i]

    def summary(self) -> dict:
        """The run distilled: counts, tails, offered vs achieved, and
        SLO-attributed goodput (good / offered — sheds, errors, chaos
        drops, and overruns all count against it: they were asked)."""
        outs = self.outcomes()
        with self._lock:
            wall = self._wall_s
            culprits = dict(self._culprits)
        by = lambda s: [o for o in outs if o.status == s]  # noqa: E731
        ok = by("ok")
        ttfts = [(o.ttft_ms if o.ttft_ms is not None else o.e2e_ms)
                 for o in ok]
        ttfts = [t for t in ttfts if t is not None]
        e2es = [o.e2e_ms for o in ok if o.e2e_ms is not None]
        good = sum(1 for o in outs if self.good(o))
        offered = len(outs)
        if wall is None and outs:
            wall = max((o.t_done or o.t_offered) for o in outs)
        wall = wall or 0.0
        return {
            "offered": offered,
            "answered": len(ok),
            "shed": len(by("shed")),
            "errors": len(by("error")),
            "dropped": len(by("dropped")),
            "overruns": int(self.c_overrun.value),
            "good": good,
            "goodput_pct": (100.0 * good / offered if offered else 0.0),
            "offered_rps": (offered / wall if wall > 0 else 0.0),
            "achieved_rps": (len(ok) / wall if wall > 0 else 0.0),
            "goodput_rps": (good / wall if wall > 0 else 0.0),
            "ttft_p50_ms": self._pct(ttfts, 50),
            "ttft_p99_ms": self._pct(ttfts, 99),
            "e2e_p99_ms": self._pct(e2es, 99),
            "wall_s": wall,
            # WHY the knee is where it is: every slo_bad request blamed
            # on its culprit stage, plus the single worst stage — what
            # bench --traffic reports next to the knee.
            "slo_bad_stages": culprits,
            "culprit_stage": (max(culprits, key=culprits.get)
                              if culprits else None),
        }


def now_s(t0: float) -> float:
    """Driver-relative clock stamp."""
    return time.monotonic() - t0
