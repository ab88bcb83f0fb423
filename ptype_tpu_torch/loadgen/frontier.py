"""Capacity-frontier measurement: goodput vs offered load, the knee,
and the derived operator curves — the port's copy of
``ptype_tpu/loadgen/frontier.py``.

One measured point is a marketing number; a frontier is evidence
(the MLPerf posture). The sweep replays
**one seeded trace** at each offered rate (``TrafficTrace.at_rate``
compresses the schedule, population untouched) through the open-loop
driver and reads each point's SLO-attributed goodput off the traffic
ledger — a counter the fleet cannot flatter, because sheds, errors,
overruns, and never-issued arrivals all count against it.

The **knee** is the highest offered rate whose goodput fraction still
clears ``min_goodput_pct`` (default 90%): to its left goodput tracks
offered load; to its right the fleet sheds, queues, or blows the TTFT
SLO and goodput decouples. If no point qualifies, the point with the
highest absolute goodput throughput stands in (the sweep started past
saturation — re-sweep lower). ``publish_knee`` stamps the result as
the ``loadgen.knee_rps`` gauge so the health plane's
``capacity-headroom`` rule can warn when *live* offered load runs
sustained above the last *measured* knee — before the SLO burns.

Derived curves:

- :func:`shed_burn_curve` — the shed rate of a run priced against a
  menu of error budgets (burn multiple = shed_rate / budget): how
  long the budget survives at this offered load.
- Scale-up-latency vs burst steepness is a fleet drill, not ledger
  math (it needs an autoscaler wired to the fleet).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ptype_tpu_torch.loadgen.arrivals import TrafficTrace
from ptype_tpu_torch.loadgen.driver import DriverConfig, OpenLoopDriver
from ptype_tpu_torch.loadgen.ledger import TrafficLedger


@dataclass
class RatePoint:
    """One frontier sample: what was offered, what came back good."""

    offered_rps: float
    achieved_rps: float
    goodput_rps: float
    goodput_pct: float
    ttft_p99_ms: float | None
    e2e_p99_ms: float | None
    shed_pct: float
    overrun_pct: float
    offered: int
    answered: int
    #: Stage-blamed SLO-bad counts + the single worst culprit — WHY
    #: this point's goodput is what it is (forensics attribution).
    slo_bad_stages: dict = field(default_factory=dict)
    culprit_stage: str | None = None

    def as_dict(self) -> dict:
        return {k: (round(v, 3) if isinstance(v, float) else v)
                for k, v in self.__dict__.items()}


@dataclass
class Frontier:
    points: list[RatePoint] = field(default_factory=list)
    knee: RatePoint | None = None

    @property
    def knee_rps(self) -> float | None:
        return self.knee.offered_rps if self.knee else None

    def as_dict(self) -> dict:
        return {"knee_rps": (round(self.knee_rps, 2)
                             if self.knee_rps is not None else None),
                "points": [p.as_dict() for p in self.points]}


def point_from_summary(s: dict) -> RatePoint:
    offered = max(1, s["offered"])
    return RatePoint(
        offered_rps=s["offered_rps"],
        achieved_rps=s["achieved_rps"],
        goodput_rps=s["goodput_rps"],
        goodput_pct=s["goodput_pct"],
        ttft_p99_ms=s["ttft_p99_ms"],
        e2e_p99_ms=s["e2e_p99_ms"],
        shed_pct=100.0 * s["shed"] / offered,
        overrun_pct=100.0 * s["overruns"] / offered,
        offered=s["offered"], answered=s["answered"],
        slo_bad_stages=dict(s.get("slo_bad_stages") or {}),
        culprit_stage=s.get("culprit_stage"))


def locate_knee(points: list[RatePoint],
                min_goodput_pct: float = 90.0) -> RatePoint | None:
    if not points:
        return None
    ok = [p for p in points if p.goodput_pct >= min_goodput_pct]
    if ok:
        return max(ok, key=lambda p: p.offered_rps)
    return max(points, key=lambda p: p.goodput_rps)


def sweep(trace: TrafficTrace, target, rates, *,
          slo_ttft_ms: float | None = None,
          slo_tpot_ms: float | None = None,
          cfg: DriverConfig | None = None,
          min_goodput_pct: float = 90.0,
          settle_s: float = 0.0,
          registry=None,
          on_point=None) -> Frontier:
    """Replay ``trace`` at each rate in ``rates`` (ascending) through
    a fresh open-loop driver + private ledger, and locate the knee.
    ``settle_s`` sleeps between points so the fleet drains its queue
    (a carried-over backlog would charge one rate's sins to the
    next). ``on_point(rate, RatePoint)`` is a progress hook;
    ``registry`` (a node's metrics registry) gets the knee stamped
    via :func:`publish_knee`."""
    import time

    fr = Frontier()
    for i, rate in enumerate(sorted(rates)):
        if i and settle_s > 0:
            # A fixed inter-point drain pause, not a poll: the fleet
            # must empty its queue so one rate's backlog cannot charge
            # the next point.
            time.sleep(settle_s)
        led = TrafficLedger(slo_ttft_ms=slo_ttft_ms,
                            slo_tpot_ms=slo_tpot_ms,
                            offered_rps=rate)
        OpenLoopDriver(trace.at_rate(rate), target, ledger=led,
                       cfg=cfg).run()
        p = point_from_summary(led.summary())
        p.offered_rps = float(rate)  # the sweep's set rate, not the
        fr.points.append(p)          # trace's empirical estimate
        if on_point is not None:
            on_point(rate, p)
    fr.knee = locate_knee(fr.points, min_goodput_pct)
    if registry is not None and fr.knee_rps is not None:
        publish_knee(registry, fr.knee_rps)
    return fr


def publish_knee(registry, knee_rps: float) -> None:
    """Stamp the last-measured knee where the sampler (and so the
    ``capacity-headroom`` rule) can see it."""
    registry.gauge("loadgen.knee_rps").set(float(knee_rps))


def shed_burn_curve(summary: dict,
                    budgets=(0.001, 0.01, 0.05, 0.1)) -> list[dict]:
    """Price one run's shed rate against a menu of error budgets.
    ``burn`` is the classic multiple (1.0 = spending the budget
    exactly on schedule; 14.4 = the fast-burn page threshold) — the
    same math the gateway's :meth:`SLOTracker.burn_rate` and the
    ``slo-burn-rate`` health rule use, so all three agree."""
    offered = max(1, summary["offered"])
    shed_rate = summary["shed"] / offered
    return [{"budget": b, "shed_rate": round(shed_rate, 4),
             "burn": round(shed_rate / b, 2)} for b in budgets]
