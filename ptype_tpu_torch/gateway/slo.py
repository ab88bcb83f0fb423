"""SLO accounting and autoscale signals for the gateway — the port's
copy of ``ptype_tpu/gateway/slo.py`` (same metric names, same policy).

Every request outcome lands here: answered (with latency and token
count), shed (by cause), expired, or errored. The tracker exports the
serving tail through the shared :class:`~ptype_tpu_torch.metrics
.MetricsRegistry` (counters, gauges, and a latency histogram with
p50/p95/p99) and distills the state into a :class:`ScaleHint` — the
one-number signal an elastic replica reconciler or an external
autoscaler polling ``Gateway.Info`` consumes without understanding
the gateway's internals.

Metric names (under the process-global registry by default):

======================================  ================================
``gateway.<svc>.requests``              arrivals (counter)
``gateway.<svc>.answered``              successful responses (counter)
``gateway.<svc>.shed``                  typed sheds, all causes (counter)
``gateway.<svc>.errors``                non-shed failures (counter)
``gateway.<svc>.latency_ms``            answered-request latency (histogram)
``gateway.<svc>.ttft_ms``               replica-reported per-request TTFT
                                        (histogram; fed by the pool's
                                        probes from the serving ledger's
                                        ``ttft_recent`` samples)
``gateway.<svc>.queue_depth``           admission queue depth (gauge)
``gateway.<svc>.healthy_replicas``      routable fleet size (gauge)
``gateway.<svc>.scale_hint``            last computed hint delta (gauge)
``gateway.<svc>.slo_good_requests``     answered AND met the TTFT and
                                        TPOT SLOs (counter)
``gateway.<svc>.slo_violations``        everything else that arrived:
                                        sheds, errors, and answers
                                        over SLO (counter)
``gateway.<svc>.stage_ms.<stage>``      per-request time in one named
                                        pipeline stage (histogram; the
                                        ``slo-stage-breach`` rule reads
                                        the sampled ``.p99`` series)
``gateway.<svc>.exemplar_dumps``        SLO-violating requests that
                                        landed a full flight-recorder
                                        dump (counter; rate-limited by
                                        ``trace.maybe_dump``)
======================================  ================================

Goodput is first-class: the good/violation pair moves per
request, so the capacity frontier and the burn-rate math read a
*series*, never post-hoc percentile arithmetic. A request is good
only if TTFT **and** TPOT met their SLOs; when the dispatch path
cannot report a per-request TTFT (the interleaved path is not
streaming), the e2e latency stands in as a conservative upper bound —
TTFT ≤ e2e, so the fallback can only under-count goodput. The
disaggregated path reports its real TTFT (prefill completion is the
first token). With no SLOs configured every answer counts good, so
the counters stay meaningful as plain answered/failed accounting.
"""

from __future__ import annotations

import threading
import time

from dataclasses import dataclass, field

from ptype_tpu_torch import lockcheck
from ptype_tpu_torch import metrics as metrics_mod
from ptype_tpu_torch import trace as trace_mod

#: Worst-value slots kept per reservoir metric (TTFT / TPOT): the
#: bounded tail-exemplar memory ``Gateway.Info`` surfaces. Small on
#: purpose — links to replayable traces, not a
#: second histogram.
WORST_SLOTS = 8


@dataclass
class ScaleHint:
    """What the fleet should do: ``delta`` replicas (+N grow, -N
    shrink, 0 hold), with the deciding signal spelled out."""

    delta: int
    reason: str
    signals: dict = field(default_factory=dict)


class Stopwatch:
    """The gateway's ONE latency clock: attribution has one home (this
    class and the serving ledger), so every latency the SLO tracker,
    the stage histograms, and the traffic ledger see is the same
    clock."""

    __slots__ = ("_t0",)

    def __init__(self):
        self._t0 = time.perf_counter()

    def ms(self) -> float:
        """Elapsed wall milliseconds since construction."""
        return (time.perf_counter() - self._t0) * 1000.0

    def s(self) -> float:
        """Elapsed wall seconds since construction."""
        return time.perf_counter() - self._t0


class SLOTracker:
    """Windowed serving stats + the scale-hint policy.

    ``window_s`` bounds every rate (shed rate, tokens/sec) to recent
    traffic, so an hour-old burst cannot hold a scale-up hostage.
    """

    def __init__(self, service: str,
                 registry: metrics_mod.MetricsRegistry | None = None,
                 window_s: float = 30.0,
                 slo_p99_ms: float | None = None,
                 slo_ttft_p99_ms: float | None = None,
                 slo_tpot_p99_ms: float | None = None):
        self.service = service
        self.window_s = float(window_s)
        self.slo_p99_ms = slo_p99_ms
        self.slo_ttft_p99_ms = slo_ttft_p99_ms
        self.slo_tpot_p99_ms = slo_tpot_p99_ms
        reg = registry if registry is not None else metrics_mod.metrics
        self._reg = reg
        p = f"gateway.{service}"
        self.c_requests = reg.counter(f"{p}.requests")
        self.c_answered = reg.counter(f"{p}.answered")
        self.c_shed = reg.counter(f"{p}.shed")
        self.c_errors = reg.counter(f"{p}.errors")
        self.h_latency = reg.histogram(f"{p}.latency_ms")
        self.h_ttft = reg.histogram(f"{p}.ttft_ms")
        self.g_queue = reg.gauge(f"{p}.queue_depth")
        self.g_replicas = reg.gauge(f"{p}.healthy_replicas")
        self.g_hint = reg.gauge(f"{p}.scale_hint")
        self.c_good = reg.counter(f"{p}.slo_good_requests")
        self.c_violations = reg.counter(f"{p}.slo_violations")
        self.c_exemplar_dumps = reg.counter(f"{p}.exemplar_dumps")
        self._lock = lockcheck.lock("gateway.slo")
        #: (t, latency_ms, tokens) for answered requests in the window.
        self._ok: list[tuple[float, float, int]] = []
        #: (t,) stamps for sheds in the window.
        self._sheds: list[float] = []
        self._ewma_ms = 0.0
        #: Per-stage latency histograms, lazily created on first
        #: :meth:`stage` call (``gateway.<svc>.stage_ms.<stage>``).
        self._h_stage: dict[str, metrics_mod.Histogram] = {}
        #: Bounded worst-TTFT / worst-TPOT exemplar reservoirs:
        #: worst-first dicts with trace ids and stage splits attached.
        self._worst_ttft: list[dict] = []
        self._worst_tpot: list[dict] = []
        #: The calling thread's last answered request (trace id +
        #: stage split) — the loadgen driver's attribution seam.
        self._tls = threading.local()

    # ------------------------------------------------------------ intake

    def arrived(self) -> None:
        self.c_requests.add(1)

    def answered(self, latency_ms: float, tokens: int = 0,
                 ttft_ms: float | None = None,
                 tpot_ms: float | None = None,
                 stages: dict | None = None,
                 trace_id: str | None = None) -> None:
        if trace_id is None:
            trace_id = trace_mod.current_trace_id()
        self.c_answered.add(1)
        self.h_latency.observe(latency_ms, trace_id)
        if stages:
            for name, ms in stages.items():
                self.stage(name, ms, trace_id)
        ok = self._good(latency_ms, ttft_ms, tpot_ms)
        if ok:
            self.c_good.add(1)
        else:
            self.c_violations.add(1)
            # The tail-exemplar lifecycle: an SLO-violating
            # request dumps the whole flight ring (rate-limited inside
            # maybe_dump) so the p99 links to a replayable trace.
            if trace_mod.maybe_dump(
                    f"slo-violation:{self.service}") is not None:
                self.c_exemplar_dumps.add(1)
        self._note_worst(latency_ms, ttft_ms, tpot_ms, stages,
                         trace_id, ok)
        now = time.monotonic()
        with self._lock:
            self._ok.append((now, latency_ms, int(tokens)))
            self._trim(now)
            self._ewma_ms = (latency_ms if self._ewma_ms == 0.0
                             else 0.2 * latency_ms + 0.8 * self._ewma_ms)

    def stage(self, name: str, ms: float,
              trace_id: str | None = None) -> None:
        """Record one request's time in one named pipeline stage into
        ``gateway.<svc>.stage_ms.<name>`` — the histograms the health
        sampler stamps into ``...stage_ms.<name>.p99`` series and the
        ``slo-stage-breach`` rule prices against its budget table."""
        h = self._h_stage.get(name)
        if h is None:
            h = self._h_stage[name] = self._reg.histogram(
                f"gateway.{self.service}.stage_ms.{name}")
        h.observe(float(ms), trace_id)

    def _note_worst(self, latency_ms: float, ttft_ms: float | None,
                    tpot_ms: float | None, stages: dict | None,
                    trace_id: str | None, ok: bool) -> None:
        """Fold one answered request into the worst-TTFT/TPOT
        reservoirs and the thread-local last-request slot."""
        entry = {"latency_ms": round(latency_ms, 3),
                 "ttft_ms": (round(ttft_ms, 3)
                             if ttft_ms is not None else None),
                 "tpot_ms": (round(tpot_ms, 3)
                             if tpot_ms is not None else None),
                 "trace_id": trace_id,
                 "stages": dict(stages) if stages else {},
                 "slo_ok": ok, "ts": round(time.time(), 3)}
        self._tls.last = entry
        # TTFT falls back to e2e — same conservative bound _good uses.
        ttft = ttft_ms if ttft_ms is not None else latency_ms
        with self._lock:
            self._fold_worst(self._worst_ttft, ttft, entry)
            if tpot_ms is not None:
                self._fold_worst(self._worst_tpot, tpot_ms, entry)

    @staticmethod
    def _fold_worst(res: list[dict], value: float, entry: dict) -> None:
        item = {"value_ms": round(float(value), 3), **entry}
        if len(res) < WORST_SLOTS:
            res.append(item)
        else:
            i = min(range(len(res)), key=lambda j: res[j]["value_ms"])
            if value > res[i]["value_ms"]:
                res[i] = item

    def worst(self, limit: int = WORST_SLOTS) -> dict:
        """Worst-first TTFT/TPOT exemplar reservoirs — each entry
        carries the trace id and the per-stage split, so a tail
        number links to its waterfall in the flight recorder."""
        with self._lock:
            ttft = sorted(self._worst_ttft,
                          key=lambda e: -e["value_ms"])[:limit]
            tpot = sorted(self._worst_tpot,
                          key=lambda e: -e["value_ms"])[:limit]
        return {"ttft": ttft, "tpot": tpot}

    def last_request(self) -> dict | None:
        """The calling thread's most recent answered request (trace
        id, stage split, SLO verdict) — how an in-process driver
        (loadgen's ``gateway_target``) attributes each outcome to its
        culprit stage without a second measurement path."""
        return getattr(self._tls, "last", None)

    def _good(self, latency_ms: float, ttft_ms: float | None,
              tpot_ms: float | None) -> bool:
        """SLO attribution for ONE answered request (module docstring:
        missing TTFT falls back to e2e, the conservative bound; a
        TPOT SLO with no sample counts as met — a single-token answer
        has no inter-token gap to judge)."""
        if self.slo_ttft_p99_ms is not None:
            ttft = ttft_ms if ttft_ms is not None else latency_ms
            if ttft > self.slo_ttft_p99_ms:
                return False
        if (self.slo_tpot_p99_ms is not None and tpot_ms is not None
                and tpot_ms > self.slo_tpot_p99_ms):
            return False
        if (self.slo_ttft_p99_ms is None and self.slo_p99_ms is not None
                and latency_ms > self.slo_p99_ms):
            return False
        return True

    def shed(self) -> None:
        self.c_shed.add(1)
        self.c_violations.add(1)
        now = time.monotonic()
        with self._lock:
            self._sheds.append(now)
            self._trim(now)

    def record_ttft(self, ttft_ms: float) -> None:
        """Fold one replica-reported per-request TTFT sample. Fed by
        the replica pool's probe loop, which drains NEW
        (sequence-tagged) samples from each replica's serving-ledger
        ``ttft_recent`` — real per-request samples, never a
        percentile-of-percentile."""
        self.h_ttft.observe(float(ttft_ms))

    def errored(self) -> None:
        self.c_errors.add(1)
        self.c_violations.add(1)

    def _trim(self, now: float) -> None:
        cut = now - self.window_s
        while self._ok and self._ok[0][0] < cut:
            self._ok.pop(0)
        while self._sheds and self._sheds[0] < cut:
            self._sheds.pop(0)

    # ----------------------------------------------------------- readouts

    def est_service_s(self) -> float:
        """Current one-request service-time estimate (admission's
        SLO-aware shed math); a conservative floor before any data."""
        with self._lock:
            return (self._ewma_ms / 1000.0) if self._ewma_ms else 0.1

    def shed_rate(self) -> float:
        """Shed fraction of window traffic (sheds / (sheds + ok))."""
        with self._lock:
            self._trim(time.monotonic())
            total = len(self._sheds) + len(self._ok)
            return len(self._sheds) / total if total else 0.0

    def burn_rate(self, budget: float = 0.01) -> float:
        """Error-budget burn rate: the windowed shed fraction divided
        by the SLO's allowed bad fraction (default 1% — a 99%
        answered-SLO). 1.0 spends the budget exactly on schedule; the
        health plane's ``slo-burn-rate`` rule pages at the classic
        fast-burn multiple (14.4x) computed the same way from the
        sampled counter series, so the local and cluster views agree.
        """
        if budget <= 0:
            return 0.0
        return self.shed_rate() / budget

    def tokens_per_sec(self) -> float:
        with self._lock:
            self._trim(time.monotonic())
            if len(self._ok) < 2:
                return 0.0
            span = self._ok[-1][0] - self._ok[0][0]
            toks = sum(t for _, _, t in self._ok)
            return toks / span if span > 0 else 0.0

    def goodput(self) -> dict:
        """Lifetime SLO-attributed goodput: the good/violation split
        and the good fraction of everything that arrived and was
        resolved (answered + shed + errored)."""
        good = self.c_good.value
        bad = self.c_violations.value
        total = good + bad
        return {"slo_good_requests": int(good),
                "slo_violations": int(bad),
                "goodput_pct": (100.0 * good / total if total
                                else 100.0)}

    def percentiles(self) -> dict:
        return {"p50_ms": self.h_latency.percentile(50),
                "p95_ms": self.h_latency.percentile(95),
                "p99_ms": self.h_latency.percentile(99),
                "ttft_p50_ms": self.h_ttft.percentile(50),
                "ttft_p99_ms": self.h_ttft.percentile(99),
                **self.goodput()}

    # --------------------------------------------------------- scale hint

    def scale_hint(self, queue_depth: int, max_depth: int,
                   n_replicas: int, inflight: int,
                   capacity: int) -> ScaleHint:
        """Distill the window into one fleet-size delta.

        Priority order: shedding (capacity is actively short) beats a
        deep queue (capacity is about to be short) beats a TTFT SLO
        breach (prompt-heavy overload — queue + prefill wait blows the
        first token long before the e2e tail moves, which is exactly
        why a controller acting on e2e p99 alone scales too late)
        beats a p99 SLO breach (capacity is marginal) beats idle
        shrink. Hold otherwise. The hint is advisory — the elastic
        layer owns actuation and rate-limiting.
        """
        signals = {"queue_depth": queue_depth,
                   "shed_rate": round(self.shed_rate(), 4),
                   "n_replicas": n_replicas,
                   "inflight": inflight,
                   "capacity": capacity,
                   "tokens_per_sec": round(self.tokens_per_sec(), 1),
                   **{k: round(v, 2)
                      for k, v in self.percentiles().items()}}
        delta, reason = 0, "steady"
        per_replica = max(1, capacity // max(1, n_replicas))
        if signals["shed_rate"] > 0.0:
            # Backlog the queue could not absorb: size the step to the
            # standing queue, at least one replica.
            delta = max(1, queue_depth // per_replica)
            reason = "shedding load"
        elif max_depth and queue_depth >= max_depth // 2:
            delta = max(1, queue_depth // per_replica)
            reason = "admission queue above half depth"
        elif (self.slo_ttft_p99_ms is not None
              and self.h_ttft.count >= 20
              and signals["ttft_p99_ms"] > self.slo_ttft_p99_ms):
            delta = 1
            reason = (f"ttft p99 {signals['ttft_p99_ms']:.0f}ms over "
                      f"SLO {self.slo_ttft_p99_ms:.0f}ms")
        elif (self.slo_p99_ms is not None and self.h_latency.count >= 20
              and signals["p99_ms"] > self.slo_p99_ms):
            delta = 1
            reason = (f"p99 {signals['p99_ms']:.0f}ms over SLO "
                      f"{self.slo_p99_ms:.0f}ms")
        elif (n_replicas > 1 and queue_depth == 0
              and inflight * 3 < capacity):
            delta = -1
            reason = "fleet under a third utilized"
        self.g_hint.set(delta)
        return ScaleHint(delta=delta, reason=reason, signals=signals)
