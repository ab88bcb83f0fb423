"""Declarative alert rules over cluster health series — the port's
copy of ``ptype_tpu/health/rules.py``.

The watchdog half of the health plane: :class:`Rule`\\ s evaluate a
cluster telemetry snapshot (per-node series + metrics, the shape
``telemetry.cluster_snapshot`` returns once the sampler is armed) and
fire typed :class:`Alert`\\ s. The :class:`AlertEngine` runs a rule
set, de-duplicates within a cooldown, lands every alert in the
structured log (``logs.KVLogger``), bumps ``health.alerts`` counters,
and triggers the flight recorder's ``maybe_dump`` — the moment an
alert fires is exactly when a post-mortem wants the span ring.

Rule catalogue (see docs/OBSERVABILITY.md for the full table and
docs/OPERATIONS.md for the per-alert runbook):

====================  ====================================================
rule                  fires when
====================  ====================================================
``slo-burn-rate``     gateway shed fraction burns the error budget at
                      ≥ ``burn_threshold``× (multi-window SRE math)
``slo-p99``           gateway latency p99 series exceeds the SLO target
``train-stall``       no step-counter progress within N× median step time
``straggler``         one node's step/collective mean exceeds
                      median + k·MAD across the fleet (names the node)
``loss``              training loss goes non-finite (page) or spikes
                      over ``spike_factor``× its recent median (warn)
``coord-flap``        the coordination term bumps more than allowed in a
                      window (promotion churn — dueling standbys)
``memory-growth``     a memory watermark grows past ``growth_frac``
                      within the window above a floor
``mfu-divergence``    counted-cost MFU (``goodput.mfu_compiled``, from
                      health/profiling.compiled_cost) disagrees with
                      the analytic MFU by more than ``gap_frac``
``ttft-p99``          a serving replica's time-to-first-token p99
                      (``serve.ttft_ms.p99``, the serving ledger's
                      histogram) exceeds the SLO target
``kv-pressure``       a replica's paged-KV admission headroom is pinned
                      low while the pool actively evicts (the
                      eviction-rate floor keeps a small-but-idle pool
                      from paging) — names the replica
``prefix-hit-collapse``  a replica's prefix-cache hit rate collapsed
                      from a healthy level (affinity routing broke, or
                      eviction pressure is churning the shared prefix)
``serve-stall``       a serving replica's engine iterations stopped
                      while its admission queue is non-empty — the
                      per-replica wedged-engine page
====================  ====================================================

Every rule takes the evaluation time from the :class:`ClusterView`
(injectable) and reads only series/metrics — deterministic unit tests
feed synthetic snapshots with fabricated timestamps.
"""

from __future__ import annotations

import collections
import math
import statistics
import time

from ptype_tpu_torch import lockcheck
from dataclasses import dataclass, field

from ptype_tpu_torch import logs, trace
from ptype_tpu_torch import metrics as metrics_mod
from ptype_tpu_torch.health.goodput import (_dedup_aliases, detect_stragglers,
                                      node_series_means, node_span_means)

log = logs.get_logger("health")


@dataclass
class Alert:
    """One typed firing: which rule, which node, why."""

    rule: str
    severity: str  # "page" | "warn"
    node: str
    message: str
    value: float | None = None
    threshold: float | None = None
    ts: float = 0.0
    labels: dict = field(default_factory=dict)

    def key(self) -> tuple[str, str]:
        return (self.rule, self.node)

    def to_dict(self) -> dict:
        d = {"rule": self.rule, "severity": self.severity,
             "node": self.node, "message": self.message,
             "ts": round(self.ts, 3)}
        if self.value is not None:
            d["value"] = round(self.value, 4)
        if self.threshold is not None:
            d["threshold"] = round(self.threshold, 4)
        if self.labels:
            d["labels"] = self.labels
        return d


class ClusterView:
    """Read helpers over one cluster snapshot — what rules evaluate."""

    def __init__(self, snapshot: dict, now: float | None = None):
        self.snapshot = snapshot
        #: Evaluation instant; defaults to the snapshot's own stamp so
        #: replayed/synthetic snapshots evaluate at their own time.
        self.now = (now if now is not None
                    else snapshot.get("ts") or time.time())
        #: Alias-deduped: several registry service names can alias one
        #: process; every rule must see it once or (rule, node-key)
        #: cooldowns can't stop the duplicate alert.
        self.nodes: dict = dict(_dedup_aliases(snapshot))

    def node_keys(self) -> list[str]:
        return sorted(self.nodes)

    def series(self, node: str, name: str) -> list:
        return (self.nodes.get(node, {}).get("series", {})
                .get(name) or [])

    def last(self, node: str, name: str):
        pts = self.series(node, name)
        return pts[-1] if pts else None

    def gauge(self, node: str, name: str):
        return (self.nodes.get(node, {}).get("metrics", {})
                .get("gauges", {}).get(name))

    def each_series(self, name: str) -> dict[str, list]:
        out = {}
        for key in self.nodes:
            pts = self.series(key, name)
            if pts:
                out[key] = pts
        return out


def counter_delta(points: list, window_s: float, now: float) -> float:
    """Increase of a cumulative-counter series over the window: last
    value minus the value at (or just before) the window start.
    Clamped at 0 — a process restart resets the counter, and a reset
    must read as 'no traffic', not negative traffic."""
    if not points:
        return 0.0
    base = None
    for t, v in points:
        if t <= now - window_s:
            base = v
        else:
            break
    if base is None:
        # Whole series inside the window: the first point is the base
        # (its increase happened at/after the window opened).
        base = points[0][1]
    return max(0.0, points[-1][1] - base)


class Rule:
    """Base: a named, severity-tagged predicate over a ClusterView."""

    name = "rule"
    severity = "warn"

    def evaluate(self, view: ClusterView) -> list[Alert]:
        raise NotImplementedError

    def _alert(self, node: str, message: str, *, value=None,
               threshold=None, severity: str | None = None,
               **labels) -> Alert:
        return Alert(rule=self.name,
                     severity=severity or self.severity, node=node,
                     message=message, value=value, threshold=threshold,
                     labels=labels)


class BurnRateRule(Rule):
    """Gateway SLO error-budget burn from the shed/request counter
    series. ``budget`` is the allowed bad fraction (0.01 = 99% of
    requests answered); the burn rate is ``shed_fraction / budget`` —
    1.0 spends the budget exactly at period's end, 14.4 (the classic
    fast-burn page) exhausts a 30-day budget in ~2 days."""

    name = "slo-burn-rate"
    severity = "page"

    def __init__(self, service: str = "llm", budget: float = 0.01,
                 burn_threshold: float = 14.4, window_s: float = 60.0,
                 min_requests: float = 10.0):
        self.service = service
        self.budget = float(budget)
        self.burn_threshold = float(burn_threshold)
        self.window_s = float(window_s)
        self.min_requests = float(min_requests)

    def burn_rate(self, shed_pts: list, req_pts: list,
                  now: float) -> float | None:
        """The deterministic math: windowed shed/requests fraction over
        the budget; None below the traffic floor (an empty window must
        not divide its way into a page)."""
        req = counter_delta(req_pts, self.window_s, now)
        if req < self.min_requests or self.budget <= 0:
            return None
        shed = counter_delta(shed_pts, self.window_s, now)
        return (shed / req) / self.budget

    def evaluate(self, view: ClusterView) -> list[Alert]:
        out = []
        p = f"gateway.{self.service}"
        for node in view.node_keys():
            burn = self.burn_rate(view.series(node, f"{p}.shed"),
                                  view.series(node, f"{p}.requests"),
                                  view.now)
            if burn is not None and burn >= self.burn_threshold:
                out.append(self._alert(
                    node,
                    f"gateway {self.service} shed burn rate "
                    f"{burn:.1f}x the error budget "
                    f"(window {self.window_s:.0f}s)",
                    value=burn, threshold=self.burn_threshold,
                    service=self.service))
        return out


class P99Rule(Rule):
    """Gateway latency p99 (histogram series the sampler stamps as
    ``gateway.<svc>.latency_ms.p99``) over the SLO target."""

    name = "slo-p99"
    severity = "warn"

    def __init__(self, service: str = "llm",
                 slo_p99_ms: float = 1000.0):
        self.service = service
        self.slo_p99_ms = float(slo_p99_ms)

    def evaluate(self, view: ClusterView) -> list[Alert]:
        out = []
        name = f"gateway.{self.service}.latency_ms.p99"
        for node in view.node_keys():
            last = view.last(node, name)
            if last is not None and last[1] > self.slo_p99_ms:
                out.append(self._alert(
                    node,
                    f"gateway {self.service} p99 {last[1]:.0f}ms over "
                    f"SLO {self.slo_p99_ms:.0f}ms",
                    value=last[1], threshold=self.slo_p99_ms,
                    service=self.service))
        return out


class StallRule(Rule):
    """Training stall: the step counter stopped advancing for longer
    than ``factor``× the node's median step time (with an absolute
    floor — a 1 ms CPU-smoke step must not page on a 10 ms pause)."""

    name = "train-stall"
    severity = "page"

    def __init__(self, factor: float = 5.0, min_steps: int = 3,
                 min_gap_s: float = 5.0,
                 steps_series: str = "goodput.steps",
                 step_ms_series: str = "goodput.step_ms"):
        self.factor = float(factor)
        self.min_steps = int(min_steps)
        self.min_gap_s = float(min_gap_s)
        self.steps_series = steps_series
        self.step_ms_series = step_ms_series

    def evaluate(self, view: ClusterView) -> list[Alert]:
        out = []
        for node in view.node_keys():
            pts = view.series(node, self.steps_series)
            if not pts or pts[-1][1] < self.min_steps:
                continue
            # The sampler appends only on change: the last point IS
            # the last observed progress.
            last_progress_t = pts[-1][0]
            step_vals = [v for _, v in
                         view.series(node, self.step_ms_series)]
            med_s = (statistics.median(step_vals) / 1e3
                     if step_vals else 0.0)
            threshold = max(self.factor * med_s, self.min_gap_s)
            gap = view.now - last_progress_t
            if gap > threshold:
                out.append(self._alert(
                    node,
                    f"no step progress for {gap:.1f}s "
                    f"(median step {med_s * 1e3:.0f}ms, "
                    f"threshold {threshold:.1f}s)",
                    value=gap, threshold=threshold))
        return out


class StragglerRule(Rule):
    """Cross-node straggler: one node's recent mean of
    ``metric`` (default per-step wall ms) exceeds the fleet's
    median + k·MAD (:func:`~ptype_tpu_torch.health.goodput
    .detect_stragglers`). Falls back to stitched-span durations
    (``span_prefix``) for fleets running the trace plane without the
    sampler."""

    name = "straggler"
    severity = "warn"

    def __init__(self, metric: str = "goodput.step_ms", k: float = 4.0,
                 min_nodes: int = 3, min_excess_ms: float = 50.0,
                 min_ratio: float = 1.5,
                 window_s: float | None = 300.0,
                 span_prefix: str = "store.push_tree"):
        # window_s bounded by default: change-driven sampling retains
        # points indefinitely, and one historic outlier (a warm-up
        # step, an incident hours ago) must not mark a currently-
        # healthy node as a straggler forever.
        self.metric = metric
        self.k = float(k)
        self.min_nodes = int(min_nodes)
        self.min_excess_ms = float(min_excess_ms)
        self.min_ratio = float(min_ratio)
        self.window_s = window_s
        self.span_prefix = span_prefix

    def evaluate(self, view: ClusterView) -> list[Alert]:
        per_node = node_series_means(view.snapshot, self.metric,
                                     self.window_s, view.now)
        source = self.metric
        if len(per_node) < self.min_nodes:
            per_node = node_span_means(view.snapshot, self.span_prefix,
                                       self.window_s, view.now)
            source = f"span:{self.span_prefix}"
        hits = detect_stragglers(per_node, k=self.k,
                                 min_nodes=self.min_nodes,
                                 min_excess=self.min_excess_ms,
                                 min_ratio=self.min_ratio)
        return [self._alert(
            h["node"],
            f"straggler: {source} ~{h['value']:.1f}ms vs cluster "
            f"median {h['median']:.1f}ms "
            f"(threshold {h['threshold']:.1f}ms)",
            value=h["value"], threshold=h["threshold"],
            median=h["median"], metric=source) for h in hits]


class LossRule(Rule):
    """Training loss health from the ``train.loss`` gauge series:
    non-finite pages immediately; a spike over ``spike_factor``× the
    recent median warns."""

    name = "loss"
    severity = "warn"

    def __init__(self, metric: str = "train.loss",
                 spike_factor: float = 3.0, min_points: int = 4):
        self.metric = metric
        self.spike_factor = float(spike_factor)
        self.min_points = int(min_points)

    def evaluate(self, view: ClusterView) -> list[Alert]:
        out = []
        for node, pts in view.each_series(self.metric).items():
            last = pts[-1][1]
            if not math.isfinite(last):
                out.append(self._alert(
                    node, f"training loss is {last} — run is diverged",
                    severity="page"))
                continue
            if len(pts) < self.min_points:
                continue
            prev = [v for _, v in pts[:-1] if math.isfinite(v)]
            if not prev:
                continue
            med = statistics.median(prev)
            if med > 0 and last > self.spike_factor * med:
                out.append(self._alert(
                    node,
                    f"loss spike {last:.3f} vs recent median "
                    f"{med:.3f} ({self.spike_factor:.1f}x threshold)",
                    value=last, threshold=self.spike_factor * med))
        return out


class CoordFlapRule(Rule):
    """Coordinator flap: the ``coord.term`` gauge bumped more than
    ``max_increases`` times within the window — promotion churn
    (dueling standbys, a lease TTL racing its keepalive)."""

    name = "coord-flap"
    severity = "page"

    def __init__(self, metric: str = "coord.term",
                 max_increases: int = 1, window_s: float = 300.0):
        self.metric = metric
        self.max_increases = int(max_increases)
        self.window_s = float(window_s)

    def evaluate(self, view: ClusterView) -> list[Alert]:
        out = []
        for node, pts in view.each_series(self.metric).items():
            vals = [v for t, v in pts if t >= view.now - self.window_s]
            # The point just before the window anchors the base term.
            older = [v for t, v in pts if t < view.now - self.window_s]
            if older:
                vals = [older[-1]] + vals
            bumps = sum(1 for a, b in zip(vals, vals[1:]) if b > a)
            if bumps > self.max_increases:
                out.append(self._alert(
                    node,
                    f"coordination term bumped {bumps}x in "
                    f"{self.window_s:.0f}s — promotion flapping",
                    value=float(bumps),
                    threshold=float(self.max_increases)))
        return out


class MemoryGrowthRule(Rule):
    """Sustained memory growth: a watermark series grew by more than
    ``growth_frac`` across the window while above ``min_bytes`` —
    the leak signature, not a transient peak. The window is bounded
    by default: change-driven sampling retains flat points
    indefinitely, and hours of legitimate slow growth (compilation
    caches) compared against an ancient baseline is not a leak."""

    name = "memory-growth"
    severity = "warn"

    def __init__(self,
                 metric_names: tuple = ("mem.device_bytes_in_use",
                                        "mem.rss_bytes"),
                 growth_frac: float = 0.5,
                 min_bytes: float = 256 * 1024 * 1024,
                 window_s: float | None = 600.0):
        self.metric_names = tuple(metric_names)
        self.growth_frac = float(growth_frac)
        self.min_bytes = float(min_bytes)
        self.window_s = window_s

    def evaluate(self, view: ClusterView) -> list[Alert]:
        out = []
        for node in view.node_keys():
            for name in self.metric_names:
                pts = view.series(node, name)
                if self.window_s is not None:
                    pts = [p for p in pts
                           if p[0] >= view.now - self.window_s]
                if len(pts) < 2:
                    continue
                first, last = pts[0][1], pts[-1][1]
                threshold = first * (1.0 + self.growth_frac)
                if last >= self.min_bytes and first > 0 \
                        and last > threshold:
                    out.append(self._alert(
                        node,
                        f"{name} grew {first / 2**20:.0f}MiB → "
                        f"{last / 2**20:.0f}MiB "
                        f"(+{100 * (last - first) / first:.0f}%)",
                        value=last, threshold=threshold, metric=name))
                    break  # one memory alert per node per pass
        return out


class MfuGapRule(Rule):
    """Compiled-vs-analytic MFU disagreement: both series exist for a
    node (the ledger computed ``mfu`` AND was armed with
    ``set_compiled_flops``) and the latest points differ by more than
    ``gap_frac`` relative — the signature of a silent remat, a dtype
    change, or a stale analytic formula shifting real FLOPs while the
    dashboard keeps smiling."""

    name = "mfu-divergence"
    severity = "warn"

    def __init__(self, gap_frac: float = 0.25,
                 analytic: str = "goodput.mfu",
                 compiled: str = "goodput.mfu_compiled"):
        self.gap_frac = float(gap_frac)
        self.analytic = analytic
        self.compiled = compiled

    def evaluate(self, view: ClusterView) -> list[Alert]:
        out = []
        for node in view.node_keys():
            a = view.last(node, self.analytic)
            c = view.last(node, self.compiled)
            if a is None or c is None or a[1] <= 0 or c[1] <= 0:
                continue
            gap = abs(c[1] - a[1]) / a[1]
            if gap > self.gap_frac:
                out.append(self._alert(
                    node,
                    f"compiled-cost MFU {c[1]:.4f} vs analytic "
                    f"{a[1]:.4f} ({100 * gap:.0f}% apart) — check for "
                    f"a silent remat/dtype change or a stale "
                    f"flops-per-token formula",
                    value=gap, threshold=self.gap_frac))
        return out


class TtftRule(Rule):
    """Serving TTFT tail: a replica's ``serve.ttft_ms.p99`` series
    (the serving ledger's histogram, sampler-stamped) exceeds the SLO
    target. This is the prompt-heavy overload signal an e2e-p99 rule
    misses — queue + reservation + prefill wait all land in TTFT long
    before the decode tail moves — and it NAMES the replica, which is
    what lets the profile-capture hook grab that node's timeline."""

    name = "ttft-p99"
    severity = "page"

    def __init__(self, slo_ttft_ms: float = 2000.0,
                 min_count: float = 8.0,
                 metric: str = "serve.ttft_ms"):
        self.slo_ttft_ms = float(slo_ttft_ms)
        self.min_count = float(min_count)
        self.metric = metric

    def evaluate(self, view: ClusterView) -> list[Alert]:
        out = []
        for node in view.node_keys():
            count = view.last(node, f"{self.metric}.count")
            if count is None or count[1] < self.min_count:
                continue  # tail of a handful of requests is noise
            last = view.last(node, f"{self.metric}.p99")
            if last is not None and last[1] > self.slo_ttft_ms:
                out.append(self._alert(
                    node,
                    f"serving TTFT p99 {last[1]:.0f}ms over SLO "
                    f"{self.slo_ttft_ms:.0f}ms "
                    f"({count[1]:.0f} requests)",
                    value=last[1], threshold=self.slo_ttft_ms))
        return out


class StageBreachRule(Rule):
    """Stage-budgeted SLO attribution: the gateway decomposes every
    request's wall into named stages (``gateway.<svc>.stage_ms.<stage>``
    histograms — queue-wait / route / prefill / migrate / decode /
    rpc), and this rule prices each stage's p99 against its share of
    the TTFT SLO (:data:`ptype_tpu_torch.health.forensics
    .DEFAULT_STAGE_FRACTIONS`). Where ``ttft-p99`` pages with a
    number, this pages with a CULPRIT — the page message names the
    stage eating the budget and points the runbook at ``obs tail`` →
    ``obs request``. One page per node names only the worst-overage
    stage: three stages breaching at once is one incident, not three
    pages."""

    name = "slo-stage-breach"
    severity = "page"

    def __init__(self, service: str = "llm",
                 slo_ttft_ms: float = 2000.0,
                 fractions: dict | None = None,
                 min_count: float = 8.0):
        from ptype_tpu_torch.health import forensics
        self.service = service
        self.slo_ttft_ms = float(slo_ttft_ms)
        self.budgets = forensics.stage_budgets_ms(slo_ttft_ms, fractions)
        self.min_count = float(min_count)

    def evaluate(self, view: ClusterView) -> list[Alert]:
        out = []
        prefix = f"gateway.{self.service}.stage_ms."
        for node in view.node_keys():
            series = self.nodes_series(view, node)
            worst = None  # (overage_ms, stage, p99, budget)
            for name in series:
                if not (name.startswith(prefix)
                        and name.endswith(".p99")):
                    continue
                stage = name[len(prefix):-len(".p99")]
                budget = self.budgets.get(stage)
                if budget is None:
                    continue
                count = view.last(node, f"{prefix}{stage}.count")
                if count is None or count[1] < self.min_count:
                    continue  # a handful of requests' tail is noise
                last = view.last(node, name)
                if last is None:
                    continue
                over = last[1] - budget
                if over > 0 and (worst is None or over > worst[0]):
                    worst = (over, stage, last[1], budget)
            if worst is not None:
                over, stage, p99, budget = worst
                out.append(self._alert(
                    node,
                    f"gateway {self.service} stage '{stage}' p99 "
                    f"{p99:.0f}ms over its {budget:.0f}ms budget "
                    f"({over:.0f}ms overage; stage budgets decompose "
                    f"TTFT SLO {self.slo_ttft_ms:.0f}ms) — "
                    f"obs tail, then obs request <trace_id>",
                    value=p99, threshold=budget,
                    service=self.service, stage=stage))
        return out

    @staticmethod
    def nodes_series(view: ClusterView, node: str) -> dict:
        return view.nodes.get(node, {}).get("series", {}) or {}


class KvPressureRule(Rule):
    """Paged-KV pool pressure: a replica's admission headroom
    (``kv.free_blocks`` / ``kv.total_blocks``) sat below ``free_frac``
    for most of the window WHILE the pool was actively evicting
    (``kv.evictions.rate`` above ``evict_rate_floor``). Both gates
    matter: low headroom alone is a well-sized busy pool; evictions
    alone are a healthy LRU turning over — together they are the
    thrash signature (admission waits at the head, prefix blocks churn
    out before they can be reused) that precedes admit-timeout sheds.
    Majority-of-window, not last-point: the free-blocks gauge swings
    at every retire, and one momentary recovery must not mask (nor one
    momentary dip fake) sustained pressure."""

    name = "kv-pressure"
    severity = "page"

    def __init__(self, free_frac: float = 0.15,
                 evict_rate_floor: float = 0.2,
                 window_s: float = 120.0, min_points: int = 3):
        self.free_frac = float(free_frac)
        self.evict_rate_floor = float(evict_rate_floor)
        self.window_s = float(window_s)
        self.min_points = int(min_points)

    def evaluate(self, view: ClusterView) -> list[Alert]:
        out = []
        for node in view.node_keys():
            total = view.last(node, "kv.total_blocks")
            if total is None or total[1] <= 0:
                continue
            pts = [p for p in view.series(node, "kv.free_blocks")
                   if p[0] >= view.now - self.window_s]
            if len(pts) < self.min_points:
                continue
            low = [v for _, v in pts
                   if v / total[1] <= self.free_frac]
            if len(low) * 2 < len(pts):
                continue
            rate = max((v for t, v in
                        view.series(node, "kv.evictions.rate")
                        if t >= view.now - self.window_s),
                       default=0.0)
            if rate <= self.evict_rate_floor:
                continue
            frac = min(low) / total[1]
            out.append(self._alert(
                node,
                f"kv pool pressure: free blocks down to "
                f"{min(low):.0f}/{total[1]:.0f} "
                f"({100 * frac:.0f}%) with evictions at "
                f"{rate:.1f}/s — admission is about to shed",
                value=frac, threshold=self.free_frac,
                evictions_per_s=round(rate, 2)))
        return out


class PrefixHitCollapseRule(Rule):
    """Prefix-cache effectiveness collapse: a replica whose
    ``kv.prefix_hit_rate`` was healthy earlier in the window reads
    collapsed now — the signature of affinity routing breaking (fleet
    churn re-hashed the keys) or eviction pressure churning the shared
    prefix out between requests. Hit rate only moves with traffic
    (change-driven sampling), so a quiet replica never fires."""

    name = "prefix-hit-collapse"
    severity = "warn"

    def __init__(self, healthy_frac: float = 0.3,
                 collapsed_frac: float = 0.1,
                 window_s: float = 600.0, min_points: int = 4):
        self.healthy_frac = float(healthy_frac)
        self.collapsed_frac = float(collapsed_frac)
        self.window_s = float(window_s)
        self.min_points = int(min_points)

    def evaluate(self, view: ClusterView) -> list[Alert]:
        out = []
        for node in view.node_keys():
            pts = [p for p in
                   view.series(node, "kv.prefix_hit_rate")
                   if p[0] >= view.now - self.window_s]
            if len(pts) < self.min_points:
                continue
            peak = max(v for _, v in pts[:-1])
            last = pts[-1][1]
            if peak >= self.healthy_frac \
                    and last <= self.collapsed_frac:
                out.append(self._alert(
                    node,
                    f"prefix hit rate collapsed "
                    f"{peak:.2f} → {last:.2f} — check affinity "
                    f"routing and pool eviction pressure",
                    value=last, threshold=self.collapsed_frac,
                    peak=round(peak, 4)))
        return out


class ServeStallRule(Rule):
    """Per-replica serving stall: the engine's iteration counter
    (``serve.steps``) stopped advancing while the admission queue
    (``serve.queue_depth``) is non-empty — a wedged engine thread, a
    hung device call, or an admission deadlock. The queue gate keeps
    an idle replica (no traffic, no steps — healthy) from paging; the
    threshold scales with the replica's own median iteration time with
    an absolute floor, like the training ``train-stall`` rule."""

    name = "serve-stall"
    severity = "page"

    def __init__(self, factor: float = 8.0, min_gap_s: float = 5.0,
                 min_steps: int = 3,
                 steps_series: str = "serve.steps",
                 step_ms_series: str = "serve.step_ms",
                 queue_series: str = "serve.queue_depth"):
        self.factor = float(factor)
        self.min_gap_s = float(min_gap_s)
        self.min_steps = int(min_steps)
        self.steps_series = steps_series
        self.step_ms_series = step_ms_series
        self.queue_series = queue_series

    def evaluate(self, view: ClusterView) -> list[Alert]:
        out = []
        for node in view.node_keys():
            pts = view.series(node, self.steps_series)
            if not pts or pts[-1][1] < self.min_steps:
                continue
            queued = view.last(node, self.queue_series)
            if queued is None or queued[1] <= 0:
                continue  # nothing waiting: an idle engine is healthy
            step_vals = [v for _, v in
                         view.series(node, self.step_ms_series)]
            med_s = (statistics.median(step_vals) / 1e3
                     if step_vals else 0.0)
            threshold = max(self.factor * med_s, self.min_gap_s)
            gap = view.now - pts[-1][0]
            if gap > threshold:
                out.append(self._alert(
                    node,
                    f"engine made no iteration for {gap:.1f}s with "
                    f"{queued[1]:.0f} queued (median iteration "
                    f"{med_s * 1e3:.0f}ms, threshold "
                    f"{threshold:.1f}s)",
                    value=gap, threshold=threshold))
        return out


class RecompileStormRule(Rule):
    """Dispatch-discipline breach at runtime: a node's
    ``jit.recompiles`` counter (the jitwatch seam — same-signature
    kernel builds or loads the build cache should have served) grew by
    ``threshold`` or more inside the window. A steady-state process
    builds NOTHING; sustained recompiles mean a hot loop is paying a
    kernel build or load per iteration — a class a green test suite
    never sees. The alert NAMES the worst-offending function
    from the per-function ``jit.fn.*`` books, which is what makes the
    page actionable (and lets the profile-capture hook grab the right
    node's timeline). Structural: the series only exists on
    jitwatch-armed processes (``ptype_tpu_torch.jitwatch``, whose
    compile seam is the kernel build cache), so a disarmed fleet never
    pays a false page."""

    name = "recompile-storm"
    severity = "page"

    def __init__(self, threshold: float = 3.0, window_s: float = 120.0,
                 series: str = "jit.recompiles"):
        self.threshold = float(threshold)
        self.window_s = float(window_s)
        self.series = series

    def _worst_fn(self, view: ClusterView, node: str):
        """(fn, recompiles) with the highest per-function count, from
        the sampled ``jit.fn.*`` series (or the live gauges when the
        snapshot carries metrics)."""
        best: tuple[str, float] | None = None
        telem = view.nodes.get(node, {})
        candidates: dict[str, float] = {}
        for name, pts in (telem.get("series") or {}).items():
            if name.startswith("jit.fn.") and pts:
                candidates[name[len("jit.fn."):]] = pts[-1][1]
        for name, val in ((telem.get("metrics") or {})
                          .get("gauges", {}).items()):
            if name.startswith("jit.fn."):
                candidates.setdefault(name[len("jit.fn."):], val)
        for fn, val in candidates.items():
            if best is None or val > best[1]:
                best = (fn, val)
        return best

    def evaluate(self, view: ClusterView) -> list[Alert]:
        out = []
        for node in view.node_keys():
            pts = view.series(node, self.series)
            delta = counter_delta(pts, self.window_s, view.now)
            if delta < self.threshold:
                continue
            worst = self._worst_fn(view, node)
            who = (f"; worst offender: {worst[0]} "
                   f"({worst[1]:.0f} recompiles)" if worst else "")
            out.append(self._alert(
                node,
                f"{delta:.0f} steady-state recompiles in "
                f"{self.window_s:.0f}s — a hot program is re-tracing "
                f"per call{who}; read `obs jit` for the per-function "
                f"books",
                value=delta, threshold=self.threshold,
                fn=worst[0] if worst else None))
        return out


class MigrationStallRule(Rule):
    """A disaggregated migration wedged mid-transfer: a replica's
    ``serve.migrate_inflight`` gauge stayed above zero for the whole
    window while its ``serve.migrations`` completion counter did not
    advance — an export ticket parked on a prefill replica or an
    import reservation pinned on a decode replica whose gateway leg
    died without the abort landing. Pinned blocks are pool capacity
    the admission gate can't hand out, so a stall quietly becomes
    KV-pressure sheds on a fleet that looks idle. Structural: the
    gauge only exists on migration-armed engines, so a
    unified fleet never pays a false page. Start at ``obs serve`` —
    the migration counters and per-replica class column name the
    wedged side."""

    name = "migration-stall"
    severity = "page"

    def __init__(self, window_s: float = 60.0,
                 inflight_series: str = "serve.migrate_inflight",
                 done_series: str = "serve.migrations"):
        self.window_s = float(window_s)
        self.inflight_series = inflight_series
        self.done_series = done_series

    def evaluate(self, view: ClusterView) -> list[Alert]:
        out = []
        for node in view.node_keys():
            pts = [p for p in view.series(node, self.inflight_series)
                   if p[0] >= view.now - self.window_s]
            if len(pts) < 2 or min(v for _, v in pts) <= 0:
                continue  # empty, briefly sampled, or drained mid-window
            done = counter_delta(
                view.series(node, self.done_series),
                self.window_s, view.now)
            if done > 0:
                continue  # migrations ARE completing; just busy
            out.append(self._alert(
                node,
                f"{pts[-1][1]:.0f} migration(s) in flight for "
                f"{self.window_s:.0f}s with none completing — a "
                f"parked export or pinned import reservation is "
                f"holding KV blocks; read `obs serve` first (class "
                f"column + migration counters name the wedged side)",
                value=pts[-1][1], threshold=0.0))
        return out


class ReshardStallRule(Rule):
    """A live elastic reshard wedged mid-move: a node's
    ``train.reshard_inflight`` gauge stayed above zero for the whole
    window while its ``train.reshards`` completion counter did not
    advance. The trainer raises the gauge before the re-pad/re-place
    loop and only clears it after the atomic swap lands
    (``StoreDPTrainer.reshard``), so a stuck gauge means the move is
    stalled (a wedged bucket re-place, a retry loop that keeps losing)
    and training is NOT stepping — the survivor set is paid for but
    idle. Structural: the series only exists on trainers that armed a
    reshard, so steady-state fleets never page. Start at ``obs
    scale``/the trace plane first — the ``train.reshard`` span (and
    its per-bucket chaos trace, if a drill is armed) names the bucket
    the move died in."""

    name = "reshard-stall"
    severity = "page"

    def __init__(self, window_s: float = 60.0,
                 inflight_series: str = "train.reshard_inflight",
                 done_series: str = "train.reshards"):
        self.window_s = float(window_s)
        self.inflight_series = inflight_series
        self.done_series = done_series

    def evaluate(self, view: ClusterView) -> list[Alert]:
        out = []
        for node in view.node_keys():
            pts = [p for p in view.series(node, self.inflight_series)
                   if p[0] >= view.now - self.window_s]
            if len(pts) < 2 or min(v for _, v in pts) <= 0:
                continue  # no reshard, briefly sampled, or completed
            done = counter_delta(
                view.series(node, self.done_series),
                self.window_s, view.now)
            if done > 0:
                continue  # reshards ARE landing; just churning
            out.append(self._alert(
                node,
                f"a live reshard has been in flight for "
                f"{self.window_s:.0f}s without completing — training "
                f"is parked on the survivor set; read `obs scale` and "
                f"the train.reshard trace span first (they name the "
                f"bucket the move stalled in), then the elastic "
                f"recover log for retry exhaustion",
                value=pts[-1][1], threshold=0.0))
        return out


class CapacityHeadroomRule(Rule):
    """Offered load sustained above the last-measured capacity knee:
    a node publishing traffic-plane series (the open-loop driver's
    ``loadgen.offered`` counter) is being asked for more than the
    frontier sweep measured the fleet good for (the ``loadgen
    .knee_rps`` gauge :func:`~ptype_tpu_torch.loadgen.frontier.publish_knee`
    stamps). This is the *leading* capacity signal — it warns while
    goodput still holds, before the SLO burns and ``slo-burn-rate``
    pages. Structural: both series exist only where a frontier has
    been measured and traffic is being offered, so untraffic'd fleets
    never see it. Runbook: docs/OPERATIONS.md "Capacity planning"."""

    name = "capacity-headroom"
    severity = "warn"

    def __init__(self, window_s: float = 30.0,
                 headroom_frac: float = 0.9,
                 min_offered: float = 8.0):
        self.window_s = float(window_s)
        #: Warn at this fraction of the knee — at 1.0 the warning and
        #: the goodput collapse arrive together, which is too late.
        self.headroom_frac = float(headroom_frac)
        self.min_offered = float(min_offered)

    def evaluate(self, view: ClusterView) -> list[Alert]:
        out = []
        for node in view.node_keys():
            knee = view.last(node, "loadgen.knee_rps")
            if knee is None or knee[1] <= 0:
                continue  # no frontier measured on this node
            pts = view.series(node, "loadgen.offered")
            if not pts:
                continue
            offered = counter_delta(pts, self.window_s, view.now)
            if offered < self.min_offered:
                continue  # a handful of requests is not "sustained"
            span = min(self.window_s,
                       max(1e-9, pts[-1][0] - pts[0][0]))
            rate = offered / span
            bar = self.headroom_frac * knee[1]
            if rate >= bar:
                out.append(self._alert(
                    node,
                    f"offered load ~{rate:.0f} rps sustained at "
                    f">={self.headroom_frac:.0%} of the measured "
                    f"capacity knee ({knee[1]:.0f} rps) — grow the "
                    f"fleet or re-sweep the frontier before the SLO "
                    f"burns",
                    value=rate, threshold=bar))
        return out


def default_rules(service: str = "llm",
                  slo_p99_ms: float | None = None,
                  slo_ttft_ms: float | None = None) -> list[Rule]:
    """The stock watchdog set; ``slo_p99_ms`` adds the latency rule
    and ``slo_ttft_ms`` the serving TTFT rule — both are SLO targets
    nobody but the operator can pick, so like ``P99Rule`` the TTFT
    page is opt-in (a healthy prompt-heavy fleet over an arbitrary
    default would page, and auto-capture profiles, out of the box).
    The structural rules (kv-pressure / prefix-hit-collapse /
    serve-stall / migration-stall / reshard-stall /
    capacity-headroom) are always in the set — they key on
    ``serve.*`` / ``kv.*`` / reshard-armed ``train.*`` /
    frontier-armed ``loadgen.*`` series only the relevant plane emits
    and need no target, so other fleets never pay a false page for
    their presence."""
    rules: list[Rule] = [
        BurnRateRule(service=service),
        StallRule(),
        StragglerRule(),
        LossRule(),
        CoordFlapRule(),
        MemoryGrowthRule(),
        MfuGapRule(),
        KvPressureRule(),
        PrefixHitCollapseRule(),
        ServeStallRule(),
        RecompileStormRule(),
        MigrationStallRule(),
        ReshardStallRule(),
        CapacityHeadroomRule(),
    ]
    if slo_ttft_ms is not None:
        rules.append(TtftRule(slo_ttft_ms=slo_ttft_ms))
        # Same opt-in SLO target, finer verdict: the stage-budget rule
        # pages naming the culprit stage rather than the total.
        rules.append(StageBreachRule(service=service,
                                     slo_ttft_ms=slo_ttft_ms))
    if slo_p99_ms is not None:
        rules.insert(1, P99Rule(service=service, slo_p99_ms=slo_p99_ms))
    return rules


class AlertEngine:
    """Run a rule set over snapshots; fire, log, count, and dump.

    ``evaluate`` returns only NEWLY fired alerts — a (rule, node) pair
    re-firing within ``cooldown_s`` is suppressed, so a polling loop
    does not page once per poll for one ongoing condition. History
    stays in :attr:`alerts` (bounded) for the top view.

    ``capture`` takes an alert callable — in practice
    :class:`ptype_tpu_torch.health.profiling.AlertCapture`, which turns a
    ``straggler``/``train-stall``/``slo-p99`` firing into a short
    device-profile capture on the NAMED node (its own rate limit, its
    own thread) so the page ships with its evidence. Any hook failure
    is logged, never raised: the watchdog outlives its attachments.
    """

    def __init__(self, rules: list[Rule] | None = None,
                 cooldown_s: float = 30.0, dump: bool = True,
                 registry: metrics_mod.MetricsRegistry | None = None,
                 capture=None):
        self.rules = rules if rules is not None else default_rules()
        self.cooldown_s = float(cooldown_s)
        self.dump = dump
        self.capture = capture
        self.registry = (registry if registry is not None
                         else metrics_mod.metrics)
        self.alerts: collections.deque = collections.deque(maxlen=256)
        self._last_fired: dict[tuple[str, str], float] = {}
        self._lock = lockcheck.lock("health.alerts")

    def evaluate(self, snapshot: dict,
                 now: float | None = None) -> list[Alert]:
        view = ClusterView(snapshot, now)
        fired: list[Alert] = []
        for rule in self.rules:
            try:
                found = rule.evaluate(view)
            except Exception as e:  # noqa: BLE001 — one broken rule
                # must not kill the watchdog that hosts the others.
                log.warning("health rule failed",
                            kv={"rule": rule.name, "err": repr(e)})
                continue
            fired.extend(found)
        kept: list[Alert] = []
        with self._lock:
            for alert in fired:
                if not alert.ts:
                    alert.ts = view.now
                last = self._last_fired.get(alert.key())
                if last is not None and \
                        view.now - last < self.cooldown_s:
                    continue
                self._last_fired[alert.key()] = view.now
                self.alerts.append(alert)
                kept.append(alert)
        for alert in kept:
            self.registry.counter("health.alerts").add(1)
            self.registry.counter(f"health.alerts.{alert.rule}").add(1)
            log.warning("health alert", kv=alert.to_dict())
            if self.dump:
                trace.maybe_dump(f"alert:{alert.rule}:{alert.node}")
            if self.capture is not None:
                try:
                    self.capture(alert)
                except Exception as e:  # noqa: BLE001 — a broken
                    # capture hook must not kill the watchdog.
                    log.warning("alert capture hook failed",
                                kv={"rule": alert.rule,
                                    "node": alert.node, "err": repr(e)})
        return kept

    def recent(self, limit: int = 16) -> list[Alert]:
        with self._lock:
            out = list(self.alerts)
        return out[-limit:]
