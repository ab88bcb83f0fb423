"""Goodput ledger: per-step time attribution + straggler detection —
the port's copy of ``ptype_tpu/health/goodput.py``.

MFU used to live only in bench tail records and the step-time
breakdown only as spans a human loads into Perfetto. This module makes
both a live, always-on account:

- :class:`GoodputLedger` listens on the ``metrics.annotate`` seam
  (:func:`ptype_tpu_torch.metrics.set_annotate_observer`) — the one hook
  train/store_dp.py, train/trainer.py, and parallel/tensorstore.py
  already run their regions through — and folds every finished region
  into a per-step record: ``data`` (``train.data``), ``collective``
  (``store.push*`` / ``store.pull*``), ``checkpoint``
  (``checkpoint.*``), ``optimizer`` (``train.opt*`` — the apply leg,
  split out so the ZeRO-1 sharded update's ~N× FLOP saving is a
  visible number), ``prefill`` (``serve.prefill`` — chunked-prefill
  admission on a serving node whose ledger steps on ``serve.step``;
  the paged engine's bounded-stall contract as a measured leg),
  ``compute`` (the step remainder), and ``stall`` (the wall-clock gap
  between consecutive steps). Each closed step
  publishes ``goodput.*`` gauges into the node's registry, which the
  health :class:`~ptype_tpu_torch.health.series.Sampler` turns into the
  series every other node can pull.
- :func:`detect_stragglers` is the robust cross-node comparison
  (median + k·MAD with an absolute-excess and ratio floor — MAD alone
  explodes on a tight cluster) that names the slow node; the
  straggler alert rule feeds it per-node step/collective means from
  the stitched cluster snapshot.

MFU is priced against ``peak_tflops`` or, without one, the card's
peak from :func:`ptype_tpu_torch.metrics.device_peak_tflops` (looked
up once, at the first step that needs it). A device the peak table
does not name has no peak: the ledger then publishes no ``mfu`` /
``mfu_compiled`` at all, never a 0 or another chip's rate.

Goodput here is the fraction of wall time spent in compute:
``100 * compute / (step + stall)`` — the number that drops when a
collective slows, a checkpoint blocks, the input pipeline starves the
step, or the scheduler steals the host.
"""

from __future__ import annotations

import collections
import statistics
import threading
import time

from ptype_tpu_torch import metrics as metrics_mod

#: Steps of history a ledger keeps.
LEDGER_WINDOW = 512


def _component(name: str) -> str | None:
    """Region name → breakdown component (None: a region no step
    attributes)."""
    fam = name.split("/", 1)[0]
    if fam.startswith("store.push") or fam.startswith("store.pull"):
        return "collective"
    if fam.startswith("checkpoint"):
        return "checkpoint"
    if fam == "train.data":
        return "data"
    if fam == "train.opt":
        # The optimizer apply — its own leg since the ZeRO-1 sharded
        # update (train.opt/zero) exists precisely to shrink it ~N×;
        # the replicated apply paths ride the same region name so the
        # comparison is apples-to-apples in `obs top` and the bench.
        return "optimizer"
    if fam == "serve.prefill":
        # Chunked-prefill admission work between decode steps on a
        # SERVING node (ledger step_name="serve.step"): its own leg so
        # the paged engine's bounded-stall contract is a measured
        # number — max per-step prefill is capped by the chunk budget,
        # and what prefill doesn't account for shows up as stall.
        return "prefill"
    return None


class _Region:
    """Context manager timing one region straight into a ledger — the
    direct-drive path for simulated nodes (several ledgers in one
    process can't share the single annotate observer)."""

    __slots__ = ("_ledger", "_name", "_t0")

    def __init__(self, ledger: "GoodputLedger", name: str):
        self._ledger = ledger
        self._name = name

    def __enter__(self) -> "_Region":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self._ledger.observe(self._name,
                             time.perf_counter() - self._t0)
        return False


class GoodputLedger:
    """Per-step goodput accounting over the annotate seam.

    ``tokens_per_step`` / ``flops_per_token`` / ``n_chips`` (all
    optional) turn the breakdown into live ``tokens_per_sec`` and MFU
    series; without them the ledger still attributes time. MFU needs a
    peak too: ``peak_tflops``, else the card's (module doc).
    """

    def __init__(self,
                 registry: metrics_mod.MetricsRegistry | None = None,
                 step_name: str = "train.step",
                 window: int = LEDGER_WINDOW,
                 tokens_per_step: int = 0,
                 flops_per_token: float = 0.0,
                 n_chips: int = 1,
                 peak_tflops: float | None = None):
        self.registry = (registry if registry is not None
                         else metrics_mod.metrics)
        self.step_name = step_name
        self.tokens_per_step = int(tokens_per_step)
        self.flops_per_token = float(flops_per_token)
        self.n_chips = int(n_chips)
        self.peak_tflops = peak_tflops
        #: The peak MFU is priced against: ``peak_tflops``, or the
        #: card's, resolved at the first step that needs it (None on a
        #: device the peak table does not name).
        self._peak: float | None = peak_tflops
        self._peak_resolved = peak_tflops is not None
        #: FLOPs per step as counted by the profiling plane's cost
        #: probe (health/profiling.compiled_cost) — 0.0 until
        #: set_compiled_flops.
        self.compiled_flops_per_step = 0.0
        self._lock = threading.Lock()
        #: (component, dur_s, monotonic end) for regions finished since
        #: the last step closed — the end stamp lets _close_step split
        #: them into inside-the-step (subtracted from compute) vs
        #: between-steps (a checkpoint save after the step: counted in
        #: its component AND deducted from stall, never from compute).
        #: Bounded: a process that emits component regions but never
        #: steps (a serving node pulling the store per request) must
        #: not leak — old events age out, steps see the recent window.
        self._events: collections.deque = collections.deque(
            maxlen=4096)
        self._records: collections.deque = collections.deque(
            maxlen=int(window))
        self._prev_end: float | None = None
        self._steps = 0

    # ----------------------------------------------------------- intake

    def observe(self, name: str, dur_s: float,
                end: float | None = None) -> None:
        """Fold one finished region (the annotate-observer signature,
        plus an injectable monotonic ``end`` for deterministic tests).
        """
        end = time.perf_counter() if end is None else end
        if name.split("/", 1)[0] == self.step_name:
            self._close_step(dur_s, end)
            return
        comp = _component(name)
        if comp is not None:
            with self._lock:
                self._events.append((comp, dur_s, end))

    def region(self, name: str) -> _Region:
        """Time a region directly into this ledger — the simulated-
        node path; real processes install() onto the annotate seam."""
        return _Region(self, name)

    def set_compiled_flops(self, flops_per_step: float) -> "GoodputLedger":
        """Arm the compiled-cost MFU: ``flops_per_step`` counted over
        the step's programs
        (:func:`ptype_tpu_torch.health.profiling.compiled_cost`, e.g.
        ``StoreDPTrainer.compiled_cost()["flops"]``). Each closed step
        then records ``mfu_compiled`` next to the analytic ``mfu`` —
        and ``mfu_gap_pct`` when both exist, the disagreement the
        ``mfu-divergence`` alert rule watches (a silent remat or dtype
        change shifts real FLOPs; the formula never notices)."""
        with self._lock:
            self.compiled_flops_per_step = float(flops_per_step)
        return self

    def install(self) -> "GoodputLedger":
        """Become the process's annotate observer: every
        ``metrics.annotate`` region now feeds this ledger."""
        metrics_mod.set_annotate_observer(self.observe)
        return self

    def uninstall(self) -> None:
        metrics_mod.set_annotate_observer(None)

    # ------------------------------------------------------------ ledger

    def _mfu(self, tokens_per_sec: float,
             flops_per_token: float) -> float | None:
        if not self._peak_resolved:
            self._peak = metrics_mod.device_peak_tflops()
            self._peak_resolved = True
        value = metrics_mod.mfu(tokens_per_sec, flops_per_token,
                                self.n_chips, self._peak)
        return round(value, 5) if value is not None else None

    def _close_step(self, step_s: float, end: float) -> None:
        with self._lock:
            events, self._events = self._events, collections.deque(
                maxlen=4096)
            # Split components at the step's start: inside regions are
            # step costs (subtracted from compute); regions that ended
            # BEFORE the step began ran between steps (a checkpoint
            # save after the previous step) — counted in their
            # component and deducted from stall, never from compute.
            step_start = end - step_s
            inside = {"data": 0.0, "collective": 0.0,
                      "checkpoint": 0.0, "optimizer": 0.0,
                      "prefill": 0.0}
            between = dict(inside)
            for comp, dur, t in events:
                (inside if t >= step_start else between)[comp] += dur
            wall = (step_s if self._prev_end is None
                    else max(step_s, end - self._prev_end))
            self._prev_end = end
            stall = max(0.0, (wall - step_s) - sum(between.values()))
            data = inside["data"] + between["data"]
            coll = inside["collective"] + between["collective"]
            ckpt = inside["checkpoint"] + between["checkpoint"]
            opt = inside["optimizer"] + between["optimizer"]
            prefill = inside["prefill"] + between["prefill"]
            # Clamp so a mis-nested caller can't drive compute negative.
            compute = max(0.0, step_s - min(step_s,
                                            sum(inside.values())))
            goodput = 100.0 * compute / wall if wall > 0 else 0.0
            self._steps += 1
            rec = {
                "step": self._steps,
                "t": round(time.time(), 3),
                # Full wall clock this step accounts for (step + stall
                # + between-step component time) — the share
                # denominator; step_ms + stall_ms alone EXCLUDES
                # between-step components that the component sums
                # include, which would let a share exceed 100%.
                "wall_ms": round(wall * 1e3, 3),
                "step_ms": round(step_s * 1e3, 3),
                "compute_ms": round(compute * 1e3, 3),
                "collective_ms": round(coll * 1e3, 3),
                "data_ms": round(data * 1e3, 3),
                "checkpoint_ms": round(ckpt * 1e3, 3),
                "optimizer_ms": round(opt * 1e3, 3),
                "prefill_ms": round(prefill * 1e3, 3),
                "stall_ms": round(stall * 1e3, 3),
                "goodput_pct": round(goodput, 2),
            }
            if self.tokens_per_step and wall > 0:
                tps = self.tokens_per_step / wall
                rec["tokens_per_sec"] = round(tps, 1)
                if self.flops_per_token:
                    value = self._mfu(tps, self.flops_per_token)
                    if value is not None:
                        rec["mfu"] = value
            if self.compiled_flops_per_step and wall > 0:
                # tokens/sec × flops/token == flops/sec: feed the
                # shared mfu() with (1/wall, flops_per_step).
                value = self._mfu(1.0 / wall, self.compiled_flops_per_step)
                if value is not None:
                    rec["mfu_compiled"] = value
                if rec.get("mfu") and "mfu_compiled" in rec:
                    rec["mfu_gap_pct"] = round(
                        100.0 * (rec["mfu_compiled"] - rec["mfu"])
                        / rec["mfu"], 2)
            self._records.append(rec)
        reg = self.registry
        for key in ("step_ms", "compute_ms", "collective_ms", "data_ms",
                    "checkpoint_ms", "optimizer_ms", "prefill_ms",
                    "stall_ms", "goodput_pct", "tokens_per_sec", "mfu",
                    "mfu_compiled", "mfu_gap_pct"):
            if key in rec:
                name = "goodput.pct" if key == "goodput_pct" \
                    else f"goodput.{key}"
                reg.gauge(name).set(rec[key])
        reg.counter("goodput.steps").add(1)

    # ---------------------------------------------------------- readouts

    def records(self, limit: int | None = None) -> list[dict]:
        with self._lock:
            out = list(self._records)
        if limit is not None and len(out) > limit:
            out = out[-limit:]
        return out

    def summary(self, limit: int | None = None) -> dict:
        """Window means: ``goodput_pct``, a ``step_breakdown`` dict
        (the bench tail's shape), and throughput when configured."""
        recs = self.records(limit)
        if not recs:
            return {"steps": 0, "goodput_pct": 0.0, "step_breakdown": {}}
        n = len(recs)

        def mean(key: str) -> float:
            return round(sum(r.get(key, 0.0) for r in recs) / n, 3)

        breakdown = {
            k: mean(k) for k in
            ("step_ms", "compute_ms", "collective_ms", "data_ms",
             "checkpoint_ms", "optimizer_ms", "prefill_ms",
             "stall_ms")}
        # Share denominator: mean wall over the records that carry it
        # (averaging absent keys as 0 would deflate the wall and push
        # the share past 100% — the bound this metric promises).
        walls = [r["wall_ms"] for r in recs if "wall_ms" in r]
        wall = (sum(walls) / len(walls) if walls
                else breakdown["step_ms"] + breakdown["stall_ms"])
        out = {
            "steps": recs[-1]["step"],
            "goodput_pct": round(mean("goodput_pct"), 2),
            "step_breakdown": breakdown,
            # How much of the step the
            # collective leg owns — what quantized wires + fine-grained
            # overlap (store_dp overlap=True) exist to shrink.
            "collective_share_pct": round(
                100.0 * breakdown["collective_ms"] / wall, 2)
            if wall else 0.0,
        }
        if "tokens_per_sec" in recs[-1]:
            out["tokens_per_sec"] = mean("tokens_per_sec")
        if "mfu" in recs[-1]:
            out["mfu"] = round(mean("mfu"), 5)
        if "mfu_compiled" in recs[-1]:
            out["mfu_compiled"] = round(mean("mfu_compiled"), 5)
        if "mfu_gap_pct" in recs[-1]:
            out["mfu_gap_pct"] = round(mean("mfu_gap_pct"), 2)
        return out


# ------------------------------------------------- process-wide default

_default: GoodputLedger | None = None
_default_lock = threading.Lock()


def install(**kwargs) -> GoodputLedger:
    """Create + install the process-wide default ledger on the
    annotate seam (idempotent; new kwargs replace the old ledger)."""
    global _default
    with _default_lock:
        led = GoodputLedger(**kwargs).install()
        _default = led
        return led


def uninstall() -> None:
    global _default
    with _default_lock:
        led, _default = _default, None
    if led is not None:
        led.uninstall()


def default() -> GoodputLedger | None:
    return _default


# ------------------------------------------------- straggler detection


def detect_stragglers(per_node: dict[str, float], k: float = 4.0,
                      min_nodes: int = 3, min_excess: float = 0.0,
                      min_ratio: float = 1.25) -> list[dict]:
    """Name the slow nodes: value > median + max(k·MAD, min_excess)
    AND value > min_ratio·median.

    Median + MAD is the robust core (one straggler cannot drag the
    mean it is judged against), but a tight healthy cluster has MAD≈0,
    so an absolute excess floor (``min_excess``, caller's units) and a
    ratio floor keep scheduler noise from paging. Returns
    ``[{"node", "value", "median", "threshold"}, ...]``."""
    if len(per_node) < min_nodes:
        return []
    vals = list(per_node.values())
    med = statistics.median(vals)
    mad = statistics.median([abs(v - med) for v in vals])
    threshold = med + max(k * mad, min_excess)
    return [{"node": node, "value": round(v, 3),
             "median": round(med, 3), "threshold": round(threshold, 3)}
            for node, v in sorted(per_node.items())
            if v > threshold and v > min_ratio * med]


def _dedup_aliases(snapshot: dict):
    """Yield each distinct PROCESS-level node once: several registry
    service names can alias one process (same pid + same reported
    service → same registry/sampler), and a duplicated series must not
    skew the straggler median or double-fire the alert. Simulated
    nodes sharing a pid stay distinct — they report distinct service
    names over their own telemetry endpoints."""
    seen: set = set()
    for key, telem in snapshot.get("nodes", {}).items():
        pid = telem.get("pid")
        if pid is not None:
            ident = (pid, telem.get("service", ""))
            if ident in seen:
                continue
            seen.add(ident)
        yield key, telem


def node_series_means(snapshot: dict, name: str,
                      window_s: float | None = None,
                      now: float | None = None) -> dict[str, float]:
    """Per-node mean of a named series from a cluster snapshot —
    the straggler rule's input. Nodes without the series are absent
    (a serving node has no step series; it must not skew training
    stragglers)."""
    now = time.time() if now is None else now
    out: dict[str, float] = {}
    for key, telem in _dedup_aliases(snapshot):
        pts = telem.get("series", {}).get(name) or []
        if window_s is not None:
            pts = [p for p in pts if p[0] >= now - window_s]
        if pts:
            out[key] = sum(p[1] for p in pts) / len(pts)
    return out


def node_span_means(snapshot: dict, prefix: str,
                    window_s: float | None = None,
                    now: float | None = None) -> dict[str, float]:
    """Per-node mean duration (ms) of spans whose name starts with
    ``prefix`` — the fallback comparison when a fleet runs the trace
    plane but not the sampler: per-node ``store.push_tree``/step span
    durations straight from the stitched snapshot."""
    now = time.time() if now is None else now
    sums: dict[str, float] = {}
    counts: dict[str, int] = {}
    for key, telem in _dedup_aliases(snapshot):
        for sp in telem.get("spans", ()):
            if not sp.get("name", "").startswith(prefix):
                continue
            if window_s is not None and \
                    sp.get("start_s", 0.0) < now - window_s:
                continue
            sums[key] = sums.get(key, 0.0) + sp.get("dur_s", 0.0) * 1e3
            counts[key] = counts.get(key, 0) + 1
    return {k: sums[k] / counts[k] for k in sums}
