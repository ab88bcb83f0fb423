"""Tail forensics: per-request critical-path attribution — the port's
copy of ``ptype_tpu/health/forensics.py``.

The serving path crosses admission queue -> route -> prefill replica ->
KV migration wire -> decode queue -> decode (spec windows, host syncs)
— and when ``ttft-p99`` pages, a number is not a culprit.  This module
turns a stitched cross-process span tree into a **stage-attributed
waterfall**: every microsecond of the request
wall is assigned to exactly one named stage, most-specific span wins,
and the residue is reported as an honest unattributed gap (budgeted at
<=5% of wall — anything larger means the span vocabulary has a hole).

Three layers share the stage vocabulary defined here:

* :func:`extract_waterfall` / :func:`render_waterfall` — the per-trace
  forensic view.
* :func:`stage_budgets_ms` / :func:`culprit_stage` — decompose
  ``slo_ttft_p99_ms`` into per-stage ceilings; the ``slo-stage-breach``
  health rule and the loadgen ledger's per-request blame both price
  against these.
* :func:`render_tail` — the fleet's worst exemplars + stage breakdown,
  fed by :class:`~ptype_tpu_torch.metrics.Histogram` exemplars riding
  the ordinary telemetry pull.

Stitching spans across processes is the telemetry plane's
(:func:`ptype_tpu_torch.telemetry.stitch_traces`):
:func:`waterfall_from_snapshot` stitches a raw cluster snapshot, and
:func:`load_dump_traces` a flight-recorder dump.

Stage names (the shared vocabulary):

================  ====================================================
``queue-wait``    gateway admission gate + engine-side admit queue
``route``         replica pick (directory walk, class filtering)
``prefill``       prefill compute (gateway rpc wall, engine chunks)
``migrate``       KV wire: plan/export/import/release legs
``decode-queue``  admit wait on the decode engine (KV already landed)
``decode``        decode compute incl. speculative windows
``spec-window``   speculative propose/verify wall (engine detail)
``host-sync``     host blocking on device (engine detail)
``rpc``           residual RPC wall not covered by a finer span —
                  serialization + socket time, honestly named
================  ====================================================
"""

from __future__ import annotations

import json
import os

__all__ = [
    "STAGES", "DEFAULT_STAGE_FRACTIONS", "stage_budgets_ms",
    "culprit_stage", "stage_of", "extract_waterfall",
    "render_waterfall", "render_tail", "measure_forensics_overhead",
    "COVERAGE_FLOOR_PCT",
]

#: The full stage vocabulary, coarse-to-fine.
STAGES = ("queue-wait", "route", "prefill", "migrate", "decode-queue",
          "decode", "spec-window", "host-sync", "rpc")

#: A waterfall attributing less than this share of wall clock to named
#: stages indicates a hole in the span vocabulary (tentpole bar).
COVERAGE_FLOOR_PCT = 95.0

# ------------------------------------------------------- stage budgets

#: Per-stage ceilings as fractions of ``slo_ttft_p99_ms``.  These are
#: *ceilings*, not a partition — they deliberately sum past 1.0 because
#: a healthy request never maxes every stage at once; a single stage
#: crossing its ceiling is what names the culprit.  Decode runs past
#: first-token so it prices against the full SLO.
DEFAULT_STAGE_FRACTIONS = {
    "queue-wait": 0.20,
    "route": 0.05,
    "prefill": 0.60,
    "migrate": 0.50,
    "decode-queue": 0.15,
    "decode": 1.00,
    "spec-window": 0.50,
    "host-sync": 0.10,
    "rpc": 1.00,
}


def stage_budgets_ms(slo_ttft_p99_ms: float,
                     fractions: dict | None = None) -> dict:
    """Decompose a TTFT SLO into per-stage millisecond ceilings."""
    frac = DEFAULT_STAGE_FRACTIONS if fractions is None else fractions
    slo = float(slo_ttft_p99_ms)
    return {s: slo * f for s, f in frac.items()}


def culprit_stage(stages: dict, budgets: dict | None = None) -> str | None:
    """Name the stage to blame for a slow request.

    The stage with the largest *overage* past its budget wins; when no
    stage is over budget (or no budgets are given) the longest stage
    wins — a slow request always gets exactly one culprit, so tail
    counts sum to the ``slo_bad`` total.
    """
    if not stages:
        return None
    if budgets:
        over = {s: d - budgets[s] for s, d in stages.items()
                if s in budgets and d - budgets[s] > 0.0}
        if over:
            return max(over, key=over.get)
    return max(stages, key=stages.get)


# ------------------------------------------------ span -> stage mapping

#: Attribution priority when spans overlap: engine-side spans are the
#: finer truth inside a gateway RPC wall (the admit wait *inside* the
#: prefill call is queue time, not compute), and generic ``rpc.call``
#: walls are the coarsest cover of all.
_TIER_SERVE, _TIER_GATEWAY, _TIER_RPC = 3, 2, 1

#: Tie-break between same-tier overlapping spans (e.g. the decode
#: engine's migrate import vs its admit queue): the rarer, more
#: diagnostic stage wins.
_STAGE_RANK = {s: i for i, s in enumerate(
    ("rpc", "queue-wait", "route", "decode", "decode-queue", "prefill",
     "migrate", "spec-window", "host-sync"))}

#: RPC methods that *are* a stage: the migration wire legs and the
#: combined migrate+decode call.
_RPC_METHOD_STAGE = {
    "MigratePlan": "migrate",
    "ExportBlocks": "migrate",
    "ImportBlocks": "migrate",
    "ReleaseExport": "migrate",
    "MigrateDecode": "decode",
}


def stage_of(span: dict) -> tuple[str, int] | None:
    """Map one span to ``(stage, priority_tier)`` or ``None``.

    An explicit ``stage`` attr (stamped by the serving ledger's span
    synthesis) always wins — name matching is the fallback for spans
    recorded before the attr existed or by the gateway side.
    """
    name = span.get("name", "")
    attrs = span.get("attrs") or {}
    stage = attrs.get("stage")
    if stage in _STAGE_RANK:
        tier = _TIER_SERVE if name.startswith("serve.") else _TIER_GATEWAY
        return stage, tier
    if name.startswith("serve."):
        if name.startswith("serve.admit"):
            return "queue-wait", _TIER_SERVE
        if name.startswith("serve.prefill"):
            return "prefill", _TIER_SERVE
        if name.startswith("serve.migrate"):
            return "migrate", _TIER_SERVE
        if name.startswith("serve.decode"):
            return "decode", _TIER_SERVE
        if name.startswith("serve.spec"):
            return "spec-window", _TIER_SERVE
        return None
    if name.startswith("host.") or "block_until_ready" in name:
        return "host-sync", _TIER_SERVE
    if name.startswith("gateway."):
        leaf = name.split(".", 1)[1]
        if leaf == "admit":
            return "queue-wait", _TIER_GATEWAY
        if leaf == "route":
            return "route", _TIER_GATEWAY
        if leaf == "prefill":
            return "prefill", _TIER_GATEWAY
        if leaf == "migrate":
            return "migrate", _TIER_GATEWAY
        return None
    if name == "rpc.call":
        method = str(attrs.get("method", ""))
        method = method.rsplit(".", 1)[-1]
        stage = _RPC_METHOD_STAGE.get(method)
        if stage is not None:
            return stage, _TIER_GATEWAY
        return "rpc", _TIER_RPC
    return None


# ------------------------------------------------- waterfall extraction


def extract_waterfall(spans: list, trace_id: str | None = None) -> dict:
    """Attribute a stitched trace's wall clock to named stages.

    ``spans`` is a list of span dicts (``Span.to_dict`` shape — what a
    flight recorder holds).  The request
    envelope is the root span when one exists (``gateway.request``, or
    the earliest parentless span), else the min/max span hull.  Every
    elementary interval inside the envelope is assigned to the
    highest-priority covering span's stage; uncovered intervals are the
    unattributed gap.

    Returns ``{"trace_id", "wall_ms", "t0", "stages": {stage: ms},
    "segments": [{stage, start_ms, dur_ms}], "spans": [...],
    "attributed_ms", "unattributed_ms", "coverage_pct", "ok"}`` where
    ``ok`` is the tentpole bar (coverage >= 95%).
    """
    rows = [s for s in spans
            if trace_id is None or s.get("trace_id") == trace_id]
    if not rows:
        raise ValueError(f"no spans for trace {trace_id!r}")
    tids = {s.get("trace_id") for s in rows}
    if trace_id is None:
        if len(tids) != 1:
            raise ValueError(
                f"{len(tids)} traces in span set; pass trace_id")
        trace_id = next(iter(tids))
    rows.sort(key=lambda s: float(s.get("start_s", 0.0)))

    # Envelope: the root request span when present, else the hull.
    root = None
    for s in rows:
        if s.get("name") == "gateway.request":
            root = s
            break
    if root is None:
        for s in rows:
            if not s.get("parent_id"):
                root = s
                break
    if root is not None and float(root.get("dur_s", 0.0)) > 0.0:
        t0 = float(root["start_s"])
        t1 = t0 + float(root["dur_s"])
    else:
        t0 = min(float(s.get("start_s", 0.0)) for s in rows)
        t1 = max(float(s.get("start_s", 0.0)) + float(s.get("dur_s", 0.0))
                 for s in rows)
    wall = max(t1 - t0, 0.0)

    # Staged intervals, clipped to the envelope.
    ivals: list = []   # (a, b, stage, tier)
    annotated: list = []
    for s in rows:
        a = float(s.get("start_s", 0.0))
        b = a + float(s.get("dur_s", 0.0))
        st = stage_of(s)
        annotated.append({
            "name": s.get("name", "?"),
            "node": s.get("node"),
            "span_id": s.get("span_id"),
            "parent_id": s.get("parent_id"),
            "start_ms": (a - t0) * 1e3,
            "dur_ms": (b - a) * 1e3,
            "stage": st[0] if st else None,
            "attrs": s.get("attrs") or {},
        })
        if st is None:
            continue
        a, b = max(a, t0), min(b, t1)
        if b > a:
            ivals.append((a, b, st[0], st[1]))

    # Elementary-interval sweep: at each slice the covering span with
    # the highest (tier, stage rank) owns the clock.
    cuts = sorted({t0, t1, *(p for iv in ivals for p in (iv[0], iv[1]))})
    stages_s: dict = {}
    segments: list = []
    for a, b in zip(cuts, cuts[1:]):
        if b <= a:
            continue
        mid = (a + b) / 2.0
        best = None
        for ia, ib, stg, tier in ivals:
            if ia <= mid < ib:
                key = (tier, _STAGE_RANK.get(stg, -1))
                if best is None or key > best[0]:
                    best = (key, stg)
        stg = best[1] if best else None
        if stg is not None:
            stages_s[stg] = stages_s.get(stg, 0.0) + (b - a)
        if segments and segments[-1]["stage"] == stg:
            segments[-1]["dur_ms"] += (b - a) * 1e3
        else:
            segments.append({"stage": stg, "start_ms": (a - t0) * 1e3,
                             "dur_ms": (b - a) * 1e3})

    attributed = sum(stages_s.values())
    coverage = 100.0 * attributed / wall if wall > 0 else 100.0
    return {
        "trace_id": trace_id,
        "t0": t0,
        "wall_ms": wall * 1e3,
        "stages": {s: v * 1e3 for s, v in sorted(
            stages_s.items(), key=lambda kv: -kv[1])},
        "segments": segments,
        "spans": annotated,
        "attributed_ms": attributed * 1e3,
        "unattributed_ms": (wall - attributed) * 1e3,
        "coverage_pct": coverage,
        "ok": coverage >= COVERAGE_FLOOR_PCT,
    }


# ---------------------------------------------------------- rendering


def _bar(frac: float, width: int) -> str:
    n = int(round(max(0.0, min(1.0, frac)) * width))
    return "#" * n + "." * (width - n)


def render_waterfall(wf: dict, width: int = 40) -> str:
    """ASCII waterfall: stage table + per-span timeline rows."""
    wall = wf["wall_ms"] or 1.0
    lines = [
        f"trace {wf['trace_id']}  wall {wf['wall_ms']:.1f}ms  "
        f"coverage {wf['coverage_pct']:.1f}%"
        f"{'' if wf['ok'] else '  (BELOW 95% FLOOR)'}",
        "",
        f"  {'stage':<12} {'ms':>9} {'share':>7}",
    ]
    for stage, ms in wf["stages"].items():
        lines.append(f"  {stage:<12} {ms:>9.2f} {ms / wall:>6.1%}  "
                     f"|{_bar(ms / wall, width)}|")
    gap = wf["unattributed_ms"]
    lines.append(f"  {'(gap)':<12} {gap:>9.2f} {gap / wall:>6.1%}")
    lines.append("")
    for sp in wf["spans"]:
        a = sp["start_ms"] / wall
        d = sp["dur_ms"] / wall
        lead = int(round(a * width))
        body = max(1, int(round(d * width))) if sp["dur_ms"] > 0 else 1
        body = min(body, width - min(lead, width - 1))
        bar = " " * min(lead, width - 1) + "=" * body
        stage = sp["stage"] or "-"
        node = f" @{sp['node']}" if sp.get("node") else ""
        lines.append(
            f"  [{bar:<{width}}] {sp['start_ms']:>8.1f} "
            f"+{sp['dur_ms']:>8.1f}ms  {sp['name']}"
            f" ({stage}){node}")
    return "\n".join(lines)


def render_tail(snapshot: dict, limit: int = 8) -> str:
    """The fleet's worst tail, from an ordinary telemetry snapshot:
    per-histogram worst exemplars (value + trace id — each links to its
    waterfall) and the gateway stage-time breakdown."""
    # Worst exemplars across every node's histogram families.
    rows: list = []          # (value, name, trace_id, node)
    stage_p99: dict = {}     # stage -> worst p99 across nodes
    nodes = dict(snapshot.get("nodes", {}))
    if not nodes and "histograms" in snapshot:
        nodes = {"local": {"metrics": snapshot}}
    for key, telem in nodes.items():
        m = telem.get("metrics", telem) or {}
        for name, summ in (m.get("histograms") or {}).items():
            for ex in summ.get("exemplars", ()):
                rows.append((float(ex["value"]), name,
                             ex.get("trace_id", "?"), key))
            if ".stage_ms." in name:
                stage = name.rsplit(".stage_ms.", 1)[1]
                p99 = float(summ.get("p99", 0.0))
                if p99 > stage_p99.get(stage, -1.0):
                    stage_p99[stage] = p99
    rows.sort(key=lambda r: -r[0])
    lines = [f"worst exemplars ({min(limit, len(rows))} of {len(rows)}):"]
    if not rows:
        lines.append("  (none — histograms carry no trace-linked "
                     "observations yet)")
    for value, name, tid, node in rows[:limit]:
        lines.append(f"  {value:>10.2f}  {name:<40} trace={tid}  @{node}")
    lines.append("")
    lines.append("stage p99 (worst node):")
    if not stage_p99:
        lines.append("  (no gateway stage histograms in snapshot)")
    for stage, p99 in sorted(stage_p99.items(), key=lambda kv: -kv[1]):
        lines.append(f"  {stage:<12} {p99:>9.2f}ms")
    lines.append("")
    lines.append("next: the waterfall of a <trace_id> names its stages.")
    return "\n".join(lines)


# ------------------------------------------------------- obs plumbing


def waterfall_from_snapshot(snapshot: dict, trace_id: str) -> dict:
    """Stitch a cluster snapshot (or a flight-recorder dump already
    loaded as ``{"traces": ...}``) and extract one trace's waterfall."""
    traces = snapshot.get("traces")
    if traces is None:
        from ptype_tpu_torch import telemetry
        traces = telemetry.stitch_traces(telemetry.all_spans(snapshot))
    spans = traces.get(trace_id)
    if spans is None:
        # Prefix match: operators paste the short id of a tail row.
        hits = [t for t in traces if t.startswith(trace_id)]
        if len(hits) == 1:
            spans = traces[hits[0]]
            trace_id = hits[0]
    if spans is None:
        raise KeyError(
            f"trace {trace_id!r} not found "
            f"({len(traces)} traces in snapshot)")
    return extract_waterfall(spans, trace_id)


def load_dump_traces(path: str) -> dict:
    """Read a flight-recorder ``.jsonl`` dump (``trace.maybe_dump``
    output) into ``{trace_id: [span, ...]}`` — the post-mortem source
    when the cluster is gone."""
    spans: list = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            if "span_id" in d:
                spans.append(d)
    from ptype_tpu_torch import telemetry
    return telemetry.stitch_traces(spans)


def latest_dump(dump_dir: str) -> str | None:
    """Newest flight-recorder dump in a directory, or None."""
    try:
        names = [n for n in os.listdir(dump_dir)
                 if n.startswith("flight-") and n.endswith(".jsonl")]
    except OSError:
        return None
    if not names:
        return None
    names.sort(key=lambda n: os.path.getmtime(os.path.join(dump_dir, n)))
    return os.path.join(dump_dir, names[-1])


# --------------------------------------------------------- bench probe


def measure_forensics_overhead(iters: int = 20000) -> dict:
    """Marginal cost of the armed exemplar seam on the serving path,
    measured the way every observability probe here is (tight loop over
    the real calls, never a wall-clock A/B): ``Histogram.observe`` with
    a trace id racing the replace-min exemplar slots vs the same
    observe with the seam cold; divided by the engine-iteration wall
    it is the seam's share of an iteration."""
    import time as _time

    from ptype_tpu_torch import metrics as metrics_mod

    reg = metrics_mod.MetricsRegistry()  # private: a probe, not telemetry
    h_plain = reg.histogram("probe.plain")
    h_armed = reg.histogram("probe.armed")
    # Pre-fill the exemplar slots so the steady-state (full-slot
    # replace-min scan) is what gets measured, not the append ramp.
    for i in range(metrics_mod.EXEMPLAR_SLOTS):
        h_armed.observe(1e9 + i, trace_id=f"warm{i}")
    t0 = _time.perf_counter()
    for i in range(iters):
        h_plain.observe(float(i % 997))
    plain_s = _time.perf_counter() - t0
    t0 = _time.perf_counter()
    for i in range(iters):
        h_armed.observe(float(i % 997), trace_id="deadbeefcafef00d")
    armed_s = _time.perf_counter() - t0
    per_obs_us = max(0.0, (armed_s - plain_s)) / iters * 1e6
    return {
        "iters": iters,
        "observe_plain_us": plain_s / iters * 1e6,
        "observe_armed_us": armed_s / iters * 1e6,
        "exemplar_marginal_us": per_obs_us,
    }
