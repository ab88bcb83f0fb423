"""Cluster telemetry pull plane: aggregate every node's observability —
the port's copy of ``ptype_tpu/telemetry.py``.

One process's view lives in :func:`ptype_tpu_torch.trace.telemetry` (metrics
snapshot + recent spans), served by every :class:`ActorServer` as the
built-in ``ptype.Telemetry`` endpoint. This module is the fleet-wide
half:

- :func:`cluster_snapshot` walks the registry and pulls every node's
  telemetry over its existing actor RPC surface — the observability
  plane needs no new server, no sidecar, no push pipeline;
- :func:`stitch_traces` merges the per-node span lists into connected
  traces keyed by ``trace_id`` (the cross-process record the wire
  propagation in rpc.py / coord/wire.py exists to produce);
- :func:`chrome_trace` / :func:`write_chrome_trace` emit Chrome
  trace-event JSON — load the file in Perfetto (ui.perfetto.dev) or
  ``chrome://tracing`` and every process's spans land on one
  wall-clock timeline, stitched by trace id;
- :func:`write_spans_jsonl` is the grep/jq tier (one span per line);
- :func:`render_summary` is the operator one-pager (the reference's
  ``python -m ptype_tpu obs``);
- :func:`cluster_profile` is the profiling-plane sibling: a
  simultaneous ``torch.profiler`` capture across every node via the
  built-in ``ptype.Profile`` endpoint, artifacts shipped back and
  written per node (the reference's ``obs profile``).

The wire is the port's :mod:`~ptype_tpu_torch.rpc`, frame for frame the
reference's, so a port node and a reference node answer each other's
``ptype.Telemetry`` pulls with the same snapshot schema.

Also home to :func:`measure_trace_overhead` — the probe behind
``trace_overhead_pct`` (the ~zero-cost contract, measured instead of
asserted).
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import time

from ptype_tpu_torch import logs
from ptype_tpu_torch.registry import Node, Registry

log = logs.get_logger("telemetry")

#: Per-node budget for the telemetry pull (dial + one Info-sized RPC).
DEFAULT_NODE_TIMEOUT_S = 3.0


def node_telemetry(node: Node, timeout: float = DEFAULT_NODE_TIMEOUT_S,
                   span_limit: int = 256) -> dict:
    """Pull one node's telemetry over its actor RPC surface."""
    from ptype_tpu_torch import rpc as rpc_mod

    conn = rpc_mod._dial(node, dial_timeout=timeout)
    try:
        fut = conn.call_async("ptype.Telemetry", (span_limit,))
        return fut.result(timeout=timeout)
    finally:
        conn.close()


def cluster_snapshot(registry: Registry, services: list[str] | None = None,
                     timeout: float = DEFAULT_NODE_TIMEOUT_S,
                     span_limit: int = 256,
                     include_local: bool = True) -> dict:
    """Walk the registry and merge every node's telemetry.

    Returns ``{"ts", "nodes": {service/addr: telemetry},
    "errors": {service/addr: why}, "traces": {trace_id: [span, ...]}}``.
    Nodes that are registered but not actor servers (bare mesh members)
    land in ``errors`` — a partial snapshot of a degraded fleet is the
    point, so per-node failures never fail the walk. With
    ``include_local`` the calling process contributes its own telemetry
    under the key ``local`` (the aggregator is usually also the
    interesting client — its gateway/client spans stitch the fleet's
    server spans together).
    """
    from concurrent.futures import ThreadPoolExecutor

    out: dict = {"ts": round(time.time(), 3), "nodes": {}, "errors": {}}
    svc_map = registry.services()
    targets: list[tuple[str, Node]] = []
    for service in sorted(svc_map):
        if services is not None and service not in services:
            continue
        for node in svc_map[service]:
            targets.append((f"{service}/{node.address}:{node.port}", node))
    if targets:
        # Concurrent pulls (same reason the gateway's probe rounds are
        # concurrent): a degraded fleet is exactly when obs runs, and a
        # serial walk pays every blackholed node's dial timeout
        # additively instead of ~once.
        with ThreadPoolExecutor(
                max_workers=min(16, len(targets))) as pool:
            futs = {key: pool.submit(node_telemetry, node,
                                     timeout=timeout,
                                     span_limit=span_limit)
                    for key, node in targets}
        for key, fut in futs.items():
            try:
                out["nodes"][key] = fut.result()
            except Exception as e:  # noqa: BLE001 — partial is the point
                out["errors"][key] = f"{type(e).__name__}: {e}"
    if include_local:
        from ptype_tpu_torch import trace

        out["nodes"]["local"] = trace.telemetry(span_limit=span_limit)
    out["traces"] = stitch_traces(all_spans(out))
    return out


def all_spans(snapshot: dict) -> list[dict]:
    """Every span in a snapshot, tagged with its node key and deduped
    by span id — several registry endpoints can share one process (and
    therefore one flight recorder), and a span must appear once per
    trace no matter how many service names its process serves under.
    The node key is ``<pid>``-qualified so one process is one Perfetto
    row, not one row per service alias."""
    spans: list[dict] = []
    seen: set[str] = set()
    #: pid → first node key seen for it: one process, one label.
    labels: dict = {}
    for key, telem in snapshot.get("nodes", {}).items():
        pid = telem.get("pid")
        label = labels.setdefault(pid, key) if pid else key
        for sp in telem.get("spans", ()):
            sid = sp.get("span_id", "")
            if sid in seen:
                continue
            seen.add(sid)
            spans.append({**sp, "node": label})
    return spans


def stitch_traces(spans: list[dict]) -> dict[str, list[dict]]:
    """Group spans into traces by ``trace_id``, each sorted by start
    time — the cross-process request record, reassembled."""
    traces: dict[str, list[dict]] = {}
    for sp in spans:
        traces.setdefault(sp.get("trace_id", "?"), []).append(sp)
    for tid in traces:
        traces[tid].sort(key=lambda s: s.get("start_s", 0.0))
    return traces


# ---------------------------------------------------- cluster profiling


def node_profile(node: Node, duration_s: float = 0.5,
                 timeout: float | None = None,
                 include_data: bool = True, label: str = "cluster",
                 dial_timeout: float = DEFAULT_NODE_TIMEOUT_S) -> dict:
    """One node's ``ptype.Profile`` capture over its actor surface:
    start a ``torch.profiler`` capture, run ``duration_s``, stop, and
    ship the artifact bytes + device-memory snapshot back in the reply. Shared by
    :func:`cluster_profile` and the health plane's alert-triggered
    capture (``label="alert"``) — one dial/capture/ship sequence. The
    reply timeout defaults to the window plus the port's measured worst
    start and stop (``profiling.reply_timeout_s``)."""
    from ptype_tpu_torch import rpc as rpc_mod
    from ptype_tpu_torch.health import profiling

    if timeout is None:
        timeout = profiling.reply_timeout_s(duration_s)
    conn = rpc_mod._dial(node, dial_timeout=dial_timeout)
    try:
        fut = conn.call_async(
            "ptype.Profile",
            ("capture", {"duration_s": duration_s, "label": label,
                         "include_data": include_data}))
        return fut.result(timeout=timeout)
    finally:
        conn.close()


def cluster_profile(registry: Registry, duration_s: float = 0.5,
                    out_dir: str = ".",
                    services: list[str] | None = None,
                    timeout: float | None = None) -> dict:
    """Simultaneous device-profile capture across every registered
    node: every node's ``ptype.Profile`` endpoint starts its
    capture concurrently, so the per-node timelines cover ONE
    overlapping wall-clock window — and because ``metrics.annotate``
    feeds both the profiler and the distributed-trace plane, the
    ``train.step`` / ``store.push*`` regions in each device timeline
    line up with the same regions in the stitched span view
    (:func:`cluster_snapshot`).

    Artifacts land under ``out_dir/<service_addr_port>/`` per node
    (the gzipped Chrome trace ``.trace.json.gz`` —
    :func:`ptype_tpu_torch.health.profiling.summarize` reads it with
    the standard library). Returns ``{"ts", "duration_s", "nodes":
    {key: {"dir", "files", "memory", "truncated", ...}}, "errors":
    {key: why}}`` (``truncated``, beyond the reference's keys: the
    files a node listed past its byte budget and did not ship) — like
    the telemetry pull, a partial capture of a degraded fleet is the
    point, so per-node failures (dead node, profiler already busy)
    never fail the walk.
    """
    from concurrent.futures import ThreadPoolExecutor

    from ptype_tpu_torch.health import profiling

    out: dict = {"ts": round(time.time(), 3),
                 "duration_s": float(duration_s),
                 "nodes": {}, "errors": {}}
    svc_map = registry.services()
    targets: list[tuple[str, Node]] = []
    for service in sorted(svc_map):
        if services is not None and service not in services:
            continue
        for node in svc_map[service]:
            targets.append((f"{service}/{node.address}:{node.port}", node))
    if targets:
        # Concurrent on purpose — simultaneity IS the feature: the
        # fleet's captures must cover one shared window or cross-node
        # comparisons (who stalls while whose reduce runs) mean
        # nothing. One thread per node (they are I/O-bound waiters):
        # a 16-worker cap would queue the overflow into a LATER,
        # non-overlapping window and silently void that contract.
        with ThreadPoolExecutor(max_workers=len(targets)) as pool:
            futs = {key: pool.submit(node_profile, node,
                                     duration_s=duration_s,
                                     timeout=timeout)
                    for key, node in targets}
    else:
        futs = {}
    for key, fut in futs.items():
        try:
            result = fut.result()
        except Exception as e:  # noqa: BLE001 — partial is the point
            out["errors"][key] = f"{type(e).__name__}: {e}"
            continue
        node_dir = os.path.join(
            out_dir, key.replace("/", "_").replace(":", "_"))
        files = profiling.write_artifacts(node_dir, result)
        out["nodes"][key] = {
            "dir": node_dir,
            "files": [os.path.relpath(p, node_dir) for p in files],
            "remote_dir": result.get("dir"),
            "capture_s": result.get("duration_s"),
            "device_events": result.get("device_events"),
            "held_s": result.get("held_s"),
            # How much of the window the node's recordings hold, and
            # the kernel records each one's trace lost.
            **{k: result.get(k)
               for k in ("chunks", "recorded_s", "unrecorded_s",
                          "kernels_lost")},
            "memory": result.get("memory"),
            # Files the node listed but did not ship (past its byte
            # budget): fetch them with the ``fetch`` verb.
            "truncated": result.get("truncated", []),
        }
    return out


# ------------------------------------------------------------- exporters


def chrome_trace(spans: list[dict]) -> dict:
    """Chrome trace-event JSON (the ``traceEvents`` array format) from
    span dicts — loadable in Perfetto / chrome://tracing.

    Spans become complete (``ph: X``) events on their process's row
    (grouped by the originating pid — several registry service names
    can alias one process); span events become instants (``ph: i``);
    every event
    carries ``trace_id``/``span_id``/``parent_id`` in ``args`` so a
    request can be followed across process rows by its trace id.
    Timestamps are the spans' wall-clock microseconds: processes share
    one timeline, which is what makes the stitched view readable.
    """
    events: list[dict] = []
    pids: dict[str, int] = {}
    for sp in spans:
        node = str(sp.get("node", sp.get("pid", "local")))
        pid = pids.setdefault(node, len(pids) + 1)
        tid = int(sp.get("tid", 0)) % 1_000_000
        ts_us = sp.get("start_s", 0.0) * 1e6
        args = {"trace_id": sp.get("trace_id"),
                "span_id": sp.get("span_id"),
                "parent_id": sp.get("parent_id"),
                "status": sp.get("status", "ok")}
        args.update(sp.get("attrs", {}))
        events.append({
            "ph": "X", "name": sp.get("name", "?"),
            "cat": sp.get("status", "ok"),
            "ts": ts_us, "dur": max(sp.get("dur_s", 0.0) * 1e6, 1.0),
            "pid": pid, "tid": tid, "args": args,
        })
        for ev in sp.get("events", ()):
            events.append({
                "ph": "i", "s": "t",
                "name": ev.get("name", "event"),
                "ts": ts_us + ev.get("t", 0.0) * 1e6,
                "pid": pid, "tid": tid,
                "args": {**ev.get("attrs", {}),
                         "trace_id": sp.get("trace_id"),
                         "span_id": sp.get("span_id")},
            })
    for node, pid in pids.items():
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": 0, "args": {"name": node}})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, snapshot_or_spans) -> str:
    """Write a snapshot's (or bare span list's) Chrome trace to
    ``path``; returns the path."""
    spans = (all_spans(snapshot_or_spans)
             if isinstance(snapshot_or_spans, dict) else snapshot_or_spans)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(chrome_trace(spans), f, separators=(",", ":"))
    return path


def write_spans_jsonl(path: str, snapshot_or_spans) -> str:
    """One span dict per line — the grep/jq tier."""
    spans = (all_spans(snapshot_or_spans)
             if isinstance(snapshot_or_spans, dict) else snapshot_or_spans)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        for sp in spans:
            f.write(json.dumps(sp, separators=(",", ":")) + "\n")
    return path


def render_summary(snapshot: dict) -> str:
    """Operator one-pager: per-node span/metric counts and the stitched
    trace inventory (what the reference's ``python -m ptype_tpu obs``
    prints)."""
    lines = [f"cluster telemetry @ {snapshot.get('ts')}"]
    nodes = snapshot.get("nodes", {})
    lines.append(f"nodes: {len(nodes)}  "
                 f"unreachable: {len(snapshot.get('errors', {}))}")
    for key in sorted(nodes):
        t = nodes[key]
        m = t.get("metrics", {})
        lines.append(
            f"  {key}: pid={t.get('pid')} tracing={t.get('tracing')} "
            f"spans={len(t.get('spans', ()))} "
            f"(finished {t.get('spans_finished', 0)}) "
            f"counters={len(m.get('counters', {}))} "
            f"timings={len(m.get('timings', {}))} "
            f"gauges={len(m.get('gauges', {}))} "
            f"histograms={len(m.get('histograms', {}))}")
    for key in sorted(snapshot.get("errors", {})):
        lines.append(f"  {key}: UNREACHABLE "
                     f"({snapshot['errors'][key]})")
    traces = snapshot.get("traces", {})
    multi = {tid: sp for tid, sp in traces.items()
             if len({s.get("node") for s in sp}) > 1}
    lines.append(f"traces: {len(traces)} "
                 f"({len(multi)} spanning multiple nodes)")
    for tid, spans in sorted(traces.items(),
                             key=lambda kv: -len(kv[1]))[:8]:
        names = " → ".join(s.get("name", "?") for s in spans[:6])
        more = f" (+{len(spans) - 6})" if len(spans) > 6 else ""
        lines.append(f"  {tid[:16]}…: {len(spans)} spans: {names}{more}")
    return "\n".join(lines)


# ------------------------------------------------------- OpenMetrics


def _om_name(name: str) -> str:
    """Metric-name sanitization: ``gateway.llm.stage_ms.queue-wait``
    → ``gateway_llm_stage_ms_queue_wait`` (OpenMetrics charset)."""
    out = []
    for ch in name:
        out.append(ch if (ch.isalnum() or ch == "_") else "_")
    s = "".join(out)
    if s and s[0].isdigit():
        s = "_" + s
    return s


def _om_labels(labels: dict | None, extra: str = "") -> str:
    parts = [f'{_om_name(k)}="{v}"' for k, v in (labels or {}).items()]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def openmetrics(source, labels: dict | None = None) -> str:
    """Render metrics as OpenMetrics text — the scrape format every
    standard collector speaks, so a long soak needs no bespoke reader.

    ``source`` is a :class:`~ptype_tpu_torch.metrics.MetricsRegistry`, one
    process's ``snapshot()`` dict, or a full :func:`cluster_snapshot`
    (each node rendered with a ``node`` label). Counters render as
    ``_total`` samples, gauges as gauges, timings and histograms as
    quantile-labelled summaries; a histogram's worst trace-linked
    exemplar rides its ``quantile="0.99"`` sample in OpenMetrics
    exemplar syntax (``# {trace_id="..."} value``) — the p99 line
    literally names the trace to pull with ``obs request``."""
    snap = source.snapshot() if hasattr(source, "snapshot") else source
    lines: list[str] = []
    if "nodes" in snap and "counters" not in snap:
        for key in sorted(snap["nodes"]):
            m = snap["nodes"][key].get("metrics", {})
            node_labels = dict(labels or {})
            node_labels["node"] = key
            _om_family(lines, m, node_labels)
    else:
        _om_family(lines, snap, labels)
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


def _om_family(lines: list, snap: dict, labels: dict | None) -> None:
    lab = _om_labels(labels)
    for name, v in sorted((snap.get("counters") or {}).items()):
        om = _om_name(name)
        lines.append(f"# TYPE {om} counter")
        lines.append(f"{om}_total{lab} {v}")
    for name, v in sorted((snap.get("gauges") or {}).items()):
        om = _om_name(name)
        lines.append(f"# TYPE {om} gauge")
        lines.append(f"{om}{lab} {v}")
    for name, s in sorted((snap.get("timings") or {}).items()):
        om = _om_name(name)
        lines.append(f"# TYPE {om} summary")
        for q, key in (("0.5", "p50_s"), ("0.95", "p95_s"),
                       ("0.99", "p99_s")):
            qlab = _om_labels(labels, 'quantile="%s"' % q)
            lines.append(f"{om}{qlab} {s.get(key, 0.0)}")
        lines.append(f"{om}_count{lab} {s.get('count', 0)}")
    for name, s in sorted((snap.get("histograms") or {}).items()):
        om = _om_name(name)
        lines.append(f"# TYPE {om} summary")
        exemplars = s.get("exemplars") or []
        for q, key in (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99")):
            qlab = _om_labels(labels, 'quantile="%s"' % q)
            line = f"{om}{qlab} {s.get(key, 0.0)}"
            if q == "0.99" and exemplars:
                ex = exemplars[0]  # worst-first
                line += (' # {trace_id="%s"} %s %s'
                         % (ex["trace_id"], ex["value"],
                            ex.get("ts", 0.0)))
            lines.append(line)
        lines.append(f"{om}_count{lab} {s.get('count', 0)}")


# ------------------------------------------------------------ bench probe


def measure_trace_overhead(steps: int = 16, preset: str = "tiny",
                           batch: int = 8, seq: int = 32,
                           device=None) -> dict:
    """Tracing cost on the store-DP step loop — the numbers behind
    ``trace_overhead_pct``.

    Method: the probe interleaves traced and untraced steps (drift on
    a shared host dwarfs a naive A-then-B comparison) to establish the
    per-step floor and the span rate, then costs the span machinery
    DIRECTLY — a tight loop over ``with trace.span(...)`` enabled, and
    over the bare ``trace.span`` call disabled — and scales by the
    measured spans-per-step. The direct product is the estimator
    because it is the only part a differential can't lie about: the
    span machinery (allocate span, two contextvar ops, ring append) IS
    everything tracing adds to the step loop, it measures in
    microseconds, and the step measures in tens of milliseconds — a
    wall-clock A/B on a noisy host reports scheduler jitter, not the
    0.0x% signal. The raw interleaved wall clocks ride along for
    transparency.

    Runs a world-1 ``StoreDPTrainer`` on ``device`` (``cuda`` unless
    named); it makes its own process group when none exists and tears
    that one down after.

    - ``trace_overhead_pct``: enabled span cost × span rate / step —
      the cost of leaving tracing ON (acceptance: <5%);
    - ``trace_disabled_overhead_pct``: disabled hook cost × span rate
      / step — the compiled-out contract (acceptance: <1%).
    """
    from ptype_tpu_torch import trace

    # Capture the host process's tracing state: the probe toggles
    # enable/disable around its loops and must hand back the ORIGINAL
    # recorder (ring, service name, dump config), not a fresh one.
    orig_rec, orig_dump = trace.recorder(), trace._dump_dir
    with probe_trainer(preset, device) as (trainer, stream):
        step = lambda: trainer.step(stream(batch, seq))  # noqa: E731
        step()  # warm-up (allocator, first launches)
        # Span rate, from the recorder's own counter over a traced pair.
        rec = trace.enable("bench-trace-overhead")
        step()  # warm the traced path
        before = rec.finished
        step()
        spans_per_step = max(1.0, float(rec.finished - before))
        trace.disable()

        # Interleaved A/B: per-arm MIN step time (robust to load spikes).
        t_on: list[float] = []
        t_off: list[float] = []
        for i in range(2 * steps):
            traced = bool(i % 2)
            if traced:
                trace.enable("bench-trace-overhead")
            else:
                trace.disable()
            t0 = time.perf_counter()
            step()
            (t_on if traced else t_off).append(time.perf_counter() - t0)
        trace.disable()

    # Enabled span machinery, costed directly.
    trace.enable("bench-trace-overhead")
    n = 20_000
    t0 = time.perf_counter()
    for _ in range(n):
        with trace.span("probe"):
            pass
    span_cost_s = (time.perf_counter() - t0) / n
    trace.disable()

    # The disabled hook: one global load + None check + singleton.
    t0 = time.perf_counter()
    for _ in range(n):
        trace.span("probe")
    noop_cost_s = (time.perf_counter() - t0) / n

    step_s = min(t_off)
    trace._restore(orig_rec, orig_dump)
    return {
        "untraced_step_ms": round(step_s * 1e3, 2),
        "traced_step_ms": round(min(t_on) * 1e3, 2),
        "span_cost_us": round(span_cost_s * 1e6, 2),
        "noop_cost_us": round(noop_cost_s * 1e6, 3),
        "spans_per_step": round(spans_per_step, 1),
        "trace_overhead_pct": round(
            100.0 * span_cost_s * spans_per_step / step_s, 4),
        "trace_disabled_overhead_pct": round(
            100.0 * noop_cost_s * spans_per_step / step_s, 6),
        "steps": steps,
    }


@contextlib.contextmanager
def probe_trainer(preset: str, device=None):
    """``with probe_trainer(preset, device) as (trainer, batches)``: a
    world-1 ``StoreDPTrainer`` at ``preset`` on ``device`` (``cuda``
    unless named) over the current process group — or over a group of
    one made here (NCCL on ``cuda``, gloo on ``cpu``) and destroyed on
    exit — and ``batches(B, S)``, seeded token blocks on the trainer's
    device. The probes' shared harness (this module's and the health
    plane's)."""
    import tempfile

    import torch
    import torch.distributed as dist

    from ptype_tpu_torch.device import resolve_device
    from ptype_tpu_torch.models import transformer as tfm
    from ptype_tpu_torch.parallel.mesh import build_mesh, init_distributed
    from ptype_tpu_torch.parallel.tensorstore import TensorStore
    from ptype_tpu_torch.train.store_dp import StoreDPTrainer

    device = resolve_device(device)
    own = None
    if not dist.is_initialized():
        own = tempfile.mkdtemp(prefix="ptype-probe-pg-")
        init_distributed(f"file://{own}/rdv", 0, 1, device=device)
    try:
        cfg = tfm.preset(preset)
        mesh = build_mesh({"data": dist.get_world_size()}, device=device)
        trainer = StoreDPTrainer(cfg, TensorStore(mesh, device=device),
                                 device=device)
        gen = torch.Generator().manual_seed(0)

        def batches(b: int, s: int) -> dict:
            toks = torch.randint(0, cfg.vocab_size, (b, s + 1),
                                 generator=gen).to(device)
            return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}

        yield trainer, batches
    finally:
        if own is not None:
            dist.destroy_process_group()
            shutil.rmtree(own, ignore_errors=True)
