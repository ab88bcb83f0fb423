"""The port's telemetry pull plane against the JAX reference's, on the
CPU — the telemetry cases of ``tests/test_trace.py`` and
``tests/test_forensics.py``: the same flight-recorder spans through
both packages' ``all_spans`` / ``stitch_traces`` / ``chrome_trace`` /
the file exporters / ``render_summary``, the same registry through both
``openmetrics``, and both ``waterfall_from_snapshot`` (of a raw
snapshot) and ``load_dump_traces`` on the same dump — exact equality
throughout. Over real sockets: ``node_telemetry`` and
``cluster_snapshot`` of port ``ActorServer``s (a dead node lands in
``errors``, the caller's own row is ``local``, shared-process spans
appear once), a single request stitched across the port's
``GatewayActor`` over TCP, and wire compatibility both ways: each
package's ``cluster_snapshot`` walks a fleet holding a node of each,
with the same schema on every row."""

import json
import time
from unittest import mock

import numpy as np
import pytest

from ptype_tpu import actor as jactor
from ptype_tpu import metrics as jmetrics
from ptype_tpu import telemetry as jtel
from ptype_tpu.health import forensics as jforensics
from ptype_tpu_torch import actor as tactor
from ptype_tpu_torch import metrics, telemetry, trace
from ptype_tpu_torch.health import forensics, rules


def _spans():
    """A few traces from the port's flight recorder: nesting, events,
    an error, two processes' worth of node keys."""
    rec = trace.enable("tel-test")
    try:
        with trace.span("a", k=1):
            with trace.span("b"):
                trace.add_event("ev", n=2)
        with trace.span("c"):
            pass
        try:
            with trace.span("boom"):
                raise ValueError("x")
        except ValueError:
            pass
        return rec.to_dicts()
    finally:
        trace.disable()


def _snapshot(spans):
    half = len(spans) // 2
    return {"ts": 5.0, "errors": {"svc/h:9": "dead"}, "nodes": {
        "svc/h:1": {"pid": 11, "service": "a", "tracing": True,
                    "spans": spans[:half] + spans[:1],
                    "spans_finished": half,
                    "metrics": {"counters": {"x": 1}}},
        "svc/h:2": {"pid": 12, "service": "b", "tracing": True,
                    "spans": spans[half:], "metrics": {}},
        "alias/h:1": {"pid": 11, "service": "a", "spans": spans[:1]}}}


def test_stitch_chrome_summary_match_the_reference():
    spans = _spans()
    snap = _snapshot(spans)
    got = [telemetry.all_spans(snap),
           telemetry.stitch_traces(telemetry.all_spans(snap)),
           telemetry.chrome_trace(telemetry.all_spans(snap)),
           telemetry.chrome_trace(spans)]
    want = [jtel.all_spans(snap),
            jtel.stitch_traces(jtel.all_spans(snap)),
            jtel.chrome_trace(jtel.all_spans(snap)),
            jtel.chrome_trace(spans)]
    assert got == want
    assert len(got[0]) == len(spans)  # each span once, aliases deduped
    snap["traces"] = got[1]
    assert telemetry.render_summary(snap) == jtel.render_summary(snap)
    assert f"traces: {len(got[1])}" in telemetry.render_summary(snap)


def test_exporters_write_files(tmp_path):
    spans = _spans()
    for mod, tag in ((telemetry, "port"), (jtel, "ref")):
        mod.write_chrome_trace(str(tmp_path / tag / "trace.json"), spans)
        mod.write_spans_jsonl(str(tmp_path / tag / "spans.jsonl"),
                              _snapshot(spans))
    for name in ("trace.json", "spans.jsonl"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "ref" / name).read_bytes()
    chrome = json.loads((tmp_path / "port" / "trace.json").read_text())
    assert {e["name"] for e in chrome["traceEvents"]
            if e["ph"] == "X"} == {"a", "b", "c", "boom"}
    assert any(e["ph"] == "i" and e["name"] == "ev"
               for e in chrome["traceEvents"])


def _fill(reg, clock):
    reg.counter("loadgen.slo_bad").add(3)
    reg.counter("scale.spawns").add(2)
    reg.gauge("gateway.llm.queue_depth").set(2.0)
    reg.gauge("mem.device_bytes_in_use").set(123456789.0)
    reg.timing("step.ms").observe(0.01)
    reg.timing("step.ms").observe(0.03)
    with clock:
        for i, v in enumerate((5.0, 123.0, 77.0)):
            reg.histogram("gateway.llm.ttft_ms").observe(v, f"cafe{i:02d}")
        reg.histogram("gateway.llm.stage_ms.queue-wait").observe(4.0)


class _Clock:
    def __enter__(self):
        self._p = mock.patch("time.time", lambda: 1.7e9)
        self._p.start()

    def __exit__(self, *exc):
        self._p.stop()


@pytest.mark.parametrize("form", ["registry", "process", "cluster"])
def test_openmetrics_matches_the_reference(form):
    reg, jreg = metrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    _fill(reg, _Clock())
    _fill(jreg, _Clock())
    if form == "registry":
        got, want = telemetry.openmetrics(reg), jtel.openmetrics(jreg)
    elif form == "process":
        got = telemetry.openmetrics(reg.snapshot(), labels={"job": "t"})
        want = jtel.openmetrics(jreg.snapshot(), labels={"job": "t"})
    else:
        snap = {"ts": 0.0, "nodes": {"gw/h:1": {"metrics": reg.snapshot()},
                                     "w/h:2": {"metrics": {}}}}
        got, want = telemetry.openmetrics(snap), jtel.openmetrics(snap)
    assert got == want
    assert got.endswith("# EOF\n")
    # A line for every family of the registry.
    for fam in ("loadgen_slo_bad_total", "scale_spawns_total",
                "gateway_llm_queue_depth", "step_ms_count",
                "gateway_llm_ttft_ms_count",
                "gateway_llm_stage_ms_queue_wait_count"):
        assert fam in got, fam
    assert '{trace_id="cafe01"}' in got


def _dump(tmp_path):
    """A flight-recorder dump of two gateway requests (stage spans)."""
    rec = trace.enable("dump-test", dump_dir=str(tmp_path))
    try:
        for i in range(2):
            with trace.span("gateway.request"):
                with trace.span("gateway.admit"):
                    time.sleep(0.002)
                with trace.span("gateway.route"):
                    pass
                with trace.span("rpc.call", method="Generator.Generate"):
                    time.sleep(0.003)
        trace._dump_last = 0.0  # the rate limiter is module-global
        path = trace.maybe_dump("test")
        return path, rec.to_dicts()
    finally:
        trace.disable()


def test_forensics_reads_raw_snapshots_and_dumps_as_the_reference(tmp_path):
    """The two functions that waited for the telemetry plane: a raw
    cluster snapshot (no ``traces``) is stitched, and a dump loads —
    equal to the reference's on the same dump."""
    path, spans = _dump(tmp_path)
    assert path is not None and forensics.latest_dump(str(tmp_path)) == path
    traces = forensics.load_dump_traces(path)
    assert traces == jforensics.load_dump_traces(path)
    assert len(traces) == 2
    raw = {"ts": 1.0, "errors": {},
           "nodes": {"gw/h:1": {"pid": 1, "spans": spans}}}
    for tid in traces:
        wf = forensics.waterfall_from_snapshot(raw, tid)
        assert wf == jforensics.waterfall_from_snapshot(raw, tid)
        # The dump's spans carry no node key; everything else agrees.
        dumped = forensics.waterfall_from_snapshot({"traces": traces},
                                                   tid[:10])
        assert {k: v for k, v in dumped.items() if k != "spans"} == \
            {k: v for k, v in wf.items() if k != "spans"}
        assert wf["stages"]["queue-wait"] > 0
    with pytest.raises(KeyError):
        forensics.waterfall_from_snapshot(raw, "zz")


# --------------------------------------------------------- over sockets


class _Echo:
    def Echo(self, x):
        return x


def _registry():
    from ptype_tpu_torch.coord.core import CoordState
    from ptype_tpu_torch.coord.local import LocalCoord
    from ptype_tpu_torch.registry import CoordRegistry

    state = CoordState(sweep_interval=0.05)
    return state, CoordRegistry(LocalCoord(state), lease_ttl=5.0)


def test_telemetry_endpoint_and_cluster_snapshot():
    from ptype_tpu_torch.actor import ActorServer
    from ptype_tpu_torch.registry import Node

    state, registry = _registry()
    rec = trace.enable("snap-test")
    try:
        with mock.patch.object(tactor, "lookup_local", lambda a, p: None):
            server = ActorServer("127.0.0.1", 0, device="cpu")
            server.register(_Echo(), "Echo")
            server.serve()
            reg = registry.register("echo", "e0", "127.0.0.1", server.port)
            dead = registry.register("echo", "dead", "127.0.0.1", 1)
            with trace.span("snap-span"):
                pass
            try:
                t = telemetry.node_telemetry(Node("127.0.0.1",
                                                  server.port))
                assert t["tracing"] and t["service"] == "snap-test"
                assert "counters" in t["metrics"] and "series" in t
                assert any(s["name"] == "snap-span" for s in t["spans"])
                snap = telemetry.cluster_snapshot(registry, timeout=2.0)
            finally:
                reg.close()
                dead.close()
                server.close()
    finally:
        trace.disable()
        state.close()
    assert f"echo/127.0.0.1:{server.port}" in snap["nodes"]
    assert "echo/127.0.0.1:1" in snap["errors"]
    assert "local" in snap["nodes"]
    all_ids = [s["span_id"] for s in telemetry.all_spans(snap)]
    assert len(all_ids) == len(set(all_ids))
    assert any(any(s["name"] == "snap-span" for s in spans)
               for spans in snap["traces"].values())
    assert rec.finished >= 1
    # The health plane reads the snapshot as it stands.
    assert rules.AlertEngine(registry=metrics.MetricsRegistry(),
                             dump=False).evaluate(snap) == []


def test_cluster_snapshot_is_wire_compatible_both_ways():
    """A reference node answers the port's walk and a port node the
    reference's, with the same snapshot schema on every row."""
    from ptype_tpu.actor import ActorServer as JServer
    from ptype_tpu.coord.core import CoordState as JState
    from ptype_tpu.coord.local import LocalCoord as JLocal
    from ptype_tpu.registry import CoordRegistry as JRegistry
    from ptype_tpu_torch.actor import ActorServer

    state, registry = _registry()
    jstate = JState(sweep_interval=0.05)
    jregistry = JRegistry(JLocal(jstate), lease_ttl=5.0)
    port_srv = ActorServer("127.0.0.1", 0, device="cpu").serve()
    ref_srv = JServer("127.0.0.1", 0).serve()
    regs = []
    try:
        with mock.patch.object(tactor, "lookup_local", lambda a, p: None), \
                mock.patch.object(jactor, "lookup_local", lambda a, p: None):
            for r in (registry, jregistry):
                regs.append(r.register("mix", "port", "127.0.0.1",
                                       port_srv.port))
                regs.append(r.register("mix", "ref", "127.0.0.1",
                                       ref_srv.port))
            snaps = {"port": telemetry.cluster_snapshot(registry,
                                                        timeout=5.0),
                     "ref": jtel.cluster_snapshot(jregistry, timeout=5.0)}
    finally:
        for r in regs:
            r.close()
        port_srv.close()
        ref_srv.close()
        state.close()
        jstate.close()
    keys = {f"mix/127.0.0.1:{port_srv.port}",
            f"mix/127.0.0.1:{ref_srv.port}", "local"}
    for who, snap in snaps.items():
        assert set(snap) == {"ts", "nodes", "errors", "traces"}, who
        assert snap["errors"] == {} and set(snap["nodes"]) == keys, who
        schemas = {k: sorted(v) for k, v in snap["nodes"].items()}
        assert len({tuple(v) for v in schemas.values()}) == 1, schemas
        for node in snap["nodes"].values():
            assert set(node["metrics"]) == {"counters", "timings",
                                            "gauges", "histograms"}


class _Gen:
    """Serving replica stand-in (numpy; ``tests/test_trace.py``'s)."""

    def __init__(self):
        self.calls = 0

    def Generate(self, prompt, max_new=8, *a):
        self.calls += 1
        return np.full((np.asarray(prompt).shape[0], int(max_new)), 7,
                       np.int32)

    def Info(self):
        return {"in_flight": 0, "queue_depth": 0, "calls": self.calls}


def test_single_stitched_trace_through_gateway_actor_over_tcp():
    """One request through the port's ``GatewayActor`` over real TCP:
    one stitched trace, client rpc.call → actor/Gateway.Generate →
    gateway.request → admit / route → dispatch rpc.call →
    actor/Generator.Generate, carried by the Chrome export."""
    from ptype_tpu_torch.actor import ActorServer
    from ptype_tpu_torch.gateway import (GatewayActor, GatewayConfig,
                                         InferenceGateway)
    from ptype_tpu_torch.rpc import Client, ConnConfig

    state, registry = _registry()
    rec = trace.enable("t")
    servers, regs = [], []
    gw = client = None
    with mock.patch.object(tactor, "lookup_local", lambda a, p: None):
        try:
            for i in range(2):
                s = ActorServer("127.0.0.1", 0, device="cpu")
                s.register(_Gen(), "Generator")
                s.serve()
                servers.append(s)
                regs.append(registry.register("llm-t", f"r{i}",
                                              "127.0.0.1", s.port))
            gw = InferenceGateway(
                registry, "llm-t",
                GatewayConfig(probe_interval_s=0.2,
                              default_deadline_s=15.0), device="cpu")
            deadline = time.monotonic() + 10
            while (gw.pool.n_healthy() < 2
                   and time.monotonic() < deadline):
                time.sleep(0.05)
            assert gw.pool.n_healthy() == 2
            gws = ActorServer("127.0.0.1", 0, device="cpu")
            gws.register(GatewayActor(gw), "Gateway")
            gws.serve()
            servers.append(gws)
            regs.append(registry.register("llm-gw", "gw0", "127.0.0.1",
                                          gws.port))
            client = Client("test", "llm-gw", registry,
                            ConnConfig(initial_node_timeout=10.0),
                            device="cpu")
            out = client.call("Gateway.Generate",
                              np.zeros((1, 4), np.int32), 8)
            assert tuple(out.shape) == (1, 8)
        finally:
            if client is not None:
                client.close()
            if gw is not None:
                gw.close()
            for r in regs:
                r.close()
            for s in servers:
                s.close()
            trace.disable()
            state.close()
    roots = [s for s in rec.spans()
             if s.name == "rpc.call" and s.parent_id is None]
    assert len(roots) == 1
    tid = roots[0].trace_id
    names = {e["name"] for e in telemetry.chrome_trace(rec.to_dicts())[
        "traceEvents"]
        if e["ph"] == "X" and e["args"].get("trace_id") == tid}
    assert {"rpc.call", "actor/Gateway.Generate", "gateway.request",
            "gateway.admit", "gateway.route",
            "actor/Generator.Generate"} <= names
    stitched = telemetry.stitch_traces(rec.to_dicts())[tid]
    assert stitched == jtel.stitch_traces(rec.to_dicts())[tid]


def test_measure_trace_overhead_on_the_cpu():
    out = telemetry.measure_trace_overhead(steps=2, device="cpu")
    assert out["spans_per_step"] >= 3 and out["steps"] == 2
    assert out["untraced_step_ms"] > 0 and out["span_cost_us"] > 0
    assert set(out) == {
        "untraced_step_ms", "traced_step_ms", "span_cost_us",
        "noop_cost_us", "spans_per_step", "trace_overhead_pct",
        "trace_disabled_overhead_pct", "steps"}  # the reference's keys
    assert trace.recorder() is None  # the caller's state handed back
