"""The port's profiling plane on ``torch.profiler``, on the CPU — the
cases of ``tests/test_profiling.py``: capture sessions (manifest, the
gzipped Chrome trace ``summarize`` reads, a region opened on another
thread in the trace, double start and stop without start as typed
errors), artifact shipping, the fetch traversal guard, the built-in
``ptype.Profile`` endpoint over real sockets, a partial
``cluster_profile`` with a dead node, ``AlertCapture``'s rate limit and
dedup, the memory snapshot and its table, and the counted-cost
accounting against the reference's XLA ``cost_analysis``: one fwd+bwd
at tiny and at optimus-125m (B=8, S=128; at 125M also in the store-DP
layout) within the reference's own 10% bar (``tests/test_profiling.py``'s
125M check), and ``StoreDPTrainer.compiled_cost`` (tiny) against the
reference trainer's, each gap printed. Then the
end-to-end drill: the straggler alert on port ``ActorServer``s
auto-captures a profile of the named node over its own endpoint."""

import os
import time

import pytest
import torch

from ptype_tpu import metrics as jmetrics
from ptype_tpu.health import profiling as jprofiling
from ptype_tpu.models import transformer as jtfm
from ptype_tpu_torch import metrics
from ptype_tpu_torch.device import DeviceGate, device_work
from ptype_tpu_torch.health import (AlertCapture, AlertEngine, ClusterView,
                                    GoodputLedger, MfuGapRule,
                                    default_rules, profiling)
from ptype_tpu_torch.models import transformer as ttfm

#: The reference's bar on counted vs reference FLOPs.
FLOPS_GAP_PCT = 10.0


@pytest.fixture(autouse=True)
def _no_session_left():
    yield
    if profiling.active():
        profiling.stop()


def _work():
    """A region and a matmul on a thread other than the session's."""
    import threading

    def run():
        with metrics.annotate("train.step"):
            torch.ones(64, 64) @ torch.ones(64, 64)

    t = threading.Thread(target=run)
    t.start()
    t.join()


# ------------------------------------------------------ capture session


def test_start_stop_capture_manifest_and_summary(tmp_path):
    profiling.start(label="unit", base=str(tmp_path))
    assert profiling.active()
    _work()
    out = profiling.stop()
    assert not profiling.active()
    names = [f["path"] for f in out["files"]]
    assert len(names) == 1 and names[0].endswith(".pt.trace.json.gz")
    assert out["activities"] == ["cpu"] and out["device_events"] == 0
    assert out["cpu_threads"] in ("all", "session")
    s = profiling.summarize(out["dir"])
    assert s["events"] > 0 and s["files"] == out["files"]
    if out["cpu_threads"] == "all":
        assert any(op["name"] == "train.step" for op in s["top_ops"])
    assert out["memory"]["host"]["rss_bytes"] > 0
    assert out["memory"]["devices"] == [
        {"id": 0, "platform": "cpu", "kind": "cpu", "stats": {}}]


def test_double_start_is_typed_error_and_stop_without_start(tmp_path):
    profiling.start(base=str(tmp_path))
    try:
        with pytest.raises(profiling.ProfileError):
            profiling.start(base=str(tmp_path))
    finally:
        profiling.stop()
    with pytest.raises(profiling.ProfileError):
        profiling.stop()


def test_start_and_stop_on_different_threads(tmp_path):
    """The RPC verbs arrive on different handler threads: a session
    started on one thread stops on another (the session's own thread
    holds the profiler)."""
    import threading

    box = {}
    t = threading.Thread(target=lambda: box.setdefault(
        "s", profiling.start(label="x", base=str(tmp_path))))
    t.start()
    t.join()
    _work()
    t = threading.Thread(target=lambda: box.setdefault(
        "o", profiling.stop()))
    t.start()
    t.join()
    assert box["o"]["dir"] == box["s"]["dir"] and box["o"]["files"]


#: Device records as Kineto's Chrome trace writes them: one key a line
#: (this host's torch) and ``"ph"`` beside ``"cat"`` (older Kinetos).
_KINETO_EVENTS = (
    '  {{\n    "ph": "X",\n    "cat": "{cat}",\n    "name": "k{i}",\n'
    '    "pid": 0,\n    "tid": 7,\n    "ts": {i}.5, "dur": 1.0\n  }}',
    '  {{\n    "ph": "X", "cat": "{cat}", "name": "k{i}", "pid": 0, '
    '"tid": 7,\n    "ts": {i}.5, "dur": 1.0\n  }}')


def test_stop_counts_device_records_while_it_gzips(tmp_path, monkeypatch):
    """The stop counts a trace's device records on the bytes it gzips,
    with no parse of the whole trace: the count equals a JSON parse's
    on a trace of both Kineto layouts whose records straddle the chunk
    boundaries at many offsets, and the gzip holds the same bytes. A
    session's manifest carries the seconds of each part of its start
    and stop."""
    import gzip
    import json

    cats = ("kernel", "cpu_op", "gpu_memcpy", "gpu_user_annotation",
            "gpu_memset", "kernel")
    events = [_KINETO_EVENTS[i % 2].format(cat=cats[i % len(cats)], i=i)
              for i in range(400)]
    events.append('  {"ph": "f", "cat": "kernel", "name": "flow"}')
    raw = tmp_path / "t.pt.trace.json"
    raw.write_text('{\n  "traceEvents": [\n' + ",\n".join(events)
                   + '\n  ]\n}\n')
    doc = json.loads(raw.read_text())
    want = sum(1 for ev in doc["traceEvents"] if ev.get("ph") == "X"
               and ev.get("cat") in profiling.DEVICE_CATEGORIES)
    assert 0 < want < len(events) - 1
    for chunk in (97, 256, 4096):
        monkeypatch.setattr(profiling, "_CHUNK", chunk)
        dst = tmp_path / f"t{chunk}.json.gz"
        assert profiling._gzip_counting(str(raw), str(dst)) == want
        assert gzip.decompress(dst.read_bytes()) == raw.read_bytes()
    monkeypatch.undo()
    profiling.start(label="held", base=str(tmp_path))
    _work()
    held = profiling.stop()["held_s"]
    assert set(held) == {"start_wait", "start_switch", "stop_wait",
                         "stop_sync", "stop_switch", "stop_disable",
                         "export", "gzip"}
    assert all(v is None or v >= 0 for v in held.values())
    assert held["stop_switch"] >= held["stop_sync"]


def test_device_gate_switch_waits_for_work_and_queues_new_work():
    """A switch waits for the device work inside to leave; work that
    arrives while a switch waits or runs queues behind it; work already
    inside may re-enter without deadlocking a waiting switch."""
    import threading
    import time

    gate = DeviceGate()
    events, release = [], threading.Event()

    def worker():
        with gate.work():
            events.append("work in")
            release.wait(10)
            with gate.work():  # re-entry while the switch waits
                events.append("re-entered")
            events.append("work out")

    def switcher():
        with gate.switch():
            events.append("switch")
            time.sleep(0.05)
        events.append("switch out")

    def late():
        with gate.work():
            events.append("late work")

    w = threading.Thread(target=worker)
    w.start()
    while "work in" not in events:
        time.sleep(0.001)
    s = threading.Thread(target=switcher)
    s.start()
    time.sleep(0.05)
    l = threading.Thread(target=late)
    l.start()
    time.sleep(0.05)
    assert events == ["work in"]        # the switch and late work wait
    release.set()
    for t in (w, s, l):
        t.join(timeout=10)
        assert not t.is_alive()
    assert events.index("work out") < events.index("switch")
    assert events.index("switch out") < events.index("late work")
    assert "re-entered" in events


def test_a_session_starts_and_stops_outside_device_work(tmp_path):
    """``start`` and ``stop`` wait for a thread inside ``device_work``
    to leave before they switch the profiler."""
    import threading
    import time

    done = {}

    def busy(key):
        with device_work():
            time.sleep(0.3)
            done[key] = time.monotonic()

    t = threading.Thread(target=busy, args=("before_start",))
    t.start()
    time.sleep(0.05)
    profiling.start(label="gate", base=str(tmp_path))
    started = time.monotonic()
    t.join(timeout=10)
    assert started >= done["before_start"]
    t = threading.Thread(target=busy, args=("before_stop",))
    t.start()
    time.sleep(0.05)
    with device_work():  # a stop from inside would self-wait
        with pytest.raises(profiling.ProfileError, match="device_work"):
            profiling.stop()
    profiling.stop()
    stopped = time.monotonic()
    t.join(timeout=10)
    assert stopped >= done["before_stop"]
    with device_work():
        with pytest.raises(profiling.ProfileError, match="device_work"):
            profiling.start(label="inside", base=str(tmp_path))


def test_capture_ships_data_and_fetch_blocks_traversal(tmp_path):
    out = profiling.capture(duration_s=0.01, base=str(tmp_path),
                            include_data=True)
    assert out["data"] and all(isinstance(b, bytes)
                               for b in out["data"].values())
    rel = out["files"][0]["path"]
    assert profiling.fetch(out["dir"], rel) == out["data"][rel]
    with pytest.raises(profiling.ProfileError):
        profiling.fetch(out["dir"], "../../etc/passwd")
    dest = tmp_path / "shipped"
    written = profiling.write_artifacts(str(dest), out)
    assert len(written) == len(out["data"])
    assert profiling.summarize(str(dest))["events"] > 0
    # Past the byte budget a file is listed, not shipped.
    small = profiling.capture(duration_s=0.01, base=str(tmp_path),
                              include_data=True, max_bytes=1)
    assert small["data"] == {} and small["truncated"] == [
        f["path"] for f in small["files"]]
    # write_artifacts keeps the fetch guard: no path escapes.
    assert profiling.write_artifacts(
        str(tmp_path / "g"), {"data": {"../escape": b"x"}}) == []


def test_capture_duration_is_capped(tmp_path, monkeypatch):
    monkeypatch.setattr(profiling, "MAX_CAPTURE_S", 0.05)
    out = profiling.capture(duration_s=600.0, base=str(tmp_path))
    assert out["duration_s"] < 30.0


def test_memory_snapshot_and_hbm_table_match_the_reference():
    mem = profiling.memory_snapshot(include_profile=True)
    assert mem["devices"][0]["stats"] == {}
    assert "memory_profile_note" in mem and "memory_profile" not in mem
    table = profiling.render_hbm_table(mem)
    assert table == jprofiling.render_hbm_table(mem)
    assert "no allocator stats" in table and "host rss" in table
    card = {"devices": [{"id": 0, "platform": "cuda", "kind": "H100",
                         "stats": {"bytes_in_use": 3 * 2**30,
                                   "peak_bytes_in_use": 4 * 2**30,
                                   "bytes_limit": 80 * 2**30}}],
            "host": {"rss_bytes": 2**30}}
    assert profiling.render_hbm_table(card) == \
        jprofiling.render_hbm_table(card)


# ------------------------------------------ the ptype.Profile endpoint


def _dial(server):
    from ptype_tpu_torch import rpc as rpc_mod
    from ptype_tpu_torch.registry import Node

    return rpc_mod._dial(Node("127.0.0.1", server.port), dial_timeout=5.0)


def _call(conn, *args, timeout=60.0):
    return conn.call_async("ptype.Profile", args).result(timeout=timeout)


def test_profile_endpoint_over_real_sockets(tmp_path, monkeypatch):
    monkeypatch.setenv(profiling.PROFILE_DIR_ENV, str(tmp_path))
    from unittest import mock

    from ptype_tpu_torch import actor as actor_mod
    from ptype_tpu_torch.actor import ActorServer
    from ptype_tpu_torch.errors import RemoteError

    with mock.patch.object(actor_mod, "lookup_local", lambda a, p: None):
        server = ActorServer("127.0.0.1", 0, device="cpu").serve()
        assert "ptype.Profile" in server.methods
        conn = _dial(server)
        try:
            st = _call(conn, "status")
            assert st["active"] is False and st["devices"] >= 1
            assert st["platform"] == "cpu" and st["device_kind"] == "cpu"
            started = _call(conn, "start", {"label": "remote"})
            assert str(tmp_path) in started["dir"]
            assert _call(conn, "status")["active"] is True
            with pytest.raises(RemoteError):
                _call(conn, "start", {"label": "again"})
            out = _call(conn, "stop", {"include_data": True})
            assert out["files"] and out["data"]
            rel = out["files"][0]["path"]
            blob = _call(conn, "fetch", {"dir": out["dir"], "path": rel})
            assert blob == out["data"][rel]
            mem = _call(conn, "memory")
            assert mem["host"]["rss_bytes"] > 0
            with pytest.raises(RemoteError):
                _call(conn, "nope")
        finally:
            conn.close()
            server.close()


def test_reference_client_reads_a_port_profile():
    """Wire compatibility: the reference's ``node_profile`` dials a port
    node's ``ptype.Profile`` and gets a manifest its own
    ``write_artifacts``/``summarize`` read."""
    import tempfile

    from ptype_tpu import telemetry as jtel
    from ptype_tpu.registry import Node as JNode
    from ptype_tpu_torch.actor import ActorServer

    server = ActorServer("127.0.0.1", 0, device="cpu").serve()
    try:
        res = jtel.node_profile(JNode("127.0.0.1", server.port),
                                duration_s=0.02)
    finally:
        server.close()
    d = tempfile.mkdtemp()
    assert jprofiling.write_artifacts(d, res)
    assert jprofiling.summarize(d)["events"] > 0


def test_cluster_profile_partial_on_dead_node(tmp_path, monkeypatch):
    monkeypatch.setenv(profiling.PROFILE_DIR_ENV, str(tmp_path / "node"))
    from ptype_tpu_torch import telemetry
    from ptype_tpu_torch.actor import ActorServer
    from ptype_tpu_torch.coord.core import CoordState
    from ptype_tpu_torch.coord.local import LocalCoord
    from ptype_tpu_torch.registry import CoordRegistry

    state = CoordState(sweep_interval=0.05)
    registry = CoordRegistry(LocalCoord(state), lease_ttl=5.0)
    live = ActorServer("127.0.0.1", 0, device="cpu").serve()
    dead = ActorServer("127.0.0.1", 0, device="cpu").serve()
    dead_port = dead.port
    regs = [registry.register("work", "w0", "127.0.0.1", live.port),
            registry.register("work", "w1", "127.0.0.1", dead_port)]
    dead.close()
    try:
        res = telemetry.cluster_profile(
            registry, duration_s=0.02, out_dir=str(tmp_path / "out"))
        live_key = f"work/127.0.0.1:{live.port}"
        assert live_key in res["nodes"], res
        assert f"work/127.0.0.1:{dead_port}" in res["errors"], res
        node = res["nodes"][live_key]
        assert node["files"] and os.path.isdir(node["dir"])
        assert profiling.summarize(node["dir"])["events"] > 0
        assert node["memory"]["host"]["rss_bytes"] > 0
    finally:
        for r in regs:
            r.close()
        live.close()
        state.close()


# ------------------------------------------------ alert-driven capture


def _alert(rule="straggler", node="local"):
    from ptype_tpu_torch.health.rules import Alert

    return Alert(rule=rule, severity="warn", node=node, message="test",
                 ts=1.0)


def test_alert_capture_rate_limit_dedup(tmp_path, monkeypatch):
    monkeypatch.setenv(profiling.PROFILE_DIR_ENV, str(tmp_path / "base"))
    cap = AlertCapture(out_dir=str(tmp_path / "alerts"), duration_s=0.01,
                       min_interval_s=60.0, background=False)
    cap(_alert())
    cap(_alert())
    assert len(cap.captures) == 1, (cap.captures, cap.errors)
    cap(_alert(rule="train-stall"))
    assert len(cap.captures) == 2
    cap(_alert(rule="loss"))
    assert len(cap.captures) == 2
    assert profiling.PROFILE_ALERT_RULES == jprofiling.PROFILE_ALERT_RULES
    d = cap.captures[0]["dir"]
    assert os.path.isfile(os.path.join(d, "capture.json"))
    assert profiling.summarize(d)["files"]


def test_alert_capture_survives_dead_node(tmp_path):
    cap = AlertCapture(out_dir=str(tmp_path), duration_s=0.01,
                       timeout_s=2.0, background=False)
    cap(_alert(node="work/127.0.0.1:1"))
    assert cap.captures == []
    assert cap.errors and cap.errors[0]["node"] == "work/127.0.0.1:1"


# --------------------------------------------- counted-cost accounting


def _gap_pct(port: float, ref: float) -> float:
    return 100.0 * (port - ref) / ref


@pytest.mark.parametrize("preset,stacked", [("tiny", None),
                                            ("optimus-125m", None),
                                            ("optimus-125m", 1)])
def test_counted_flops_against_the_reference_cost_analysis(preset,
                                                           stacked):
    """One fwd+bwd at B=8, S=128: the port's counted FLOPs within 10%
    of XLA's ``cost_analysis`` of the reference's program, gap printed
    — unstacked, and at optimus-125m also in the store-DP layout
    (``stacked=1``: the grads program of a one-worker
    ``StoreDPTrainer``, which the reference vmaps). The gap is the
    counting convention: XLA prices elementwise ops too, FlopCounterMode
    the matmul-class ones, and the port's loss recomputes the LM head
    in its backward (its fused chunked NLL)."""
    port = profiling.transformer_grads_cost(ttfm.preset(preset), 8, 128,
                                            stacked=stacked)
    ref = jprofiling.transformer_grads_cost(jtfm.preset(preset), 8, 128,
                                            stacked=stacked)
    gap = _gap_pct(port["flops_per_token"], ref["flops_per_token"])
    print(f"{preset} stacked={stacked}: port "
          f"{port['flops_per_token']:.0f} vs reference "
          f"{ref['flops_per_token']:.0f} FLOPs/token ({gap:+.2f}%, "
          f"counted on {port['device']})")
    assert port["device"] == "meta"
    assert port["tokens_per_step"] == ref["tokens_per_step"] == 8 * 128
    assert abs(gap) <= FLOPS_GAP_PCT
    # Against the analytic formula, as measure_compiled_cost reports.
    m = profiling.measure_compiled_cost(preset, 8, 128)
    assert m["compiled_flops_per_token"] == pytest.approx(
        port["flops_per_token"], abs=0.1)
    assert abs(m["mfu_gap_pct"]) <= FLOPS_GAP_PCT


def test_stacked_cost_is_per_shard_times_shards():
    cfg = ttfm.preset("tiny")
    one = profiling.transformer_grads_cost(cfg, 2, 32)
    four = profiling.transformer_grads_cost(cfg, 2, 32, stacked=4)
    assert four["flops"] == 4 * one["flops"]
    assert four["flops_per_token"] == one["flops_per_token"]


def test_compiled_cost_counts_matmuls_and_bytes():
    a = torch.empty(64, 32, device="meta")
    b = torch.empty(32, 16, device="meta")
    c = profiling.compiled_cost(lambda: (a @ b).relu())
    assert c["flops"] == 2 * 64 * 32 * 16
    # mm: a + b + out; relu: out in + out out (4-byte floats).
    assert c["bytes_accessed"] == 4 * (64 * 32 + 32 * 16 + 3 * 64 * 16)
    with pytest.raises(profiling.ProfileError):
        profiling.compiled_cost(lambda: None)


@pytest.fixture(scope="module")
def store_trainers():
    """Port ``StoreDPTrainer``s (world 1, gloo, tiny) of three modes
    after one B=8, S=128 step, and the reference's ``compiled_cost`` of
    the same step on the same layout: one worker of 8 rows (a 1-device
    data mesh — on conftest's 8-device mesh the reference counts a
    program vmapped over 8 one-row shards, another program)."""
    import jax

    from ptype_tpu.models import transformer as jt
    from ptype_tpu.parallel.mesh import build_mesh
    from ptype_tpu.parallel.tensorstore import TensorStore as JStore
    from ptype_tpu.train.data import synthetic_batches
    from ptype_tpu.train.store_dp import StoreDPTrainer as JTrainer
    from ptype_tpu_torch import telemetry

    cfg = jt.preset("tiny")
    jtr = JTrainer(cfg, JStore(build_mesh({"data": 1},
                                          devices=jax.devices()[:1])))
    jtr.step(next(synthetic_batches(cfg.vocab_size, 8, 128)))
    ref = jtr.compiled_cost()
    out = {}
    with telemetry.probe_trainer("tiny", "cpu") as (tr, batches):
        with pytest.raises(ValueError):
            tr.compiled_cost()  # needs one step's shapes
        tr.step(batches(8, 128))
        out["whole"] = tr.compiled_cost()
        from ptype_tpu_torch.parallel.tensorstore import TensorStore
        from ptype_tpu_torch.train.store_dp import StoreDPTrainer

        for name, kw in (("zero", {"zero": True}),
                         ("overlap", {"overlap": True})):
            t = StoreDPTrainer(ttfm.preset("tiny"),
                               TensorStore(tr.mesh, device="cpu"),
                               device="cpu", **kw)
            t.step(batches(8, 128))
            before = [p.clone() for p in t._param_leaves or []]
            out[name] = t.compiled_cost()
            after = t._param_leaves or []
            assert all(torch.equal(a, b) for a, b in zip(before, after))
    return ref, out


def test_store_dp_compiled_cost_against_the_reference(store_trainers):
    """``StoreDPTrainer.compiled_cost`` at tiny: its grads program is
    the counted fwd+bwd of the store-DP layout exactly (held to the
    reference within 10% at optimus-125m above); its total against the
    reference trainer's is printed and held to the reference's own bar
    for tiny (``tests/test_profiling.py``: within 2× of the analytic
    count), since at tiny XLA's elementwise and vmapped-layout terms
    (~13% of the count) exceed the 10% the 125M bar allows."""
    ref, out = store_trainers
    cost = out["whole"]
    gap = _gap_pct(cost["flops_per_token"], ref["flops_per_token"])
    print(f"StoreDPTrainer tiny B=8 S=128: port "
          f"{cost['flops_per_token']:.0f} vs reference "
          f"{ref['flops_per_token']:.0f} FLOPs/token ({gap:+.2f}%)")
    grads = profiling.transformer_grads_cost(ttfm.preset("tiny"), 8, 128,
                                             stacked=1)
    assert cost["programs"]["grads"]["flops"] == grads["flops"]
    assert 0.5 < cost["flops_per_token"] / ref["flops_per_token"] < 2.0
    analytic = ttfm.flops_per_token(ttfm.preset("tiny"), 128)
    assert 0.5 < cost["flops_per_token"] / analytic < 2.0
    assert cost["tokens_per_step"] == ref["tokens_per_step"] == 8 * 128
    assert set(cost["programs"]) == set(ref["programs"]) == {
        "grads", "optimizer"}
    assert cost["bytes_accessed"] > 0
    # FlopCounterMode prices no elementwise op: the apply's FLOPs are 0,
    # its bytes are not.
    opt = cost["programs"]["optimizer"]
    assert opt["flops"] == 0.0 and opt["bytes_accessed"] > 0


@pytest.mark.parametrize("mode", ["zero", "overlap"])
def test_zero_and_overlap_compiled_cost(store_trainers, mode):
    _, out = store_trainers
    cost, whole = out[mode], out["whole"]
    opt = cost["programs"]["optimizer"]
    assert opt["bytes_accessed"] > 0
    if mode == "zero":
        assert opt["n_buckets"] >= 1
    assert cost["programs"]["grads"] == whole["programs"]["grads"]
    assert cost["flops"] == whole["flops"]


def test_compiled_cost_feeds_mfu_compiled_as_the_reference():
    def run(met, led_cls):
        reg = met.MetricsRegistry()
        led = led_cls(registry=reg, tokens_per_step=8 * 32,
                      flops_per_token=7.0e5, peak_tflops=10.0)
        led.set_compiled_flops(1.9e8)
        end = 10.0
        for _ in range(2):
            end += 0.1
            led.observe("train.step", 0.1, end=end)
        return led.records(), reg.snapshot()["gauges"]

    from unittest import mock

    from ptype_tpu.health import GoodputLedger as JLedger

    with mock.patch("time.time", lambda: 5.0):
        assert run(metrics, GoodputLedger) == run(jmetrics, JLedger)


def test_mfu_gap_rule_fires_on_divergence():
    rule = MfuGapRule(gap_frac=0.25)

    def snap(compiled):
        return {"ts": 1000.0, "errors": {}, "nodes": {"w": {"series": {
            "goodput.mfu": [[999.0, 0.40]],
            "goodput.mfu_compiled": [[999.0, compiled]]}}}}

    alerts = rule.evaluate(ClusterView(snap(0.55)))
    assert len(alerts) == 1 and alerts[0].rule == "mfu-divergence"
    assert rule.evaluate(ClusterView(snap(0.42))) == []
    lone = {"ts": 1.0, "errors": {}, "nodes": {"w": {"series": {
        "goodput.mfu": [[0.5, 0.4]]}}}}
    assert rule.evaluate(ClusterView(lone)) == []


def test_overhead_probes_run_on_the_cpu():
    from ptype_tpu_torch.health import bench

    prof = profiling.measure_profile_overhead(steps=2, device="cpu")
    # One trace a recording: two steps on a loaded host can outlast
    # CHUNK_S, and are then recorded in two sessions.
    assert prof["capture_artifact_files"] == prof["capture_recordings"] >= 1
    assert prof["mfu_gap_pct"] is not None
    assert prof["profile_overhead_pct"] >= 0.0
    health = bench.measure_health_overhead(steps=2, device="cpu")
    assert health["steps"] == 2 and health["sampler_tick_us"] > 0
    assert health["mfu"] is None  # no peak for the CPU
    assert set(health["step_breakdown"]) >= {"step_ms", "compute_ms"}
    lock = bench.measure_lockcheck_overhead(ticks=40, repeats=1)
    assert lock["lockcheck_acquires_per_tick"] > 0


# ------------------------------------------- end-to-end drill + capture


def test_straggler_alert_auto_captures_profile_on_named_node(tmp_path):
    """The straggler drill of ``test_torch_health.py`` with an
    ``AlertCapture`` on the engine: the alert names the slow node AND a
    profile of THAT node, taken over the real socket to its
    ``ptype.Profile``, lands next to the dumps; a repeat firing inside
    the capture's rate limit takes none."""
    from test_torch_health import (DRILL_STEPS, N_WORKERS, SLOW_PUSH_S,
                                   _SimWorker)

    import torch.distributed as dist

    from ptype_tpu_torch import chaos, telemetry
    from ptype_tpu_torch.chaos import FaultPlan, FaultSpec
    from ptype_tpu_torch.coord.core import CoordState
    from ptype_tpu_torch.coord.local import LocalCoord
    from ptype_tpu_torch.parallel.mesh import build_mesh, init_distributed
    from ptype_tpu_torch.registry import CoordRegistry

    own = not dist.is_initialized()
    if own:
        init_distributed(f"file://{tmp_path}/rdv", 0, 1, device="cpu")
    mesh = build_mesh({"data": 1}, device="cpu")
    state = CoordState(sweep_interval=0.05)
    registry = CoordRegistry(LocalCoord(state), lease_ttl=5.0)
    workers = [_SimWorker(f"w{i}", mesh, registry)
               for i in range(N_WORKERS)]
    cap = AlertCapture(out_dir=str(tmp_path / "alerts"), duration_s=0.05,
                       min_interval_s=300.0, background=False)
    engine = AlertEngine(default_rules(), cooldown_s=0.0,
                         registry=metrics.MetricsRegistry(), capture=cap)
    try:
        for w in workers:
            w.step(0)
        for w in workers:
            w.sampler.start()
        chaos.arm(FaultPlan([FaultSpec(
            "store.push", "delay", match="w2",
            times=DRILL_STEPS + 1, delay_s=SLOW_PUSH_S)]))
        for i in range(1, DRILL_STEPS + 1):
            for w in workers:
                w.step(i)
        chaos.disarm()
        for w in workers:
            w.sampler.sample_once()
        snap = telemetry.cluster_snapshot(registry, include_local=False)
        alerts = engine.evaluate(snap)
        slow_key = workers[2].key
        assert [a.rule for a in alerts] == ["straggler"], alerts
        assert alerts[0].node == slow_key
        assert len(cap.captures) == 1, (cap.captures, cap.errors)
        rec = cap.captures[0]
        assert rec["node"] == slow_key and rec["files"] >= 1
        files = profiling.summarize(rec["dir"])["files"]
        assert any(f["path"].endswith(".trace.json.gz") for f in files)
        alerts2 = engine.evaluate(snap, now=snap["ts"] + 1.0)
        assert [a.rule for a in alerts2] == ["straggler"]
        assert len(cap.captures) == 1
    finally:
        chaos.disarm()
        for w in workers:
            w.close()
        state.close()
        if own:
            dist.destroy_process_group()


# ------------------- long windows: recordings, leases, a stop that gives up


def test_a_capture_longer_than_a_chunk_writes_a_trace_a_chunk(tmp_path,
                                                              monkeypatch):
    """A capture of about 1.2 s with ``CHUNK_S`` at 0.25 s is recorded in
    consecutive sessions (at least 3; the count depends on the host's
    speed), each its own ``*.pt.trace.json.gz``: the manifest's count,
    its records (CPU ops stand in for device records here: the CPU
    traces none) and ``held_s`` sum and take the maximum over the
    files, exactly; ``summarize`` reads every file."""
    import gzip
    import json
    import re

    monkeypatch.setattr(profiling, "CHUNK_S", 0.25)
    monkeypatch.setattr(profiling, "DEVICE_CATEGORIES", ("cpu_op",))
    profiling.start(label="chunks", base=str(tmp_path))
    t_end = time.monotonic() + 1.2
    while time.monotonic() < t_end:
        _work()
        time.sleep(0.02)
    out = profiling.stop()
    names = [f["path"] for f in out["files"]]
    assert out["chunks"] >= 3 and len(names) == out["chunks"]
    assert all(re.fullmatch(r".+\.\d{3}\.pt\.trace\.json\.gz", n)
               for n in names), names
    per_file, x_events = [], 0
    for n in names:
        with gzip.open(os.path.join(out["dir"], n), "rt") as fp:
            evs = [e for e in json.load(fp)["traceEvents"]
                   if e.get("ph") == "X"]
        per_file.append(sum(e.get("cat") == "cpu_op" for e in evs))
        x_events += len(evs)
    assert all(per_file) and out["device_events"] == sum(per_file)
    assert out["kernels_lost"] == [0] * out["chunks"]  # no launch here
    held = out["held_s"]
    assert len(held["chunks"]) == out["chunks"]
    for key in ("start_wait", "stop_switch", "export", "gzip"):
        assert held[key] == max(c[key] for c in held["chunks"])
    assert 0 < out["recorded_s"] < out["duration_s"]
    assert 0 < out["unrecorded_s"] < out["duration_s"] - out["recorded_s"]
    s = profiling.summarize(out["dir"])
    assert s["files"] == out["files"] and s["events"] == x_events
    if out["cpu_threads"] == "all":
        assert any(op["name"] == "train.step" for op in s["top_ops"])


def test_a_one_chunk_capture_keeps_its_name_and_keys(tmp_path):
    """A capture shorter than ``CHUNK_S`` is one recording, as before
    chunks: one trace named ``<host>_<pid>.pt.trace.json.gz``, nothing
    unrecorded, and ``held_s`` with no ``chunks`` key."""
    import socket

    out = profiling.capture(duration_s=0.05, base=str(tmp_path))
    assert out["chunks"] == 1 and out["unrecorded_s"] == 0
    assert out["recorded_s"] >= 0.05
    assert [f["path"] for f in out["files"]] == [
        f"{socket.gethostname()}_{os.getpid()}.pt.trace.json.gz"]
    assert "chunks" not in out["held_s"]


def _fake_card(monkeypatch, counts):
    """A CUDA session on the CPU: the profiler's CUDA flag set over CPU
    activities, the card's drain and marker kernel stubbed, and each
    recording's trace counted with ``counts`` (kernel launches, kernel
    records, copies) for its records of those kinds."""
    real_kwargs, real_count = profiling._profiler_kwargs, profiling.count_records

    def kwargs(torch_):
        kw, _, threads = real_kwargs(torch_)
        return kw, True, threads

    def count(read):
        n = real_count(read)
        n["launch"], n["kernel"], n["gpu_memcpy"] = counts
        return n

    monkeypatch.setattr(profiling, "_profiler_kwargs", kwargs)
    monkeypatch.setattr(profiling, "count_records", count)
    monkeypatch.setattr(profiling, "_marker", lambda torch_: None)
    monkeypatch.setattr(profiling, "_runtime_call", lambda torch_: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)


@pytest.mark.parametrize("cuda,preset,seen", [(True, None, "1"),
                                              (True, "0", "0"),
                                              (False, None, None)])
def test_a_cuda_capture_tears_cupti_down_after_each_trace(
        tmp_path, monkeypatch, cuda, preset, seen):
    """Kineto reads ``TEARDOWN_CUPTI`` at each trace; without it, a
    process that had run other sessions drifted its device times from
    the host's, and Kineto dropped an idle session's every kernel record
    as outside its window. A CUDA capture's every recording stops with
    the variable at "1" unless the environment set it (then as set); a
    CPU capture leaves it alone."""
    monkeypatch.delenv(profiling.CUPTI_TEARDOWN_ENV, raising=False)
    if preset is not None:
        monkeypatch.setenv(profiling.CUPTI_TEARDOWN_ENV, preset)
    if cuda:
        _fake_card(monkeypatch, (3, 3, 0))
    monkeypatch.setattr(profiling, "CHUNK_S", 0.2)
    stops = []
    real = torch.profiler.profile.stop

    def stop(prof):
        stops.append(os.environ.get(profiling.CUPTI_TEARDOWN_ENV))
        return real(prof)

    monkeypatch.setattr(torch.profiler.profile, "stop", stop)
    out = profiling.capture(duration_s=0.5, base=str(tmp_path))
    assert len(stops) == out["chunks"] >= 2
    assert stops == [seen] * len(stops)


def test_a_cuda_session_starts_once_the_last_teardown_had_its_calls(
        tmp_path, monkeypatch):
    """Kineto finalizes CUPTI at the first runtime call after a trace,
    on a thread of its own that then re-arms CUPTI's callbacks; a
    session started before it was done recorded nothing. With the
    teardown on, every recording of a CUDA capture starts after
    ``TEARDOWN_SETTLE_CALLS`` runtime calls, the last at least
    ``TEARDOWN_SETTLE_S`` before the start."""
    monkeypatch.delenv(profiling.CUPTI_TEARDOWN_ENV, raising=False)
    _fake_card(monkeypatch, (3, 3, 0))
    monkeypatch.setattr(profiling, "CHUNK_S", 0.2)
    calls, starts = [], []
    monkeypatch.setattr(profiling, "_runtime_call",
                        lambda torch_: calls.append(time.perf_counter()))
    real = torch.profiler.profile.start

    def start(prof):
        starts.append((len(calls), time.perf_counter()))
        return real(prof)

    monkeypatch.setattr(torch.profiler.profile, "start", start)
    out = profiling.capture(duration_s=0.5, base=str(tmp_path))
    assert len(starts) == out["chunks"] >= 2
    n = profiling.TEARDOWN_SETTLE_CALLS
    for i, (made, at) in enumerate(starts):
        assert made == n * (i + 1)
        assert at - calls[made - 1] >= profiling.TEARDOWN_SETTLE_S


def test_a_cuda_trace_with_no_kernel_record_fails_the_stop(tmp_path,
                                                           monkeypatch):
    """A CUDA recording whose trace holds its markers' launches and a
    copy but no kernel record fails the stop: every trace of a CUDA
    capture holds a kernel record, never a device record of another
    kind alone."""
    _fake_card(monkeypatch, (3, 0, 1))
    with pytest.raises(profiling.ProfileError,
                       match=r"no CUDA kernel.*\[0\] kernel records of "
                             r"\[3\] launches"):
        profiling.capture(duration_s=0.05, base=str(tmp_path))


def test_a_stop_that_gives_up_refuses_start_until_its_thread_ends(
        tmp_path, monkeypatch):
    """With the session thread's switch-off held back, a stop gives up
    after ``SESSION_TIMEOUT_S`` (0.2 s here) with a typed error, and
    every start raises ``ProfileError`` (the status verb reads
    ``stopping``) until the thread has ended; then a capture runs. The
    thread ends within 10 s of its release."""
    import threading

    release = threading.Event()
    real = profiling._switch_off

    def slow(*args, **kwargs):
        release.wait(30)
        return real(*args, **kwargs)

    monkeypatch.setattr(profiling, "_switch_off", slow)
    monkeypatch.setattr(profiling, "SESSION_TIMEOUT_S", 0.2)
    profiling.start(label="slow", base=str(tmp_path))
    with pytest.raises(profiling.ProfileError, match="did not stop"):
        profiling.stop()
    assert not profiling.active()
    for _ in range(3):
        with pytest.raises(profiling.ProfileError,
                           match="session thread still runs"):
            profiling.start(base=str(tmp_path))
        st = profiling.endpoint("status")
        assert st["stopping"] is True and st["active"] is False
        time.sleep(0.05)
    release.set()
    profiling._thread.join(timeout=10)
    assert not profiling._thread.is_alive()
    assert profiling.endpoint("status")["stopping"] is False
    assert profiling.capture(duration_s=0.01, base=str(tmp_path))["files"]


def test_a_start_that_gives_up_stops_its_session_once_it_records(
        tmp_path, monkeypatch):
    """With the session thread's first switch-on held back, a start
    gives up after ``SESSION_TIMEOUT_S`` (0.2 s here) with a typed
    error and no capture active, and every start raises
    ``ProfileError`` while the thread lives. Released, the thread
    records once and ends (within 10 s) with no one to stop it, though
    its recordings last 0.05 s: one trace in the directory, not one a
    chunk without end. Then a capture runs."""
    import threading

    release = threading.Event()
    real = profiling._switch_on

    def slow(*args, **kwargs):
        release.wait(30)
        return real(*args, **kwargs)

    monkeypatch.setattr(profiling, "_switch_on", slow)
    monkeypatch.setattr(profiling, "SESSION_TIMEOUT_S", 0.2)
    monkeypatch.setattr(profiling, "CHUNK_S", 0.05)
    with pytest.raises(profiling.ProfileError, match="did not start"):
        profiling.start(label="slow", base=str(tmp_path / "slow"))
    assert not profiling.active()
    with pytest.raises(profiling.ProfileError,
                       match="session thread still runs"):
        profiling.start(base=str(tmp_path))
    assert profiling.endpoint("status")["stopping"] is True
    release.set()
    profiling._thread.join(timeout=10)
    assert not profiling._thread.is_alive()
    (d,) = os.listdir(tmp_path / "slow")
    assert len(profiling.artifact_files(str(tmp_path / "slow" / d))) == 1
    assert profiling.endpoint("status")["stopping"] is False
    assert profiling.capture(duration_s=0.01, base=str(tmp_path))["files"]


def test_the_record_count_equals_a_parse_by_category_and_launch(
        tmp_path, monkeypatch):
    """``count_records`` on a trace's bytes, read in chunks of 97, 256
    and 4,096 bytes so that records straddle the boundaries at many
    offsets, equals a JSON parse of both Kineto layouts: records by
    category, and ``launch``, the runtime and driver calls that launch a
    kernel (not a copy, nor a host function, nor a kernel's record of
    such a name)."""
    import io
    import json

    names = {"kernel": ("void at::native::vectorized_elementwise_kernel<4, "
                        "at::native::FillFunctor<float>, std::array<char*, "
                        "1ul> >(int, at::native::FillFunctor<float>)",
                        "flash_fwd_kernel_bf16", "cudaLaunchKernel"),
             "cuda_runtime": ("cudaLaunchKernel", "cudaMemcpyAsync",
                              "cudaLaunchKernelExC_v11060",
                              "cudaLaunchHostFunc"),
             "cuda_driver": ("cuLaunchKernelEx", "cuMemAlloc_v2"),
             "cpu_op": ("aten::fill_",), "gpu_memcpy": ("Memcpy HtoD",)}
    rows = [(c, n) for c, ns in names.items() for n in ns]
    events = [_KINETO_EVENTS[i % 2].replace('"k{i}"', '"{n}"').format(
        cat=rows[i % len(rows)][0], n=rows[i % len(rows)][1], i=i)
        for i in range(500)]
    events.append('  {"ph": "f", "cat": "kernel", "name": "flow"}')
    raw = ('{\n  "traceEvents": [\n' + ",\n".join(events)
           + '\n  ]\n}\n').encode()
    want = {}
    for ev in json.loads(raw)["traceEvents"]:
        if ev["ph"] != "X":
            continue
        want[ev["cat"]] = want.get(ev["cat"], 0) + 1
        if ev["cat"] in ("cuda_runtime", "cuda_driver") and ev[
                "name"].startswith(("cudaLaunchKernel", "cuLaunchKernel")):
            want["launch"] = want.get("launch", 0) + 1
    assert 0 < want["launch"] < want["cuda_runtime"] + want["cuda_driver"]
    for chunk in (97, 256, 4096):
        monkeypatch.setattr(profiling, "_CHUNK", chunk)
        assert dict(profiling.count_records(io.BytesIO(raw).read)) == want


def test_each_recording_holds_the_leases_through_its_stop(tmp_path,
                                                          monkeypatch):
    """On the in-process coordinator, a registration on a 0.5 s lease
    is on a lease of ``STOP_LEASE_S`` while each recording's trace is
    exported (the GIL-holding part of a stop), its 0.5 s lease revoked,
    and back on a 0.5 s lease after the capture."""
    from ptype_tpu_torch.coord.core import CoordState
    from ptype_tpu_torch.coord.local import LocalCoord
    from ptype_tpu_torch.registry import CoordRegistry

    monkeypatch.setattr(profiling, "CHUNK_S", 0.2)
    state = CoordState(sweep_interval=0.05)
    r = CoordRegistry(LocalCoord(state), lease_ttl=0.5).register(
        "svc", "n1", "10.0.0.1", 9000)
    seen = []
    real = torch.profiler.profile.export_chrome_trace

    def export(prof, path):
        seen.append((r.lease_id, state._leases[r.lease_id].ttl))
        return real(prof, path)

    monkeypatch.setattr(torch.profiler.profile, "export_chrome_trace",
                        export)
    try:
        first = r.lease_id
        out = profiling.capture(duration_s=0.5, base=str(tmp_path))
        assert len(seen) == out["chunks"] >= 2
        assert all(ttl == profiling.STOP_LEASE_S for _, ttl in seen)
        assert first not in state._leases
        assert r.lease_id not in {lease for lease, _ in seen}
        assert state._leases[r.lease_id].ttl == 0.5
    finally:
        r.close()
        state.close()


@pytest.mark.parametrize("part", ["start", "count", "memory"])
def test_a_capture_holds_the_leases_from_its_start_to_its_reply(
        tmp_path, monkeypatch, part):
    """Parts of a capture other than a stop can starve a short lease:
    Kineto's start held a loaded replica's GIL 0.96 s on a 1 s lease,
    and a keepalive went unsent for 1.09-1.13 s after a stop, while the
    stop's last trace was counted and its reply built. With the
    keepalive starved (it answers without refreshing, as no beat leaves a
    process whose GIL is held) and each ``torch.profiler`` start, each
    trace's count or the stop's memory snapshot taking 0.6 s, a
    registration on a 0.3 s lease stays listed through every one of
    them in a capture of several recordings, on a lease of
    ``STOP_LEASE_S``, and is back on its 0.3 s lease after."""
    from ptype_tpu_torch.coord.core import CoordState
    from ptype_tpu_torch.coord.local import LocalCoord
    from ptype_tpu_torch.registry import CoordRegistry

    monkeypatch.setattr(profiling, "CHUNK_S", 0.2)
    state = CoordState(sweep_interval=0.05)
    coord = LocalCoord(state)
    reg = CoordRegistry(coord, lease_ttl=0.3)
    r = reg.register("svc", "n1", "10.0.0.1", 9000)
    seen = []

    def slow(real):
        def run(*args, **kwargs):
            time.sleep(0.6)
            seen.append((bool(reg.nodes("svc")),
                         state._leases[r.lease_id].ttl))
            return real(*args, **kwargs)
        return run

    if part == "start":
        monkeypatch.setattr(torch.profiler.profile, "start",
                            slow(torch.profiler.profile.start))
    elif part == "count":
        monkeypatch.setattr(profiling, "count_records",
                            slow(profiling.count_records))
    else:
        monkeypatch.setattr(profiling, "memory_snapshot",
                            slow(profiling.memory_snapshot))
    coord.keepalive = lambda lease_id: 0.3  # starved: none refreshes
    try:
        out = profiling.capture(duration_s=0.5, base=str(tmp_path))
        assert out["chunks"] >= 2
        assert len(seen) == (1 if part == "memory" else out["chunks"])
        assert seen == [(True, profiling.STOP_LEASE_S)] * len(seen)
        assert state._leases[r.lease_id].ttl == 0.3
    finally:
        del coord.keepalive
        r.close()
        state.close()


def test_a_capture_frees_its_recordings_while_it_holds_the_leases(
        tmp_path, monkeypatch):
    """What a loaded recording leaves behind is freed only by the
    garbage collector, and a collection that met it after the capture
    held a replica's GIL past its 1 s lease. With the collector off, a
    slow-to-free object in a reference cycle hung on each recording's
    profiler is freed before the capture lets go of the leases: on a
    lease of ``STOP_LEASE_S``, every one of them."""
    import gc

    from ptype_tpu_torch.coord.core import CoordState
    from ptype_tpu_torch.coord.local import LocalCoord
    from ptype_tpu_torch.registry import CoordRegistry

    monkeypatch.setattr(profiling, "CHUNK_S", 0.2)
    state = CoordState(sweep_interval=0.05)
    r = CoordRegistry(LocalCoord(state), lease_ttl=0.3).register(
        "svc", "n1", "10.0.0.1", 9000)
    freed = []

    class Results:
        def __init__(self):
            self.cycle = self

        def __del__(self):
            freed.append(state._leases[r.lease_id].ttl)

    real = torch.profiler.profile.start

    def start(prof):
        prof._results = Results()
        return real(prof)

    monkeypatch.setattr(torch.profiler.profile, "start", start)
    gc.collect()
    gc.disable()
    try:
        out = profiling.capture(duration_s=0.5, base=str(tmp_path))
        assert len(freed) == out["chunks"] >= 2
        assert freed == [profiling.STOP_LEASE_S] * len(freed)
    finally:
        gc.enable()
        gc.collect()
        r.close()
        state.close()


def test_obs_profile_names_the_files_that_stayed_on_the_node(
        tmp_path, monkeypatch, capsys):
    """``obs profile`` of a node whose capture passes the reply's byte
    budget (10 bytes here) prints which files stayed on the node, and
    in what directory."""
    from unittest import mock

    from ptype_tpu_torch import __main__ as cli
    from ptype_tpu_torch import actor as actor_mod
    from ptype_tpu_torch.actor import ActorServer
    from ptype_tpu_torch.coord.core import CoordState
    from ptype_tpu_torch.coord.local import LocalCoord
    from ptype_tpu_torch.registry import CoordRegistry

    monkeypatch.setenv(profiling.PROFILE_DIR_ENV, str(tmp_path / "node"))
    monkeypatch.setenv("OBS_DIR", str(tmp_path / "obs"))
    monkeypatch.setenv("PROFILE_DURATION", "0.05")
    monkeypatch.setattr(profiling, "MAX_SHIP_BYTES", 10)
    state = CoordState(sweep_interval=0.05)
    registry = CoordRegistry(LocalCoord(state), lease_ttl=5.0)
    with mock.patch.object(actor_mod, "lookup_local", lambda a, p: None):
        server = ActorServer("127.0.0.1", 0, device="cpu").serve()
        reg = registry.register("work", "w0", "127.0.0.1", server.port)
        try:
            cli._obs_profile(registry)
        finally:
            reg.close()
            server.close()
            state.close()
    out = capsys.readouterr().out
    (line,) = [ln for ln in out.splitlines() if "stayed on the node" in ln]
    remote = line.split(" in ", 1)[1].split(": ", 1)[0]
    assert remote.startswith(str(tmp_path / "node"))
    files = line.rsplit(": ", 1)[1].split(", ")
    assert line.startswith(f"  {len(files)} files stayed")
    assert sorted(files) == sorted(os.listdir(remote))


@pytest.mark.parametrize("window", [0.25, 1.0, 3.0, 10.0, 30.0, 600.0])
def test_node_profile_waits_the_window_and_the_measured_start_and_stop(
        window, monkeypatch):
    """``node_profile``'s default reply timeout is the window (capped at
    ``MAX_CAPTURE_S``) plus twice the measured worst first start and
    one recording's stop: at least their sum, whatever the window (a
    longer capture stops only its last recording after its window)."""
    from ptype_tpu_torch import rpc as rpc_mod
    from ptype_tpu_torch import telemetry
    from ptype_tpu_torch.registry import Node

    seen = {}

    class Reply:
        def result(self, timeout):
            seen["timeout"] = timeout
            return {}

    class Conn:
        def call_async(self, method, args):
            seen["call"] = (method, args)
            return Reply()

        def close(self):
            pass

    monkeypatch.setattr(rpc_mod, "_dial", lambda node, dial_timeout: Conn())
    telemetry.node_profile(Node("127.0.0.1", 1), duration_s=window)
    assert seen["call"][1][1]["duration_s"] == window
    capped = min(window, profiling.MAX_CAPTURE_S)
    assert seen["timeout"] == profiling.reply_timeout_s(window)
    assert seen["timeout"] >= capped + 2 * (profiling.FIRST_START_S
                                            + profiling.RECORDING_STOP_S)
    assert seen["timeout"] < capped + 90.0


def test_alert_capture_takes_the_reply_timeout_of_its_window(tmp_path,
                                                             monkeypatch):
    """``AlertCapture``'s 0.25 s capture of a remote node waits
    ``node_profile``'s default reply timeout unless it is given one."""
    from ptype_tpu_torch import telemetry

    calls = []
    monkeypatch.setattr(telemetry, "node_profile",
                        lambda node, **kw: calls.append(kw) or {})
    AlertCapture(out_dir=str(tmp_path), background=False)(
        _alert(node="work/127.0.0.1:1"))
    AlertCapture(out_dir=str(tmp_path), background=False, timeout_s=5.0)(
        _alert(node="work/127.0.0.1:2"))
    assert [(c["duration_s"], c["timeout"]) for c in calls] == [
        (0.25, None), (0.25, 5.0)]
