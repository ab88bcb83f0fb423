"""The port's inference gateway (``ptype_tpu_torch.gateway``) against the
reference's (``ptype_tpu.gateway``) on the CPU.

Units: the same operation sequences through both packages'
``AdmissionQueue`` (sheds by cause, lapsed deadlines, ``retry_after_s``),
``PrefixDirectory`` (holders, collisions, eviction and restart drops,
the LRU bound) and ``SLOTracker`` (percentiles, goodput, the scale
hint; under one patched clock) give the same results, and
``_count_generated`` counts the same tokens.

End to end: two tiny f32 port engines (``device="cpu"``, a prefill- and a
decode-class ``PagedGeneratorActor``) served by port ``ActorServer``s
and registered on the port's TCP coordinator (calls forced over TCP),
and two reference engines with the same weights (carried across by
``models/weights.params_from_numpy``) on the reference's plane. Each
package's gateway serves the same greedy prompts: interleaved, then
disaggregated over the exact wire, then with the ``serve.migrate`` seam
armed to drop (that request falls back to a local prefill on the decode
replica). Tokens must be equal, exactly. Both port paths answer an int32
tensor on the gateway's device. The wire works across packages both
ways (the port's gateway in front of the reference's ``_FakeGen``
replicas; the reference's gateway in front of port engines);
``GatewayActor`` serves a thin client, a ``ShedError`` crossing the wire
typed and unretried; a replica closed mid-run loses no request; with no
card and none named the gateway raises.

Every multi-thread test waits on conditions with deadlines, never on
fixed sleeps, and joins its threads with a time limit.
"""

import threading
import time
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptype_tpu import actor as jactor
from ptype_tpu import chaos as jchaos
from ptype_tpu import gateway as jgw
from ptype_tpu.errors import ShedError as JShedError
from ptype_tpu.gateway import frontdoor as jfront
from ptype_tpu.metrics import MetricsRegistry as JMetrics
from ptype_tpu.models import transformer as jtfm
from ptype_tpu.registry import CoordRegistry as JCoordRegistry
from ptype_tpu.serve_engine import PagedGeneratorActor as JPaged
from ptype_tpu_torch import actor as tactor
from ptype_tpu_torch import chaos as tchaos
from ptype_tpu_torch import gateway as tgw
from ptype_tpu_torch import lockcheck as tlockcheck
from ptype_tpu_torch.cluster import join
from ptype_tpu_torch.config import Config, PlatformConfig
from ptype_tpu_torch.errors import ShedError
from ptype_tpu_torch.gateway import frontdoor as tfront
from ptype_tpu_torch.metrics import MetricsRegistry
from ptype_tpu_torch.models import transformer as ttfm
from ptype_tpu_torch.models.weights import params_from_numpy
from ptype_tpu_torch.rpc import Client, ConnConfig
from ptype_tpu_torch.serve_engine import PagedGeneratorActor
from test_gateway import _FakeGen

JCFG = jtfm.preset("tiny", dtype=jnp.float32)
CFG = ttfm.preset("tiny", dtype=torch.float32)
PAGED = dict(n_slots=4, block_tokens=16, prefill_chunk=32)
RNG = np.random.default_rng(31)
SHARED = RNG.integers(1, CFG.vocab_size, 32)
#: Greedy requests: a shared 32-token prefix (two full blocks), tails
#: of 5..26 tokens; 6 new tokens each.
PROMPTS = [np.concatenate([SHARED, RNG.integers(1, CFG.vocab_size, n)])
           .astype(np.int32)[None] for n in (5, 11, 19, 26)]
MAX_NEW = 6


@pytest.fixture(autouse=True)
def _port_lock_order_watchdog():
    """The port's lock-order watchdog armed for every test (a cycle in
    the acquisition graph fails the test); the port's chaos plan
    disarmed after it."""
    was = tlockcheck.active()
    wd = tlockcheck.enable()
    yield
    cycles = wd.cycles()
    tlockcheck._watchdog = was
    tchaos.disarm()
    assert not cycles, f"lock-order cycles: {cycles}"


def _until(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return cond()


def _gw_cfg(mod, **over):
    cfg = mod.GatewayConfig(probe_interval_s=0.1, probe_timeout_s=2.0,
                            default_deadline_s=60.0,
                            generate_method="Paged.Generate",
                            info_method="Paged.Info",
                            per_replica_inflight=4)
    for k, v in over.items():
        setattr(cfg, k, v)
    return cfg


# ------------------------------------------------------------ units


def _admission_script(mod, ShedErr):
    """One scripted run of an AdmissionQueue: what it admits, what it
    sheds (by cause, with the retry hint), and its counters."""
    cap = [1]
    q = mod.AdmissionQueue(max_depth=2, capacity=lambda: cap[0],
                           est_service_s=lambda: 0.4)
    log = []

    def admit(key, deadline=None):
        try:
            q.admit(key, deadline)
            log.append((key, "admitted"))
        except ShedErr as e:
            log.append((key, "shed", round(e.retry_after_s, 6), str(e)))

    admit("a")                                   # takes the only slot
    # SLO shed: one waiter's estimated wait (0.4 s) beats 0.1 s.
    admit("slo", time.monotonic() + 0.1)
    waiters = [threading.Thread(target=admit, args=(f"w{i}",))
               for i in range(2)]
    for i, t in enumerate(waiters):
        t.start()
        assert _until(lambda: q.depth == i + 1)
    admit("full")                                # queue at max_depth
    q.release()                                  # w0 granted
    assert _until(lambda: q.depth == 1)
    cap[0] = 2
    q.poke()                                     # capacity grew: w1
    for t in waiters:
        t.join(timeout=10)
    # A deadline that lapses while queued (capacity 2, both held).
    q2 = mod.AdmissionQueue(max_depth=4, capacity=lambda: 1,
                            est_service_s=lambda: 0.001)
    q2.admit("b")
    try:
        q2.admit("late", time.monotonic() + 0.05)
        log.append(("late", "admitted"))
    except ShedErr as e:
        log.append(("late", "shed", round(e.retry_after_s, 6), str(e)))
    q2.release()
    q.close()
    try:
        q.admit("closed")
    except ShedErr as e:
        log.append(("closed", "shed", e.retry_after_s, str(e)))
    counters = [(x.shed_full, x.shed_slo, x.shed_deadline, x.admitted,
                 x.shed_total, x.inflight, x.depth) for x in (q, q2)]
    return sorted(log, key=str), counters


def test_admission_queue_equals_the_reference():
    got = _admission_script(tgw.admission, ShedError)
    want = _admission_script(jgw.admission, JShedError)
    assert got == want
    log, counters = got
    assert [c[:3] for c in counters] == [(1, 1, 0), (0, 0, 1)]
    assert ("w0", "admitted") in log and ("w1", "admitted") in log


def _directory_script(mod):
    d = mod.PrefixDirectory(max_blocks=3)
    out = [d.publish("r1", [(11, (1, 2)), (12, (3, 4)), (13, (5, 6))]),
           d.publish("r2", [(11, (1, 2))]),
           d.holders(11, (1, 2)), d.holders(11, (9, 9)),   # collision
           d.overlap("r1", [11, 12, 99], [(1, 2), (3, 4), (0, 0)]),
           d.publish("r1", [(14, (7, 8))]),                # LRU: 11 out
           d.holders(11, [1, 2]), d.n_blocks("r1"), d.n_blocks(),
           d.note_evictions("r1", 0), d.note_evictions("r1", 0),
           d.note_evictions("r1", None),
           d.note_evictions("r1", 2),                      # LRU freed
           d.n_blocks("r1"),
           d.publish("r1", [(12, (3, 4))]),
           d.note_evictions("r1", 0),                      # restarted
           d.stats(), d.overlap("r9", [11], [(1, 2)])]
    d.drop_replica("r2")
    out.append(d.stats())
    out.append(d.holders(11, (1, 2)))
    return out


def test_prefix_directory_equals_the_reference():
    got = _directory_script(tgw.directory)
    assert got == _directory_script(jgw.directory)
    assert got[3] == [] and got[10] is False and got[12] is True


def _slo_script(mod, registry):
    t = [1000.0]
    with mock.patch("time.monotonic", lambda: t[0]), \
            mock.patch("time.time", lambda: t[0] + 5e8):
        s = mod.SLOTracker("svc", registry=registry, window_s=10.0,
                           slo_ttft_p99_ms=200.0, slo_tpot_p99_ms=40.0)
        hints = []
        for i in range(30):
            t[0] += 0.25
            s.arrived()
            if i % 7 == 3:
                s.shed()
            elif i % 11 == 5:
                s.errored()
            else:
                s.answered(50.0 + 13 * (i % 9), tokens=i % 5 + 1,
                           ttft_ms=(None if i % 4 else 30.0 * (i % 6)),
                           tpot_ms=(None if i % 3 else 10.0 + i),
                           stages={"queue-wait": float(i), "rpc": 40.0})
            s.record_ttft(20.0 + 5 * i)
            if i % 10 == 9:
                hints.append(s.scale_hint(queue_depth=i // 10,
                                          max_depth=4, n_replicas=2,
                                          inflight=i % 4, capacity=8))
        t[0] += 20.0      # past the window: rates fall back to zero
        hints.append(s.scale_hint(0, 4, 2, 0, 8))
        out = {"pct": s.percentiles(), "good": s.goodput(),
               "shed_rate": s.shed_rate(), "burn": s.burn_rate(0.05),
               "tps": s.tokens_per_sec(), "est": s.est_service_s(),
               "worst": s.worst(), "last": s.last_request(),
               "hints": [(h.delta, h.reason, h.signals) for h in hints]}
    return out, registry.snapshot()


def test_slo_tracker_equals_the_reference():
    got = _slo_script(tgw.slo, MetricsRegistry())
    want = _slo_script(jgw.slo, JMetrics())
    assert got == want
    assert got[0]["good"]["slo_violations"] > 0
    assert {h[0] for h in got[0]["hints"]} >= {1, -1}


def test_count_generated_equals_the_reference():
    rng = np.random.default_rng(5)
    for stop in (-1, 3, 7):
        for shape in ((3, 6), (1, 8), (5,), (2, 0)):
            arr = rng.integers(0, 9, shape).astype(np.int32)
            want = jfront._count_generated(arr, stop)
            assert tfront._count_generated(arr, stop) == want
            assert tfront._count_generated(torch.as_tensor(arr), stop) == want


# ------------------------------------------------------ end to end


@pytest.fixture(scope="module")
def params_np():
    pj = jtfm.init_params(jax.random.PRNGKey(0), JCFG)
    return jax.tree_util.tree_map(np.asarray, pj)


@pytest.fixture(scope="module")
def port_plane():
    """The port's TCP coordinator (a seed ``join``) and its registry.
    Calls between in-process servers are forced onto TCP sockets."""
    with mock.patch.object(tactor, "lookup_local", lambda a, p: None):
        seed = join(Config(
            service_name="gw-seed", node_name="seed", port=9001,
            platform=PlatformConfig(name="seed",
                                    coordinator_address="127.0.0.1:0",
                                    is_coordinator=True, lease_ttl=1.0)),
            device="cpu")
        try:
            yield seed.registry
        finally:
            seed.close()


def _serve_port(registry, service, actors):
    """Port ``ActorServer``s (one an actor map) registered under
    ``service``; returns (servers, registrations)."""
    servers, regs = [], []
    for i, named in enumerate(actors):
        s = tactor.ActorServer("127.0.0.1", 0, device="cpu")
        for name, a in named.items():
            s.register(a, name)
        s.serve()
        servers.append(s)
        regs.append(registry.register(service, f"r{i}", "127.0.0.1",
                                      s.port))
    return servers, regs


def _close(*groups):
    for g in groups:
        for x in g:
            x.close()


@pytest.fixture(scope="module")
def port_fleet(params_np, port_plane):
    params = params_from_numpy(params_np, CFG)
    engines = [PagedGeneratorActor(CFG, params=params, device="cpu",
                                   serve_class=c,
                                   metrics_registry=MetricsRegistry(),
                                   **PAGED)
               for c in ("prefill", "decode")]
    servers, regs = _serve_port(port_plane, "llm",
                                [{"Paged": e} for e in engines])
    yield engines
    _close(regs, servers, engines)


@pytest.fixture(scope="module")
def ref_plane():
    from ptype_tpu.coord.core import CoordState
    from ptype_tpu.coord.local import LocalCoord

    state = CoordState(sweep_interval=0.05)
    yield JCoordRegistry(LocalCoord(state), lease_ttl=1.0)
    state.close()


@pytest.fixture(scope="module")
def ref_fleet(params_np, ref_plane):
    engines, servers, regs = [], [], []
    for i, c in enumerate(("prefill", "decode")):
        e = JPaged(JCFG, params=params_np, serve_class=c,
                   metrics_registry=JMetrics(), **PAGED)
        s = jactor.ActorServer("127.0.0.1", 0)
        s.register(e, "Paged")
        s.serve()
        engines.append(e)
        servers.append(s)
        regs.append(ref_plane.register("llm", f"j{i}", "127.0.0.1",
                                       s.port))
    yield engines
    _close(regs, servers, engines)


def _serve_all(gw, n=2):
    assert _until(lambda: gw.pool.n_healthy() == n)
    assert _until(lambda: all(r.serve_class() for r in gw.pool.healthy()))
    return [gw.generate(p, MAX_NEW) for p in PROMPTS]


@pytest.fixture(scope="module")
def ref_tokens(ref_plane, ref_fleet):
    """The reference gateway's answers: interleaved, disaggregated over
    the exact wire, and with ``serve.migrate`` dropping the first
    migration."""
    out = {}
    for mode, over in (("interleaved", {}),
                       ("disagg", dict(disagg=True, kv_wire="exact")),
                       ("fallback", dict(disagg=True, kv_wire="exact"))):
        gw = jgw.InferenceGateway(ref_plane, "llm", _gw_cfg(jgw, **over),
                                  metrics_registry=JMetrics())
        plan = None
        if mode == "fallback":
            plan = jchaos.arm(jchaos.FaultPlan([jchaos.FaultSpec(
                "serve.migrate", "drop", times=1)]))
        try:
            mig0 = ref_fleet[1].Info().get("migrations", 0)
            out[mode] = [np.asarray(t).tolist() for t in _serve_all(gw)]
            migrated = ref_fleet[1].Info().get("migrations", 0) - mig0
            assert migrated == {"interleaved": 0, "disagg": len(PROMPTS),
                                "fallback": len(PROMPTS) - 1}[mode]
            if plan is not None:
                assert [e.action for e in plan.fired()] == ["drop"]
        finally:
            jchaos.disarm()
            gw.close()
    return out


def _check_answers(answers, shape=(1, MAX_NEW)):
    for t in answers:
        assert isinstance(t, torch.Tensor)
        assert t.dtype == torch.int32 and t.device.type == "cpu"
        assert tuple(t.shape) == shape


def test_interleaved_tokens_equal_the_reference(port_plane, port_fleet,
                                                ref_tokens):
    gw = tgw.InferenceGateway(port_plane, "llm", _gw_cfg(tgw),
                              metrics_registry=MetricsRegistry(),
                              device="cpu")
    try:
        answers = _serve_all(gw)
        _check_answers(answers)
        assert [t.tolist() for t in answers] == ref_tokens["interleaved"]
        assert ref_tokens["disagg"] == ref_tokens["interleaved"]
        assert gw.pool.device == torch.device("cpu")
        from ptype_tpu_torch import rpc

        assert all(isinstance(r.conn, rpc._Conn)
                   for r in gw.pool.healthy())
        assert gw.slo.c_answered.value == len(PROMPTS)
        # Both replicas reported their class through Info().
        assert sorted(r.serve_class() for r in gw.pool.healthy()) == [
            "decode", "prefill"]
    finally:
        gw.close()


def test_disaggregated_exact_wire_tokens_equal_the_reference(
        port_plane, port_fleet, ref_tokens):
    pre, dec = port_fleet
    mig0 = dec.Info().get("migrations", 0)
    reg = MetricsRegistry()
    gw = tgw.InferenceGateway(port_plane, "llm",
                              _gw_cfg(tgw, disagg=True, kv_wire="exact"),
                              metrics_registry=reg, device="cpu")
    try:
        answers = _serve_all(gw)
        _check_answers(answers)
        assert [t.tolist() for t in answers] == ref_tokens["disagg"]
        # Every request migrated, none fell back.
        assert dec.Info()["migrations"] - mig0 == len(PROMPTS)
        stages = reg.snapshot()["histograms"]
        for stage in ("prefill", "migrate", "decode"):
            assert stages[f"gateway.llm.stage_ms.{stage}"]["count"] == len(
                PROMPTS)
        # The directory learned the decode replica's prompt blocks.
        dec_key = next(r.key for r in gw.pool.healthy()
                       if r.serve_class() == "decode")
        assert gw.directory.n_blocks(dec_key) >= 2
    finally:
        gw.close()


def test_migrate_drop_falls_back_to_the_same_tokens(port_plane, port_fleet,
                                                    ref_tokens):
    reg = MetricsRegistry()
    gw = tgw.InferenceGateway(port_plane, "llm",
                              _gw_cfg(tgw, disagg=True, kv_wire="exact"),
                              metrics_registry=reg, device="cpu")
    plan = tchaos.arm(tchaos.FaultPlan([tchaos.FaultSpec(
        "serve.migrate", "drop", times=1)]))
    try:
        answers = _serve_all(gw)
        _check_answers(answers)
        assert [t.tolist() for t in answers] == ref_tokens["fallback"]
        assert ref_tokens["fallback"] == ref_tokens["interleaved"]
        assert [(e.site, e.action) for e in plan.fired()] == [
            ("serve.migrate", "drop")]
        assert tchaos.unrecovered() == {}
        hist = reg.snapshot()["histograms"]
        assert hist["gateway.llm.stage_ms.migrate"]["count"] == len(
            PROMPTS) - 1
        assert gw.slo.c_answered.value == len(PROMPTS)
    finally:
        tchaos.disarm()
        gw.close()


def test_port_gateway_fronts_the_reference_fake_replicas(port_plane):
    """The reference's ``_FakeGen`` on the reference's ``ActorServer``,
    registered on the port's coordinator: the port's gateway probes and
    routes to it over TCP and answers int32 on its device."""
    fakes = [_FakeGen(name=f"f{i}") for i in range(2)]
    servers, regs = [], []
    for i, f in enumerate(fakes):
        s = jactor.ActorServer("127.0.0.1", 0)
        s.register(f, "Generator")
        s.serve()
        servers.append(s)
        regs.append(port_plane.register("ref-fakes", f"f{i}", "127.0.0.1",
                                        s.port))
    gw = tgw.InferenceGateway(port_plane, "ref-fakes",
                              tgw.GatewayConfig(probe_interval_s=0.1),
                              metrics_registry=MetricsRegistry(),
                              device="cpu")
    try:
        assert _until(lambda: gw.pool.n_healthy() == 2)
        for _ in range(4):
            out = gw.generate(np.zeros((2, 4), np.int32), 5)
            _check_answers([out], (2, 5))
            assert out.tolist() == [[7] * 5] * 2
        assert sum(f.calls for f in fakes) == 4
        assert gw.stats()["pool"]["healthy"] == 2
    finally:
        gw.close()
        _close(regs, servers)


def test_reference_gateway_fronts_port_engines(ref_plane, port_fleet,
                                               ref_tokens):
    """Port engines registered on the reference's coordinator, behind
    the reference's gateway over TCP: interleaved and disaggregated
    (exact f32 wire) tokens equal the reference fleet's."""
    servers, regs = [], []
    for i, e in enumerate(port_fleet):
        s = tactor.ActorServer("127.0.0.1", 0, device="cpu")
        s.register(e, "Paged")
        s.serve()
        servers.append(s)
        regs.append(ref_plane.register("port-llm", f"p{i}", "127.0.0.1",
                                       s.port))
    try:
        with mock.patch.object(jactor, "lookup_local", lambda a, p: None):
            for mode, over in (("interleaved", {}),
                               ("disagg", dict(disagg=True,
                                               kv_wire="exact"))):
                gw = jgw.InferenceGateway(ref_plane, "port-llm",
                                          _gw_cfg(jgw, **over),
                                          metrics_registry=JMetrics())
                try:
                    got = [np.asarray(t).tolist() for t in _serve_all(gw)]
                finally:
                    gw.close()
                assert got == ref_tokens[mode], mode
    finally:
        _close(regs, servers)


class _PortFake:
    """A port-side stand-in replica: ``Generate``/``Info`` with a fixed
    service time, torch replies, a call count."""

    def __init__(self, delay_s=0.0):
        self.delay_s = delay_s
        self.calls = 0
        self._lock = threading.Lock()

    def Generate(self, prompt, max_new_tokens=8, *args):
        with self._lock:
            self.calls += 1
        time.sleep(self.delay_s)
        return torch.full((int(prompt.shape[0]), int(max_new_tokens)), 3,
                          dtype=torch.int64)

    def Info(self):
        return {"in_flight": 0, "queue_depth": 0}


def test_gateway_actor_serves_a_thin_client_and_sheds_typed(port_plane):
    fakes = [_PortFake(), _PortFake()]
    servers, regs = _serve_port(port_plane, "thin-llm",
                                [{"Generator": f} for f in fakes])
    gw = tgw.InferenceGateway(port_plane, "thin-llm",
                              tgw.GatewayConfig(probe_interval_s=0.1),
                              metrics_registry=MetricsRegistry(),
                              device="cpu")
    gw_servers, gw_regs = _serve_port(port_plane, "thin-llm-gw",
                                      [{"Gateway": tgw.GatewayActor(gw)}])
    client = Client("thin", "thin-llm-gw", port_plane,
                    ConnConfig(retries=2, initial_node_timeout=5.0,
                               debounce_time=0.1), device="cpu")
    try:
        assert _until(lambda: gw.pool.n_healthy() == 2)
        out = client.call("Gateway.Generate", np.zeros((1, 4), np.int32), 6)
        assert out.dtype == torch.int32 and out.tolist() == [[3] * 6]
        info = client.call("Gateway.Info")
        assert info["pool"]["healthy"] == 2 and "scale_hint" in info
        plan = tchaos.arm(tchaos.FaultPlan([tchaos.FaultSpec(
            "gateway.admit", "shed", times=1)]))
        calls = sum(f.calls for f in fakes)
        with pytest.raises(ShedError) as ei:
            client.call("Gateway.Generate", np.zeros((1, 4), np.int32), 6)
        assert ei.value.retry_after_s > 0
        # Not retried: the seam fired once and no replica was called.
        assert len(plan.fired()) == 1
        assert sum(f.calls for f in fakes) == calls
        tchaos.disarm()
        assert client.call("Gateway.Generate", np.zeros((1, 4), np.int32),
                           2).tolist() == [[3, 3]]
    finally:
        tchaos.disarm()
        client.close()
        gw.close()
        _close(gw_regs, gw_servers, regs, servers)


def test_a_replica_closed_mid_run_loses_no_request(port_plane):
    """24 concurrent requests over two slow replicas; one replica's
    server closes after the first half starts. Every request is
    answered or shed typed, service continues after the close, and the
    pool stops routing to the dead replica. Time limit: 60 s."""
    fakes = [_PortFake(0.05), _PortFake(0.05)]
    servers, regs = _serve_port(port_plane, "kill-llm",
                                [{"Generator": f} for f in fakes])
    gw = tgw.InferenceGateway(
        port_plane, "kill-llm",
        tgw.GatewayConfig(probe_interval_s=0.1, per_replica_inflight=4,
                          default_deadline_s=20.0),
        metrics_registry=MetricsRegistry(), device="cpu")
    answered, shed, lost = [], [], []
    lock = threading.Lock()

    def fire(i):
        try:
            out = gw.generate(np.zeros((1, 4), np.int32), 4)
            with lock:
                answered.append((i, out))
        except ShedError as e:
            with lock:
                shed.append((i, e))
        except Exception as e:  # noqa: BLE001 — the "lost" bucket
            with lock:
                lost.append((i, e))

    t0 = time.monotonic()
    threads = [threading.Thread(target=fire, args=(i,)) for i in range(24)]
    try:
        assert _until(lambda: gw.pool.n_healthy() == 2)
        for t in threads[:12]:
            t.start()
        assert _until(lambda: fakes[1].calls > 0)
        servers[1].close()       # a crash: the registration lives on
        for t in threads[12:]:
            t.start()
        for t in threads:
            t.join(timeout=max(0.1, 60 - (time.monotonic() - t0)))
        assert not any(t.is_alive() for t in threads)
        assert not lost, f"lost requests: {lost}"
        assert len(answered) + len(shed) == 24
        assert any(i >= 12 for i, _ in answered)
        assert _until(lambda: gw.pool.n_healthy() == 1)
        _check_answers([o for _, o in answered], (1, 4))
    finally:
        gw.close()
        _close(regs, servers)


def test_the_gateway_raises_without_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgw.InferenceGateway(None, "llm")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgw.InferenceGateway(None, "llm", tgw.GatewayConfig(disagg=True))


def test_a_request_past_the_reach_is_a_counted_remote_error(port_plane,
                                                            port_fleet):
    """A prompt longer than the engine's reach raises ``ValueError`` in
    the replica: the gateway surfaces it as a ``RemoteError`` and counts
    it as an error (never a shed, never a retry), interleaved and
    disaggregated alike (the disaggregated path's prefill fails and its
    interleaved fallback raises)."""
    from ptype_tpu_torch.errors import RemoteError

    long_prompt = np.ones((1, CFG.max_seq + 4), np.int32)
    for over in ({}, dict(disagg=True, kv_wire="exact")):
        gw = tgw.InferenceGateway(port_plane, "llm", _gw_cfg(tgw, **over),
                                  metrics_registry=MetricsRegistry(),
                                  device="cpu")
        try:
            assert _until(lambda: gw.pool.n_healthy() == 2)
            with pytest.raises(RemoteError, match="reach"):
                gw.generate(long_prompt, MAX_NEW)
            assert gw.slo.c_errors.value == 1
            assert gw.slo.c_shed.value == 0
            assert gw.pool.n_healthy() == 2
        finally:
            gw.close()


def _lock_names(gw_mod, lg_mod, registry, node):
    """The lockcheck names of the gateway's and the load generator's
    locks, built under an armed watchdog."""
    gw = gw_mod
    objs = [gw.admission.AdmissionQueue(1, lambda: 1)._lock,
            gw.directory.PrefixDirectory()._lock,
            gw.slo.SLOTracker("s", registry=registry)._lock,
            gw.pool.Replica(node).lock,
            lg_mod.TrafficLedger()._lock,
            lg_mod.ClosedLoopDriver(None, None)._lock]
    tr = lg_mod.synth_trace(0, rate_rps=1.0, duration_s=0.1)
    objs.append(lg_mod.OpenLoopDriver(tr, None)._lock)
    return [o._name for o in objs]


def test_lock_names_equal_the_reference():
    """Every lock the gateway and the load generator take is tracked by
    the port's lock-order watchdog under the reference's name."""
    from ptype_tpu import lockcheck as jlockcheck
    from ptype_tpu import loadgen as jlg
    from ptype_tpu.registry import Node as JNode
    from ptype_tpu_torch import loadgen as tlg
    from ptype_tpu_torch.registry import Node

    was = jlockcheck.active()
    jlockcheck.enable()
    try:
        want = _lock_names(jgw, jlg, JMetrics(), JNode("127.0.0.1", 1))
    finally:
        jlockcheck._watchdog = was
    got = _lock_names(tgw, tlg, MetricsRegistry(), Node("127.0.0.1", 1))
    assert got == want
    assert got[:4] == ["gateway.admission", "gateway.directory",
                       "gateway.slo", "gateway.pool.replica"]
