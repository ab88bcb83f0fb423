"""The port's hierarchical wire and locality-aware serving against the
reference's ``tests/test_topology.py``, on this host's CPU.

The wire: the two-leg allreduce and reduce-scatter at every (outer,
inner) factorization of 4 gloo ranks against the flat composite-axis
wire (rtol 1e-5, the reference's tolerance), the shards equal to the
flat scatter's, the max op, per-leg error feedback beating naive int8,
the slow-leg-only int8 wire arming only the outer residual, the leg
byte counters, the ``TensorStore``'s push and scatter through the two
legs, its outer residuals kept across pushes and dropped on a reshard,
and ZeRO-2 and ZeRO-3 curves through the flat and the two-leg store.
The port's 2×2 is also held against the reference's 2×2 on 4 of the
conftest's devices, from the same seeded inputs, at the reference's
tolerances. The ranks run the suite "topology" of
``tests/torch_ranks.py`` (one spawn of 4); the reference runs while
they do.

The descriptor (``factorizations``, the env and JSON forms, the cost
model, ``topology_for``) and the serving side (gateway affinity inside
a domain, the spawn-domain signal, the reconciler's and the launcher's
domain plumbing, KV migration inside a domain and across one only with
no local holder) are the reference's tests with the port's modules."""

import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from ptype_tpu.models import transformer as jtfm
from ptype_tpu.parallel import collectives as jcoll
from ptype_tpu.parallel.tensorstore import TensorStore as JStore
from ptype_tpu.parallel.topology import Topology as JTopology
from ptype_tpu.train import store_dp as jsd
from ptype_tpu.train import trainer as jtr
from ptype_tpu_torch.parallel.topology import (HIER_AXIS, INNER_AXIS,
                                               OUTER_AXIS, LegWire, Topology,
                                               factorizations, is_hier_axis)
from test_torch_train import LOSS_TOL
from torch_ranks import Ranks

N = 4
GEOM = (2, 2)
OPT = dict(lr=1e-3, warmup=1, decay_steps=50)
#: The reference's tolerance between the flat and the two-leg wire.
EXACT = dict(rtol=1e-5, atol=1e-6)


def _inputs():
    rng = np.random.default_rng(18)
    cfg = jtfm.preset("tiny", dtype=jnp.float32, attn_impl="xla")
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k: jtfm.init_params(k, cfg))(jax.random.PRNGKey(7)))
    batches = []
    for _ in range(3):
        toks = rng.integers(0, 256, (8, 33)).astype(np.int32)
        batches.append({"tokens": toks[:, :-1], "targets": toks[:, 1:]})
    return {
        "leaves": [rng.standard_normal((N, 4, 16)).astype(np.float32),
                   rng.standard_normal((N, 200)).astype(np.float32),
                   rng.integers(0, 5, (N, 3)).astype(np.int32)],
        "g": rng.standard_normal((N, 512)).astype(np.float32),
        "tree": {"w": rng.standard_normal((N, 64, 32)).astype(np.float32),
                 "b": rng.standard_normal((N, 128)).astype(np.float32)},
        "geom": GEOM, "opt": OPT, "params": params, "batches": batches}


def _place(mesh, ax, x):
    return jax.device_put(jnp.asarray(x),
                          NamedSharding(mesh, P(ax, *(None,) * (x.ndim - 1))))


def _reference(inp) -> dict:
    """The reference's 2×2 on 4 of the conftest's devices."""
    topo = JTopology.emulated_host(*GEOM)
    mesh, ax = topo.mesh(), topo.flat_axis
    leaves = [_place(mesh, ax, x) for x in inp["leaves"]]
    out = {"ar": [np.asarray(x) for x in jcoll.bucketed_all_reduce(
        leaves, mesh, ax, "mean", topology=topo)],
        "rs": [np.asarray(s) for _, s, _ in
               jcoll.bucketed_reduce_scatter_stream(leaves[:2], mesh, ax,
                                                    "sum", topology=topo)],
        "max": np.asarray(jcoll.bucketed_all_reduce(
            leaves[:1], mesh, ax, "max", topology=topo)[0])}
    store = JStore(mesh, topology=topo)
    out["push_tree"] = {k: np.asarray(v) for k, v in store.push_tree(
        "g", {k: _place(mesh, ax, v) for k, v in inp["tree"].items()}
    ).items()}
    cfg = jtfm.preset("tiny", dtype=jnp.float32, attn_impl="xla")
    out["zero"] = {}
    for stage in (2, 3):
        tr = jsd.StoreDPTrainer(cfg, JStore(topo.mesh(), topology=topo),
                                rng=jax.random.PRNGKey(7), zero=stage,
                                zero_hparams=jtr.OptHParams(**OPT))
        out["zero"][stage] = [float(tr.step(b)["loss"])
                              for b in inp["batches"]]
    return out


@pytest.fixture(scope="module")
def wire(tmp_path_factory):
    inp = _inputs()
    ranks = Ranks("topology", N, tmp_path_factory.mktemp("topology"), inp)
    try:
        ref = _reference(inp)
        outs = ranks.join()
    except BaseException:
        ranks._kill()
        raise
    return inp, outs, ref


# ------------------------------------------------------- the descriptor


def test_factorizations_of_4_and_8():
    assert factorizations(8) == [(1, 8), (2, 4), (4, 2), (8, 1)]
    assert factorizations(N) == [(1, 4), (2, 2), (4, 1)]


def test_from_env_shorthand_json_and_file(tmp_path):
    assert Topology.from_env({"PTYPE_TOPOLOGY": "2x4"}).n_inner == 4
    t = Topology.from_env({"PTYPE_TOPOLOGY":
                           '{"n_outer": 4, "n_inner": 2, "outer_gbps": 12.5}'})
    assert (t.n_outer, t.n_inner, t.outer_gbps) == (4, 2, 12.5)
    p = tmp_path / "topo.json"
    p.write_text(json.dumps(Topology(n_outer=2, n_inner=2).to_json()))
    t = Topology.from_env({"PTYPE_TOPOLOGY": f"@{p}"})
    assert (t.n_outer, t.n_inner) == (2, 2)
    assert Topology.from_env({}) is None


def test_json_roundtrip_carries_leg_wires():
    t = Topology(n_outer=2, n_inner=4, outer_gbps=6.25,
                 outer_wire=LegWire(compress="int8", q_block=32))
    t2 = Topology.from_json(t.to_json())
    assert t2 == t
    assert t2.resolve_leg(OUTER_AXIS, None, 128) == ("int8", 32)
    assert t2.resolve_leg(INNER_AXIS, "int8", 128) == ("int8", 128)
    assert t2.resolve_leg(INNER_AXIS, None, 128) == (None, 128)


def test_cost_model_prefers_hier_on_asymmetric_fabric():
    topo = Topology.emulated_host(2, 4)
    payload = 64 << 20
    assert topo.hier_allreduce_ms(payload) < topo.flat_allreduce_ms(payload)
    legs = topo.leg_bytes(payload)
    assert legs["outer"] <= legs["flat_outer"] / topo.n_inner + 1
    rs = topo.leg_bytes(payload, kind="reduce_scatter")
    assert rs["outer"] == pytest.approx(legs["outer"] / 2)
    assert topo.ratio == pytest.approx(8.0)
    want = JTopology.emulated_host(2, 4)
    assert topo.leg_bytes(payload, "reduce_scatter") == want.leg_bytes(
        payload, "reduce_scatter")
    assert is_hier_axis(HIER_AXIS) and not is_hier_axis("data")


def test_mesh_geometry_contiguous_domains(wire):
    """Rank r sits at (inner r % n_inner, outer r // n_inner): domains
    are contiguous rank blocks; the composite axis spans every rank, its
    index the rank; ``topology_for`` reads the geometry back and a flat
    mesh has none."""
    _, outs, _ = wire
    topo = Topology(*GEOM)
    assert topo.domains() == [[0, 1], [2, 3]]
    for r, out in enumerate(outs):
        g = out["geometry"]
        assert g["shape"] == {OUTER_AXIS: 2, INNER_AXIS: 2}
        assert g["n"] == N and g["lin"] == r
        assert (g["inner"], g["outer"]) == (r % 2, r // 2)
        assert topo.domain_of_device(r) == topo.domain_of_linear(r) == r // 2
        assert g["topology_for"] == (2, 2)
        assert g["flat_topology_for"] is None


# ------------------------------------- hierarchical collectives: parity


@pytest.mark.parametrize("no,ni", factorizations(N))
def test_hier_allreduce_exact_parity_every_factorization(wire, no, ni):
    """Every factorization of 4 ranks, the size-1 legs included, through
    the one entry point: the two-leg mean equals the flat composite one
    at rtol 1e-5 (the int leaf exactly)."""
    _, outs, _ = wire
    for out in outs:
        row = out["fact"][(no, ni)]
        for f, h in zip(row["flat"], row["hier"]):
            np.testing.assert_allclose(h, f, **EXACT)


@pytest.mark.parametrize("no,ni", factorizations(N))
def test_hier_reduce_scatter_shard_parity(wire, no, ni):
    """Each rank's two-leg shard is the flat composite scatter's: the
    rank at (outer o, inner i) holds chunk o·n_inner + i."""
    _, outs, _ = wire
    for out in outs:
        row = out["fact"][(no, ni)]
        assert len(row["rs_flat"]) == len(row["rs_hier"]) >= 1
        for f, h in zip(row["rs_flat"], row["rs_hier"]):
            np.testing.assert_allclose(h, f, **EXACT)


def test_hier_matches_the_reference_2x2(wire):
    """The port's 2×2 against the reference's on the same inputs: the
    allreduce, and the reduce-scatter's flat (the ranks' shards in
    composite order) at rtol 1e-5."""
    _, outs, ref = wire
    row = outs[0]["fact"][GEOM]
    for got, want in zip(row["hier"], ref["ar"]):
        np.testing.assert_allclose(got, want, **EXACT)
    for b, want in enumerate(ref["rs"]):
        got = np.concatenate([out["fact"][GEOM]["rs_hier"][b]
                              for out in outs])
        np.testing.assert_allclose(got, want, **EXACT)


def test_hier_max_op_falls_back_to_flat_composite(wire):
    _, outs, ref = wire
    for out in outs:
        np.testing.assert_array_equal(out["max"]["hier"], out["max"]["flat"])
        np.testing.assert_array_equal(out["max"]["hier"], ref["max"])


# ----------------------------------------------- per-leg int8+EF wires


def test_per_leg_error_feedback_beats_naive_int8(wire):
    """24 int8 pushes of the same gradient: with each leg's error carried
    into the next push the mean's bias collapses; 3× is the
    reference's floor."""
    _, outs, _ = wire
    for out in outs:
        assert out["ef"]["ef"] * 3 < out["ef"]["naive"], out["ef"]


def test_slow_leg_only_int8_engages_only_outer_residual(wire):
    """Inner leg exact, outer leg int8 (a LegWire, no caller-level
    compress): no inner residual, one outer residual keyed by bucket,
    the result close but not exact."""
    _, outs, _ = wire
    for out in outs:
        s = out["slow_leg"]
        assert 0 < s["err"] < 0.05
        assert s["inner_res"] is None
        assert s["outer_keys"] == [0]


def test_leg_byte_counters_pin_slow_leg_wire_win(wire):
    _, outs, _ = wire
    for out in outs:
        c = out["counters"]
        inner = c["collectives.leg_bytes.inner"]
        outer = c["collectives.leg_bytes.outer"]
        flat = c["collectives.leg_bytes.flat_outer"]
        assert inner > 0 and outer > 0 and flat > 0
        assert outer <= flat / GEOM[1] + 1
        assert c["collectives.hier_launches"] >= 1


# ------------------------------------------------- TensorStore riding


def test_store_exact_push_tree_parity_flat_vs_hier(wire):
    """The store's default axis follows the topology; its push equals
    the flat store's and the reference's two-leg store's."""
    _, outs, ref = wire
    for out in outs:
        assert tuple(out["store_axis"]) == HIER_AXIS
        for k, v in out["push_tree"]["flat"].items():
            np.testing.assert_allclose(out["push_tree"]["hier"][k], v,
                                       **EXACT)
            np.testing.assert_allclose(out["push_tree"]["hier"][k],
                                       ref["push_tree"][k], **EXACT)


def test_store_scatter_iter_parity_flat_vs_hier(wire):
    _, outs, _ = wire
    for out in outs:
        assert out["scatter"]
        for hier, flat in out["scatter"].values():
            np.testing.assert_allclose(hier, flat, **EXACT)


def test_store_outer_residuals_persist_and_reshard_clears(wire):
    _, outs, _ = wire
    for out in outs:
        assert out["residuals_kept"]["outer"] == ["q|mean"]
        assert out["residuals_kept"]["inner"] == ["q/b", "q/w"]
        b = out["store_bias"]
        assert b["ef"] * 3 < b["naive"], b
        assert tuple(out["residuals_after_reshard"]) == (0, 0)


# ------------------------------------------------ ZeRO rides unchanged


@pytest.mark.parametrize("stage", [2, 3])
def test_zero_training_curves_identical_flat_vs_hier(wire, stage):
    """ZeRO-2/3 through the two-leg store: the curve of the flat store
    at the reference's rtol 1e-5, every rank the same, and the
    reference's two-leg curve at ``LOSS_TOL``."""
    _, outs, ref = wire
    for out in outs:
        z = out["zero"]
        np.testing.assert_allclose(z[(stage, "hier")], z[(stage, "flat")],
                                   **EXACT)
        np.testing.assert_array_equal(z[(stage, "hier")],
                                      outs[0]["zero"][(stage, "hier")])
    np.testing.assert_allclose(outs[0]["zero"][(stage, "hier")],
                               ref["zero"][stage], **LOSS_TOL)


# ------------------------------------------- serving: domain locality


class _FakeGen:
    def __init__(self, name):
        self.name = name
        self.calls = 0
        self._lock = threading.Lock()

    def Generate(self, prompt, max_new_tokens=8, *args):
        with self._lock:
            self.calls += 1
        rows = np.asarray(prompt).shape[0]
        return np.full((rows, int(max_new_tokens)), 7, np.int32)

    def Info(self):
        return {"in_flight": 0, "queue_depth": 0, "serve_class": "prefill"}


def _registry():
    from ptype_tpu_torch.coord.core import CoordState
    from ptype_tpu_torch.coord.local import LocalCoord
    from ptype_tpu_torch.registry import CoordRegistry

    state = CoordState(sweep_interval=0.1)
    return state, CoordRegistry(LocalCoord(state), lease_ttl=2.0)


def _domain_fleet(domains):
    """Fake replicas, replica i advertising ``domains[i]`` in its
    registry metadata (the launcher's stamp)."""
    from ptype_tpu_torch.actor import ActorServer

    state, registry = _registry()
    actors, servers, regs = [], [], []
    for i, dom in enumerate(domains):
        a = _FakeGen(f"r{i}")
        s = ActorServer("127.0.0.1", 0, device="cpu")
        s.register(a, "Generator")
        s.serve()
        regs.append(registry.register("llm", f"r{i}", "127.0.0.1", s.port,
                                      metadata={"domain": dom}))
        actors.append(a)
        servers.append(s)

    def close():
        for r in regs:
            r.close()
        for s in servers:
            s.close()
        state.close()

    return registry, actors, close


def _wait_healthy(gw, n, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if gw.pool.n_healthy() >= n:
            return True
        time.sleep(0.02)
    return False


def _gateway(registry, service, metrics_registry, **over):
    from ptype_tpu_torch.gateway import GatewayConfig, InferenceGateway

    cfg = GatewayConfig(**{"probe_interval_s": 0.1, "probe_timeout_s": 2.0,
                           "default_deadline_s": 30.0, **over})
    return InferenceGateway(registry, service, cfg,
                            metrics_registry=metrics_registry, device="cpu")


def test_gateway_routes_and_affinity_stay_in_local_domain():
    """Gateway pinned to domain 0 of two: every pick, least-loaded and
    prefix-affinity, lands in the preferred domain; requests reach only
    domain 0; the pool snapshot and the scale hint carry the domains."""
    from ptype_tpu_torch.metrics import MetricsRegistry

    registry, actors, close = _domain_fleet([0, 0, 1, 1])
    gw = _gateway(registry, "llm", MetricsRegistry(), domain=0)
    try:
        assert _wait_healthy(gw, 4)
        for _ in range(12):
            assert gw.pool.pick(None, prefer_domain=0).domain() == 0
        for key in ("alpha", "beta", "gamma"):
            assert gw.pool.pick(key, prefer_domain=1).domain() == 1
        prompt = np.zeros((1, 4), np.int32)
        for _ in range(6):
            out = np.asarray(gw.generate(prompt, max_new_tokens=4))
            assert out.shape == (1, 4)
        assert actors[0].calls + actors[1].calls >= 6
        assert actors[2].calls + actors[3].calls == 0
        snaps = gw.pool.status()["replicas"]
        assert sorted(s["domain"] for s in snaps) == [0, 0, 1, 1]
        hint = gw.class_hint("prefill")
        assert hint.signals["domains"] == {"0": 2, "1": 2}
        assert hint.signals["spawn_domain"] == 0
    finally:
        gw.close()
        close()


def test_spawn_domain_signal_targets_emptiest_domain():
    from ptype_tpu_torch.metrics import MetricsRegistry

    registry, _, close = _domain_fleet([0, 0, 0, 1])
    gw = _gateway(registry, "llm", MetricsRegistry(), domain=0)
    try:
        assert _wait_healthy(gw, 4)
        hint = gw.class_hint("prefill")
        assert hint.signals["domains"] == {"0": 3, "1": 1}
        assert hint.signals["spawn_domain"] == 1
    finally:
        gw.close()
        close()


def test_reconciler_passes_spawn_domain_to_launcher():
    """The reconciler folds the hint's ``spawn_domain`` (sticky across a
    hint without it) and passes it to a launcher whose spawn takes a
    domain; a launcher without one gets none."""
    from ptype_tpu_torch.gateway.slo import ScaleHint
    from ptype_tpu_torch.metrics import MetricsRegistry
    from ptype_tpu_torch.reconciler.core import Reconciler

    class _Hint:
        signals = {"spawn_domain": 1, "domains": {"0": 2, "1": 0}}

    rec = object.__new__(Reconciler)
    rec._spawn_domain = None
    rec._lock = threading.Lock()
    rec._reg = MetricsRegistry()
    rec._note_spawn_domain(_Hint())
    assert rec._spawn_domain == 1
    rec._note_spawn_domain(ScaleHint(0, "steady", {}))
    assert rec._spawn_domain == 1

    class _ModernLauncher:
        def spawn(self, name, warm_hold=False, domain=None):
            pass

    class _LegacyLauncher:
        def spawn(self, name, warm_hold=False):
            pass

    rec.launcher = _ModernLauncher()
    assert rec._spawn_kwargs() == {"warm_hold": True, "domain": 1}
    rec.launcher = _LegacyLauncher()
    assert rec._spawn_kwargs() == {"warm_hold": True}


def test_local_launcher_stamps_domain_metadata():
    from ptype_tpu_torch.metrics import MetricsRegistry
    from ptype_tpu_torch.reconciler.replica import LocalLauncher

    state, registry = _registry()
    lch = LocalLauncher(registry, lambda: _FakeGen("x"),
                        metrics_registry=MetricsRegistry(), domain=1)
    h = lch.spawn("rep0")
    try:
        h.activate()
        deadline = time.monotonic() + 5.0
        node = None
        while time.monotonic() < deadline:
            nodes = registry.services().get("llm", [])
            if nodes:
                node = nodes[0]
                break
            time.sleep(0.05)
        assert node is not None
        assert node.metadata.get("domain") == 1
        h2 = lch.spawn("rep1", domain=0)
        assert h2._host.domain == 0
    finally:
        lch.close()
        state.close()


# ------------------------------ serving: KV migration stays in-domain


@pytest.fixture(scope="module")
def params():
    from ptype_tpu_torch.models import transformer as tfm
    from ptype_tpu_torch.models.weights import params_from_numpy

    jcfg = jtfm.preset("tiny", dtype=jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda r: jtfm.init_params(r, jcfg))(jax.random.PRNGKey(0)))
    cfg = tfm.preset("tiny", dtype=torch.float32)
    return cfg, params_from_numpy(tree, cfg)


def _disagg_fleet(params, placement, gw_domain):
    """Port paged engines at ``placement`` = [(name, serve_class,
    domain), ...] behind a domain-pinned disaggregated gateway."""
    from ptype_tpu_torch.actor import ActorServer
    from ptype_tpu_torch.metrics import MetricsRegistry
    from ptype_tpu_torch.serve_engine import PagedGeneratorActor

    cfg, p = params
    state, registry = _registry()
    actors, servers, regs = [], [], []
    for name, cls, dom in placement:
        a = PagedGeneratorActor(cfg, params=p, n_slots=2, block_tokens=16,
                                prefill_chunk=32, serve_class=cls,
                                metrics_registry=MetricsRegistry(),
                                device="cpu")
        s = ActorServer("127.0.0.1", 0, device="cpu")
        s.register(a, "Generator")
        s.serve()
        regs.append(registry.register("llm-topo", name, "127.0.0.1", s.port,
                                      metadata={"domain": dom}))
        actors.append(a)
        servers.append(s)
    mreg = MetricsRegistry()
    gw = _gateway(registry, "llm-topo", mreg, default_deadline_s=60.0,
                  disagg=True, kv_wire="exact", domain=gw_domain)

    def close():
        gw.close()
        for r in regs:
            r.close()
        for s in servers:
            s.close()
        for a in actors:
            a.close()
        state.close()

    return gw, mreg, actors, close


def _wait_classes(gw, timeout=8.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if {"prefill", "decode"} <= {r.serve_class()
                                     for r in gw.pool.healthy()}:
            return True
        time.sleep(0.05)
    return False


def _topo_prompt(n, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(1, 100, n).astype(np.int32))[None]


def test_kv_migration_stays_in_domain_when_local_holder_exists(params):
    """Prefill and one decode replica in domain 0, a second decode
    replica across the slow leg: every migration lands in domain 0,
    tokens equal the prefill engine's own, nothing is shed."""
    gw, mreg, actors, close = _disagg_fleet(
        params, [("pre0", "prefill", 0), ("dec0", "decode", 0),
                 ("dec1", "decode", 1)], gw_domain=0)
    try:
        assert _wait_classes(gw)
        pre, dec_local, dec_far = actors
        for i in range(2):
            prompt = _topo_prompt(40, seed=100 + i)
            want = np.asarray(pre.Generate(prompt, 6))
            got = np.asarray(gw.generate(prompt, max_new_tokens=6))
            np.testing.assert_array_equal(got, want)
        assert dec_local.Info()["migrations"] == 2
        assert dec_far.Info()["migrations"] == 0
        c = mreg.snapshot()["counters"]
        assert c.get("serve.migrate.local_domain", 0) == 2
        assert c.get("serve.migrate.cross_domain", 0) == 0
        assert c.get("gateway.shed", 0) == 0
    finally:
        close()


def test_kv_migration_crosses_domain_only_without_local_holder(params):
    gw, mreg, actors, close = _disagg_fleet(
        params, [("pre0", "prefill", 0), ("dec1", "decode", 1)],
        gw_domain=0)
    try:
        assert _wait_classes(gw)
        pre, dec_far = actors
        prompt = _topo_prompt(40, seed=200)
        want = np.asarray(pre.Generate(prompt, 6))
        got = np.asarray(gw.generate(prompt, max_new_tokens=6))
        np.testing.assert_array_equal(got, want)
        assert dec_far.Info()["migrations"] == 1
        c = mreg.snapshot()["counters"]
        assert c.get("serve.migrate.cross_domain", 0) == 1
        assert c.get("serve.migrate.local_domain", 0) == 0
    finally:
        close()
