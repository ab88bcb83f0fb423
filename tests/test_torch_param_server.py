"""The port's async param server against the reference's, on the CPU:
``tests/test_param_server.py`` each test with a counterpart here, the
concurrent-push consistency of ``tests/test_race.py``, the quantized
push of ``tests/test_quantized_train.py``, and the cross-package wires
— a tree either package quantized decodes in the other, and a worker of
one package trains against the other's server over the actor wire.

Parity runs at f32 (tiny, ``causal=False``: the BERT-shaped encoder)
from the reference's seed-0 weights on its token stream; losses are
held at 1e-5 relative (the repo's default for f32 losses where a
reference test states none), the int8 wire's leaves at the migrate
wire's bounds (``q`` within 1, ``s`` within 1 ulp: the reference's
jitted quantizer multiplies by a reciprocal)."""

import tempfile
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptype_tpu.actor import ActorServer as JActorServer
from ptype_tpu.models import transformer as jtfm
from ptype_tpu.parallel import collectives as JC
from ptype_tpu.parallel.mesh import build_mesh as jbuild_mesh
from ptype_tpu.parallel.tensorstore import TensorStore as JTensorStore
from ptype_tpu.registry import Node as JNode
from ptype_tpu.rpc import _Conn as JConn
from ptype_tpu.train import data as jdata
from ptype_tpu.train import param_server as jps
from ptype_tpu.train import trainer as jtr
from ptype_tpu_torch import actor as tactor
from ptype_tpu_torch import rpc
from ptype_tpu_torch.actor import ActorServer
from ptype_tpu_torch.models import transformer as tfm
from ptype_tpu_torch.models.weights import params_from_numpy
from ptype_tpu_torch.parallel import collectives as C
from ptype_tpu_torch.parallel.collectives import WireConfig
from ptype_tpu_torch.parallel.tensorstore import TensorStore
from ptype_tpu_torch.registry import Node
from ptype_tpu_torch.train import trainer as ttr
from ptype_tpu_torch.train.data import synthetic_batches
from ptype_tpu_torch.train.param_server import (AsyncWorker, ParamServer,
                                                StalePushError)

CFG = tfm.preset("tiny", causal=False)  # encoder mode, BERT-shaped
CFG32 = tfm.preset("tiny", causal=False, dtype=torch.float32)
JCFG32 = jtfm.preset("tiny", causal=False, dtype=jnp.float32)
OPT = dict(lr=1e-2, warmup=1, decay_steps=50)
LOSS = dict(rtol=1e-5)


@pytest.fixture(scope="module")
def mesh():
    """A world-1 gloo group and its mesh for the servers' TensorStores
    (made here, torn down after the module)."""
    import torch.distributed as dist

    from ptype_tpu_torch.parallel.mesh import build_mesh, init_distributed

    own = None
    if not dist.is_initialized():
        own = tempfile.mkdtemp(prefix="ps-pg-")
        init_distributed(f"file://{own}/rdv", 0, 1, device="cpu")
    yield build_mesh({"data": 1}, device="cpu")
    if own is not None:
        dist.destroy_process_group()


@pytest.fixture
def server(mesh):
    return ParamServer(CFG, TensorStore(mesh, device="cpu"))


def _stream(seed=0):
    return synthetic_batches(CFG.vocab_size, 4, 32, seed=seed, device="cpu")


def test_single_worker_trains(server):
    worker = AsyncWorker(CFG, server, device="cpu")
    results = worker.run(_stream(), 3)
    assert all(r["applied"] for r in results)
    assert server.Stats()["version"] == 3
    assert np.isfinite(results[-1]["loss"])


def test_stale_push_rejected(server):
    snap = server.Pull()
    worker = AsyncWorker(CFG, server, device="cpu")
    worker.run(_stream(), server.max_staleness + 2)
    zeros = ttr.tree_map(torch.zeros_like, snap["params"])
    with pytest.raises(StalePushError):
        server.Push(zeros, snap["version"])
    assert server.Stats()["rejected"] == 1


def test_concurrent_workers_no_barrier(server):
    """Workers push concurrently; every non-stale push lands and the
    version counts them all — no ordering barrier between workers."""
    n_workers, steps = 3, 4
    errs = []

    def run(i):
        try:
            AsyncWorker(CFG, server, worker_id=i, device="cpu").run(
                _stream(seed=i), steps)
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(n_workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs
    stats = server.Stats()
    assert stats["applied"] + stats["rejected"] == n_workers * steps
    assert stats["version"] == stats["applied"]


def test_sync_publishes_to_store(server):
    AsyncWorker(CFG, server, device="cpu").run(_stream(), 2)
    server.Sync()
    flat = server.store.get_tree("params")
    assert flat
    live = server.Pull()["params"]["embed"]
    assert torch.equal(flat["params/embed"], live)


def test_over_actor_rpc(server):
    """The ParamServer drops into an ActorServer: Pull/Push through its
    dispatch (the actor wire's handler table)."""
    srv = ActorServer("127.0.0.1", device="cpu").serve()
    try:
        srv.register(server, "ParamServer")

        class Proxy:
            def Pull(self):
                return srv.dispatch("ParamServer.Pull", ())

            def Push(self, grads, version):
                return srv.dispatch("ParamServer.Push", (grads, version))

        results = AsyncWorker(CFG, Proxy(), device="cpu").run(_stream(), 2)
        assert all(r["applied"] for r in results)
    finally:
        srv.close()


def test_bert_encoder_is_bidirectional():
    """causal=False lets position i attend to j>i: perturbing a late
    token changes an early position's logits."""
    from ptype_tpu_torch.models.weights import init_params

    params = init_params(torch.Generator().manual_seed(0), CFG)
    toks = torch.zeros((1, 16), dtype=torch.int64)
    toks2 = toks.clone()
    toks2[0, 12] = 5
    a = tfm.forward(params, toks, CFG)
    b = tfm.forward(params, toks2, CFG)
    assert not torch.allclose(a[0, 0], b[0, 0])
    c = tfm.forward(params, toks, tfm.preset("tiny"))
    d = tfm.forward(params, toks2, tfm.preset("tiny"))
    assert torch.equal(c[0, 0], d[0, 0])


def test_param_server_versions_consistent(mesh):
    """Version == applied count under concurrent pushes (no lost or
    double-counted optimizer steps) — tests/test_race.py's check."""
    ps = ParamServer(tfm.preset("tiny"), TensorStore(mesh, device="cpu"),
                     max_staleness=10_000)
    zeros = ttr.tree_map(torch.zeros_like, ps.Pull()["params"])

    def work():
        for _ in range(10):
            ps.Push(zeros, ps.Pull()["version"])

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    stats = ps.Stats()
    assert stats["version"] == stats["applied"] == 40


def test_param_server_quantized_push(mesh):
    """The int8 RPC wire (tests/test_quantized_train.py): quantized
    pushes are dequantized, counted and train; a stale quantized push
    is rejected before its dequantize and not counted; a failed push
    restores the worker's error-feedback residual."""
    wire = WireConfig(compress="int8", q_block=256)
    ps = ParamServer(CFG, TensorStore(mesh, device="cpu"), wire=wire)
    raw = AsyncWorker(CFG, ps, worker_id=0, device="cpu")
    q = AsyncWorker(CFG, ps, worker_id=1, wire=wire, device="cpu")
    it = _stream(seed=3)
    assert raw.step(next(it))["applied"] and q.step(next(it))["applied"]
    stats = ps.Stats()
    assert stats["quantized"] == 1 and stats["applied"] == 2
    assert stats["wire"] == "int8"
    assert q._residuals is not None
    assert all(np.isfinite([q.step(next(it))["loss"] for _ in range(4)]))

    before = ps.Stats()
    stale, _ = C.quantize_tree(ttr.tree_map(torch.zeros_like, ps._params))
    called = []
    real = C.dequantize_tree
    C.dequantize_tree = lambda *a: called.append(1) or real(*a)
    try:
        with pytest.raises(StalePushError):
            ps.Push(stale, -100)
    finally:
        C.dequantize_tree = real
    after = ps.Stats()
    assert not called  # rejected before the dequantize
    assert after["quantized"] == before["quantized"]
    assert after["rejected"] == before["rejected"] + 1

    class Rejecting:
        def Pull(self):
            return ps.Pull()

        def Push(self, grads, version):
            raise StalePushError("forced rejection")

    w = AsyncWorker(CFG, Rejecting(), worker_id=2, wire=wire, device="cpu")
    w._residuals = [torch.ones_like(p) for _, p in
                    C.tree_flatten(ps._params)]
    keep = [r.clone() for r in w._residuals]
    out = w.step(next(it))
    assert not out["applied"] and w.stale_rejections == 1
    for a, b in zip(keep, w._residuals):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="bf16"):
        AsyncWorker(CFG, ps, wire=WireConfig(compress="bf16"), device="cpu")


def test_quantized_tree_crosses_between_packages():
    """A tree the reference quantized decodes in the port, and the
    reverse: the leaf order and wire keys are one format."""
    rng = np.random.default_rng(0)
    tree = {"b": {"y": rng.standard_normal((3, 700)).astype(np.float32),
                  "x": rng.standard_normal(300).astype(np.float32)},
            "a": rng.standard_normal((5, 5)).astype(np.float32)}
    like = {"a": 0, "b": {"x": 0, "y": 0}}
    jwire, _ = JC.quantize_tree(tree, 256)
    jwire = {"__ptype_q8_tree__": [
        {k: np.array(v) if k in ("q", "s") else v for k, v in w.items()}
        for w in jwire["__ptype_q8_tree__"]]}
    assert C.is_quantized_tree(jwire)
    got = C.dequantize_tree(jwire, like)
    treedef = jax.tree_util.tree_structure(tree)
    want = JC.dequantize_tree(jwire, treedef)
    for path, leaf in C.tree_flatten(got):
        w = want[path[0]] if len(path) == 1 else want[path[0]][path[1]]
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(w))
    twire, _ = C.quantize_tree(ttr.tree_map(torch.from_numpy, tree), 256)
    for tw, jw in zip(twire["__ptype_q8_tree__"],
                      jwire["__ptype_q8_tree__"]):
        assert tw["shape"] == jw["shape"] and tw["dtype"] == jw["dtype"]
        np.testing.assert_allclose(tw["q"].numpy(), jw["q"], atol=1)
        np.testing.assert_allclose(tw["s"].numpy(), jw["s"], rtol=2e-7)
    back = JC.dequantize_tree({"__ptype_q8_tree__": [
        {k: (v.numpy() if torch.is_tensor(v) else v) for k, v in w.items()}
        for w in twire["__ptype_q8_tree__"]]}, treedef)
    for path, leaf in C.tree_flatten(C.dequantize_tree(twire, like)):
        w = back[path[0]] if len(path) == 1 else back[path[0]][path[1]]
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(w))


# ------------------------------------------------- the two packages, f32


def _ref_weights():
    return jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k: jtfm.init_params(k, JCFG32))(jax.random.PRNGKey(0)))


def _ref_batches(n):
    it = jdata.synthetic_batches(CFG.vocab_size, 4, 32, seed=0)
    return [{k: np.array(v) for k, v in next(it).items()}
            for _ in range(n)]


def _ref_server():
    return jps.ParamServer(JCFG32, JTensorStore(jbuild_mesh({"data": 1})),
                           optimizer=jtr.default_optimizer(**OPT),
                           rng=jax.random.PRNGKey(0))


def _port_server(mesh, weights):
    return ParamServer(CFG32, TensorStore(mesh, device="cpu"),
                       optimizer=ttr.default_optimizer(**OPT),
                       params=params_from_numpy(weights, CFG32))


def _losses(worker, batches):
    return [worker.step(b)["loss"] for b in batches]


@pytest.fixture(scope="module")
def ref_run():
    """The reference's worker against its own server, in process."""
    batches = _ref_batches(3)
    ref = jps.AsyncWorker(JCFG32, _ref_server())
    return batches, _losses(ref, [{k: jnp.asarray(v) for k, v in b.items()}
                                  for b in batches])


def test_port_worker_trains_as_the_reference(mesh, ref_run):
    """The port's worker and server, from the reference's weights on its
    stream, give the reference's losses."""
    batches, want = ref_run
    got = _losses(AsyncWorker(CFG32, _port_server(mesh, _ref_weights()),
                              device="cpu"), batches)
    np.testing.assert_allclose(got, want, **LOSS)


class _WireProxy:
    """Pull/Push over a raw actor-wire connection."""

    def __init__(self, conn):
        self.conn = conn

    def Pull(self):
        return self.conn.call_async("ParamServer.Pull", ()).result(60)

    def Push(self, grads, version):
        return self.conn.call_async("ParamServer.Push",
                                    (grads, version)).result(60)


def test_port_worker_pushes_to_the_reference_server(ref_run):
    """A port worker trains against a reference server over TCP (the
    port's codec in, the reference's out) with the reference's losses."""
    batches, want = ref_run
    srv = JActorServer("127.0.0.1", 0)
    srv.register(_ref_server(), "ParamServer")
    srv.serve()
    conn = rpc._dial(Node("127.0.0.1", srv.port), 5.0, "cpu")
    try:
        assert isinstance(conn, rpc._Conn)
        got = _losses(AsyncWorker(CFG32, _WireProxy(conn), device="cpu"),
                      batches)
    finally:
        conn.close()
        srv.close()
    np.testing.assert_allclose(got, want, **LOSS)


def test_reference_worker_pushes_to_the_port_server(mesh, ref_run,
                                                    monkeypatch):
    """The reverse: the reference's worker against a port server over
    TCP; and a port int8 worker over TCP, whose quantized tree the port's
    codec carries (the reference's refuses its ``__dunder__`` keys)."""
    batches, want = ref_run
    server = _port_server(mesh, _ref_weights())
    srv = ActorServer("127.0.0.1", device="cpu").serve()
    srv.register(server, "ParamServer")
    conn = JConn(JNode("127.0.0.1", srv.port, 0, ()))
    try:
        ref = jps.AsyncWorker(JCFG32, _WireProxy(conn))
        got = _losses(ref, [{k: jnp.asarray(v) for k, v in b.items()}
                            for b in batches])
        np.testing.assert_allclose(got, want, **LOSS)
        monkeypatch.setattr(tactor, "lookup_local", lambda a, p: None)
        tconn = rpc._dial(Node("127.0.0.1", srv.port), 5.0, "cpu")
        try:
            q = AsyncWorker(CFG32, _WireProxy(tconn), worker_id=1,
                            wire=WireConfig(compress="int8"), device="cpu")
            out = q.step(batches[0])
        finally:
            tconn.close()
        assert out["applied"] and np.isfinite(out["loss"])
        assert server.Stats()["quantized"] == 1
    finally:
        conn.close()
        srv.close()
