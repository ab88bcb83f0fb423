"""The port's data plane against the reference, on this host's CPU: the
plain collectives, the block-scaled int8 wire with error feedback, the
bucket and shard planners, and the TensorStore's semantics.

The reference runs on ``build_mesh({"data": n})`` over the conftest's
CPU devices, holding the stacked ``(n, ...)`` contributions; the port
runs n gloo ranks (``tests/torch_ranks.py``), rank r holding row r. All
inputs come from a numpy seed; world sizes 2 and 4, one spawn each.

Tolerances: exact ops in f32 at ``rtol=1e-6`` (n ranks sum in another
order). The int8 wire's scales and quantized values are the
reference's, but where its jitted body sums dequantized terms (phase
1's reduction) or subtracts them (the error-feedback residual) XLA
contracts the product into a fused multiply-add; the port rounds the
product first. So its results agree within one ulp a summed term: n
ulps of the largest value they come from (:func:`ulp_of`). At world 2
they happen to agree bit for bit, except for the residuals.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptype_tpu.errors import CoordinationError as JCoordinationError
from ptype_tpu.models import transformer as jtfm
from ptype_tpu.parallel import collectives as JC
from ptype_tpu.parallel import zero as JZ
from ptype_tpu.parallel.mesh import build_mesh
from ptype_tpu.parallel.tensorstore import TensorStore as JStore
from ptype_tpu.parallel.topology import Topology as JTopology
from ptype_tpu_torch.parallel import collectives as TC
from ptype_tpu_torch.parallel import topology as TT
from ptype_tpu_torch.parallel import zero as TZ
from torch_ranks import FlakyKV, Ranks

F32 = np.float32
EXACT = dict(rtol=1e-6, atol=1e-6)
PLAIN = ["all_reduce_sum", "all_reduce_mean", "all_reduce_max",
         "all_reduce_min", "all_reduce_int_sum", "all_reduce_int_mean",
         "reduce_scatter_sum", "reduce_scatter_mean", "all_gather",
         "ring_shift_1", "ring_shift_3", "all_to_all", "broadcast"]


def ulp_of(*arrays) -> float:
    """One f32 ulp at the largest magnitude in ``arrays``."""
    m = max(float(np.abs(np.asarray(a, F32)).max()) for a in arrays)
    return float(np.spacing(F32(m)))


def make_inputs(n: int) -> dict:
    rng = np.random.default_rng(100 + n)
    q = rng.normal(size=(n, n * 1000)).astype(F32)
    q[:, ::97] *= 40  # outliers: each poisons one block
    return {
        "x": rng.normal(size=(n, 8, 6)).astype(F32),
        "x2": rng.normal(size=(n, 4 * n, 3)).astype(F32),
        "xi": rng.integers(-50, 50, size=(n, 5)).astype(np.int32),
        "q": q,
        "res": (rng.normal(size=(n, n * 1000)) * 1e-2).astype(F32),
        # 13+15 elements pack into one 200-byte bucket, the 100-element
        # leaf into its own; the int leaf into a third.
        "tree": {"blk": {"w": rng.normal(size=(n, 13)).astype(F32),
                         "b": rng.normal(size=(n, 3, 5)).astype(F32)},
                 "big": (rng.normal(size=(n, 100)) * 3).astype(F32),
                 "step": rng.integers(0, 9, size=(n, 4)).astype(np.int32),
                 "scalar": rng.normal(size=(n,)).astype(F32)},
        "bf16_tree": {"f": np.full((n, 4), 0.5, F32),
                      "i": np.full((n, 4), 1 << 20, np.int32)},
        "ef_tree": {"a": rng.normal(size=(n, 400)).astype(F32),
                    "b": rng.normal(size=(n, 400)).astype(F32)},
    }


def jnp_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def reference(n: int, inp: dict) -> dict:
    """The same calls on the reference's n-device CPU mesh."""
    mesh = build_mesh({"data": n})
    x, x2, xi, q, res = (jnp.asarray(inp[k])
                         for k in ("x", "x2", "xi", "q", "res"))
    ref: dict = {}
    for op in ("sum", "mean", "max", "min"):
        ref[f"all_reduce_{op}"] = JC.all_reduce(x, mesh, op=op)
    for op in ("sum", "mean"):
        ref[f"all_reduce_int_{op}"] = JC.all_reduce(xi, mesh, op=op)
        ref[f"reduce_scatter_{op}"] = JC.reduce_scatter(x2, mesh, op=op)
        ref[f"qar_{op}"] = JC.quantized_all_reduce(q, mesh, op=op)
        ref[f"qrs_{op}"] = JC.quantized_reduce_scatter(q, mesh, op=op)
    ref["qar_sum_chunk_scale"] = JC.quantized_all_reduce(q, mesh,
                                                         q_block=None)
    ref["all_gather"] = JC.all_gather(x, mesh)
    for shift in (1, 3):
        ref[f"ring_shift_{shift}"] = JC.ring_shift(x, mesh, shift=shift)
    ref["all_to_all"] = JC.all_to_all(x2, mesh)
    ref["broadcast"] = x[n - 1]
    wire = dict(compress="int8", int8_min_bytes=0)
    o, rs = JC.bucketed_all_reduce([q], mesh, op="mean", residuals=[res],
                                   **wire)
    ref["ef_out"], ref["ef_res"] = o[0], rs[0]
    (_, shard, rres), = list(JC.bucketed_reduce_scatter_stream(
        [q], mesh, op="mean", residuals=[res], **wire))
    ref["ef_rs_shard"], ref["ef_rs_res"] = shard, rres[0]

    tree = jnp_tree(inp["tree"])
    small = JC.WireConfig(bucket_bytes=200)
    ref["pt_bucketed"] = JStore(mesh, wire=small).push_tree("g", tree,
                                                           op="mean")
    ref["pt_buckets"] = len(JC.plan_buckets(
        jax.tree_util.tree_leaves(tree), n, 200))
    ts8 = JStore(mesh, wire=JC.WireConfig(compress="int8", bucket_bytes=200,
                                          int8_min_bytes=256))
    ref["pt_int8"] = ts8.push_tree("g", tree, op="mean")
    ref["pt_int8_residuals"] = dict(ts8._residuals)
    ref["pt_bf16"] = JStore(mesh, compress="bf16").push_tree(
        "g", jnp_tree(inp["bf16_tree"]), op="sum")
    ts = JStore(mesh, wire=small)
    ref["scatter_flats"] = [h.flat for h in ts.push_tree_scatter_iter(
        "s", tree, op="mean")]

    rec = []
    s0 = ts.put_tree("params", {"w": jnp.ones(4), "v": {"a": jnp.zeros(2)}})
    rec += [ts.tree_seq("params") == s0, ts.tree_seq("absent")]
    for _ in range(2):
        ts.push("k/x", x)
    rec += [ts.epoch("k/x"), ts.epoch("params/w")]
    ts.put("params/w", jnp.zeros(4))
    s1 = ts.tree_seq("params")
    rec += [s1 > s0, ts.epoch("params/w")]
    ts.delete("params/v/a")
    rec += [ts.tree_seq("params") > s1, sorted(ts.get_tree("params"))]
    ref["seq_record"] = rec

    kv = FlakyKV(JCoordinationError)
    ms = JStore(mesh, kv=kv, namespace="ns")
    kv.fail = True
    ms.put("a", jnp.ones(4))
    ref["kv_missed"] = sorted(kv.data)
    kv.fail = False
    ms.put("b", jnp.ones((2, 3)))
    ms.push_scatter("s", x2, op="sum")
    ms.push("p", x)
    ref["kv"], ref["manifest"] = dict(kv.data), ms.manifest()

    ef = JStore(mesh, wire=JC.WireConfig(compress="int8", int8_min_bytes=0,
                                         bucket_bytes=2048))
    ef.push_tree("g", jnp_tree(inp["ef_tree"]), op="mean")
    ef.push("k", q, op="mean")
    ref["store_residuals"] = dict(ef._residuals)
    return ref


@pytest.fixture(scope="module", params=[2, 4], ids=lambda n: f"world{n}")
def world(request, tmp_path_factory):
    """(n, inputs, the port's per-rank outputs, the reference's)."""
    n = request.param
    inp = make_inputs(n)
    ranks = Ranks("collectives", n, tmp_path_factory.mktemp(f"ranks{n}"),
                  inp)
    try:
        ref = reference(n, inp)  # while the ranks run
    finally:
        outs = ranks.join()
    return n, inp, outs, ref


def ref_row(name: str, ref, r: int, n: int):
    """What the reference leaves on device r."""
    full = np.asarray(ref[name])
    if name.startswith(("reduce_scatter", "qrs", "ef_rs_shard")):
        return np.split(full, n)[r]
    if name in ("ring_shift_1", "ring_shift_3", "all_to_all", "ef_res",
                "ef_rs_res"):
        return full[r]
    return full


# ------------------------------------------------------ plain collectives


@pytest.mark.parametrize("name", PLAIN)
def test_plain_collective_matches_reference(world, name):
    n, _, outs, ref = world
    for r, out in enumerate(outs):
        got, want = out[name], ref_row(name, ref, r, n)
        assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
        np.testing.assert_allclose(got, want, err_msg=f"{name} rank {r}",
                                   **EXACT)


# --------------------------------------------------------------- int8 wire


@pytest.mark.parametrize("name", ["qar_sum", "qar_mean",
                                  "qar_sum_chunk_scale", "qrs_sum",
                                  "qrs_mean", "ef_out", "ef_res",
                                  "ef_rs_shard", "ef_rs_res"])
def test_int8_wire_matches_the_reference_row(world, name):
    """The int8 allreduce (block scales and one scale a chunk), the
    reduce-scatter shard, and with a residual the outputs and rank r's
    new residual (the reference's row r): within one ulp a summed term
    (the reference's fused multiply-adds); none is zero."""
    n, inp, outs, ref = world
    xf = inp["q"] + inp["res"]
    for r, out in enumerate(outs):
        want = ref_row(name, ref, r, n)
        bound = n * ulp_of(xf, want)
        np.testing.assert_allclose(out[name], want, rtol=0, atol=bound,
                                   err_msg=f"{name} rank {r}")
        assert np.abs(out[name]).max() > 0


# ---------------------------------------------------------------- planners


def _shapes_125m():
    cfg = jtfm.preset("optimus-125m")
    return jax.eval_shape(lambda k: jtfm.init_params(k, cfg),
                          jax.random.PRNGKey(0))


@pytest.mark.parametrize("bucket_bytes", [JC.DEFAULT_BUCKET_BYTES, 4 << 20,
                                          64 << 10])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_plan_buckets_matches_reference_on_optimus_125m(n, bucket_bytes):
    """The 125m tree's shapes (never allocated) in store-sorted order:
    the same buckets, slots and pads."""
    pairs = sorted(
        ("/".join(str(p.key) for p in path), leaf)
        for path, leaf in jax.tree_util.tree_flatten_with_path(
            _shapes_125m())[0])
    stacked = [jax.ShapeDtypeStruct((n,) + leaf.shape, leaf.dtype)
               for _, leaf in pairs]
    local = [torch.empty(leaf.shape, dtype=torch.float32, device="meta")
             for _, leaf in pairs]
    want = JC.plan_buckets(stacked, n, bucket_bytes)
    got = TC.plan_buckets(local, n, bucket_bytes)
    assert [(b.dtype, b.pad, b.elems) for b in got] == \
        [(b.dtype, b.pad, b.elems) for b in want]
    assert [[(s.index, s.offset, s.size, tuple(s.shape)) for s in b.slots]
            for b in got] == \
        [[(s.index, s.offset, s.size, tuple(s.shape)) for s in b.slots]
         for b in want]
    assert got[0].payload_bytes == want[0].payload_bytes


@pytest.mark.parametrize("n", [2, 4, 8])
def test_shard_plan_matches_reference(n):
    """ShardPlan over the tiny and 125m trees: identical manifests (so
    rank r owns the reference device r's elements), moment bytes, and
    the re-pad for another count."""
    for shapes in (_shapes_125m(),
                   jax.eval_shape(lambda k: jtfm.init_params(
                       k, jtfm.preset("tiny")), jax.random.PRNGKey(0))):
        leaves = [leaf for _, leaf in sorted(
            ("/".join(str(p.key) for p in path), leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                shapes)[0])]
        local = [torch.empty(x.shape, device="meta") for x in leaves]
        for bb in (1 << 20, 32 << 20):
            want = JZ.ShardPlan.for_leaves(leaves, n, bb)
            got = TZ.ShardPlan.for_leaves(local, n, bb)
            assert got.manifest() == json.loads(json.dumps(want.manifest()))
            assert got.moment_bytes_per_replica() == \
                want.moment_bytes_per_replica()
            assert got.with_n(3).manifest() == json.loads(
                json.dumps(want.with_n(3).manifest()))
            TZ.check_plan_compatible(want.with_n(2).manifest(),
                                     got.manifest())


def test_plan_buckets_mixed_dtypes_match_reference():
    """Greedy per dtype (a leaf that would pass the target opens the
    next bucket), pads to n, bf16 and int groups apart."""
    shapes = [((13,), "float32"), ((3, 5), "float32"), ((100,), "float32"),
              ((4,), "int32"), ((), "float32"), ((7,), "bfloat16")]
    want = JC.plan_buckets([jax.ShapeDtypeStruct((4,) + s, jnp.dtype(d))
                            for s, d in shapes], 4, 200)
    got = TC.plan_buckets([torch.empty(s, dtype=getattr(torch, d))
                           for s, d in shapes], 4, 200)
    assert [(b.dtype, [(x.index, x.offset, x.size, tuple(x.shape))
                       for x in b.slots], b.pad) for b in got] == \
        [(b.dtype, [(x.index, x.offset, x.size, tuple(x.shape))
                    for x in b.slots], b.pad) for b in want]
    assert all(b.elems % 4 == 0 for b in got)


def test_wire_config_and_topology_rules():
    with pytest.raises(ValueError, match="q_block"):
        TC.WireConfig(compress="int8", q_block=4)
    with pytest.raises(ValueError, match="unknown compression"):
        TC.WireConfig(compress="fp8")
    assert TC.WireConfig(compress="int8").feedback_armed
    for o, i in ((1, 8), (2, 4), (4, 2), (8, 1)):
        t = TT.Topology.emulated_host(o, i)
        assert TT.Topology.from_json(t.to_json()) == t
        want = JTopology.emulated_host(o, i)
        assert t.leg_bytes(1 << 20) == want.leg_bytes(1 << 20)
        assert t.hier_allreduce_ms(1 << 20) == want.hier_allreduce_ms(1 << 20)
        assert t.describe() == want.describe()
    assert TT.Topology.from_env({"PTYPE_TOPOLOGY": "2x4"}).n == 8
    assert TT.Topology.from_env({}) is None


# ------------------------------------------------------------------- store


def _assert_tree_close(got: dict, want: dict, **tol):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), err_msg=k,
                                   **tol)


def test_push_tree_bucketed_equals_per_leaf_and_reference(world):
    n, _, outs, ref = world
    for out in outs:
        _assert_tree_close(out["pt_bucketed"], out["pt_per_leaf"], **EXACT)
        _assert_tree_close(out["pt_bucketed"], ref["pt_bucketed"], **EXACT)
        assert out["pt_bucketed"]["g/step"].dtype == np.float32  # pmean
        assert out["pt_launches"] == ref["pt_buckets"] == 3


def test_int8_ineligible_buckets_ride_exact(world):
    """At int8_min_bytes=256 the 400-byte bucket quantizes, the 116-byte
    one and the int one ride exact: those leaves equal the exact push,
    the quantized one the reference's int8 push; residuals exist only
    for the quantized leaf and equal the reference's row."""
    n, inp, outs, ref = world
    big = inp["tree"]["big"]
    for r, out in enumerate(outs):
        got, exact = out["pt_int8"], out["pt_bucketed"]
        for k in ("g/blk/b", "g/blk/w", "g/scalar"):
            np.testing.assert_allclose(got[k], exact[k], err_msg=k, **EXACT)
        np.testing.assert_array_equal(got["g/step"], np.asarray(
            ref["pt_int8"]["g/step"]))
        assert got["g/step"].dtype == np.int32  # restored after the wire
        np.testing.assert_allclose(got["g/big"],
                                   np.asarray(ref["pt_int8"]["g/big"]),
                                   rtol=0, atol=n * ulp_of(big))
        assert sorted(out["pt_int8_residuals"]) == ["g/big"] == \
            sorted(ref["pt_int8_residuals"])
        want = np.asarray(ref["pt_int8_residuals"]["g/big"])[r]
        np.testing.assert_allclose(out["pt_int8_residuals"]["g/big"], want,
                                   rtol=0, atol=n * ulp_of(big))


def test_bf16_wire_skips_int_leaves(world):
    n, _, outs, ref = world
    for out in outs:
        np.testing.assert_array_equal(out["pt_bf16"]["g/i"],
                                      np.full(4, n << 20, np.int32))
        assert out["pt_bf16"]["g/f"].dtype == np.float32
        _assert_tree_close(out["pt_bf16"], ref["pt_bf16"], rtol=0, atol=0)


def test_streams_equal_the_barrier_push(world):
    """push_tree_iter commits what push_tree does, epoch 1 a key;
    push_tree_scatter_iter's shards gather to the reference's flats."""
    n, _, outs, ref = world
    for out in outs:
        assert out["stream_buckets"] == 3
        _assert_tree_close(out["stream"], out["pt_bucketed"], rtol=0, atol=0)
        assert set(out["stream_epochs"].values()) == {1}
        assert len(out["scatter_flats"]) == len(ref["scatter_flats"]) == 3
        for got, want in zip(out["scatter_flats"], ref["scatter_flats"]):
            np.testing.assert_allclose(got, np.asarray(want), **EXACT)
        assert out["scatter_epochs"] == [1, 1, 1]
        assert out["scatter_keys"] == [["s/big"],
                                       ["s/blk/b", "s/blk/w", "s/scalar"],
                                       ["s/step"]]


def test_epochs_and_tree_seq_with_an_external_writer(world):
    n, _, outs, ref = world
    for out in outs:
        assert out["seq_record"] == ref["seq_record"]
    assert ref["seq_record"][:7] == [True, 0, 2, 0, True, 0, True]


def test_manifests_publish_and_catch_up(world):
    """A failed publish lags the manifest; the next successful one
    republishes it. The published JSON is the reference's, byte for
    byte (a scattered key carries the whole value's shape)."""
    n, _, outs, ref = world
    for out in outs:
        assert out["kv_missed"] == ref["kv_missed"] == []
        assert out["kv"] == ref["kv"]
        assert out["manifest"] == ref["manifest"]
        assert json.loads(out["kv"]["tensors/ns/s"])["shape"] == [4 * n, 3]


def test_store_residuals_are_the_reference_rows(world):
    """Per-key EF residuals of push_tree and push under int8+EF: rank
    r's are the reference's row r (one ulp, as above)."""
    n, inp, outs, ref = world
    for r, out in enumerate(outs):
        got, want = out["store_residuals"], ref["store_residuals"]
        assert sorted(got) == sorted(want) == ["g/a", "g/b", "k"]
        for k in want:
            w = np.asarray(want[k])[r]
            np.testing.assert_allclose(got[k], w, rtol=0,
                                       atol=ulp_of(inp["q"], w) * n,
                                       err_msg=k)


def test_chaos_timeout_leaves_residuals_in_place(world):
    """A store.push timeout on push_tree, push_tree_iter and push raises
    before any state changes: every residual is the same tensor value;
    an exact-wire stream and an abandoned one keep them too."""
    _, _, outs, _ = world
    for out in outs:
        assert out["chaos_raised"] == 3
        assert out["chaos_residuals_kept"]
        assert out["abandoned_residual_keys"] == ["g/a", "g/b", "k"]


def test_entry_points_refuse_the_wrong_device_and_backend(world):
    """No fallback hides the device or the backend: a cuda mesh on a
    gloo group, axes that do not cover the group, a store or trainer
    with no device named on a host without CUDA, a hierarchical
    topology and a collective over a sub-axis all raise."""
    _, _, outs, _ = world
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    for out in outs:
        got = out["refusals"]
        assert got["cuda_mesh_on_gloo"].startswith("ClusterError")
        assert "nccl" in got["cuda_mesh_on_gloo"]
        assert got["axes_past_the_group"].startswith("ClusterError")
        for name in ("store_without_device", "trainer_without_device"):
            assert got[name].startswith("RuntimeError: no CUDA device")
        assert got["hierarchical_topology"].startswith(
            "NotImplementedError")
        assert "ROADMAP" in got["hierarchical_topology"]
        assert got["sub_axis_collective"].startswith("NotImplementedError")
