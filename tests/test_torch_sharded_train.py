"""The port's mesh ``Trainer`` against the reference's GSPMD trainer, on
this host's CPU: data, fsdp, tensor (model) and ``shard_update`` layouts
on 2 and 4 gloo ranks, from the same params on the same batches — loss
and grad-norm curves against each other (the reference's rtol 1e-4
between layouts, ``tests/test_train.py``) and against the reference on
a mesh of the same axes (``LOSS_TOL``/``STEP_TOL`` of
``test_torch_train.py``); the moments really sharded under
``shard_update``; grad accumulation with an uneven mask; the sub-axis
process groups and the autograd collectives; ``local_row_range``; a
sharded save the reference restores, and a reference save restored into
the port's placements; evaluation; ranks that read only their own rows.

Config: ``tiny`` with 2 KV heads (GQA) in f32, dense attention, B=8,
S=32, AdamW at lr 1e-3. The port runs on n gloo ranks
(``tests/torch_ranks.py`` suite "sharded_train", one spawn per world
size); the reference on the conftest's CPU devices, while the ranks
run. Params and batches are seeded numpy, the same in both."""

import itertools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from ptype_tpu.checkpoint import Checkpointer as JCheckpointer
from ptype_tpu.checkpoint import _flat_key as jkey
from ptype_tpu.models import transformer as jtfm
from ptype_tpu.parallel.mesh import build_mesh
from ptype_tpu.train import trainer as jtr
from ptype_tpu_torch.models import transformer as ttfm
from test_torch_train import LOSS_TOL, STEP_TOL
from torch_ranks import Ranks

OPT = dict(lr=1e-3, warmup=1, decay_steps=50)
#: Between two layouts of the port, as between the reference's
#: (tests/test_train.py: sums reduced in other orders).
LAYOUT_RTOL = 1e-4
#: world → [(case, axes, Trainer knobs)].
CASES = {
    2: [("dp", {"data": 2}, {}), ("fsdp", {"fsdp": 2}, {}),
        ("tp", {"model": 2}, {}),
        ("su", {"data": 2}, {"shard_update": True})],
    4: [("dp", {"data": 4}, {}), ("fsdp", {"data": 2, "fsdp": 2}, {}),
        ("tp", {"data": 2, "fsdp": 1, "model": 2}, {}),
        ("fsdp_tp", {"fsdp": 2, "model": 2}, {}),
        ("tp4", {"model": 4}, {}),
        ("su", {"data": 4}, {"shard_update": True})],
}
SAVE_CASE = {2: "tp", 4: "fsdp_tp"}


def jcfg():
    return jtfm.preset("tiny", dtype=jnp.float32, attn_impl="xla",
                       n_kv_heads=2)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def token_batch(rng, B=8, S=32, masked=False):
    toks = rng.integers(0, 256, (B, S + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if masked:
        mask = (rng.random((B, S)) < 0.5).astype(np.float32)
        mask[:2] = 0.0           # rank 0's rows hold no valid token
        mask[B // 2:] = 1.0      # the second half holds most of them
        out["loss_mask"] = mask
    return out


def ref_state(mesh, params, shard_update=False):
    opt = jtr.default_optimizer(**OPT)
    state, sh = jtr.init_state(jax.random.PRNGKey(0), jcfg(), mesh, opt,
                               shard_update=shard_update)
    state = jtr.TrainState(jax.device_put(params, sh.params),
                           state.opt_state, state.step)
    return state, sh, opt


def ref_run(axes, params, batches, shard_update=False, grad_accum=1):
    """The reference's losses, grad norms and state after the batches,
    on its own mesh of ``axes``."""
    mesh = build_mesh(axes)
    state, sh, opt = ref_state(mesh, params, shard_update)
    keys = tuple(k for k in jtr.BATCH_KEYS if k in batches[0])
    step = jtr.make_train_step(jcfg(), mesh, opt, batch_keys=keys,
                               grad_accum=grad_accum,
                               shard_update=shard_update)
    losses, norms = [], []
    for b in batches:
        state, out = step(state, b)
        losses.append(float(out["loss"]))
        norms.append(float(out["grad_norm"]))
    return {"losses": losses, "grad_norms": norms, "state": state,
            "mesh": mesh}


def flat_keys(tree) -> dict:
    """Reference checkpoint keys → numpy arrays of a state."""
    return {jkey(path): np.asarray(x) for path, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def port_keys(state) -> dict:
    """The same keys of a port rank's gathered state (its params and
    moments in the reference's ``TrainState`` layout)."""
    out = {}

    def walk(prefix, tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(prefix + (k,), v)
            else:
                out[prefix + (k,)] = v

    flat: dict = {}
    for name, pre in (("params", "0"), ("mu", "1.1.0..mu"),
                      ("nu", "1.1.0..nu")):
        out.clear()
        walk((), state[name])
        flat.update({pre + "." + ".".join(p): v for p, v in out.items()})
    return flat


@pytest.fixture(scope="module", params=[2, 4], ids=lambda n: f"world{n}")
def world(request, tmp_path_factory):
    n = request.param
    work = tmp_path_factory.mktemp(f"sharded{n}")
    params = np_tree(jax.jit(lambda k: jtfm.init_params(k, jcfg()))(
        jax.random.PRNGKey(42)))
    rng = np.random.default_rng(11)
    batches = [token_batch(rng) for _ in range(3)]
    eval_batches = [token_batch(rng, masked=True) for _ in range(2)]
    accum_batch = token_batch(rng, masked=True)
    next_batch = token_batch(rng)
    mp_rows = rng.integers(0, 256, (8, 33)).astype(np.int32)
    # The reference's save, restored by the ranks: two steps on {data}.
    saved = ref_run({"data": n}, params, batches[:2])
    JCheckpointer(str(work / "ref_ckpt")).save(2, saved["state"])
    half = max(n // 2, 1)
    inputs = {
        "params": params, "batches": batches, "opt": OPT,
        "cases": CASES[n], "save_case": SAVE_CASE[n],
        "port_ckpt": str(work / "port_ckpt"),
        "eval_batches": eval_batches,
        "accum_axes": {"data": 2, "fsdp": n // 2},
        "accum_batch": accum_batch,
        "group_axes": {"data": 2, "fsdp": 1, "model": half},
        "group_probe": ["data", "fsdp", "model", ["data", "fsdp"],
                        ["data", "model"], ["data", "fsdp", "model"]],
        "row_axes": {"dp": {"data": n}, "mixed": {"data": 2, "model": half},
                     "fsdp": {"fsdp": n}},
        "restore_axes": {c: a for c, a, _ in CASES[n]}[SAVE_CASE[n]],
        "ref_ckpt": str(work / "ref_ckpt"), "next_batch": next_batch,
        "mp_rows": mp_rows,
    }
    ranks = Ranks("sharded_train", n, work, inputs)
    try:  # the reference runs while the ranks do
        ref = {"cases": {}}
        for name, axes, knobs in CASES[n]:
            ref["cases"][name] = ref_run(axes, params, batches,
                                         knobs.get("shard_update", False))
        ref["accum"] = ref_run(inputs["accum_axes"], params, [accum_batch],
                               grad_accum=2)
        save_axes = inputs["restore_axes"]
        ref["next"] = ref_run({"data": n}, params,
                              batches[:2] + [next_batch])["losses"][2]
        ref["eval"] = jtr.evaluate(
            ref["cases"][SAVE_CASE[n]]["state"].params, jcfg(),
            ref["cases"][SAVE_CASE[n]]["mesh"], iter(eval_batches), 2)
        mp = {"tokens": mp_rows[:, :-1], "targets": mp_rows[:, 1:]}
        ref["mp"] = ref_run({"data": n}, params, [mp] * 3)["losses"]
        # The port's save, restored by the reference into its shardings.
        mesh = build_mesh(save_axes)
        skel, sh, _ = ref_state(mesh, params)
        outs = ranks.join()
        ref["port_restored"] = JCheckpointer(inputs["port_ckpt"]).restore(
            skel, step=3, shardings=sh)
    except BaseException:
        ranks._kill()
        raise
    return n, inputs, outs, ref, saved


def _close(got, want, **tol):
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def test_layouts_agree_with_each_other(world):
    n, _, outs, _, _ = world
    base = outs[0]["cases"]["dp"]
    for name, _, _ in CASES[n]:
        for out in outs:
            row = out["cases"][name]
            np.testing.assert_allclose(row["losses"], base["losses"],
                                       rtol=LAYOUT_RTOL, err_msg=name)
            np.testing.assert_allclose(row["grad_norms"],
                                       base["grad_norms"],
                                       rtol=LAYOUT_RTOL, err_msg=name)


def test_layouts_match_the_reference_curves(world):
    n, _, outs, ref, _ = world
    for name, _, _ in CASES[n]:
        got, want = outs[0]["cases"][name], ref["cases"][name]
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   err_msg=name, **LOSS_TOL)
        np.testing.assert_allclose(got["grad_norms"], want["grad_norms"],
                                   rtol=1e-4, err_msg=name)


def test_layouts_match_the_reference_params(world):
    n, _, outs, ref, _ = world
    for name, _, _ in CASES[n]:
        want = flat_keys(ref["cases"][name]["state"].params)
        got = port_keys(outs[-1]["cases"][name]["state"])
        _close({k: got["0." + k] for k in want}, want, **STEP_TOL)


def test_shard_update_shards_the_moments_and_keeps_the_curve(world):
    """ZeRO-1 by placement: every moment leaf of ``tiny`` has a dim the
    data axis divides, so each rank holds 1/n of the moments, and the
    curve is plain DP's."""
    n, _, outs, _, _ = world
    for out in outs:
        su, dp = out["cases"]["su"], out["cases"]["dp"]
        assert su["moment_elems"] * n == dp["moment_elems"]
        np.testing.assert_allclose(su["losses"], dp["losses"], rtol=1e-6)
    # The whole moments are the plain run's.
    for k in ("mu", "nu"):
        got = port_keys(outs[0]["cases"]["su"]["state"])
        want = port_keys(outs[0]["cases"]["dp"]["state"])
        _close({x: got[x] for x in got if f".{k}." in x},
               {x: want[x] for x in want if f".{k}." in x},
               rtol=1e-5, atol=1e-12)


def test_grad_accum_with_an_uneven_mask_on_a_mesh(world):
    """The normalizer is the GLOBAL mask sum: rank 0's rows hold no
    valid token, the second half of the batch most of them."""
    _, inputs, outs, ref, _ = world
    for out in outs:
        np.testing.assert_allclose(out["accum"]["loss"],
                                   ref["accum"]["losses"][0], **LOSS_TOL)
    want = flat_keys(ref["accum"]["state"].params)
    got = port_keys(outs[0]["accum"]["state"])
    _close({k: got["0." + k] for k in want}, want, **STEP_TOL)


def _coords(rank, axes):
    names = list(axes)
    out = {}
    for a in reversed(names):
        out[a] = rank % axes[a]
        rank //= axes[a]
    return out


def test_sub_axis_groups_index_and_sum(world):
    """Each rank's group on an axis holds the ranks that differ from it
    only there, in mesh order; its coordinate is its index; a sum over
    the group adds exactly those ranks."""
    n, inputs, outs, _, _ = world
    axes = inputs["group_axes"]
    for r, out in enumerate(outs):
        c = _coords(r, axes)
        for probe in inputs["group_probe"]:
            names = tuple(probe) if isinstance(probe, list) else (probe,)
            members = [q for q in range(n)
                       if all(_coords(q, axes)[a] == c[a]
                              for a in axes if a not in names)]
            got = out["groups"][str(tuple(probe) if isinstance(probe, list)
                                    else probe)]
            assert got["ranks"] == members, probe
            assert got["sum"] == sum(q + 1 for q in members), probe
            idx = 0
            for a in axes:
                if a in names and axes[a] > 1:
                    idx = idx * axes[a] + c[a]
            assert got["index"] == idx, probe


def test_autograd_collectives(world):
    """gather_for_use: allgather, gradient reduce-scattered (summed over
    the group); gather_replicated: allgather, the gradient's own block;
    reduce_from ("g"): allreduce, identity backward; copy_to ("f"):
    identity, allreduced backward."""
    n, inputs, outs, _, _ = world
    axes = inputs["group_axes"]
    m = axes["model"]
    for r, out in enumerate(outs):
        c = _coords(r, axes)
        group = [q for q in range(n)
                 if all(_coords(q, axes)[a] == c[a] for a in axes
                        if a != "model")]
        xs = [np.arange(4.0).reshape(2, 2) + 10 * q for q in group]
        i = group.index(r)
        p = out["autograd_collectives"]
        full = np.concatenate(xs, axis=1)
        weight = np.arange(full.size).reshape(full.shape) + 1.0
        blk = weight[:, 2 * i:2 * i + 2]
        np.testing.assert_array_equal(p["gather_for_use"]["y"], full)
        np.testing.assert_array_equal(p["gather_for_use"]["grad"], blk * m)
        np.testing.assert_array_equal(p["gather_replicated"]["y"], full)
        np.testing.assert_array_equal(p["gather_replicated"]["grad"], blk)
        np.testing.assert_array_equal(p["reduce_from"]["y"], sum(xs))
        np.testing.assert_array_equal(p["reduce_from"]["grad"],
                                      np.full((2, 2), r + 1.0))
        np.testing.assert_array_equal(p["copy_to"]["y"], xs[i])
        np.testing.assert_array_equal(p["copy_to"]["grad"],
                                      np.full((2, 2), sum(q + 1.0
                                                          for q in group)))
        assert out["roundtrip"]


def test_local_row_range(world):
    """The rows a rank holds under the batch placement: its contiguous
    block over the data-like axes, outer first (the reference's
    ``local_row_range`` per controller); all rows when replicated."""
    n, inputs, outs, _, _ = world
    for r, out in enumerate(outs):
        for label, axes in inputs["row_axes"].items():
            c = _coords(r, axes)
            split = [a for a in ("data", "fsdp") if a in axes]
            k = math.prod(axes[a] for a in split)
            idx = 0
            for a in split:
                idx = idx * axes[a] + c[a]
            rows = out["rows"][label]
            assert tuple(rows["batch"]) == (idx * 16 // k,
                                            (idx + 1) * 16 // k), label
            assert tuple(rows["replicated"]) == (0, 16)


def test_reference_restores_a_port_sharded_save(world):
    """Every rank wrote its blocks at their offsets (one writer a block);
    the reference restores the step into its own shardings: the same
    params and moments as the port's, bit for bit, and the counts."""
    _, _, outs, ref, _ = world
    got = flat_keys(ref["port_restored"])
    n_case = SAVE_CASE[len(outs)]
    want = port_keys(outs[0]["cases"][n_case]["state"])
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert got["2"].reshape(-1).tolist() == [3]
    assert got["1.1.0..count"].reshape(-1).tolist() == [3]
    # And the port's Checkpointer.restore(placements=) reads each rank's
    # blocks back equal to its own.
    assert all(out["cases"][n_case]["restore_blocks_equal"] for out in outs)


def test_port_restores_a_reference_save_into_its_placements(world):
    """The reference's save (two steps on {data: n}) read into the
    port's sharded layout, each rank reading its own blocks: the same
    state bit for bit, and the next step's loss the reference's."""
    _, _, outs, ref, saved = world
    want = flat_keys(saved["state"])
    for out in outs:
        row = out["restored"]
        assert row["step"] == 2
        assert row["state"]["count"] == 2
        got = port_keys(row["state"])
        for k, v in got.items():
            np.testing.assert_array_equal(v, want[k], err_msg=k)
        np.testing.assert_allclose(row["next"], ref["next"], **LOSS_TOL)


def test_ranks_reading_their_own_rows_train_as_one(world):
    """Each rank reads only its ``local_row_range`` of the global batch
    and steps on it: every rank holds the same global loss, the
    reference's on the whole batch (tests/test_mp_train.py)."""
    n, _, outs, ref, _ = world
    ranges = sorted(tuple(out["mp"]["range"]) for out in outs)
    assert ranges == [(r * 8 // n, (r + 1) * 8 // n) for r in range(n)]
    for out in outs:
        np.testing.assert_allclose(out["mp"]["losses"],
                                   outs[0]["mp"]["losses"], rtol=0, atol=0)
    np.testing.assert_allclose(outs[0]["mp"]["losses"], ref["mp"],
                               **LOSS_TOL)


def test_evaluate_on_a_mesh_matches_the_reference(world):
    """Token-weighted over two masked batches, sums over the batch
    axes: the reference's evaluate of the same layout's state."""
    n, _, outs, ref, _ = world
    got = outs[0]["cases"][SAVE_CASE[n]]["eval"]
    assert got["tokens"] == ref["eval"]["tokens"]
    np.testing.assert_allclose(got["loss"], ref["eval"]["loss"], rtol=1e-4)


@pytest.mark.parametrize("name", ["tiny", "llama-3-8b", "optimus-moe"])
def test_param_specs_and_batch_spec_match_the_reference(name):
    sizes = [{"data": 2}, {"data": 2, "fsdp": 4},
             {"data": 2, "fsdp": 2, "model": 2}, {"fsdp": 3, "model": 3},
             {"model": 8, "expert": 2}, {"data": 2, "seq": 4}]
    for axes in sizes:
        want = jax.tree_util.tree_map(
            tuple, jtfm.param_specs(jtfm.preset(name), axes),
            is_leaf=lambda x: isinstance(x, P))
        assert ttfm.param_specs(ttfm.preset(name), axes) == want, axes
        for seq in (False, True):
            spec = jtfm.batch_spec(axes, seq)
            assert ttfm.batch_spec(axes, seq) == tuple(spec), (axes, seq)


def test_opt_state_placements_follow_the_reference_shard_update_rule():
    """``_shard_update_spec`` adds the data axis on the first unsplit
    dim it divides, as the reference's does."""
    from ptype_tpu_torch.train import trainer as ttr

    shapes = [(8, 4), (3, 8), (2, 3), (16,), (4, 2, 8)]
    specs = [(None, "model"), ("fsdp", None), (None, None), (None,),
             (None, "fsdp", None)]
    for shape, spec in itertools.product(shapes, specs):
        if len(spec) > len(shape):
            continue
        want = tuple(jtr._shard_update_spec(P(*spec), shape, "data", 4))
        assert ttr._shard_update_spec(spec, shape, "data", 4) == want
