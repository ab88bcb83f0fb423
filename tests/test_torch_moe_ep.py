"""Expert parallelism: the port's mesh ``Trainer`` on a mixture-of-experts
config against the reference's GSPMD trainer on the same axes, on this
host's CPU.

Layouts: ``{data: 2}`` and ``{expert: 2}`` on 2 gloo ranks;
``{data: 2, expert: 2}``, ``{expert: 4}``, ``{fsdp: 2, expert: 2}``,
``{expert: 2, model: 2}`` and ``{seq: 2, expert: 2}`` (ring attention)
on 4; a dropping case (capacity factor 0.5, ``grad_accum=2``) on
``{data: 2, expert: 2}`` and on ``{seq: 2, expert: 2}``; and
``shard_update`` on ``{data: 2, expert: 2}`` and ``{data: 2}``. Each
from the same params on the same batches: loss and grad-norm curves
against the reference's at ``LOSS_TOL``/``STEP_TOL``, against each
other at 1e-4, the first loss against the unsharded loss at rtol 1e-5
(``tests/test_moe.py``), the final params; the expert bank split
(E/size experts a rank); the mesh's MoE branch taken on every mesh; a
port save of an expert-split run restored by the reference, and the
reference's save restored into the port's expert placements.

The dropping cases pin the global program: the capacity is the global
microbatch's and the slots count in the global token order (under
``seq`` the ranks' sequence blocks interleave row by row), so a rank's
kept set differs from what a per-rank capacity would keep (asserted on
the first layer), and the reference's curve and params hold only for
the global one.

Config: ``tiny-moe`` (4 experts, top-2) in f32, dense attention, B=8,
S=32, AdamW at lr 1e-3. The ranks run the suite "moe_ep" of
``tests/torch_ranks.py`` (one spawn per world size); the reference
runs on the conftest's CPU devices while they do."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from ptype_tpu.checkpoint import Checkpointer as JCheckpointer
from ptype_tpu.models import transformer as jtfm
from ptype_tpu.parallel.mesh import build_mesh
from ptype_tpu.parallel.ring_attention import make_ring_attention
from ptype_tpu.train import trainer as jtr
from ptype_tpu_torch.models import transformer as ttfm
from ptype_tpu_torch.models.weights import params_from_numpy
from ptype_tpu_torch.parallel.mesh import Mesh
from ptype_tpu_torch.train import trainer as ttr
from test_torch_sharded_train import flat_keys, port_keys
from test_torch_train import LOSS_TOL, STEP_TOL
from torch_ranks import Ranks

OPT = dict(lr=1e-3, warmup=1, decay_steps=50)
#: Between two layouts (the reference's, tests/test_train.py).
LAYOUT_RTOL = 1e-4
#: EP against the unsharded loss (tests/test_moe.py).
UNSHARDED_RTOL = 1e-5
DROP = dict(capacity_factor=0.5, grad_accum=2)
#: world → [(case, axes, knobs)].
CASES = {
    2: [("dp", {"data": 2}, {}), ("ep", {"expert": 2}, {}),
        ("su", {"data": 2}, {"shard_update": True})],
    4: [("dp_ep", {"data": 2, "expert": 2}, {}), ("ep4", {"expert": 4}, {}),
        ("fsdp_ep", {"fsdp": 2, "expert": 2}, {}),
        ("ep_tp", {"expert": 2, "model": 2}, {}),
        ("seq_ep", {"seq": 2, "expert": 2}, {"ring": True}),
        ("drop", {"data": 2, "expert": 2}, DROP),
        ("drop_seq", {"seq": 2, "expert": 2}, {"ring": True, **DROP}),
        ("su_ep", {"data": 2, "expert": 2}, {"shard_update": True})],
}
SAVE_CASE = {2: "ep", 4: "dp_ep"}
#: world → (the shard_update case, the same layout without it).
SU_CASE = {2: ("su", "dp"), 4: ("su_ep", "dp_ep")}
RESTORE_AXES = {2: {"expert": 2}, 4: {"data": 2, "expert": 2}}


def jcfg(**kw):
    return jtfm.preset("tiny-moe", dtype=jnp.float32, attn_impl="xla", **kw)


def token_batch(rng, B=8, S=32):
    toks = rng.integers(0, 256, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def ref_state(mesh, cfg, params, shard_update=False):
    opt = jtr.default_optimizer(**OPT)
    state, sh = jtr.init_state(jax.random.PRNGKey(0), cfg, mesh, opt,
                               shard_update=shard_update)
    return jtr.TrainState(jax.device_put(params, sh.params), state.opt_state,
                          state.step), sh, opt


def ref_run(axes, params, batches, knobs=None):
    """The reference's curves and state after ``batches`` on a mesh of
    ``axes``."""
    knobs = knobs or {}
    cfg = jcfg(capacity_factor=knobs.get("capacity_factor", 1.25))
    mesh = build_mesh(axes)
    state, _, opt = ref_state(mesh, cfg, params,
                              knobs.get("shard_update", False))
    ring = knobs.get("ring", False)
    step = jtr.make_train_step(
        cfg, mesh, opt, grad_accum=knobs.get("grad_accum", 1),
        attn_fn=make_ring_attention(mesh) if ring else None, seq_axis=ring,
        shard_update=knobs.get("shard_update", False))
    losses, norms = [], []
    for b in batches:
        state, out = step(state, b)
        losses.append(float(out["loss"]))
        norms.append(float(out["grad_norm"]))
    return {"losses": losses, "grad_norms": norms, "state": state}


@pytest.fixture(scope="module", params=[2, 4], ids=lambda n: f"world{n}")
def world(request, tmp_path_factory):
    n = request.param
    work = tmp_path_factory.mktemp(f"moe_ep{n}")
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k: jtfm.init_params(k, jcfg()))(jax.random.PRNGKey(42)))
    rng = np.random.default_rng(17)
    batches = [token_batch(rng) for _ in range(3)]
    next_batch = token_batch(rng)
    saved = ref_run({"data": n}, params, batches[:2])
    JCheckpointer(str(work / "ref_ckpt")).save(2, saved["state"])
    inputs = {"params": params, "batches": batches, "opt": OPT,
              "cases": CASES[n], "save_case": SAVE_CASE[n],
              "port_ckpt": str(work / "port_ckpt"),
              "ref_ckpt": str(work / "ref_ckpt"),
              "restore_axes": RESTORE_AXES[n], "next_batch": next_batch}
    ranks = Ranks("moe_ep", n, work, inputs)
    try:  # the reference runs while the ranks do
        ref = {"cases": {name: ref_run(axes, params, batches, knobs)
                         for name, axes, knobs in CASES[n]}}
        ref["next"] = ref_run({"data": n}, params,
                              batches[:2] + [next_batch])["losses"][2]
        ref["unsharded"] = float(jtfm.loss_fn(params, batches[0], jcfg()))
        outs = ranks.join()
        mesh = build_mesh({c: a for c, a, _ in CASES[n]}[SAVE_CASE[n]])
        skel, sh, _ = ref_state(mesh, jcfg(), params)
        ref["port_restored"] = JCheckpointer(inputs["port_ckpt"]).restore(
            skel, step=3, shardings=sh)
    except BaseException:
        ranks._kill()
        raise
    return n, inputs, outs, ref, saved


def test_ep_layouts_match_the_reference_curves(world):
    n, _, outs, ref, _ = world
    for name, _, _ in CASES[n]:
        got, want = outs[0]["cases"][name], ref["cases"][name]
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   err_msg=name, **LOSS_TOL)
        np.testing.assert_allclose(got["grad_norms"], want["grad_norms"],
                                   err_msg=name, **STEP_TOL)


def test_ep_layouts_agree_with_each_other(world):
    """Every rank returns the same global curve, and every layout of
    the default config the first's."""
    n, _, outs, _, _ = world
    base = outs[0]["cases"][CASES[n][0][0]]
    for name, _, knobs in CASES[n]:
        for out in outs:
            row = out["cases"][name]
            np.testing.assert_array_equal(row["losses"],
                                          outs[0]["cases"][name]["losses"])
            if "capacity_factor" in knobs:
                continue
            for key in ("losses", "grad_norms"):
                np.testing.assert_allclose(row[key], base[key],
                                           rtol=LAYOUT_RTOL, err_msg=name)


def test_ep_loss_matches_the_unsharded_loss(world):
    """The first step's loss (the initial params) on every layout: the
    reference's unsharded ``loss_fn``, and the port's, at rtol 1e-5."""
    n, inputs, outs, ref, _ = world
    cfg = ttfm.preset("tiny-moe", dtype=torch.float32, attn_impl="xla")
    params = params_from_numpy(inputs["params"], cfg)
    b = {k: torch.from_numpy(v).long()
         for k, v in inputs["batches"][0].items()}
    port = float(ttfm.loss_fn(params, b, cfg))
    np.testing.assert_allclose(port, ref["unsharded"], rtol=UNSHARDED_RTOL)
    for name, _, knobs in CASES[n]:
        if "capacity_factor" in knobs:
            continue
        np.testing.assert_allclose(outs[0]["cases"][name]["losses"][0],
                                   ref["unsharded"], rtol=UNSHARDED_RTOL,
                                   err_msg=name)


def test_ep_layouts_match_the_reference_params(world):
    n, _, outs, ref, _ = world
    for name, _, _ in CASES[n]:
        want = flat_keys(ref["cases"][name]["state"].params)
        got = port_keys(outs[-1]["cases"][name]["state"])
        for k, v in want.items():
            np.testing.assert_allclose(got["0." + k], v, err_msg=f"{name} {k}",
                                       **STEP_TOL)


def test_expert_bank_is_split_over_the_expert_axis(world):
    """Each rank holds E/size experts of every layer's bank (and, under
    ``model``, its F block)."""
    n, _, outs, _, _ = world
    E, D, F = 4, 64, 64
    for name, axes, _ in CASES[n]:
        want = (2, E // axes.get("expert", 1), D // axes.get("fsdp", 1),
                F // axes.get("model", 1))
        for out in outs:
            assert tuple(out["cases"][name]["bank"]) == want, name


def test_ep_branch_runs_on_every_expert_mesh(world):
    """The mesh's MoE branch: once a layer a microbatch a step."""
    n, _, outs, _, _ = world
    for name, _, knobs in CASES[n]:
        want = 2 * 3 * knobs.get("grad_accum", 1)
        for out in outs:
            assert out["cases"][name]["moe_calls"] == want, name


def _layer0_moe_input(params_np, batch, cfg):
    """The first layer's MoE input of ``batch`` at the given params (the
    port's local forward, its MLP entry spied on)."""
    params = params_from_numpy(params_np, cfg)
    seen = []
    real = ttfm._moe_mlp

    def spy(h, layer, c, capacity=None):
        seen.append((h.detach(), layer["router"].detach()))
        return real(h, layer, c, capacity=capacity)

    ttfm._moe_mlp = spy
    try:
        b = {k: torch.from_numpy(v).long() for k, v in batch.items()}
        ttfm.loss_fn(params, b, cfg)
    finally:
        ttfm._moe_mlp = real
    return seen[0]


def test_dropping_case_keeps_the_global_capacity():
    """The dropping case's first microbatch (global rows 0..3) at its
    first layer: the global capacity drops assignments, and a per-rank
    capacity over each data rank's two rows would keep another set. So
    the case's curve, held to the reference's in
    ``test_ep_layouts_match_the_reference_curves``, pins the global
    capacity and token order."""
    cfg = ttfm.preset("tiny-moe", dtype=torch.float32, attn_impl="xla",
                      capacity_factor=DROP["capacity_factor"])
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k: jtfm.init_params(k, jcfg()))(jax.random.PRNGKey(42)))
    batch = token_batch(np.random.default_rng(17))
    mb = {k: v[:4] for k, v in batch.items()}
    h, router = _layer0_moe_input(params, mb, cfg)
    x = h.reshape(-1, h.shape[-1])
    _, gate_e, _ = ttfm._moe_route(x, router, cfg)
    E, k = cfg.n_experts, cfg.expert_top_k

    def cap(T):
        return max(math.ceil(k * T / E * cfg.capacity_factor), 1)

    T = x.shape[0]
    keep = ttfm._moe_dispatch(x, gate_e, cap(T), cfg)[3]
    half = T // 2
    per_rank = torch.cat([
        ttfm._moe_dispatch(x[i:i + half], gate_e[i:i + half], cap(half),
                           cfg)[3] for i in (0, half)])
    assert not bool(keep.all())
    assert bool((keep != per_rank).any())


def test_shard_update_on_an_expert_mesh(world):
    """``shard_update`` on {data: 2} and {data: 2, expert: 2}: the
    moments split over data as well (half of them a rank), the curve
    the plain layout's."""
    n, _, outs, _, _ = world
    for out in outs:
        su, dp = (out["cases"][c] for c in SU_CASE[n])
        assert su["moment_elems"] * 2 == dp["moment_elems"]
        np.testing.assert_allclose(su["losses"], dp["losses"], rtol=1e-6)


@pytest.mark.parametrize("axes", [{"data": 2, "expert": 2},
                                  {"data": 4, "expert": 2},
                                  {"data": 2, "fsdp": 2, "expert": 2}])
def test_expert_opt_state_placements_follow_the_reference_rule(axes):
    """The moments' placements of the MoE tree under ``shard_update``:
    the reference's rule (``_shard_update_spec``, data on the first
    unsplit dim it divides) applied to its own param specs."""
    cfg = ttfm.preset("tiny-moe")
    names = tuple(axes)
    mesh = Mesh(names, dict(axes), None, 0, torch.device("cpu"), None)
    layout = ttfm.MeshLayout(cfg, mesh)
    got = ttr.opt_state_placements(layout, shard_update=True)
    specs = jtfm.param_specs(jtfm.preset("tiny-moe"), axes)
    shapes = jax.eval_shape(lambda: jtfm.init_params(jax.random.PRNGKey(0),
                                                     jtfm.preset("tiny-moe")))
    for (path, spec), (_, shape) in zip(
            jax.tree_util.tree_leaves_with_path(
                specs, is_leaf=lambda x: isinstance(x, P)),
            jax.tree_util.tree_leaves_with_path(shapes)):
        keys = tuple(p.key for p in path)
        want = tuple(jtr._shard_update_spec(spec, shape.shape, "data",
                                            axes["data"]))
        node = got
        for key in keys:
            node = node[key]
        assert node == want, keys


def test_reference_restores_a_port_expert_split_save(world):
    """Every rank wrote its blocks of the expert-split state; the
    reference restores the step into its own shardings bit for bit."""
    n, _, outs, ref, _ = world
    got = flat_keys(ref["port_restored"])
    want = port_keys(outs[0]["cases"][SAVE_CASE[n]]["state"])
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert got["2"].reshape(-1).tolist() == [3]


def test_port_restores_a_reference_save_into_expert_placements(world):
    """The reference's save (two steps on {data: n}) read into the
    expert-split layout, each rank its own blocks: the state bit for
    bit, and the next step's loss the reference's."""
    _, _, outs, ref, saved = world
    want = flat_keys(saved["state"])
    for out in outs:
        row = out["restored"]
        assert row["step"] == 2
        for k, v in port_keys(row["state"]).items():
            np.testing.assert_array_equal(v, want[k], err_msg=k)
        np.testing.assert_allclose(row["next"], ref["next"], **LOSS_TOL)
