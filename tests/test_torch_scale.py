"""Scale checks of the port without the hardware: the twins of
``tests/test_scale.py`` and of ``tests/test_fsdp_8b.py``'s accounting, at
llama-3-8b's full 32 layers and optimus-moe's full width, on the
``meta`` device. Nothing is allocated: every leaf is a shape alone.

A rank of a mesh is a ``Mesh`` with no process group here (its rank and
axes are all a placement reads), so one process plays every rank in
turn: ``param_specs`` divide every dim at ``{fsdp: 8}`` and ``{data: 8,
fsdp: 8}`` and equal the reference's; one rank's state under ``{fsdp:
8}`` (a ``Trainer`` on the meta device: params and both Adam moments)
holds an eighth of the whole within the reference's 8 MiB of
replicated norms; optimus-moe on ``{data: 2, expert: 4}`` gives each
rank a quarter of the experts, and the ranks' banks cover them all.
The weights' ``place=`` hooks give each rank its block of a tree: the
blocks of every rank put back together are the tree, bit for bit."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from ptype_tpu.models import transformer as jtfm
from ptype_tpu_torch.models import transformer as ttfm
from ptype_tpu_torch.models.weights import (init_params, param_shapes,
                                            params_from_numpy)
from ptype_tpu_torch.parallel.mesh import Mesh, block_of, shard_of
from ptype_tpu_torch.train import trainer as ttr

META = torch.device("meta")
#: Replicated leaves a rank holds whole (the norms and their moments):
#: the reference's slack for the 8B accounting.
REPLICATED_SLACK = 8 * 2**20


def rank_mesh(axes: dict, rank: int, device=META) -> Mesh:
    """Rank ``rank`` of a mesh of ``axes``, with no process group."""
    return Mesh(tuple(axes), dict(axes), None, rank, device, None)


def leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def state_bytes(state) -> int:
    trees = (state.params, state.opt_state.mu, state.opt_state.nu)
    return sum(x.numel() * x.element_size() for t in trees
               for _, x in leaves(t))


@pytest.mark.parametrize("axes", [{"fsdp": 8}, {"data": 8, "fsdp": 8}])
def test_llama8b_fsdp_specs_divide(axes):
    cfg = ttfm.preset("llama-3-8b")
    specs = ttfm.param_specs(cfg, axes)
    want = jax.tree_util.tree_map(
        tuple, jtfm.param_specs(jtfm.preset("llama-3-8b"), axes),
        is_leaf=lambda x: isinstance(x, P))
    assert specs == want
    shapes = dict(leaves(param_shapes(cfg)))
    for path, spec in leaves(specs):
        for dim, part in zip(shapes[path], spec):
            if part is None:
                continue
            parts = part if isinstance(part, tuple) else (part,)
            assert dim % math.prod(axes[a] for a in parts) == 0, (path, dim)


def test_llama8b_fsdp_state_is_an_eighth_a_rank():
    """Each of the 8 ranks of ``{fsdp: 8}`` holds its block of the full
    32-layer model and of both Adam moments: an eighth of the whole
    state, to within the replicated norms; the blocks cover it."""
    cfg = ttfm.preset("llama-3-8b")
    shapes = dict(leaves(param_shapes(cfg)))
    n_params = sum(math.prod(s) for s in shapes.values())
    assert 7.5e9 < n_params < 8.5e9
    total = 3 * 4 * n_params
    covered = 0
    for r in range(8):
        t = ttr.Trainer(cfg, mesh=rank_mesh({"fsdp": 8}, r), sync_every=0)
        assert all(x.device.type == "meta"
                   for tree in (t.state.params, t.state.opt_state.mu)
                   for _, x in leaves(tree))
        got = state_bytes(t.state)
        assert abs(got - total / 8) < REPLICATED_SLACK, (r, got, total / 8)
        assert got / 2**30 < 12.0
        covered += sum(x.numel() for path, x in leaves(t.state.params)
                       if any(ttr._at(t.layout.specs, path)))
    split = sum(math.prod(s) for p, s in shapes.items()
                if any(ttr._at(ttfm.param_specs(cfg, {"fsdp": 8}), p)))
    assert covered == split


def test_llama8b_state_on_a_64_rank_mesh():
    """``{data: 8, fsdp: 8}``: the params and moments split over fsdp
    only, replicated over data; with ``shard_update`` the moments are
    split over data too (ZeRO-1 by placement)."""
    cfg = ttfm.preset("llama-3-8b")
    shapes = dict(leaves(param_shapes(cfg)))
    params = {}
    for path, s in shapes.items():
        node = params
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = torch.empty(s, device=META)
    total = 4 * sum(math.prod(s) for s in shapes.values())
    for r in (0, 9, 63):
        mesh = rank_mesh({"data": 8, "fsdp": 8}, r)
        plain, _ = ttr.init_state(cfg, mesh, params)
        su, _ = ttr.init_state(cfg, mesh, params, shard_update=True)
        p_bytes = sum(x.numel() * 4 for _, x in leaves(plain.params))
        assert abs(p_bytes - total / 8) < REPLICATED_SLACK / 3
        assert abs(state_bytes(plain) - 3 * total / 8) < REPLICATED_SLACK
        mom = state_bytes(su) - p_bytes
        assert abs(mom - 2 * total / 64) < REPLICATED_SLACK / 3


def test_optimus_moe_expert_placements_on_data_expert_mesh():
    """optimus-moe on ``{data: 2, expert: 4}``: each rank's bank holds a
    quarter of the 8 experts (E/4 = 2), the router whole; the four
    expert ranks of a data row cover every expert once."""
    cfg = ttfm.preset("optimus-moe")
    axes = {"data": 2, "expert": 4}
    assert ttfm.param_specs(cfg, axes) == jax.tree_util.tree_map(
        tuple, jtfm.param_specs(jtfm.preset("optimus-moe"), axes),
        is_leaf=lambda x: isinstance(x, P))
    starts = []
    for r in range(8):
        t = ttr.Trainer(cfg, mesh=rank_mesh(axes, r), sync_every=0)
        blocks = t.state.params["blocks"]
        for name in ("w_gate", "w_up", "w_down"):
            assert blocks[name].shape[1] == cfg.n_experts // 4, name
            assert t.state.opt_state.mu["blocks"][name].shape == \
                blocks[name].shape
        assert tuple(blocks["router"].shape) == (12, 768, 8)
        assert t.layout.n_experts_local == 2
        starts.append(t.layout.expert_lo)
    assert starts == [0, 2, 4, 6] * 2


def _reassemble(trees, specs, meshes, shapes):
    """The full leaves from every rank's blocks (each block written at
    its offset), and how many times each element was written."""
    full, hits = {}, {}
    for path, shape in leaves(shapes):
        full[path] = np.zeros(shape, np.float32)
        hits[path] = np.zeros(shape, np.int64)
    for tree, mesh in zip(trees, meshes):
        for path, block in leaves(tree):
            start, size = block_of(full[path].shape,
                                   ttr._at(specs, path), mesh)
            idx = tuple(slice(a, a + n) for a, n in zip(start, size))
            full[path][idx] = block.numpy()
            hits[path][idx] += 1
    return full, hits


@pytest.mark.parametrize("axes", [{"data": 2, "expert": 2, "model": 2},
                                  {"fsdp": 2, "expert": 4}])
def test_rank_blocks_of_a_reference_moe_tree_rebuild_it(axes):
    """``params_from_numpy(place=)`` with each rank's ``shard_of``:
    every rank's blocks of a reference MoE tree, put back at their
    offsets, are the tree bit for bit (the replicated leaves are whole
    on every rank); ``init_params(place=)`` gives the blocks of the
    same draws as the whole tree."""
    jcfg = jtfm.preset("tiny-moe", dtype=jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k: jtfm.init_params(k, jcfg))(jax.random.PRNGKey(3)))
    cfg = ttfm.preset("tiny-moe", dtype=torch.float32)
    specs = ttfm.param_specs(cfg, axes)
    n = math.prod(axes.values())
    meshes = [rank_mesh(axes, r, torch.device("cpu")) for r in range(n)]

    def placer(mesh):
        return lambda path, x: shard_of(x, ttr._at(specs, path), mesh)

    trees = [params_from_numpy(tree, cfg, place=placer(m)) for m in meshes]
    full, hits = _reassemble(trees, specs, meshes, param_shapes(cfg))
    for path, want in leaves(tree):
        np.testing.assert_array_equal(full[path], want, err_msg=str(path))
        copies = n // math.prod(
            axes[a] for a in ttr._spec_axes(ttr._at(specs, path)))
        assert (hits[path] == copies).all(), path
    for m, t in zip(meshes, trees):
        assert t["blocks"]["w_gate"].shape[1] == 4 // axes["expert"]

    whole = init_params(torch.Generator().manual_seed(0), cfg)
    drawn = [init_params(torch.Generator().manual_seed(0), cfg,
                         place=placer(m)) for m in meshes]
    full, _ = _reassemble(drawn, specs, meshes, param_shapes(cfg))
    for path, want in leaves(whole):
        np.testing.assert_array_equal(full[path], want.numpy(),
                                      err_msg=str(path))
