"""The reference parameter tree carried across to the port and back,
bit for bit, and the port's own seeded init."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ptype_tpu.models import transformer as jtfm
from ptype_tpu_torch.models import transformer as ttfm
from ptype_tpu_torch.models.weights import (init_params, params_from_numpy,
                                            params_to_numpy)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def test_round_trip_is_bit_exact_on_tiny():
    cfg = jtfm.preset("tiny", dtype=jnp.float32)
    tree = jax.tree_util.tree_map(
        np.asarray, jtfm.init_params(jax.random.PRNGKey(0), cfg))
    pt = params_from_numpy(tree, ttfm.preset("tiny", dtype=torch.float32))
    back = _flat(params_to_numpy(pt))
    want = _flat(tree)
    assert set(back) == set(want)
    for name, arr in want.items():
        assert back[name].dtype == arr.dtype and back[name].shape == arr.shape
        assert np.array_equal(back[name].view(np.uint32),
                              arr.view(np.uint32)), name


def test_round_trip_is_bit_exact_at_optimus_125m_shapes():
    """At the reference's full optimus-125m shapes (from
    ``jax.eval_shape``; the values are seeded numpy draws)."""
    cfg = jtfm.preset("optimus-125m")
    shapes = _flat(jax.tree_util.tree_map(
        lambda s: s.shape,
        jax.eval_shape(lambda: jtfm.init_params(jax.random.PRNGKey(0), cfg))))
    rng = np.random.default_rng(0)
    tree = {"blocks": {}}
    for k, shape in shapes.items():
        arr = rng.standard_normal(shape, dtype=np.float32)
        if k.startswith("blocks/"):
            tree["blocks"][k[len("blocks/"):]] = arr
        else:
            tree[k] = arr
    pt = params_from_numpy(tree, ttfm.preset("optimus-125m"))
    assert ttfm.count_params(pt) == sum(
        int(np.prod(s)) for s in shapes.values())
    back = _flat(params_to_numpy(pt))
    for k, arr in _flat(tree).items():
        assert np.array_equal(back[k], arr), k


def test_init_params_shapes_match_reference_and_are_seeded():
    jc = jtfm.preset("tiny")
    tc = ttfm.preset("tiny")
    want = _flat(jax.tree_util.tree_map(
        lambda s: (tuple(s.shape), s.dtype),
        jax.eval_shape(lambda: jtfm.init_params(jax.random.PRNGKey(0), jc))))
    a = init_params(torch.Generator().manual_seed(5), tc)
    b = init_params(torch.Generator().manual_seed(5), tc)
    c = init_params(torch.Generator().manual_seed(6), tc)
    fa, fb, fc = _flat(a), _flat(b), _flat(c)
    assert {k: tuple(v.shape) for k, v in fa.items()} == {
        k: s for k, (s, _) in want.items()}
    assert all(v.dtype == torch.float32 for v in fa.values())
    assert all(torch.equal(fa[k], fb[k]) for k in fa)
    assert not torch.equal(fa["embed"], fc["embed"])
    # The reference's scales: 0.02 normals, GPT residual scaling on wo.
    assert abs(fa["embed"].std().item() - 0.02) < 2e-3
    assert fa["blocks/wo"].std().item() < 0.02
