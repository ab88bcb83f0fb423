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


def test_init_params_place_keeps_blocks_of_the_same_draws():
    """``place`` sees every leaf, named by its path, as it is drawn, and
    the tree keeps what it returns (a mesh rank's block): the values are
    those of the whole init, for tied and untied heads."""
    for tie in (True, False):
        cfg = ttfm.preset("tiny", dtype=torch.float32, tie_embeddings=tie)
        whole = _flat(init_params(torch.Generator().manual_seed(3), cfg))
        seen = []

        def place(path, leaf):
            seen.append("/".join(path))
            return leaf.narrow(-1, 0, 1).clone()

        kept = _flat(init_params(torch.Generator().manual_seed(3), cfg,
                                 place=place))
        assert sorted(seen) == sorted(whole)
        for name, leaf in whole.items():
            assert torch.equal(kept[name], leaf.narrow(-1, 0, 1))


def test_stage_params_cut_each_stage_layers():
    """One pipeline stage's share of the reference's tree: its L/S
    layers of every block leaf, the rest whole, from the stacked tree or
    the reference's ``split_stages`` form alike; the stages' blocks laid
    end to end are the whole stack."""
    from ptype_tpu.parallel.pipeline import split_stages
    from ptype_tpu_torch.models.weights import stage_params_from_numpy

    jcfg = jtfm.preset("tiny", n_layers=4, dtype=jnp.float32)
    cfg = ttfm.preset("tiny", n_layers=4, dtype=torch.float32)
    tree = jax.tree_util.tree_map(
        np.asarray, jtfm.init_params(jax.random.PRNGKey(0), jcfg))
    split = dict(tree, blocks=jax.tree_util.tree_map(
        np.asarray, split_stages(tree["blocks"], 2)))
    stages = [stage_params_from_numpy(tree, cfg, s, 2) for s in range(2)]
    for s in range(2):
        again = stage_params_from_numpy(split, cfg, s, 2)
        for (k, a), b in zip(_flat(stages[s]).items(),
                             _flat(again).values()):
            assert torch.equal(a, b), k
        assert stages[s]["blocks"]["wq"].shape[0] == 2
        assert torch.equal(stages[s]["embed"], torch.from_numpy(
            np.array(tree["embed"])))
    for k, leaf in tree["blocks"].items():
        whole = torch.cat([st["blocks"][k] for st in stages])
        assert np.array_equal(whole.numpy(), leaf), k


def test_resnet_round_trip_is_bit_exact():
    """A reference ResNet tree (HWIO convolutions) to the port's (OIHW)
    and back, bit for bit; batch-norm statistics and the head as they
    are."""
    from ptype_tpu.models import resnet as jresnet
    from ptype_tpu_torch.models import resnet
    from ptype_tpu_torch.models.weights import (resnet_params_from_numpy,
                                                resnet_params_to_numpy)

    jcfg = jresnet.preset("tiny", dtype=jnp.float32)
    tree = jax.tree_util.tree_map(
        np.asarray, jresnet.init_params(jax.random.PRNGKey(0), jcfg))
    params = resnet_params_from_numpy(tree, resnet.preset("tiny"))
    stem = params["stem"]["conv"]
    assert tuple(stem.shape) == (64, 3, 7, 7)
    assert np.array_equal(stem[:, :, 1, 2].numpy(),
                          tree["stem"]["conv"][1, 2].T)
    assert torch.equal(params["stage2"][0]["bn1"]["var"], torch.from_numpy(
        np.array(tree["stage2"][0]["bn1"]["var"])))
    back = resnet_params_to_numpy(params)
    a, b = (jax.tree_util.tree_leaves(t) for t in (back, tree))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.shape == y.shape and np.array_equal(x.view(np.uint32),
                                                     y.view(np.uint32))
    own = resnet.init_params(torch.Generator().manual_seed(0),
                             resnet.preset("tiny"))
    assert [tuple(t.shape) for t in jax.tree_util.tree_leaves(
        resnet_params_to_numpy(own))] == [y.shape for y in b]
