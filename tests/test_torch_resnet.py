"""The port's ResNet against the reference's ``tests/test_resnet.py``
on the CPU: each reference test with a counterpart here, on the
reference's seed-0 weights carried across (``models/weights.py``,
HWIO → OIHW) and the same images (NHWC there, NCHW here), at f32.

Tolerances: the reference's 1e-5 (relative and absolute) on logits and
stage chains; batch statistics 1e-5; losses over five Adam steps 1e-5
relative (the repo's default for f32 losses)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from ptype_tpu.models import resnet as jresnet
from ptype_tpu_torch.models import resnet
from ptype_tpu_torch.models.weights import (resnet_params_from_numpy,
                                            resnet_params_to_numpy)
from ptype_tpu_torch.train.trainer import Adam, tree_leaves, tree_map

JCFG = jresnet.preset("tiny", dtype=jnp.float32)
CFG = resnet.preset("tiny", dtype=torch.float32)
TOL = dict(rtol=1e-5, atol=1e-5)


def _weights():
    jp = jresnet.init_params(jax.random.PRNGKey(0), JCFG)
    return jp, resnet_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), CFG)


def _batch(B=2, hw=32):
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    images = np.asarray(jax.random.normal(k1, (B, hw, hw, 3), jnp.float32))
    labels = np.asarray(jax.random.randint(k2, (B,), 0, JCFG.n_classes,
                                           jnp.int32))
    return images, labels


def _nchw(images):
    return torch.from_numpy(np.array(images)).permute(0, 3, 1, 2)


def test_forward_shapes():
    """Logits and stats of the reference's shape and tree, its logits
    and batch statistics in eval and train mode."""
    jp, params = _weights()
    images, _ = _batch()
    for train in (False, True):
        logits, stats = resnet.forward(params, _nchw(images), CFG, train)
        assert logits.shape == (2, CFG.n_classes)
        assert "stem" in stats and "stage2" in stats
        jl, js = jresnet.forward(jp, jnp.asarray(images), JCFG, train)
        np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jl),
                                   **TOL)
        np.testing.assert_allclose(
            stats["stage2"][0]["bn_proj"]["var"].numpy(),
            np.asarray(js["stage2"][0]["bn_proj"]["var"]), **TOL)


def test_resnet50_param_count():
    """ResNet-50 ≈ 25.6 M parameters (batch-norm statistics included):
    the port's tree counted on the ``meta`` device equals the
    reference's under ``jax.eval_shape``, leaf for leaf."""
    meta = resnet.init_params(torch.Generator(), resnet.preset("resnet-50"),
                              device="meta")
    n = resnet.count_params(meta)
    shapes = jax.eval_shape(lambda: jresnet.init_params(
        jax.random.PRNGKey(0), jresnet.preset("resnet-50")))
    assert n == sum(int(np.prod(x.shape))
                    for x in jax.tree_util.tree_leaves(shapes))
    assert 24e6 < n < 27e6
    assert all(t.device.type == "meta" for t in tree_leaves(meta))


def test_bn_train_updates_stats():
    jp, params = _weights()
    images, _ = _batch()
    x = images * 3 + 1  # nonzero mean
    _, stats = resnet.forward(params, _nchw(x), CFG, train=True)
    merged = resnet.update_stats(params, stats)
    moved = merged["stem"]["bn"]["mean"].numpy()
    assert not np.allclose(moved, 0.0)  # moved toward the batch mean
    _, jstats = jresnet.forward(jp, jnp.asarray(x), JCFG, train=True)
    want = jresnet.update_stats(jp, jstats)
    got = resnet_params_to_numpy(merged)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)
    a, _ = resnet.forward(merged, _nchw(x), CFG, train=False)
    b, _ = resnet.forward(merged, _nchw(x), CFG, train=False)
    assert torch.equal(a, b)


def test_training_learns():
    """Five Adam steps with batch-norm statistics merged: the loss falls,
    step for step the reference's (optax.adam)."""
    jp, params = _weights()
    images, labels = _batch(B=4, hw=16)
    opt = optax.adam(1e-3)
    js = opt.init(jp)

    @jax.jit
    def step(p, s):
        (loss, stats), grads = jax.value_and_grad(
            jresnet.loss_fn, has_aux=True)(
                p, {"images": jnp.asarray(images),
                    "labels": jnp.asarray(labels)}, JCFG)
        upd, s = opt.update(grads, s, p)
        return jresnet.update_stats(optax.apply_updates(p, upd), stats), s, \
            loss

    want = []
    for _ in range(5):
        jp, js, loss = step(jp, js)
        want.append(float(loss))

    adam = Adam(1e-3)
    state = adam.init(params)
    batch = {"images": _nchw(images),
             "labels": torch.from_numpy(np.array(labels))}
    got = []
    for _ in range(5):
        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        loss, stats = resnet.loss_fn(p, batch, CFG)
        leaves = tree_leaves(p)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        it = iter([torch.zeros_like(t) if g is None else g
                   for t, g in zip(leaves, grads)])
        params = tree_map(lambda t: t.detach().clone(), params)
        adam.update(params, tree_map(lambda _: next(it), params), state)
        params = resnet.update_stats(params, stats)
        got.append(float(loss.detach()))
    assert got[-1] < got[0]
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_stage_split_matches_forward():
    """Chained stage_split functions == the monolithic forward."""
    jp, params = _weights()
    images, _ = _batch()
    want, _ = resnet.forward(params, _nchw(images), CFG, train=False)
    y = _nchw(images)
    names = []
    for name, fn, p in resnet.stage_split(params, CFG):
        y = fn(p, y)
        names.append(name)
    assert names == ["stem", "stage1", "stage2", "head"]
    torch.testing.assert_close(y, want, **TOL)
    jwant, _ = jresnet.forward(jp, jnp.asarray(images), JCFG, train=False)
    np.testing.assert_allclose(y.numpy(), np.asarray(jwant), **TOL)
