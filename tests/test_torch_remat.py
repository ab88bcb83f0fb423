"""Remat of the port against no remat and against the reference's
``jax.checkpoint`` remat, in f32 on the CPU: the loss and every gradient
of ``tiny`` and a narrow GQA config under both policies, the weight
products "dots" saves, the flash path (its plain version here), and the
presets. The counterpart of ``tests/test_models.py::
test_remat_matches_no_remat``. Parameters cross as numpy; inputs are
numpy, seeded."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ptype_tpu.models import transformer as jtfm
from ptype_tpu_torch.models import transformer as ttfm
from ptype_tpu_torch.train import trainer as ttr
from test_torch_train import (GRAD_TOL, LOSS_TOL, assert_trees_close,
                              batch_np, configs, flat, param_pair, to_j, to_t)

POLICIES = ("none", "dots")
#: Grads with remat against without: the reference's own tolerance for
#: this comparison (tests/test_models.py::test_remat_matches_no_remat).
#: The same computation, but autograd sums the contributions to a leaf
#: used twice (the tied embedding) in another order, a few f32 ulps.
REMAT_TOL = dict(rtol=1e-4, atol=1e-5)
CONFIGS = ("tiny", "narrow")


class _OpCount(TorchDispatchMode):
    """Counts the aten ops dispatched inside the block."""

    def __init__(self):
        super().__init__()
        self.n = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[str(func)] = self.n.get(str(func), 0) + 1
        return func(*args, **(kwargs or {}))


def port_loss_and_grads(pt, b, cfg, count=False):
    leaves = [p.requires_grad_(True) for _, p in flat(pt)]
    loss = ttfm.loss_fn(pt, to_t(b), cfg)
    counter = _OpCount()
    if count:
        with counter:
            grads = torch.autograd.grad(loss, leaves)
    else:
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), grads, counter.n


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", CONFIGS)
def test_remat_matches_no_remat(name, policy):
    """The recompute is the forward's own computation: the loss bit for
    bit in f32; the grads within the reference's remat tolerance (the
    tied embedding's two contributions are summed in another order)."""
    _, tc = configs(name, attn_impl="xla")
    _, pt, _ = param_pair(*configs(name), seed=2)
    b = batch_np(3, 4, 64, masked=True)
    l0, g0, _ = port_loss_and_grads(pt, b, tc)
    rc = dataclasses.replace(tc, remat=True, remat_policy=policy)
    l1, g1, _ = port_loss_and_grads(pt, b, rc)
    assert torch.equal(l1, l0)
    for (path, _), a, c in zip(flat(pt), g1, g0):
        torch.testing.assert_close(a, c, **REMAT_TOL, msg="/".join(path))


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", CONFIGS)
def test_remat_matches_reference_remat(name, policy):
    """Loss and grads against the reference's ``jax.checkpoint`` remat of
    the same policy, at the train tests' f32 tolerances."""
    jc, tc = configs(name, attn_impl="xla", remat=True, remat_policy=policy)
    pj, pt, _ = param_pair(jc, tc, seed=4)
    b = batch_np(5, 4, 64, masked=True)
    lj, gj = jax.value_and_grad(jtfm.loss_fn)(pj, to_j(b), jc)
    lt, gt, _ = port_loss_and_grads(pt, b, tc)
    np.testing.assert_allclose(float(lt), float(lj), **LOSS_TOL)
    assert_trees_close(ttr._unflatten(zip([p for p, _ in flat(pt)], gt)),
                       gj, **GRAD_TOL)


def test_dots_saves_the_weight_products():
    """Per layer, "none" recomputes in backward the weight products
    (``aten.mm``) of q, k, v, o, gate and up — six: the recompute stops
    once backward has what it needs, before the down projection, whose
    output nothing saves; "dots" saves them and recomputes none, so its
    backward runs as many as no remat's."""
    _, tc = configs("narrow", attn_impl="xla")
    _, pt, _ = param_pair(*configs("narrow"))
    b = batch_np(6, 2, 32)
    mm = "aten.mm.default"
    counts = {}
    for policy in (None,) + POLICIES:
        cfg = (tc if policy is None
               else dataclasses.replace(tc, remat=True, remat_policy=policy))
        counts[policy] = port_loss_and_grads(pt, b, cfg, count=True)[2][mm]
    assert counts["dots"] == counts[None]
    assert counts["none"] == counts[None] + 6 * tc.n_layers


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_through_the_flash_path(policy):
    """attn_impl="flash" (the autograd Function, its plain forward and
    backward here) under remat: loss and grads equal no remat's."""
    _, tc = configs("narrow", attn_impl="flash")
    _, pt, _ = param_pair(*configs("narrow"), seed=7)
    b = batch_np(8, 2, 64)
    l0, g0, _ = port_loss_and_grads(pt, b, tc)
    rc = dataclasses.replace(tc, remat=True, remat_policy=policy)
    l1, g1, _ = port_loss_and_grads(pt, b, rc)
    assert torch.equal(l1, l0)
    for a, c in zip(g1, g0):
        torch.testing.assert_close(a, c, **REMAT_TOL)


def test_presets_and_fields_match_the_reference():
    for name in ttfm.PRESETS:
        assert ttfm.preset(name).remat == jtfm.preset(name).remat, name
        assert (ttfm.preset(name).remat_policy
                == jtfm.preset(name).remat_policy), name
    assert ttfm.preset("llama-3-8b").remat


def test_unknown_policy_raises_and_no_grad_runs_plain():
    _, tc = configs("tiny", attn_impl="xla")
    _, pt, _ = param_pair(*configs("tiny"))
    b = to_t(batch_np(9, 2, 16))
    bad = dataclasses.replace(tc, remat=True, remat_policy="everything")
    with pytest.raises(ValueError, match="remat_policy"):
        ttfm.loss_fn(pt, b, bad)
    with torch.no_grad():
        got = ttfm.loss_fn(pt, b, bad)
        want = ttfm.loss_fn(pt, b, tc)
    assert torch.equal(got, want)
