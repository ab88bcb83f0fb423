"""Parity of ptype_tpu_torch.models.transformer with the JAX reference:
the same parameters (carried across as numpy) and the same inputs
(numpy, seeded) through both packages."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptype_tpu.models import transformer as jtfm
from ptype_tpu_torch.models import transformer as ttfm
from ptype_tpu_torch.models.weights import params_from_numpy

#: The two small configs of the port's tests: the reference's ``tiny``
#: and a narrow one with the serving head width (Dh = 128) and GQA.
NARROW = dict(vocab_size=256, d_model=256, n_layers=2, n_heads=2,
              n_kv_heads=1, d_ff=256, max_seq=256)
#: f32 parity tolerance (models and generation): rtol = atol = 1e-4.
TOL = dict(rtol=1e-4, atol=1e-4)


def configs(name, dtype="f32", **kw):
    jd, td = ((jnp.float32, torch.float32) if dtype == "f32"
              else (jnp.bfloat16, torch.bfloat16))
    if name == "narrow":
        return (jtfm.TransformerConfig(dtype=jd, **NARROW, **kw),
                ttfm.TransformerConfig(dtype=td, **NARROW, **kw))
    return jtfm.preset(name, dtype=jd, **kw), ttfm.preset(name, dtype=td, **kw)


def param_pair(jcfg, tcfg, seed=0):
    pj = jtfm.init_params(jax.random.PRNGKey(seed), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, pj)
    return pj, params_from_numpy(tree, tcfg)


def test_presets_match_reference_widths():
    assert set(ttfm.PRESETS) == set(jtfm.PRESETS)
    for name, tc in ttfm.PRESETS.items():
        jc = jtfm.PRESETS[name]
        for f in dataclasses.fields(tc):
            if f.name in ("dtype", "param_dtype"):
                continue
            assert getattr(tc, f.name) == getattr(jc, f.name), (name, f.name)
        assert (tc.head_dim, tc.kv_heads) == (jc.head_dim, jc.kv_heads)


@pytest.mark.parametrize("name", ["tiny", "narrow"])
def test_count_params_matches_reference(name):
    jc, tc = configs(name)
    pj, pt = param_pair(jc, tc)
    assert ttfm.count_params(pt) == jtfm.count_params(pj)


def test_rms_norm_rope_tables_apply_rope_match_reference():
    rng = np.random.default_rng(0)
    jc, tc = configs("narrow")
    x = rng.normal(size=(2, 9, 256)).astype(np.float32)
    s = rng.normal(size=(256,)).astype(np.float32)
    np.testing.assert_allclose(
        ttfm.rms_norm(torch.tensor(x), torch.tensor(s)).numpy(),
        np.asarray(jtfm.rms_norm(jnp.asarray(x), jnp.asarray(s))), **TOL)
    pos = rng.integers(0, 200, (2, 9))
    sj, cj = jtfm.rope_tables(jc, positions=jnp.asarray(pos))
    st, ct = ttfm.rope_tables(tc, positions=torch.tensor(pos))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), **TOL)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), **TOL)
    q = rng.normal(size=(2, 9, 2, 128)).astype(np.float32)
    np.testing.assert_allclose(
        ttfm.apply_rope(torch.tensor(q), st, ct).numpy(),
        np.asarray(jtfm.apply_rope(jnp.asarray(q), sj, cj)), **TOL)
    sj, cj = jtfm.rope_tables(jc, 9)
    st, ct = ttfm.rope_tables(tc, 9)
    np.testing.assert_allclose(
        ttfm.apply_rope(torch.tensor(q), st, ct).numpy(),
        np.asarray(jtfm.apply_rope(jnp.asarray(q), sj, cj)), **TOL)


@pytest.mark.parametrize("causal,H,K,masked", [
    (True, 4, 4, False), (False, 4, 4, False), (True, 4, 2, False),
    (True, 4, 1, True)])
def test_dense_attention_matches_reference(causal, H, K, masked):
    rng = np.random.default_rng(1)
    jc, tc = configs("tiny", causal=causal)
    q = rng.normal(size=(2, 12, H, 16)).astype(np.float32)
    k = rng.normal(size=(2, 12, K, 16)).astype(np.float32)
    v = rng.normal(size=(2, 12, K, 16)).astype(np.float32)
    mask = None
    if masked:
        mask = np.arange(12)[None, :] >= np.array([[0], [5]])
    want = jtfm._attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           jc, None if mask is None else jnp.asarray(mask))
    got = ttfm._attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                          tc, None if mask is None else torch.tensor(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", ["tiny", "narrow"])
@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_forward_logits_match_reference_f32(name, impl):
    jc, tc = configs(name, attn_impl="xla")
    tc = dataclasses.replace(tc, attn_impl=impl)
    pj, pt = param_pair(jc, tc)
    toks = np.random.default_rng(2).integers(0, 256, (2, 128))
    want = jtfm.forward(pj, jnp.asarray(toks), jc)
    got = ttfm.forward(pt, torch.tensor(toks), tc)
    assert got.dtype == torch.float32 and got.shape == (2, 128, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_forward_logits_match_reference_bf16():
    """bf16 rounds at different points in the two frameworks (XLA keeps
    some f32 intermediates that PyTorch's CPU bf16 matmuls round, and
    the head matmul's output is rounded to bf16 here before widening),
    so bf16 logits agree to a bf16-sized tolerance, 2e-2 absolute on
    logits of magnitude ~0.1, not to f32's 1e-4."""
    jc, tc = configs("narrow", "bf16", attn_impl="xla")
    pj, pt = param_pair(jc, tc)
    toks = np.random.default_rng(3).integers(0, 256, (2, 64))
    want = np.asarray(jtfm.forward(pj, jnp.asarray(toks), jc))
    got = ttfm.forward(pt, torch.tensor(toks), tc).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)


def test_resolve_attn_fn_policy():
    _, tc = configs("tiny")
    assert ttfm.default_attn_impl("cpu") == "xla"
    assert ttfm.default_attn_impl("cuda") == "flash"
    assert ttfm.resolve_attn_fn(tc, "cpu") is ttfm._attention
    assert ttfm.resolve_attn_fn(tc, "cuda") is ttfm._flash_attn_fn
    with pytest.raises(ValueError, match="attn_impl"):
        ttfm.resolve_attn_fn(dataclasses.replace(tc, attn_impl="ring"))
