"""Parity of ptype_tpu_torch.models.generate with the JAX reference:
prefill/decode steps, the paged steps, greedy generation token for
token, the logit filters exactly, and sampling by its distribution
(torch's Philox draws are not JAX's threefry draws)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptype_tpu.models import generate as jgen
from ptype_tpu.models import transformer as jtfm
from ptype_tpu_torch.models import generate as tgen
from ptype_tpu_torch.models import transformer as ttfm
from ptype_tpu_torch.models.weights import params_from_numpy

JCFG = jtfm.preset("tiny", dtype=jnp.float32)
TCFG = ttfm.preset("tiny", dtype=torch.float32)
TOL = dict(rtol=1e-4, atol=1e-4)
PJ = jtfm.init_params(jax.random.PRNGKey(0), JCFG)
PT = params_from_numpy(jax.tree_util.tree_map(np.asarray, PJ), TCFG)


def _toks(seed, shape):
    return np.random.default_rng(seed).integers(1, 256, shape)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("ragged", [False, True])
def test_prefill_and_decode_step_match_reference(ragged):
    B, S = 2, 24
    toks = _toks(1, (B, S))
    lens = np.array([24, 9]) if ragged else None
    cj = jgen.init_cache(JCFG, B, max_seq=64)
    ct = tgen.init_cache(TCFG, B, max_seq=64)
    lj, cj = jgen.prefill(PJ, jnp.asarray(toks), JCFG, cj,
                          prompt_lens=None if lens is None
                          else jnp.asarray(lens))
    lt, ct = tgen.prefill(PT, torch.tensor(toks), TCFG, ct,
                          prompt_lens=None if lens is None
                          else torch.tensor(lens))
    np.testing.assert_allclose(_np(lt), _np(lj), **TOL)
    np.testing.assert_allclose(_np(ct.k), _np(cj.k), **TOL)
    tok = np.array([5, 77])
    rope = None if lens is None else lens
    vf = None if lens is None else S - lens
    for i in range(3):
        lj, cj = jgen.decode_step(
            PJ, jnp.asarray(tok), S + i, JCFG, cj,
            rope_pos=None if rope is None else jnp.asarray(rope + i),
            valid_from=None if vf is None else jnp.asarray(vf))
        lt, ct = tgen.decode_step(
            PT, torch.tensor(tok), S + i, TCFG, ct,
            rope_pos=None if rope is None else torch.tensor(rope + i),
            valid_from=None if vf is None else torch.tensor(vf))
        np.testing.assert_allclose(_np(lt), _np(lj), **TOL)
        tok = _np(lt).argmax(-1)
    np.testing.assert_allclose(_np(ct.v), _np(cj.v), **TOL)


def test_prefill_last_index_matches_reference():
    toks = _toks(2, (2, 16))
    li = np.array([15, 6])
    lj, _ = jgen.prefill(PJ, jnp.asarray(toks), JCFG,
                         jgen.init_cache(JCFG, 2, 32),
                         last_index=jnp.asarray(li))
    lt, _ = tgen.prefill(PT, torch.tensor(toks), TCFG,
                         tgen.init_cache(TCFG, 2, 32),
                         last_index=torch.tensor(li))
    np.testing.assert_allclose(_np(lt), _np(lj), **TOL)


def test_flash_routing_rule_matches_reference():
    """Both packages send the same prefill shapes to the flash path."""
    for S in (64, 128, 256, 384, 1024, 2048, 3072):
        ref = S % 128 == 0 and S % min(1024, S) == 0
        assert tgen.use_flash_prefill(TCFG, S, False, "cuda") == ref, S
        assert not tgen.use_flash_prefill(TCFG, S, True, "cuda")
        assert not tgen.use_flash_prefill(TCFG, S, False, "cpu")
    flash = ttfm.preset("tiny", dtype=torch.float32, attn_impl="flash")
    assert tgen.use_flash_prefill(flash, 128, False, "cpu")


def test_flash_prefill_matches_dense_prefill():
    import dataclasses

    toks = torch.tensor(_toks(3, (2, 128)))
    flash = dataclasses.replace(TCFG, attn_impl="flash")
    ld, cd = tgen.prefill(PT, toks, TCFG, tgen.init_cache(TCFG, 2, 128))
    lf, cf = tgen.prefill(PT, toks, flash, tgen.init_cache(flash, 2, 128))
    np.testing.assert_allclose(lf.numpy(), ld.numpy(), **TOL)
    np.testing.assert_allclose(cf.k.numpy(), cd.k.numpy(), **TOL)


def _bank_pair(seed, n_blocks=20, bt=16):
    rng = np.random.default_rng(seed)
    shape = (JCFG.n_layers, n_blocks, bt, JCFG.kv_heads, JCFG.head_dim)
    kb = rng.normal(size=shape).astype(np.float32)
    vb = rng.normal(size=shape).astype(np.float32)
    return (jnp.asarray(kb), jnp.asarray(vb),
            torch.tensor(kb), torch.tensor(vb))


@pytest.mark.parametrize("impl", ["gather", "kernel"])
def test_decode_step_paged_matches_reference(impl):
    kbj, vbj, kbt, vbt = _bank_pair(4)
    tables = np.array([[3, 4, 5, 0], [7, 8, 0, 0], [0, 0, 0, 0]], np.int32)
    pos = np.array([40, 17, 0], np.int32)
    wr_b = np.array([5, 8, 0], np.int32)
    wr_o = pos % 16
    tok = np.array([9, 10, 0])
    lj, kbj, vbj = jgen.decode_step_paged(
        PJ, jnp.asarray(tok), jnp.asarray(pos), JCFG, kbj, vbj,
        jnp.asarray(tables), jnp.asarray(wr_b), jnp.asarray(wr_o),
        attn_impl=impl, interpret=True)
    lt, kbt, vbt = tgen.decode_step_paged(
        PT, torch.tensor(tok), torch.tensor(pos), TCFG, kbt, vbt,
        torch.tensor(tables), torch.tensor(wr_b), torch.tensor(wr_o),
        attn_impl=impl)
    np.testing.assert_allclose(_np(lt)[:2], _np(lj)[:2], **TOL)
    np.testing.assert_allclose(_np(kbt)[:, 1:], _np(kbj)[:, 1:], **TOL)


def test_prefill_paged_chunk_matches_reference():
    kbj, vbj, kbt, vbt = _bank_pair(5)
    table = np.array([2, 6, 9, 0], np.int32)
    toks = np.zeros((1, 32), np.int64)
    toks[0, :21] = _toks(6, 21)
    for start, length in ((0, 16), (16, 5)):
        chunk = np.zeros((1, 32), np.int64)
        chunk[0, :length] = toks[0, start:start + length]
        lj, kbj, vbj = jgen.prefill_paged_chunk(
            PJ, jnp.asarray(chunk), jnp.int32(start), jnp.int32(length),
            JCFG, kbj, vbj, jnp.asarray(table))
        lt, kbt, vbt = tgen.prefill_paged_chunk(
            PT, torch.tensor(chunk), start, length, TCFG, kbt, vbt,
            torch.tensor(table))
        np.testing.assert_allclose(_np(lt), _np(lj), **TOL)
    np.testing.assert_allclose(_np(kbt)[:, 1:], _np(kbj)[:, 1:], **TOL)


@pytest.mark.parametrize("kw", [
    {}, {"stop_token": 239, "pad_token": 0},
    {"repetition_penalty": 1.3}])
def test_greedy_generate_matches_reference_token_for_token(kw):
    toks = _toks(7, (2, 20))
    want = jgen.generate(PJ, JCFG, jnp.asarray(toks), 12, **kw)
    got = tgen.generate(PT, TCFG, torch.tensor(toks), 12, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ragged_greedy_generate_matches_reference():
    prompts = [_toks(8, 5), _toks(9, 17), _toks(10, 11)]
    pj, lj = jgen.pad_prompts(prompts)
    pt, lt = tgen.pad_prompts(prompts)
    assert np.array_equal(pt.numpy(), np.asarray(pj))
    want = jgen.generate(PJ, JCFG, pj, 10, prompt_lens=lj)
    got = tgen.generate(PT, TCFG, pt, 10, prompt_lens=lt)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_generate_validates_like_reference():
    p = torch.zeros((1, 8), dtype=torch.int64)
    with pytest.raises(ValueError, match="max_seq"):
        tgen.generate(PT, TCFG, p, 200)
    with pytest.raises(ValueError, match="top_p"):
        tgen.generate(PT, TCFG, p, 4, temperature=1.0, top_p=0.0)
    with pytest.raises(ValueError, match="repetition_penalty"):
        tgen.generate(PT, TCFG, p, 4, repetition_penalty=0.0)


@pytest.mark.parametrize("top_k,top_p", [
    (0, 1.0), (5, 1.0), (0, 0.7), (7, 0.5), (300, 0.95), (1, 1.0)])
def test_filters_match_reference_exactly(top_k, top_p):
    logits = np.random.default_rng(top_k).normal(
        size=(3, 64)).astype(np.float32) * 3
    want = np.asarray(jgen._filter_logits(jnp.asarray(logits), top_k, top_p))
    got = tgen._filter_logits(torch.tensor(logits), top_k, top_p).numpy()
    np.testing.assert_array_equal(got, want)
    for row in range(3):
        want = np.asarray(jgen._filter_logits_traced(
            jnp.asarray(logits[row]), jnp.int32(top_k), jnp.float32(top_p)))
        got = tgen._filter_logits_traced(torch.tensor(logits[row]), top_k,
                                         top_p).numpy()
        np.testing.assert_array_equal(got, want)


def test_sample_token_rows_draws_from_the_filtered_softmax():
    """The distribution contract: N draws of a temperature-scaled,
    top-k-filtered row land on each token with the softmax's
    probability (max deviation < 0.02 at N = 4000, ~4.5 sigma) and
    never outside the top-k set."""
    logits = torch.tensor([[2.0, 1.0, 0.5, 0.0, -1.0, -3.0]])
    t, k = 0.8, 4
    g = torch.Generator().manual_seed(0)
    n = 4000
    counts = np.zeros(6)
    for _ in range(n):
        counts[int(tgen.sample_token_rows(logits, [g], [t], [k], [1.0])[0])] += 1
    want = torch.softmax(logits[0, :k] / t, dim=0).numpy()
    assert counts[k:].sum() == 0
    assert np.abs(counts[:k] / n - want).max() < 0.02
    # Greedy rows (temperature 0) take the argmax and draw nothing.
    assert int(tgen.sample_token_rows(logits, [None], [0.0], [0],
                                      [1.0])[0]) == 0


def test_sampled_generate_is_seeded_and_top_k_one_is_greedy():
    p = torch.tensor(_toks(11, (1, 12)))
    a = tgen.generate(PT, TCFG, p, 10, 1.0, torch.Generator().manual_seed(4))
    b = tgen.generate(PT, TCFG, p, 10, 1.0, torch.Generator().manual_seed(4))
    assert torch.equal(a, b)
    greedy = tgen.generate(PT, TCFG, p, 10)
    k1 = tgen.generate(PT, TCFG, p, 10, 1.0,
                       torch.Generator().manual_seed(4), top_k=1)
    assert torch.equal(k1, greedy)
