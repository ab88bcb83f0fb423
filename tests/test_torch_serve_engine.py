"""The port's serving path: BlockPool invariants and hashes equal to
the reference's, the paged engine token for token against the port's
contiguous generate (mid-decode joins included) and the reference's,
kernel-vs-gather engines, sampled single-row solo parity, typed sheds
and the GeneratorActor endpoints."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptype_tpu.models import generate as jgen
from ptype_tpu.models import transformer as jtfm
from ptype_tpu.serve_engine import blocks as jblocks
from ptype_tpu_torch.errors import ShedError
from ptype_tpu_torch.models import generate as tgen
from ptype_tpu_torch.models import transformer as ttfm
from ptype_tpu_torch.models.weights import params_from_numpy
from ptype_tpu import serve as jserve
from ptype_tpu_torch.serve import GeneratorActor, _norm_prompt, _pow2
from ptype_tpu_torch.serve_engine import (BlockPool, PagedGeneratorActor,
                                          block_hashes,
                                          prefix_affinity_key)

CFG = ttfm.preset("tiny", dtype=torch.float32)
JCFG = jtfm.preset("tiny", dtype=jnp.float32)
RNG = np.random.default_rng(7)


def _prompt(n, rng=RNG):
    return torch.as_tensor(rng.integers(1, CFG.vocab_size, n))[None]


def _engine(**kw):
    kw.setdefault("device", "cpu")
    kw.setdefault("block_tokens", 16)
    return PagedGeneratorActor(CFG, **kw)


# ------------------------------------------------------- pool (unit)


def test_block_pool_refcount_reuse_eviction_invariants():
    pool = BlockPool(CFG, n_blocks=5, block_tokens=16)
    assert pool.capacity == 4 and pool.free_blocks() == 4
    assert pool.k.shape == (2, 5, 16, 4, 16) and pool.k.dtype == torch.float32
    assert pool.try_reserve(3)
    assert not pool.try_reserve(2)
    a, b = pool.alloc(), pool.alloc()
    toks = list(range(16))
    h = block_hashes(toks, 16)[0]
    pool.seal(a, h, toks)
    assert pool.lookup(h, toks) == a
    assert pool.lookup(h, list(range(1, 17))) is None
    pool.deref(a)
    pool.deref(b)
    assert pool.lookup(h, toks) == a
    pool.unreserve(1)
    assert pool.check_invariants() == []
    assert pool.try_reserve(1)
    pool.ref(a)
    st = pool.stats()
    assert st["kv_used_blocks"] == 1 and st["kv_cached_blocks"] == 0
    pool.deref(a)
    assert pool.try_reserve(4)
    got = [pool.alloc() for _ in range(4)]
    assert a in got and pool.lookup(h, toks) is None
    assert pool.evictions >= 1
    for bid in got:
        pool.deref(bid)
    assert pool.check_invariants() == [] and pool.free_blocks() == 4
    with pytest.raises(ValueError, match="divide"):
        BlockPool(CFG, n_blocks=4, block_tokens=12)


def test_block_hashes_and_affinity_keys_equal_the_reference():
    toks = list(RNG.integers(1, 200, 70))
    assert block_hashes(toks, 16) == jblocks.block_hashes(toks, 16)
    assert (prefix_affinity_key(toks, 16)
            == jblocks.prefix_affinity_key(toks, 16))
    assert prefix_affinity_key(toks[:15], 16) is None


# ---------------------------------------------------------- parity


def test_paged_engine_matches_contiguous_greedy_with_mid_decode_joins():
    actor = _engine(n_slots=4, prefill_chunk=24)
    try:
        lens = (3, 17, 5, 33, 4, 21)
        news = (6, 12, 9, 5, 10, 7)
        prompts = [_prompt(n) for n in lens]
        outs = [None] * len(prompts)

        def call(i, delay):
            time.sleep(delay)
            outs[i] = actor.Generate(prompts[i], news[i])

        threads = [threading.Thread(target=call, args=(i, 0.02 * (i % 3)))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        for i, p in enumerate(prompts):
            want = tgen.generate(actor.params, CFG, p, news[i])
            assert torch.equal(outs[i], want), i
        info = actor.Info()
        assert info["max_live_slots"] >= 2, info
        assert actor.pool.check_invariants() == []
        assert info["kv_used_blocks"] == 0
    finally:
        actor.close()


def test_paged_engine_matches_reference_generate_greedy():
    pj = jtfm.init_params(jax.random.PRNGKey(0), JCFG)
    pt = params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), CFG)
    actor = _engine(params=pt, n_slots=2, prefill_chunk=16)
    try:
        for n in (7, 40):
            p = _prompt(n)
            want = jgen.generate(pj, JCFG, jnp.asarray(p.numpy()), 9)
            np.testing.assert_array_equal(actor.Generate(p, 9).numpy(),
                                          np.asarray(want))
    finally:
        actor.close()


def test_kernel_attn_engine_matches_gather_engine_with_prefix_reuse():
    a = _engine(n_slots=2)
    b = _engine(params=a.params, n_slots=2, attn="kernel")
    try:
        shared = _prompt(48)[0]
        for tail in (5, 9):
            p = torch.cat([shared, _prompt(tail)[0]])[None]
            assert torch.equal(a.Generate(p, 10), b.Generate(p, 10))
        assert b.Info()["prefix_hit_rate"] == 0.5  # 3 of 6 full blocks
        assert b.Info()["attn"] == "kernel"
    finally:
        a.close()
        b.close()


def test_sampled_single_row_rides_engine_with_solo_parity():
    actor = _engine(n_slots=2)
    try:
        p = _prompt(13)
        kw = dict(temperature=0.9, seed=11, top_k=30, top_p=0.9)
        got = actor.Generate(p, 8, **kw)
        want = GeneratorActor.Generate(actor, p, 8, **kw)
        assert torch.equal(got, want)
        assert actor.Info()["engine_steps"] > 0
    finally:
        actor.close()


def test_stop_token_pads_and_retires():
    actor = _engine(n_slots=2)
    try:
        p = _prompt(9)
        free = actor.Generate(p, 8)
        stop = int(free[0, 2])
        got = actor.Generate(p, 8, stop_token=stop, pad_token=-1)
        want = tgen.generate(actor.params, CFG, p, 8, stop_token=stop,
                             pad_token=-1)
        assert torch.equal(got, want)
        assert actor.pool.check_invariants() == []
    finally:
        actor.close()


# ------------------------------------------------------- admission


def test_queue_full_and_drain_shed_typed():
    actor = _engine(n_slots=1, max_queue=1)
    try:
        with pytest.raises(ShedError) as ei:
            actor.Generate(torch.cat([_prompt(4)] * 2), 4)  # 2 rows > 1
        assert ei.value.retry_after_s > 0
        actor.begin_drain()
        with pytest.raises(ShedError, match="draining"):
            actor.Generate(_prompt(4), 4)
        assert actor.drained()
    finally:
        actor.close()


def test_admit_timeout_sheds_when_pool_exhausted():
    # 8 usable blocks: one 4+120-token request holds all of them.
    actor = _engine(n_slots=2, n_blocks=9, admit_timeout_s=0.1)
    try:
        out = {}

        def long():
            out["a"] = actor.Generate(_prompt(4), 120)

        t = threading.Thread(target=long)
        t.start()
        time.sleep(0.05)
        with pytest.raises(ShedError, match="exhausted"):
            actor.Generate(_prompt(4), 120)
        t.join(timeout=120)
        assert out["a"].shape == (1, 120)
        assert actor.pool.check_invariants() == []
    finally:
        actor.close()


def test_request_validation():
    actor = _engine(n_slots=1, max_len=64)
    try:
        with pytest.raises(ValueError, match="reach"):
            actor.Generate(_prompt(60), 10)
        assert actor.Generate(_prompt(4), 0).shape == (1, 0)
        with pytest.raises(ValueError, match="attn"):
            _engine(attn="flash")
    finally:
        actor.close()


# ------------------------------------------------------ GeneratorActor


def test_generator_actor_endpoints_match_reference():
    pj = jtfm.init_params(jax.random.PRNGKey(1), JCFG)
    pt = params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), CFG)
    actor = GeneratorActor(CFG, params=pt, device="cpu")
    toks = RNG.integers(1, 256, (2, 16))
    np.testing.assert_allclose(
        actor.Logits(toks).numpy(),
        np.asarray(jtfm.forward(pj, jnp.asarray(toks), JCFG)),
        rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(
        actor.Generate(toks, 6).numpy(),
        np.asarray(jgen.generate(pj, JCFG, jnp.asarray(toks), 6)))
    info = actor.Info()
    assert info["calls"] == 1 and info["n_params"] == sum(
        x.size for x in jax.tree_util.tree_leaves(pj))
    assert info["memory"] == {} and info["device"] == "cpu"
    actor.begin_drain()
    with pytest.raises(ShedError):
        actor.Generate(toks, 2)
    assert actor.drained()


def test_prompt_normalization_and_pow2_match_reference():
    for n in (1, 2, 3, 17, 64, 65, 1000):
        assert _pow2(n) == jserve._pow2(n)
    p = _norm_prompt(np.arange(5), "cpu")
    assert p.shape == (1, 5) and p.dtype == torch.int64
    assert _norm_prompt([[1, 2]], "cpu").shape == (1, 2)
