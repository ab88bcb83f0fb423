"""The port's ``BatchingGeneratorActor`` against the JAX reference's, in
f32 on the CPU at ``tiny``: concurrent greedy requests coalesce into
one round and every caller's rows equal the reference batcher's and
its solo decode (same-shape, mixed shapes, mixed lengths); sampled
requests take the solo path with its exact RNG; an equal-length batch
with S a multiple of 128 runs the flash prefill and a left-padded one
does not. Tokens are compared exactly; prompts are numpy, seeded."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptype_tpu import serve as jserve
from ptype_tpu.models import transformer as jtfm
from ptype_tpu_torch import serve
from ptype_tpu_torch.models import generate as tgen
from ptype_tpu_torch.models import transformer as ttfm
from ptype_tpu_torch.models.weights import params_from_numpy
from ptype_tpu_torch.ops import flash_attention as flash_mod

JCFG = jtfm.preset("tiny", dtype=jnp.float32, max_seq=256)
CFG = ttfm.preset("tiny", dtype=torch.float32, max_seq=256)


@pytest.fixture(scope="module")
def trees():
    pj = jtfm.init_params(jax.random.PRNGKey(0), JCFG)
    return pj, params_from_numpy(jax.tree_util.tree_map(np.asarray, pj),
                                 CFG)


def _concurrent(actor, prompts, max_new):
    """Every prompt from its own thread, released together so they
    land inside one batching window."""
    outs = [None] * len(prompts)
    barrier = threading.Barrier(len(prompts))

    def call(i):
        barrier.wait()
        outs[i] = actor.Generate(prompts[i], max_new)

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert all(o is not None for o in outs)
    return outs


def _both(trees, **kw):
    pj, pt = trees
    return (jserve.BatchingGeneratorActor(JCFG, params=pj, **kw),
            serve.BatchingGeneratorActor(CFG, params=pt, device="cpu", **kw))


@pytest.mark.parametrize("lens", [(4,) * 6, (3, 5, 8, 6)],
                         ids=["same_shape", "mixed_lengths"])
def test_batching_coalesces_and_matches_the_reference_and_solo(trees,
                                                               lens):
    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, CFG.vocab_size, n)[None] for n in lens]
    ref, actor = _both(trees, window_ms=200.0, max_batch=16)
    try:
        want = _concurrent(ref, [jnp.asarray(p) for p in prompts], 5)
        got = _concurrent(actor, [torch.as_tensor(p) for p in prompts], 5)
        for i, p in enumerate(prompts):
            assert got[i].tolist() == np.asarray(want[i]).tolist(), i
            solo = tgen.generate(actor.params, CFG, torch.as_tensor(p), 5)
            assert torch.equal(got[i], solo), i
        info = actor.Info()
        assert info["batched_requests"] == len(prompts)
        assert info["batches"] < len(prompts)
        assert info["queue_depth"] == 0 and info["in_flight"] == 0
        assert set(ref.Info()) <= set(info)
    finally:
        ref.close()
        actor.close()


def test_batching_mixed_shapes_and_sampled_requests(trees):
    """Rows of different requests split by max_new; a multi-row request
    batches whole; a sampled request keeps the solo path's RNG."""
    _, pt = trees
    actor = serve.BatchingGeneratorActor(CFG, params=pt, device="cpu",
                                         window_ms=50.0)
    solo = serve.GeneratorActor(CFG, params=pt, device="cpu")
    try:
        a = actor.Generate(torch.zeros((1, 4), dtype=torch.int64), 3)
        b = actor.Generate(torch.ones((2, 8), dtype=torch.int64), 4)
        assert a.shape == (1, 3) and b.shape == (2, 4)
        assert torch.equal(b, solo.Generate(torch.ones((2, 8),
                                                       dtype=torch.int64), 4))
        kw = dict(temperature=0.7, seed=11, top_k=20)
        s = actor.Generate(torch.zeros((1, 4), dtype=torch.int64), 3, **kw)
        assert torch.equal(s, solo.Generate(
            torch.zeros((1, 4), dtype=torch.int64), 3, **kw))
        assert actor.Info()["batches"] == 2  # the sampled one went solo
    finally:
        actor.close()


def test_equal_length_batches_take_the_flash_prefill_ragged_ones_do_not(
        trees, monkeypatch):
    """The flash prefill needs uniform rows with S a multiple of 128: an
    equal-length batch (4 × 128) calls it once a layer, a mixed-length
    batch (left-padded, masked) never. Tokens equal the reference
    batcher's either way."""
    pj, pt = trees
    calls = []
    real = flash_mod.flash_attention

    def spy(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    monkeypatch.setattr(flash_mod, "flash_attention", spy)
    fcfg = ttfm.preset("tiny", dtype=torch.float32, max_seq=256,
                       attn_impl="flash")
    ref = jserve.BatchingGeneratorActor(JCFG, params=pj, window_ms=300.0)
    actor = serve.BatchingGeneratorActor(fcfg, params=pt, device="cpu",
                                         window_ms=300.0)
    rng = np.random.default_rng(4)
    try:
        for lens, want_calls in (((128,) * 4, CFG.n_layers),
                                 ((100, 128, 70, 128), 0)):
            calls.clear()
            prompts = [rng.integers(1, CFG.vocab_size, n)[None]
                       for n in lens]
            b0 = actor.Info()["batches"]
            got = _concurrent(actor, [torch.as_tensor(p) for p in prompts],
                              4)
            want = _concurrent(ref, [jnp.asarray(p) for p in prompts], 4)
            assert actor.Info()["batches"] == b0 + 1
            assert len(calls) == want_calls, (lens, calls)
            assert all(tuple(c[:2]) == (4, 128) for c in calls)
            for g, w in zip(got, want):
                assert g.tolist() == np.asarray(w).tolist()
    finally:
        ref.close()
        actor.close()


def test_pow2_buckets_and_lifecycle_codes_equal_the_reference():
    for n in range(1, 40):
        assert serve._pow2(n) == jserve._pow2(n)
    assert serve.LIFECYCLES == jserve.LIFECYCLES
    assert serve.LIFECYCLE_CODES == jserve.LIFECYCLE_CODES


def test_batching_actor_drains_and_refuses_after_close(trees):
    _, pt = trees
    actor = serve.BatchingGeneratorActor(CFG, params=pt, device="cpu")
    one = torch.ones((1, 4), dtype=torch.int64)
    assert actor.Generate(one, 2).shape == (1, 2)
    actor.begin_drain()
    with pytest.raises(serve.ShedError, match="draining"):
        actor.Generate(one, 2)
    assert actor.drained()
    actor.close()
    closed = serve.BatchingGeneratorActor(CFG, params=pt, device="cpu")
    closed.close()
    with pytest.raises(RuntimeError, match="closed"):
        closed.Generate(one, 2)
