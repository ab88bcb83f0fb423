"""The port's serving path: BlockPool invariants and hashes equal to
the reference's, the paged engine token for token against the port's
contiguous generate (mid-decode joins included) and the reference's,
kernel-vs-gather engines, sampled single-row solo parity, typed sheds,
the engine's leak and shed checks (prefix eviction under pressure, the
chunked-prefill stall bar, a multi-row shed's withdrawn siblings, a
cancelled live row) and the GeneratorActor endpoints."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptype_tpu.models import generate as jgen
from ptype_tpu.models import transformer as jtfm
from ptype_tpu.serve_engine import PagedGeneratorActor as JPaged
from ptype_tpu.serve_engine import blocks as jblocks
from ptype_tpu_torch.errors import ShedError
from ptype_tpu_torch.health.goodput import GoodputLedger
from ptype_tpu_torch.models import generate as tgen
from ptype_tpu_torch.models import transformer as ttfm
from ptype_tpu_torch.models.weights import init_params, params_from_numpy
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



def test_used_blocks_equals_stats_through_alloc_ref_deref_seal():
    pool = BlockPool(CFG, n_blocks=6, block_tokens=16)

    def agree(n):
        assert pool.used_blocks() == n
        assert pool.stats()["kv_used_blocks"] == n

    agree(0)
    assert pool.try_reserve(3)
    a, b = pool.alloc(), pool.alloc()
    agree(2)
    toks = list(range(16))
    pool.seal(a, block_hashes(toks, 16)[0], toks)
    agree(2)
    pool.ref(a)                 # a second holder: still one block
    agree(2)
    pool.deref(a)
    agree(2)
    pool.deref(a)               # sealed, refcount 0: cached, not used
    agree(1)
    pool.ref(a)                 # back from the cache
    agree(2)
    for bid in (a, b):
        pool.deref(bid)
    agree(0)
    assert pool.check_invariants() == []


# ------------------------------------------- leak and shed checks


def test_prefix_cache_evicts_under_pressure_and_stays_sound():
    """A pool smaller than the working set (8 usable blocks, prompts of
    3 blocks each): cached prefix blocks are evicted LRU, counters tick,
    invariants hold, and every request equals the port's solo generate
    and the reference engine's at the same weights."""
    pj = jtfm.init_params(jax.random.PRNGKey(0), JCFG)
    pt = params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), CFG)
    actor = _engine(params=pt, n_slots=2, n_blocks=9, max_len=64)
    ref = JPaged(JCFG, params=pj, n_slots=2, block_tokens=16, n_blocks=9,
                 max_len=64)
    try:
        prompts = [_prompt(33) for _ in range(4)]
        for p in prompts:
            got = actor.Generate(p, 4)
            assert torch.equal(got, tgen.generate(actor.params, CFG, p, 4))
            np.testing.assert_array_equal(
                got.numpy(),
                np.asarray(ref.Generate(jnp.asarray(p.numpy(),
                                                    jnp.int32), 4)))
        st = actor.pool.stats()
        assert st["kv_evictions"] > 0, st
        assert st["kv_evictions"] == ref.pool.stats()["kv_evictions"]
        assert actor.pool.check_invariants() == []
        assert st["kv_used_blocks"] == 0 and actor.pool.used_blocks() == 0
    finally:
        actor.close()
        ref.close()


def test_chunked_prefill_bounds_co_batched_decode_stall():
    """The interference bar: one long prompt admitted while a decode is
    live. Whole-prompt admission stalls the co-batched decode for the
    full prefill; chunked admission bounds the per-step stall to one
    chunk — the engine's own stall meter, with the goodput ledger's
    serve-side prefill leg cross-checking. The reference's bar: the
    chunked drive's median stall under 0.75 x the whole-prompt drive's
    largest, both drives re-run (up to twice) only when it is unmet."""
    # Wide enough that a chunk's compute dominates dispatch (the
    # reference's shape for the same reason).
    cfg = ttfm.preset("tiny", d_model=256, n_layers=4, d_ff=512,
                      dtype=torch.float32)
    long_p = torch.as_tensor(RNG.integers(1, cfg.vocab_size, 96))[None]
    # Same length, different content: warming with long_p would seal its
    # blocks and both drives would prefix-hit down to one tail chunk.
    warm_p = torch.as_tensor(RNG.integers(1, cfg.vocab_size, 96))[None]
    short = torch.zeros((1, 4), dtype=torch.int64)
    params = init_params(torch.Generator().manual_seed(0), cfg,
                         device="cpu")

    def drive(prefill_chunk):
        # One intra-op thread while the stalls are timed: torch's CPU
        # ops fork-join over a pool of a thread a core, and on a host
        # whose cores other processes keep busy each op then waits for
        # its slowest pool thread, whatever its size — a 16-token chunk
        # stalls as long as the 96-token prompt. On the calling thread
        # an op's time is its compute, the quantity the bar compares.
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            return _drive(prefill_chunk)
        finally:
            torch.set_num_threads(threads)

    def _drive(prefill_chunk):
        actor = PagedGeneratorActor(cfg, params=params, n_slots=2,
                                    block_tokens=16,
                                    prefill_chunk=prefill_chunk,
                                    device="cpu")
        ledger = GoodputLedger(step_name="serve.step").install()
        stalls: list[float] = []
        rec0 = actor._record_stall
        actor._record_stall = lambda ms: (stalls.append(ms),
                                          rec0(ms))[-1]
        try:
            actor.Generate(warm_p, 2)
            actor.Generate(short, 2)
            actor._max_stall_ms = actor._last_stall_ms = 0.0
            stalls.clear()
            done = threading.Event()
            # The co-batched decode must outlive the long prompt's
            # admission: 120 steps (the reference's 48 ran out first on
            # a loaded host, leaving no stall to compare).
            # The long prompt goes in once the decode has stepped: sent
            # between the short row's admission and its first step, it
            # joined that admission round, before any decode was live to
            # stall, and the whole-prompt drive recorded no stall.
            steps0 = actor.Info()["engine_steps"]
            t = threading.Thread(target=lambda: (
                actor.Generate(short, 120), done.set()))
            t.start()
            while not done.is_set():
                info = actor.Info()
                if info["live_slots"] >= 1 and info["engine_steps"] > steps0:
                    break
                time.sleep(0.002)
            out = actor.Generate(long_p, 4)
            t.join(timeout=120)
            assert not t.is_alive()
            meter = actor.Info()["prefill_stall_ms"]
            return out, [s for s in stalls if s > 0.05], meter, \
                ledger.records()
        finally:
            ledger.uninstall()
            actor.close()

    out_c, stalls_c, meter_c, recs = drive(16)
    out_w, stalls_w, meter_w, _ = drive(None)  # None: the whole prompt
    assert torch.equal(out_c, out_w)
    for _ in range(2):
        if (len(stalls_c) >= 6
                and float(np.median(stalls_c)) < 0.75 * max(stalls_w)):
            break
        out_c, stalls_c, meter_c, recs = drive(16)
        out_w, stalls_w, meter_w, _ = drive(None)
        assert torch.equal(out_c, out_w)
    stall_whole = max(stalls_w)
    stall_chunked = float(np.median(stalls_c))
    assert len(stalls_c) >= 6, stalls_c
    assert stall_chunked < 0.75 * stall_whole, (stalls_c, stalls_w)
    assert meter_w >= stall_whole - 0.01 and meter_c > 0
    assert any(r["prefill_ms"] > 0 for r in recs), recs[-5:]


def test_multirow_shed_leaves_no_orphaned_work():
    """A multi-row request one of whose rows sheds at the admit timeout
    withdraws its siblings: nothing keeps queuing or decoding output the
    caller will never read, and the pool drains. Capacity 8 covers
    exactly one row's worst case (4 + 120 tokens -> 8 blocks)."""
    actor = _engine(n_slots=2, n_blocks=9, admit_timeout_s=0.2)
    try:
        with pytest.raises(ShedError):
            actor.Generate(torch.zeros((3, 4), dtype=torch.int64), 120)
        s0 = actor.Info()["engine_steps"]
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            info = actor.Info()
            if (info["live_slots"] == 0 and info["queue_depth"] == 0
                    and actor.pool.used_blocks() == 0):
                break
            time.sleep(0.01)
        info = actor.Info()
        assert info["live_slots"] == 0
        assert info["queue_depth"] == 0
        assert actor.pool.used_blocks() == 0
        assert actor.Info()["engine_steps"] - s0 < 60
    finally:
        actor.close()


def test_cancel_rows_retires_active_row_and_frees_blocks():
    """White-box: flagging a LIVE row through ``_cancel_rows`` makes the
    engine retire it at the next boundary and free its blocks."""
    actor = _engine(n_slots=1)
    try:
        t = threading.Thread(target=lambda: actor.Generate(
            torch.zeros((1, 4), dtype=torch.int64), 120))
        t.start()
        deadline = time.monotonic() + 30
        while (actor.Info()["live_slots"] < 1
               and time.monotonic() < deadline):
            time.sleep(0.002)
        slot = int(np.flatnonzero(actor._active)[0])
        row = actor._slot_state[slot]
        actor._cancel_rows([row])
        deadline = time.monotonic() + 30
        while (actor.pool.used_blocks() > 0
               and time.monotonic() < deadline):
            time.sleep(0.01)
        assert actor.pool.used_blocks() == 0
        assert len(row.emitted) < 120
        t.join(timeout=120)
        assert not t.is_alive()
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


# --------------------------------------------- dispatch discipline


def test_steady_state_decode_builds_nothing_armed():
    """The armed serve tier, twin of the reference's: after one warmup
    request a steady stream of same-shaped requests builds nothing, the
    decode region's guard held (an unsanctioned host synchronisation in
    a step would have raised, failing the drive), and the books show a
    step's one host read and the reference's upload contract: a step
    after an admission builds the device mirror of the slot state (eight
    uploads), and every later step uploads nothing. Greedy tokens equal
    the reference engine's on the same weights."""
    from ptype_tpu_torch import jitwatch

    pj = jtfm.init_params(jax.random.PRNGKey(0), JCFG)
    pt = params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), CFG)
    p = _prompt(5, np.random.default_rng(11))
    ref = JPaged(JCFG, params=pj, n_slots=2, block_tokens=16)
    try:
        want = np.asarray(ref.Generate(jnp.asarray(p.numpy()), 8))
    finally:
        ref.close()
    jw = jitwatch.enable()
    actor = _engine(params=pt, n_slots=2)
    step, mirror = actor._plain_step, actor._mirror
    per_step, builds = [], []

    def counted_step():
        n = jw.sanctioned().get("serve.slot_state", 0)
        step()
        per_step.append(jw.sanctioned()["serve.slot_state"] - n)

    def counted_mirror():
        builds.append(actor._sdev is None)
        return mirror()

    actor._plain_step, actor._mirror = counted_step, counted_mirror
    try:
        warm = actor.Generate(p, 8).numpy()
        jw.mark_steady()
        for _ in range(3):
            np.testing.assert_array_equal(actor.Generate(p, 8).numpy(),
                                          warm)
        assert jw.recompiles_since_steady() == {}
        assert jw.recompiles() == {} and jw.storms() == []
        rep = jw.report()
        assert rep["hot_regions"] > 0  # the guard was LIVE
        books = jw.sanctioned()
        # Four requests of 8 tokens: the first from the prefill, then
        # seven decode steps each.
        assert books["serve.decode_read"] == actor._steps == 4 * 7
    finally:
        actor.close()
        jitwatch.disable()
    # After the close: the engine thread has booked its last step. 5 + 8
    # tokens fit one block, so each request's first step builds (after
    # its admission) and its six others upload nothing.
    assert per_step == [8, 0, 0, 0, 0, 0, 0] * 4
    assert books["serve.slot_state"] == 8 * sum(builds) == 8 * 4
    np.testing.assert_array_equal(warm, want)
