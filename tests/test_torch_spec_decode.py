"""Speculative decoding in the port, in f32 on the CPU at ``tiny``.

Port function against reference function: the greedy acceptance chain,
the verify step's logits and bank writes, the draft's greedy proposals,
and the zero-copy truncated draft. Then the port's own contracts, as
``tests/test_spec_decode.py`` holds the reference to them: co-batched
greedy speculative output identical to the plain engine and to the
reference engine (with a draft that accepts nearly everything and one
that accepts nothing), the sampled acceptance distribution against the
target's, the bonus token on a full accept, a stop token mid-window,
prefix reuse, both pools reserved at admission and the worst-case audit
under pool pressure, the draft caught up after plain steps, and adaptive
k. Torch's generators are not JAX's keys, so sampled tests compare
distributions, never draws."""

import threading
import time
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from ptype_tpu.models import generate as jgen
from ptype_tpu.models import transformer as jtfm
from ptype_tpu.serve_engine import PagedGeneratorActor as JPaged
from ptype_tpu_torch.errors import ShedError
from ptype_tpu_torch.models import generate as tgen
from ptype_tpu_torch.models import transformer as ttfm
from ptype_tpu_torch.models.weights import params_from_numpy
from ptype_tpu_torch.serve_engine import (BlockPool, PagedGeneratorActor,
                                          SpecConfig)

JCFG = jtfm.preset("tiny", dtype=jnp.float32)
CFG = ttfm.preset("tiny", dtype=torch.float32)
PJ = jtfm.init_params(jax.random.PRNGKey(0), JCFG)
PT = params_from_numpy(jax.tree_util.tree_map(np.asarray, PJ), CFG)
#: Logits of the same f32 forward in both packages (sums in other orders).
LOGIT_TOL = dict(rtol=0, atol=1e-5)


def _prompt(n, seed):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(1, 256, n))[None]


def _friendly():
    """The layer-truncated draft: it agrees with the random-init target
    nearly always (the residual blocks barely move the logits)."""
    return tgen.truncated_draft_params(PT, CFG, n_layers=1)


def _hostile():
    """A draft that never agrees: an untied head rolled one vocab slot,
    so it proposes (target's pick − 1)."""
    emb = PT["embed"]
    return (dict(PT, lm_head=torch.roll(emb, -1, dims=0).T.contiguous()),
            replace(CFG, tie_embeddings=False))


def _engine(draft=None, k=3, adaptive=False, **kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("block_tokens", 16)
    spec = None
    if draft is not None:
        dp, dc = draft
        spec = SpecConfig(draft_params=dp, draft_cfg=dc, k=k,
                          adaptive=adaptive, **kw.pop("spec_kw", {}))
    return PagedGeneratorActor(CFG, params=PT, device="cpu", spec=spec, **kw)


def _co_batched(engine, prompts, news, stagger=0.0):
    outs = [None] * len(prompts)

    def call(i):
        time.sleep(stagger * (i % 3))
        outs[i] = np.asarray(engine.Generate(prompts[i], news[i]))

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert all(o is not None for o in outs)
    return outs


# ------------------------------------------------ function against function


def test_spec_accept_rows_greedy_chain_matches_reference():
    rng = np.random.default_rng(3)
    k, V, B = 4, 13, 8
    tlg = rng.normal(size=(B, k + 1, V)).astype(np.float32)
    draft = rng.integers(0, V, (B, k))
    gt = tlg.argmax(-1)
    for b in range(B):  # every accept length, 0..k
        draft[b, :b % (k + 1)] = gt[b, :b % (k + 1)]
    zeros = np.zeros((B,), np.float32)
    want_out, want_acc = jgen.spec_accept_rows(
        jnp.asarray(draft, jnp.int32), jnp.zeros((B, k, V), jnp.float32),
        jnp.asarray(tlg), jnp.zeros((B, 2), jnp.uint32),
        jnp.zeros((B,), jnp.int32), jnp.asarray(zeros),
        jnp.zeros((B,), jnp.int32), jnp.ones((B,), jnp.float32),
        sampled=False)
    for sampled in (False, True):  # all-greedy rows of a sampled window
        out, acc = tgen.spec_accept_rows(
            torch.tensor(draft), torch.zeros(B, k, V), torch.tensor(tlg),
            [None] * B, zeros, np.zeros(B, np.int64), np.ones(B),
            sampled=sampled)
        np.testing.assert_array_equal(acc.numpy(), np.asarray(want_acc))
        for b in range(B):
            a = int(want_acc[b])
            np.testing.assert_array_equal(out[b, :a + 1].numpy(),
                                          np.asarray(want_out)[b, :a + 1])
    assert sorted(set(acc.tolist())) == list(range(k + 1))


def _paged_setup(seed=0, B=3, W=4):
    """Random banks, disjoint tables, and a window's write routing with
    one inactive lane (row 1) routed to trash block 0."""
    rng = np.random.default_rng(seed)
    L, Kh, Dh, bt, nb = CFG.n_layers, CFG.kv_heads, CFG.head_dim, 16, 4
    n_blocks = B * nb + 1
    kb = rng.normal(size=(L, n_blocks, bt, Kh, Dh)).astype(np.float32)
    vb = rng.normal(size=kb.shape).astype(np.float32)
    tables = (1 + np.arange(B * nb)).reshape(B, nb).astype(np.int32)
    pos0 = np.array([5, 20, 33][:B], np.int32)
    ap = pos0[:, None] + np.arange(W)[None]
    wr_b = np.take_along_axis(tables, ap // bt, axis=1)
    wr_b[1] = 0
    wr_o = (ap % bt).astype(np.int32)
    return kb, vb, tables, pos0, wr_b.astype(np.int32), wr_o


def test_verify_step_paged_logits_and_writes_match_reference():
    kb, vb, tables, pos0, wr_b, wr_o = _paged_setup()
    toks = np.random.default_rng(1).integers(1, 256, (3, 4))
    lj, kj, vj = jgen.verify_step_paged(
        PJ, jnp.asarray(toks, jnp.int32), jnp.asarray(pos0), JCFG,
        jnp.asarray(kb), jnp.asarray(vb), jnp.asarray(tables),
        jnp.asarray(wr_b), jnp.asarray(wr_o))
    kt, vt = torch.tensor(kb), torch.tensor(vb)
    lt, _, _ = tgen.verify_step_paged(
        PT, torch.tensor(toks), torch.tensor(pos0), CFG, kt, vt,
        torch.tensor(tables), torch.tensor(wr_b), torch.tensor(wr_o))
    assert lt.shape == (3, 4, 256) and lt.dtype == torch.float32
    for b in (0, 2):  # the live rows (row 1 attends trash KV)
        np.testing.assert_allclose(lt[b].numpy(), np.asarray(lj)[b],
                                   **LOGIT_TOL)
    live = tables[[0, 2]].reshape(-1)
    np.testing.assert_allclose(kt[:, live].numpy(), np.asarray(kj)[:, live],
                               **LOGIT_TOL)
    np.testing.assert_allclose(vt[:, live].numpy(), np.asarray(vj)[:, live],
                               **LOGIT_TOL)


def test_draft_propose_paged_greedy_matches_reference():
    W = 3
    kb, vb, tables, pos0, wr_b, wr_o = _paged_setup(seed=2, W=W)
    tok = np.array([7, 99, 200])
    B = len(tok)
    pj, pc = jgen.truncated_draft_params(PJ, JCFG, n_layers=1)
    tp, tc = _friendly()
    pj_toks, pj_lg, kj, _ = jgen.draft_propose_paged(
        pj, jnp.asarray(tok, jnp.int32), jnp.asarray(pos0), pc,
        jnp.asarray(kb[:1]), jnp.asarray(vb[:1]), jnp.asarray(tables),
        jnp.asarray(wr_b), jnp.asarray(wr_o), jnp.zeros((B, 2), jnp.uint32),
        jnp.zeros((B,), jnp.int32), jnp.zeros((B,), jnp.float32),
        jnp.zeros((B,), jnp.int32), jnp.ones((B,), jnp.float32),
        n_steps=W, sampled=False)
    kt = torch.tensor(kb[:1])
    toks, lg, _, _ = tgen.draft_propose_paged(
        tp, torch.tensor(tok), torch.tensor(pos0), tc, kt,
        torch.tensor(vb[:1]), torch.tensor(tables), torch.tensor(wr_b),
        torch.tensor(wr_o), [None] * B, np.zeros(B), np.zeros(B, np.int64),
        np.ones(B), n_steps=W, sampled=False)
    for b in (0, 2):
        np.testing.assert_array_equal(toks[b].numpy(),
                                      np.asarray(pj_toks)[b])
        np.testing.assert_allclose(lg[b].numpy(), np.asarray(pj_lg)[b],
                                   **LOGIT_TOL)
    live = tables[[0, 2]].reshape(-1)
    np.testing.assert_allclose(kt[:, live].numpy(), np.asarray(kj)[:, live],
                               **LOGIT_TOL)


def test_truncated_draft_params_are_views():
    dp, dc = tgen.truncated_draft_params(PT, CFG, n_layers=1)
    assert dc.n_layers == 1 and dc.d_model == CFG.d_model
    assert dp["embed"] is PT["embed"]
    for name, w in dp["blocks"].items():
        full = PT["blocks"][name]
        assert w.shape == (1, *full.shape[1:])
        assert w.data_ptr() == full.data_ptr()  # a view: no copy
        assert w._base is full or w._base is full._base
    for bad in (0, CFG.n_layers + 1):
        with pytest.raises(ValueError, match="n_layers"):
            tgen.truncated_draft_params(PT, CFG, n_layers=bad)


def test_spec_config_is_checked():
    dp, dc = _friendly()
    with pytest.raises(ValueError, match="vocab"):
        _engine((dp, replace(dc, vocab_size=128)))
    with pytest.raises(ValueError, match="spec.k"):
        _engine((dp, dc), k=0)


# ------------------------------------------------------- greedy identity

LENS = (3, 17, 5, 33, 4, 21)
NEWS = (6, 12, 9, 5, 10, 7)


@pytest.fixture(scope="module")
def plain_outputs():
    """The same co-batched requests through the reference's engine and
    the port's plain engine."""
    prompts = [_prompt(n, 100 + i) for i, n in enumerate(LENS)]
    ref = JPaged(JCFG, params=PJ, n_slots=4, block_tokens=16,
                 prefill_chunk=24)
    try:
        want = _co_batched(ref, [jnp.asarray(p.numpy(), jnp.int32)
                                 for p in prompts], NEWS)
    finally:
        ref.close()
    plain = _engine(n_slots=4, prefill_chunk=24)
    try:
        got = _co_batched(plain, prompts, NEWS)
    finally:
        plain.close()
    return prompts, want, got


@pytest.mark.parametrize("draft", ["friendly", "hostile"])
def test_spec_greedy_co_batched_identical_to_plain_and_reference(
        plain_outputs, draft):
    """Mixed-length greedy requests joining mid-decode (ragged accept
    lengths) through the speculative engine equal the plain engine's and
    the reference engine's tokens, with a draft that accepts nearly
    everything and one that accepts nothing."""
    prompts, want, plain = plain_outputs
    eng = _engine(_friendly() if draft == "friendly" else _hostile(),
                  n_slots=4, prefill_chunk=24)
    try:
        got = _co_batched(eng, prompts, NEWS, stagger=0.05)
        info = eng.Info()
    finally:
        eng.close()
    for i in range(len(prompts)):
        np.testing.assert_array_equal(got[i], plain[i], err_msg=f"req {i}")
        np.testing.assert_array_equal(got[i], want[i], err_msg=f"req {i}")
    assert info["spec_windows"] > 0 and info["max_live_slots"] >= 2
    if draft == "friendly":
        assert info["spec_accept_rate"] > 0.9, info
    else:
        assert info["spec_accept_rate"] == 0.0, info
    assert info["kv_used_blocks"] == 0
    assert eng._dpool.stats()["kv_used_blocks"] == 0
    assert eng.pool.check_invariants() == []
    assert eng._dpool.check_invariants() == []


def test_spec_moe_greedy_identical_at_an_overflowing_capacity():
    """A tiny-moe target and its truncated draft at capacity factor 0.1:
    the window's verify (capacity B·W) and draft steps (capacity B) drop
    no token, so the tokens equal the contiguous path's."""
    cfg = ttfm.preset("tiny-moe", dtype=torch.float32, capacity_factor=0.1)
    jc = jtfm.preset("tiny-moe", dtype=jnp.float32, capacity_factor=0.1)
    pt = params_from_numpy(jax.tree_util.tree_map(
        np.asarray, jtfm.init_params(jax.random.PRNGKey(1), jc)), cfg)
    dp, dc = tgen.truncated_draft_params(pt, cfg, n_layers=1)
    eng = PagedGeneratorActor(cfg, params=pt, device="cpu", n_slots=2,
                              block_tokens=16,
                              spec=SpecConfig(dp, dc, k=3, adaptive=False))
    prompts = [_prompt(n, 200 + n) for n in (9, 26)]
    try:
        got = _co_batched(eng, prompts, (11, 8))
        assert eng.Info()["spec_windows"] > 0
    finally:
        eng.close()
    for p, g, n in zip(prompts, got, (11, 8)):
        np.testing.assert_array_equal(g, tgen.generate(pt, cfg, p, n).numpy())


def test_spec_windows_commit_many_tokens_per_iteration():
    eng = _engine(_friendly(), k=4)
    try:
        out = eng.Generate(_prompt(9, 1), 40)
        info = eng.Info()
    finally:
        eng.close()
    assert out.shape == (1, 40)
    # 39 decode tokens (the first came from prefill) in windows of <= 5.
    assert info["engine_steps"] <= 12, info
    assert info["spec_tokens"] == 39
    assert info["spec_proposed"] >= info["spec_accepted"] > 0
    assert info["spec_k"] == 4 and "kv_draft_free_blocks" in info
    np.testing.assert_array_equal(
        out.numpy(), tgen.generate(PT, CFG, _prompt(9, 1), 40).numpy())
    plain = _engine()
    try:
        plain.Generate(_prompt(5, 2), 4)
        assert "spec_accept_rate" not in plain.Info()
        assert "spec_windows" not in plain.Info()
    finally:
        plain.close()


def test_spec_stop_token_retires_mid_window():
    eng = _engine(_friendly(), k=4)
    prompt = torch.zeros((1, 4), dtype=torch.int64)
    solo = tgen.generate(PT, CFG, prompt, 24)
    stop = int(solo[0, 2])  # stops 2 tokens in
    try:
        out = eng.Generate(prompt, 24, stop_token=stop, pad_token=7)
        info = eng.Info()
    finally:
        eng.close()
    want = tgen.generate(PT, CFG, prompt, 24, stop_token=stop, pad_token=7)
    np.testing.assert_array_equal(out.numpy(), want.numpy())
    assert info["engine_steps"] < 24
    assert info["kv_used_blocks"] == 0
    assert eng._dpool.stats()["kv_used_blocks"] == 0


def test_spec_composes_with_prefix_reuse():
    """A shared-prefix second request skips its resident blocks'
    prefill (target pool only: draft KV is the draft's own) and both
    decode through speculation windows, token for token."""
    eng = _engine(_friendly(), n_slots=4, prefill_chunk=16)
    rng = np.random.default_rng(5)
    shared = rng.integers(1, 256, 48)
    p1, p2 = (torch.as_tensor(np.concatenate(
        [shared, rng.integers(1, 256, n)]))[None] for n in (7, 5))
    try:
        o1, o2 = eng.Generate(p1, 8), eng.Generate(p2, 8)
        info = eng.Info()
        assert info["prefix_hits"] == 3  # 48 shared tokens = 3 blocks
        assert info["spec_windows"] > 0
        assert eng.pool.check_invariants() == []
        assert eng._dpool.check_invariants() == []
    finally:
        eng.close()
    for p, o in ((p1, o1), (p2, o2)):
        np.testing.assert_array_equal(o.numpy(),
                                      tgen.generate(PT, CFG, p, 8).numpy())


def test_draft_catches_up_after_plain_steps():
    """Two iterations forced to plain steps leave two positions of
    draft KV unwritten; the next window writes them before drafting, so
    the accept rate stays high and the tokens stay exact."""
    eng = _engine(_friendly(), k=3)
    orig_k, orig_cu = eng._spec_k_eff, eng._draft_catch_up
    forced, spans = [0], []

    def k_eff():
        k = orig_k()
        if k and eng._spec_windows == 2 and forced[0] < 2:
            forced[0] += 1
            return 0
        return k

    def catch_up(slot, row):
        span = int(eng._pos[slot]) - int(eng._dpos[slot])
        if span > 0:
            spans.append(span)
        orig_cu(slot, row)

    eng._spec_k_eff, eng._draft_catch_up = k_eff, catch_up
    try:
        out = eng.Generate(_prompt(9, 3), 24)
        info = eng.Info()
    finally:
        eng.close()
    np.testing.assert_array_equal(
        out.numpy(), tgen.generate(PT, CFG, _prompt(9, 3), 24).numpy())
    assert forced[0] == 2 and spans == [2], spans
    assert info["engine_steps"] >= info["spec_windows"] + 2
    assert info["spec_accept_rate"] > 0.9, info


# ------------------------------------------------- sampled acceptance


def _gens(seed0, n, fold):
    return [tgen.folded_generator(seed0 + i, fold, "cpu") for i in range(n)]


def test_accept_sampled_matches_the_target_distribution():
    """Over many independent windows the first emitted token is
    distributed as the target's softmax: a chi-square test at fixed
    seeds, and no farther from p in total variation than a direct
    categorical sample of the same size."""
    V, k, N = 16, 2, 3000
    rng = np.random.default_rng(0)
    t_lg = torch.tensor(rng.normal(size=(k + 1, V)) * 2.0,
                        dtype=torch.float32)
    d_lg = torch.tensor(rng.normal(size=(k, V)) * 2.0, dtype=torch.float32)
    ones, zk, op = np.ones(N), np.zeros(N, np.int64), np.ones(N)
    dgens = _gens(0, N, tgen._DRAFT_FOLD)
    draft = torch.stack([tgen.sample_token_rows(d_lg[j].expand(N, V), dgens,
                                                ones, zk, op)
                         for j in range(k)], dim=1)
    out, acc = tgen.spec_accept_rows(
        draft, d_lg.expand(N, k, V), t_lg.expand(N, k + 1, V),
        _gens(0, N, tgen._ACCEPT_FOLD), ones, zk, op)
    p0 = torch.softmax(t_lg[0], -1).numpy().astype(np.float64)
    counts = np.bincount(out[:, 0].numpy(), minlength=V)
    chi2 = ((counts - N * p0) ** 2 / (N * p0)).sum()
    assert chi2 < scipy.stats.chi2.ppf(0.999, V - 1), chi2
    ref = torch.multinomial(torch.tensor(p0), N, replacement=True,
                            generator=torch.Generator().manual_seed(1))
    tv_ref = 0.5 * np.abs(np.bincount(ref.numpy(), minlength=V) / N
                          - p0).sum()
    tv = 0.5 * np.abs(counts / N - p0).sum()
    assert tv < max(2.5 * tv_ref, 0.05), (tv, tv_ref)
    assert 0 < acc.float().mean() < k  # both branches ran


def test_accept_sampled_full_accept_draws_bonus_from_target():
    """q == p: every proposal is accepted (ratio 1), and the bonus token
    is drawn from the target at the last position."""
    V, N = 12, 3000
    rng = np.random.default_rng(1)
    t_lg = torch.tensor(rng.normal(size=(2, V)) * 2.0, dtype=torch.float32)
    ones, zk, op = np.ones(N), np.zeros(N, np.int64), np.ones(N)
    d0 = tgen.sample_token_rows(t_lg[0].expand(N, V),
                                _gens(0, N, tgen._DRAFT_FOLD), ones, zk, op)
    out, acc = tgen.spec_accept_rows(
        d0[:, None], t_lg[:1].expand(N, 1, V), t_lg.expand(N, 2, V),
        _gens(0, N, tgen._ACCEPT_FOLD), ones, zk, op)
    assert (acc == 1).all()
    np.testing.assert_array_equal(out[:, 0].numpy(), d0.numpy())
    p1 = torch.softmax(t_lg[1], -1).numpy()
    emp = np.bincount(out[:, 1].numpy(), minlength=V) / N
    assert 0.5 * np.abs(emp - p1).sum() < 0.06


def test_spec_sampled_rows_are_reproducible_and_own_their_streams():
    """A sampled request rides the windows: the same seed gives the same
    tokens on two engines, and its draft and acceptance generators are
    seeded apart from its plain sampling generator."""
    kw = dict(temperature=0.8, seed=5, top_k=12)
    a, b = _engine(_friendly()), _engine(_friendly())
    try:
        o1 = a.Generate(_prompt(9, 4), 12, **kw).numpy()
        o2 = b.Generate(_prompt(9, 4), 12, **kw).numpy()
        assert a.Info()["spec_windows"] > 0
    finally:
        a.close()
        b.close()
    assert o1.shape == (1, 12)
    np.testing.assert_array_equal(o1, o2)
    seeds = {tgen.folded_generator(5, f, "cpu").initial_seed()
             for f in (tgen._DRAFT_FOLD, tgen._ACCEPT_FOLD)}
    assert len(seeds) == 2 and 5 not in seeds


# ------------------------------------------------- reservation discipline


def test_block_pool_spec_rows_audit_catches_undercover():
    pool = BlockPool(CFG, n_blocks=9, block_tokens=16)
    # pos 30 with 2 blocks and a 4-token window needs one more block.
    assert pool.check_invariants(spec_rows=[(30, 2, 1, 4)]) == []
    bad = pool.check_invariants(spec_rows=[(30, 2, 0, 4)])
    assert bad and "advance" in bad[0], bad
    # A block crossing inside the window: pos 15, window 4.
    assert pool.check_invariants(spec_rows=[(15, 1, 0, 4)])


def test_spec_reservations_cover_worst_case_under_pool_pressure():
    """After every window, every live row's remaining reservation covers
    its next worst-case advance in both pools, with a pool tight enough
    that cached blocks churn (audited from the engine thread)."""
    eng = _engine(_friendly(), k=4, n_blocks=13, max_len=96)
    bad, windows = [], [0]
    orig = eng._spec_step

    def audited(k_eff):
        orig(k_eff)
        windows[0] += 1
        bad.extend(eng.check_spec_reservations())

    eng._spec_step = audited
    prompts = [_prompt(33, 6), _prompt(17, 7)]
    try:
        outs = _co_batched(eng, prompts, (40, 40))
        assert eng.pool.check_invariants() == []
        assert eng._dpool.check_invariants() == []
    finally:
        eng.close()
    assert windows[0] > 0 and bad == [], bad[:5]
    for p, o in zip(prompts, outs):
        np.testing.assert_array_equal(o, tgen.generate(PT, CFG, p, 40).numpy())


def test_spec_admission_reserves_both_pools():
    """Both pools or neither: with the draft pool exhausted, a request
    sheds after the admit timeout and leaks no target reservation; it is
    admitted once the draft pool has room again."""
    eng = _engine(_friendly(), k=2, n_slots=1, admit_timeout_s=0.2)
    try:
        grabbed = eng._dpool.free_blocks()
        assert eng._dpool.try_reserve(grabbed)
        free_t = eng.pool.free_blocks()
        with pytest.raises(ShedError, match="exhausted"):
            eng.Generate(torch.zeros((1, 4), dtype=torch.int64), 4)
        assert eng.pool.free_blocks() == free_t
        eng._dpool.unreserve(grabbed)
        out = eng.Generate(torch.zeros((1, 4), dtype=torch.int64), 4)
        assert out.shape == (1, 4)
    finally:
        eng.close()


# ----------------------------------------------------------- adaptive k


def test_adaptive_k_backs_off_and_reprobes():
    """A draft that never agrees drives the accept EWMA to 0: the depth
    sheds to 0 (plain steps), k=1 probes re-run every ``probe_every``
    iterations, and the tokens stay exact."""
    eng = _engine(_hostile(), k=4, adaptive=True,
                  spec_kw={"probe_every": 10})
    try:
        out = eng.Generate(_prompt(9, 8), 60)
        info = eng.Info()
    finally:
        eng.close()
    np.testing.assert_array_equal(
        out.numpy(), tgen.generate(PT, CFG, _prompt(9, 8), 60).numpy())
    assert info["spec_k_cur"] == 0, info
    assert 4 < info["spec_windows"] < 40, info  # probes, not every step
    assert info["spec_accept_rate"] == 0.0


def test_adaptive_k_holds_depth_for_good_draft():
    eng = _engine(_friendly(), k=4, adaptive=True)
    try:
        out = eng.Generate(_prompt(9, 9), 40)
        info = eng.Info()
    finally:
        eng.close()
    assert out.shape == (1, 40)
    assert info["spec_k_cur"] == 4, info
    assert info["spec_accept_rate"] > 0.9
