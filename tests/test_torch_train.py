"""The port's training path against the JAX reference, in f32 on the
CPU: the fused chunked loss and its grads, the schedule, decay mask and
AdamW update against optax, the train step and N-step loss curves
against the reference's ``make_train_step`` on a one-device host mesh,
grad accumulation, token-weighted evaluation, and the data streams.
Parameters cross as numpy (``params_from_numpy``); inputs are numpy,
seeded."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ptype_tpu.models import transformer as jtfm
from ptype_tpu.parallel.mesh import build_mesh
from ptype_tpu.train import trainer as jtr
from ptype_tpu_torch import metrics as tmetrics
from ptype_tpu_torch.models import transformer as ttfm
from ptype_tpu_torch.models.weights import params_from_numpy
from ptype_tpu_torch.train import data as tdata
from ptype_tpu_torch.train import trainer as ttr

#: The reference's ``tiny`` and a narrow config with the serving head
#: width (Dh = 128) and GQA, as in test_torch_transformer.py.
NARROW = dict(vocab_size=256, d_model=256, n_layers=2, n_heads=2,
              n_kv_heads=1, d_ff=256, max_seq=256)
#: Loss and loss-curve tolerance in f32: the two packages sum the same
#: terms in different orders (XLA's fused reductions vs PyTorch's), a
#: few ulps per op through 2 layers, compounding over 5 Adam steps.
LOSS_TOL = dict(rtol=2e-5, atol=0)
#: Gradients in f32: the same sums in another order, on leaves whose
#: entries are as small as 1e-6.
GRAD_TOL = dict(rtol=2e-4, atol=2e-7)
#: Parameters after Adam steps at lr 1e-3: an update is lr·m/(|g|+eps)
#: on step one, so a gradient entry near eps (1e-8) moves its update by
#: up to ~1% of lr when the two packages' grads differ in the last
#: digits; every other entry agrees to f32 rounding.
STEP_TOL = dict(rtol=1e-5, atol=1e-5)


def configs(name, **kw):
    if name == "narrow":
        return (jtfm.TransformerConfig(dtype=jnp.float32, **NARROW, **kw),
                ttfm.TransformerConfig(dtype=torch.float32, **NARROW, **kw))
    return (jtfm.preset(name, dtype=jnp.float32, **kw),
            ttfm.preset(name, dtype=torch.float32, **kw))


def param_pair(jcfg, tcfg, seed=0):
    pj = jtfm.init_params(jax.random.PRNGKey(seed), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, pj)
    return pj, params_from_numpy(tree, tcfg), tree


def batch_np(seed, B, S, V=256, masked=False):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, V, (B, S + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if masked:
        mask = (rng.random((B, S)) < 0.6).astype(np.float32)
        mask[0] = 0.0  # a row with no valid token
        out["loss_mask"] = mask
    return out


def to_j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_t(batch):
    return {k: torch.as_tensor(v) if k == "loss_mask"
            else torch.as_tensor(v).long() for k, v in batch.items()}


def flat(tree):
    return ttr._flatten(tree)


def assert_trees_close(got: dict, want, **tol):
    want = jax.tree_util.tree_map(np.asarray, want)
    for path, leaf in flat(got):
        ref = want
        for key in path:
            ref = ref[key]
        np.testing.assert_allclose(leaf.detach().numpy(), ref,
                                   err_msg="/".join(path), **tol)


# -------------------------------------------------------------------- loss


def test_flops_per_token_matches_reference():
    for name in ("tiny", "optimus-125m", "bert-base", "llama-3-8b",
                 "tiny-moe", "optimus-moe"):
        for S in (128, 1024):
            assert ttfm.flops_per_token(ttfm.preset(name), S) == \
                jtfm.flops_per_token(jtfm.preset(name), S)


def test_chunk_rows_rule():
    assert ttfm._chunk_rows(16 * 1024) == 8192
    assert ttfm._chunk_rows(12 * 1024) == 6144  # not one dense chunk
    assert ttfm._chunk_rows(8191) == 8191       # prime: one dense chunk
    assert ttfm._chunk_rows(300) == 300


@pytest.mark.parametrize("name,masked", [
    ("tiny", False), ("tiny", True), ("narrow", True), ("tiny-moe", False),
    ("tiny-moe", True)])
def test_loss_terms_match_reference(name, masked):
    jc, tc = configs(name, attn_impl="xla")
    pj, pt, _ = param_pair(jc, tc)
    b = batch_np(1, 4, 64, masked=masked)
    nj, dj, _ = jtfm.loss_terms(pj, to_j(b), jc)
    nt, dt_, _ = ttfm.loss_terms(pt, to_t(b), tc)
    np.testing.assert_allclose(float(nt), float(nj), **LOSS_TOL)
    assert float(dt_) == float(dj)
    np.testing.assert_allclose(float(ttfm.loss_fn(pt, to_t(b), tc)),
                               float(jtfm.loss_fn(pj, to_j(b), jc)),
                               **LOSS_TOL)
    # The dense path from full logits gives the same terms.
    logits = ttfm.forward(pt, to_t(b)["tokens"], tc)
    ns, ds = ttfm.nll_terms_from_logits(logits, to_t(b))
    np.testing.assert_allclose(float(ns), float(nt), rtol=1e-5)
    assert float(ds) == float(dt_)


@pytest.mark.parametrize("name", ["tiny", "narrow"])
def test_chunked_nll_grads_match_reference(name, monkeypatch):
    """Two chunks of 512 rows (B·S = 1024), a loss_mask, and the tied
    embedding's grad, which sums the head's and the lookup's."""
    monkeypatch.setattr(jtfm, "LOSS_CHUNK_ROWS", 512)
    monkeypatch.setattr(ttfm, "LOSS_CHUNK_ROWS", 512)
    assert ttfm._chunk_rows(1024) == 512
    jc, tc = configs(name, attn_impl="xla")
    pj, pt, _ = param_pair(jc, tc, seed=1)
    b = batch_np(2, 8, 128, masked=True)
    lj, gj = jax.value_and_grad(jtfm.loss_fn)(pj, to_j(b), jc)
    leaves = [p.requires_grad_(True) for _, p in flat(pt)]
    lt = ttfm.loss_fn(pt, to_t(b), tc)
    gt = torch.autograd.grad(lt, leaves)
    np.testing.assert_allclose(float(lt.detach()), float(lj), **LOSS_TOL)
    assert_trees_close(ttr._unflatten(zip([p for p, _ in flat(pt)], gt)),
                       gj, **GRAD_TOL)


def test_chunked_nll_saves_no_logits(monkeypatch):
    monkeypatch.setattr(ttfm, "LOSS_CHUNK_ROWS", 512)
    _, tc = configs("tiny")
    x = torch.randn(8, 128, 64, requires_grad=True)
    head = torch.randn(64, 256, requires_grad=True)
    t = torch.randint(0, 256, (8, 128))
    nll, denom = ttfm._chunked_nll(x, head, t, None, tc)
    assert float(denom) == 1024.0
    saved = nll.grad_fn.saved_tensors
    assert max(s.numel() for s in saved) < 1024 * 256
    assert {tuple(s.shape) for s in saved} >= {(1024, 64), (64, 256)}
    # Its grads are those of the dense loss.
    ref = torch.nn.functional.cross_entropy(
        (x.reshape(-1, 64) @ head), t.reshape(-1), reduction="sum")
    gx, gh = torch.autograd.grad(nll, (x, head))
    rx, rh = torch.autograd.grad(ref, (x, head))
    torch.testing.assert_close(gx, rx, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(gh, rh, rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------- optimizer


@pytest.mark.parametrize("warmup", [0, 10])
def test_schedule_matches_optax(warmup):
    hp = ttr.OptHParams(lr=3e-4, warmup=warmup, decay_steps=50)
    ref = jtr.OptHParams(lr=3e-4, warmup=warmup, decay_steps=50).schedule()
    got = hp.schedule()
    for count in range(0, 64):
        np.testing.assert_allclose(got(count), float(ref(jnp.int32(count))),
                                   rtol=1e-6, atol=0, err_msg=str(count))
    if warmup:
        assert got(0) == 0.0  # the first update moves nothing
    with pytest.raises(ValueError, match="exceed"):
        ttr.warmup_cosine_decay(0.0, 1e-3, 10, 10, 1e-4)


@pytest.mark.parametrize("name", ["tiny", "llama-3-8b", "tiny-moe"])
def test_decay_mask_matches_reference(name):
    jc = jtfm.preset(name)
    shapes = jax.eval_shape(lambda: jtfm.init_params(jax.random.PRNGKey(0),
                                                     jc))
    want = jtr._decay_mask(shapes)
    fake = jax.tree_util.tree_map(
        lambda s: torch.empty(s.shape, device="meta"), shapes)
    got = ttr._decay_mask(fake)
    assert got == want


def test_adamw_update_matches_optax():
    """Identical params and grads through optax's default chain and the
    port's AdamW, over four updates: warmup and the cosine unclipped,
    bit for bit, then a clipped step. The global norm sums per-leaf sums
    in another order, so the clip scale can differ by an ulp, and so can
    each update (lr·u, u ~ 1: ~1.2e-9) and each param."""
    jc, tc = configs("tiny")
    pj, pt, tree = param_pair(jc, tc)
    opt_j = jtr.default_optimizer(lr=1e-2, warmup=2, decay_steps=20)
    opt_t = ttr.default_optimizer(lr=1e-2, warmup=2, decay_steps=20)
    sj, st = opt_j.init(pj), opt_t.init(pt)
    rng = np.random.default_rng(0)
    for step, scale in enumerate((1e-3, 2e-3, 1e-3, 10.0)):
        g = jax.tree_util.tree_map(
            lambda x: (rng.normal(size=x.shape) * scale).astype(np.float32),
            tree)
        upd, sj = opt_j.update(jax.tree_util.tree_map(jnp.asarray, g), sj,
                               pj)
        pj = optax.apply_updates(pj, upd)
        gn = opt_t.update(pt, params_from_numpy(g, tc), st)
        np.testing.assert_allclose(float(gn), float(optax.global_norm(g)),
                                   rtol=1e-6)
        assert st.count == step + 1
        clipped = float(optax.global_norm(g)) >= 1.0
        assert clipped == (step == 3)
        if clipped:
            assert_trees_close(pt, pj, rtol=2.4e-7, atol=4e-9)
        else:
            assert_trees_close(pt, pj, rtol=0, atol=0)


# ------------------------------------------------------------ train steps


def reference_run(jc, tree, batches, opt, grad_accum=1):
    mesh = build_mesh({"data": 1})
    state, sh = jtr.init_state(jax.random.PRNGKey(0), jc, mesh, opt)
    state = jtr.TrainState(
        jax.device_put(jax.tree_util.tree_map(jnp.asarray, tree),
                       sh.params), state.opt_state, state.step)
    keys = tuple(k for k in jtr.BATCH_KEYS if k in batches[0])
    step = jtr.make_train_step(jc, mesh, opt, batch_keys=keys,
                               grad_accum=grad_accum)
    outs = []
    for b in batches:
        state, out = step(state, to_j(b))
        outs.append((float(out["loss"]), float(out["grad_norm"])))
    return state, outs


def test_train_step_matches_reference():
    """One update with a non-zero learning rate (warmup 0: the cosine's
    first value): params, loss and the pre-clip grad norm."""
    jc, tc = configs("tiny", attn_impl="xla")
    _, _, tree = param_pair(jc, tc, seed=3)
    b = batch_np(4, 4, 32)
    js, jout = reference_run(jc, tree, [b], jtr.default_optimizer(
        lr=1e-3, warmup=0, decay_steps=100))
    tr = ttr.Trainer(tc, device="cpu", params=tree,
                     optimizer=ttr.default_optimizer(lr=1e-3, warmup=0,
                                                     decay_steps=100))
    out = tr.step(b)
    np.testing.assert_allclose(float(out["loss"]), jout[0][0], **LOSS_TOL)
    np.testing.assert_allclose(float(out["grad_norm"]), jout[0][1],
                               rtol=1e-4)
    assert out["step"] == 1
    assert_trees_close(tr.state.params, js.params, **STEP_TOL)


@pytest.mark.parametrize("name", ["tiny", "narrow"])
def test_n_step_loss_parity_with_flash(name):
    """Five steps on five batches: the reference (dense attention) and
    the port with attn_impl="flash" (the autograd.Function; on the CPU
    its plain forward and backward) give the same loss curve."""
    jc, _ = configs(name, attn_impl="xla")
    _, tc = configs(name, attn_impl="flash")
    _, _, tree = param_pair(jc, tc, seed=5)
    batches = [batch_np(10 + i, 4, 64) for i in range(5)]
    mk = dict(lr=3e-3, warmup=2, decay_steps=50)
    _, jout = reference_run(jc, tree, batches, jtr.default_optimizer(**mk))
    tr = ttr.Trainer(tc, device="cpu", params=tree,
                     optimizer=ttr.default_optimizer(**mk))
    assert tr._attn_fn is ttfm._flash_attn_fn
    got = [tr.step(b) for b in batches]
    losses = [float(o["loss"]) for o in got]
    np.testing.assert_allclose(losses, [lo for lo, _ in jout], **LOSS_TOL)
    np.testing.assert_allclose([float(o["grad_norm"]) for o in got],
                               [gn for _, gn in jout], rtol=1e-4)
    assert losses[-1] < losses[0]


def test_grad_accum_matches_full_batch_with_uneven_mask():
    _, tc = configs("tiny", attn_impl="xla")
    _, pt, tree = param_pair(*configs("tiny"))
    b = to_t(batch_np(6, 8, 32, masked=True))
    b["loss_mask"][4:] = 1.0  # microbatch 2 holds most valid tokens
    for _, p in flat(pt):
        p.requires_grad_(True)
    l1, g1 = ttr.grads_of(pt, b, tc, grad_accum=1)
    l2, g2 = ttr.grads_of(pt, b, tc, grad_accum=2)
    np.testing.assert_allclose(float(l2), float(l1), rtol=1e-6)
    for (path, a), (_, c) in zip(flat(g1), flat(g2)):
        torch.testing.assert_close(c, a, rtol=1e-5, atol=1e-8,
                                   msg="/".join(path))
    # And the whole step, against the reference's grad_accum=2.
    nb = {k: v.numpy().astype(np.float32 if k == "loss_mask" else np.int32)
          for k, v in b.items()}
    jc, _ = configs("tiny", attn_impl="xla")
    opt = dict(lr=1e-3, warmup=0, decay_steps=100)
    js, jout = reference_run(jc, tree, [nb], jtr.default_optimizer(**opt),
                             grad_accum=2)
    step = ttr.make_train_step(tc, ttr.default_optimizer(**opt),
                               grad_accum=2, device="cpu")
    state = ttr.TrainState(pt, ttr.default_optimizer(**opt).init(pt), 0)
    state, out = step(state, b)
    np.testing.assert_allclose(float(out["loss"]), jout[0][0], **LOSS_TOL)
    assert_trees_close(state.params, js.params, **STEP_TOL)


def test_evaluate_is_token_weighted_and_matches_reference():
    jc, tc = configs("tiny", attn_impl="xla")
    pj, pt, _ = param_pair(jc, tc, seed=2)
    batches = [batch_np(20 + i, 8, 32, masked=True) for i in range(2)]
    got = ttr.evaluate(pt, tc, iter(map(to_t, batches)), steps=2,
                       device="cpu")
    want = jtr.evaluate(pj, jc, build_mesh({"data": 1}),
                        iter(map(to_j, batches)), steps=2)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert got["tokens"] == want["tokens"] == int(
        sum(b["loss_mask"].sum() for b in batches))
    assert got["perplexity"] == pytest.approx(math.exp(got["loss"]))
    # Token-weighted, not a mean of per-batch means.
    nll = [float(ttfm.loss_terms(pt, to_t(b), tc)[0]) for b in batches]
    assert got["loss"] == pytest.approx(sum(nll) / got["tokens"], rel=1e-6)


def test_trainer_stats_evaluate_and_mutation():
    _, tc = configs("tiny", attn_impl="xla")
    tr = ttr.Trainer(tc, device="cpu", sync_every=2,
                     optimizer=ttr.default_optimizer(lr=1e-3, warmup=1))
    it = tdata.synthetic_batches(tc.vocab_size, 4, 32, seed=1, device="cpu")
    first = tr.step(next(it))
    assert first["tokens_per_sec"] == 0.0  # nothing drained yet
    out = tr.step(next(it))
    assert out["step"] == 2 and out["tokens_per_sec"] > 0
    assert out["mfu"] is None  # the CPU has no peak in the table
    before = [p.detach().clone() for _, p in flat(tr.state.params)]
    ev = tr.evaluate(it, steps=2)
    assert ev["tokens"] == 2 * 4 * 32
    assert all(torch.equal(a, p) for a, (_, p)
               in zip(before, flat(tr.state.params)))


# -------------------------------------------------------------------- data


def test_synthetic_batches_shape_reproducibility_and_shift():
    a = tdata.synthetic_batches(256, 4, 16, seed=7, device="cpu")
    b = tdata.synthetic_batches(256, 4, 16, seed=7, device="cpu")
    c = tdata.synthetic_batches(256, 4, 16, seed=8, device="cpu")
    x, y, z = next(a), next(b), next(c)
    assert x["tokens"].shape == x["targets"].shape == (4, 16)
    assert x["tokens"].dtype == torch.int64
    assert torch.equal(x["tokens"], y["tokens"])
    assert not torch.equal(x["tokens"], z["tokens"])
    assert torch.equal(x["tokens"][:, 1:], x["targets"][:, :-1])
    assert int(x["tokens"].min()) >= 0 and int(x["tokens"].max()) < 256
    assert not torch.equal(next(a)["tokens"], x["tokens"])


def test_token_file_dataset(tmp_path):
    path = str(tmp_path / "corpus.bin")
    corpus = np.arange(1000) % 251
    tdata.write_token_file(path, corpus, dtype=np.uint16)
    ds = tdata.TokenFileDataset(path, device="cpu")
    assert ds.n_tokens == 1000
    it = ds.batches(4, 16, seed=1)
    b = next(it)
    assert b["tokens"].shape == (4, 16) and b["tokens"].dtype == torch.int64
    assert torch.equal(b["tokens"][:, 1:], b["targets"][:, :-1])
    # Windows of the corpus: each row is consecutive mod 251.
    assert torch.all((b["targets"] - b["tokens"]) % 251 == 1)
    again = next(ds.batches(4, 16, seed=1))
    assert torch.equal(again["tokens"], b["tokens"])
    it.close()
    with pytest.raises(ValueError, match="corpus"):
        next(tdata.TokenFileDataset(path, device="cpu").batches(4, 999))


def test_mfu_needs_a_known_peak():
    assert tmetrics.device_peak_tflops("cpu") is None
    assert tmetrics.mfu(1e5, 1e9, 1, None) is None
    assert tmetrics.mfu(1e5, 1e9, 1, 989.0) == pytest.approx(1e14 / 989e12)
    st = tmetrics.StepStats(flops_per_token=1e9, n_chips=1)
    st.start()
    st.step(1000)
    assert st.tokens_per_sec > 0 and st.mfu is None


def test_batch_without_targets_is_refused():
    _, tc = configs("tiny", attn_impl="xla")
    tr = ttr.Trainer(tc, device="cpu")
    with pytest.raises(ValueError, match="targets"):
        tr.step({"tokens": np.zeros((2, 8), np.int32)})
    assert dataclasses.is_dataclass(tr.state)
