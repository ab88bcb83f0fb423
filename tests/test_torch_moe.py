"""The port's mixture-of-experts path against the JAX reference, in f32
on the CPU at ``tiny-moe``: the MoE MLP (output, router aux, and the
set of assignments kept at a capacity that overflows), the forward and
loss with aux, the parameter tree, greedy generation and the paged
engine token for token, and a 5-step loss curve against the
reference's ``make_train_step``. Parameters cross as numpy
(``params_from_numpy``); inputs are numpy, seeded.

Generation runs at ``capacity_factor=0.1``, where the training-time
capacity drops most tokens: the port's tokens equal the reference's
only if every generation entry point passes its zero-drop capacity."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptype_tpu.models import generate as jgen
from ptype_tpu.models import transformer as jtfm
from ptype_tpu.parallel.mesh import build_mesh
from ptype_tpu.serve_engine import PagedGeneratorActor as JPaged
from ptype_tpu.train import trainer as jtr
from ptype_tpu_torch.models import generate as tgen
from ptype_tpu_torch.models import transformer as ttfm
from ptype_tpu_torch.models.weights import (init_params, params_from_numpy,
                                            params_to_numpy)
from ptype_tpu_torch.serve_engine import PagedGeneratorActor
from ptype_tpu_torch.train import trainer as ttr

#: Router, dispatch and expert products in f32 on both sides: the same
#: terms summed in other orders.
MOE_TOL = dict(rtol=2e-5, atol=2e-5)
#: Loss curves in f32 over 5 Adam steps: the two packages sum the same
#: terms in other orders, a few ulps a step.
CURVE_TOL = dict(rtol=1e-5, atol=0)


def configs(**kw):
    return (jtfm.preset("tiny-moe", dtype=jnp.float32, **kw),
            ttfm.preset("tiny-moe", dtype=torch.float32, **kw))


def param_pair(jc, tc, seed=0):
    pj = jtfm.init_params(jax.random.PRNGKey(seed), jc)
    tree = jax.tree_util.tree_map(np.asarray, pj)
    return pj, params_from_numpy(tree, tc), tree


def layer0(pj, pt):
    return (jax.tree_util.tree_map(lambda x: x[0], pj["blocks"]),
            ttfm.layer_params(pt, 0))


def reference_keep(h, layer, cfg):
    """The reference's kept assignments, by its own rule: top-k of the
    f32 router softmax, t-major flattening, a slot per expert in token
    order, kept below the capacity."""
    T = h.shape[0] * h.shape[1]
    x = jnp.asarray(h).reshape(T, -1)
    probs = jax.nn.softmax(x @ layer["router"], axis=-1)
    _, gate_e = jax.lax.top_k(probs, cfg.expert_top_k)
    flat_e = gate_e.reshape(-1)
    counts = jnp.cumsum(jax.nn.one_hot(flat_e, cfg.n_experts,
                                       dtype=jnp.int32), axis=0)
    pos = counts[jnp.arange(flat_e.shape[0]), flat_e] - 1
    C = max(int(np.ceil(cfg.expert_top_k * T / cfg.n_experts
                        * cfg.capacity_factor)), 1)
    return np.asarray(pos < C)


# ------------------------------------------------------------------ layer


@pytest.mark.parametrize("cf,shape", [(1.25, (2, 16)), (8.0, (1, 8)),
                                      (0.5, (3, 24))])
def test_moe_mlp_matches_reference(cf, shape):
    jc, tc = configs(capacity_factor=cf)
    pj, pt, _ = param_pair(jc, tc)
    lj, lt = layer0(pj, pt)
    h = np.random.default_rng(2).normal(size=(*shape, 64)).astype(np.float32)
    yj, aj = jtfm._moe_mlp(jnp.asarray(h), lj, jc)
    yt, at = ttfm._moe_mlp(torch.tensor(h), lt, tc)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **MOE_TOL)
    np.testing.assert_allclose(float(at), float(aj), **MOE_TOL)


def test_moe_capacity_overflow_keeps_the_reference_set():
    """``test_moe_capacity_drops_overflow``'s setup (capacity factor 0.1,
    C = 2 per expert at 32 tokens): the port keeps exactly the
    assignments the reference keeps, and the outputs agree."""
    jc, tc = configs(capacity_factor=0.1)
    pj, pt, _ = param_pair(jc, tc)
    lj, lt = layer0(pj, pt)
    h = np.random.default_rng(3).normal(size=(2, 16, 64)).astype(np.float32)
    x = torch.tensor(h).reshape(32, 64)
    _, gate_e, _ = ttfm._moe_route(x, lt["router"], tc)
    _, _, _, keep = ttfm._moe_dispatch(x, gate_e, 2, tc)
    want = reference_keep(h, lj, jc)
    np.testing.assert_array_equal(keep.numpy(), want)
    assert 0 < want.sum() < want.size  # some kept, some dropped
    yj, _ = jtfm._moe_mlp(jnp.asarray(h), lj, jc)
    yt, _ = ttfm._moe_mlp(torch.tensor(h), lt, tc)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **MOE_TOL)
    zero_t = (yt.reshape(32, 64) == 0).all(dim=1).numpy()
    zero_j = np.all(np.asarray(yj).reshape(32, 64) == 0, axis=1)
    np.testing.assert_array_equal(zero_t, zero_j)
    assert zero_j.any()  # tokens with both picks dropped fall back


def test_moe_mlp_takes_no_value_from_the_device():
    """Static shapes: the same code at another token count, and no
    data-dependent op (a traced graph would show ``nonzero``/``item``)."""
    _, tc = configs()
    pt = init_params(torch.Generator().manual_seed(0), tc)
    h = torch.randn(2, 5, 64, generator=torch.Generator().manual_seed(1))
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        y, aux = ttfm._moe_mlp(h, ttfm.layer_params(pt, 0), tc, capacity=10)
    names = {e.key for e in prof.key_averages()}
    assert not names & {"aten::nonzero", "aten::item",
                        "aten::_local_scalar_dense"}, names
    assert y.shape == h.shape and aux.dim() == 0


# ----------------------------------------------------------- model, params


def test_forward_with_aux_and_loss_match_reference():
    jc, tc = configs()
    pj, pt, _ = param_pair(jc, tc, seed=1)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, 256, (2, 17)).astype(np.int32)
    lj, aj = jtfm.forward_with_aux(pj, jnp.asarray(toks[:, :-1]), jc)
    lt, at = ttfm.forward_with_aux(pt, torch.tensor(toks[:, :-1]).long(), tc)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **MOE_TOL)
    np.testing.assert_allclose(float(at), float(aj), **MOE_TOL)
    # Balanced routing gives aux ~ 1 a layer; any routing gives >= 1.
    assert 0.9 < float(at) / tc.n_layers < 4.0
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    want = float(jtfm.loss_fn(pj, {k: jnp.asarray(v)
                                   for k, v in batch.items()}, jc))
    got = ttfm.loss_fn(pt, {k: torch.tensor(v).long()
                            for k, v in batch.items()}, tc)
    np.testing.assert_allclose(float(got), want, **MOE_TOL)
    nll_sum, denom, _ = ttfm.loss_terms(
        pt, {k: torch.tensor(v).long() for k, v in batch.items()}, tc)
    np.testing.assert_allclose(
        float(got), float(nll_sum / denom) + tc.moe_aux_coef * float(at),
        rtol=1e-6)


def test_moe_params_cross_bit_for_bit_and_init_has_the_reference_tree():
    jc, tc = configs()
    _, pt, tree = param_pair(jc, tc)
    back = params_to_numpy(pt)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, tree)
    assert pt["blocks"]["router"].shape == (2, 64, 4)
    assert pt["blocks"]["w_gate"].shape == (2, 4, 64, 64)  # (L,E,D,F)
    want = jax.eval_shape(lambda: jtfm.init_params(jax.random.PRNGKey(0),
                                                   jc))
    got = init_params(torch.Generator().manual_seed(0), tc)
    shapes = jax.tree_util.tree_map(lambda s: tuple(s.shape), want)
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), got) == shapes
    # The reference's scales: 0.02, and 0.02/sqrt(2L) on w_down.
    assert abs(float(got["blocks"]["router"].std()) - 0.02) < 2e-3
    assert abs(float(got["blocks"]["w_down"].std()) - 0.01) < 1e-3


def test_flops_per_token_counts_routed_experts():
    for name in ("tiny-moe", "optimus-moe"):
        cfg = ttfm.preset(name)
        assert ttfm.flops_per_token(cfg, 1024) == \
            jtfm.flops_per_token(jtfm.preset(name), 1024)
        dense = ttfm.flops_per_token(ttfm.preset(name, n_experts=0), 1024)
        D, F, E = cfg.d_model, cfg.d_ff, cfg.n_experts
        assert ttfm.flops_per_token(cfg, 1024) - dense == \
            6.0 * cfg.n_layers * ((cfg.expert_top_k - 1) * 3 * D * F + D * E)


# -------------------------------------------------------------- generation


def test_moe_generate_matches_reference_and_forward():
    """Ample capacity (no drop on either path): greedy tokens equal the
    reference's and the port's own step-by-step full forward."""
    jc, tc = configs(capacity_factor=8.0)
    pj, pt, _ = param_pair(jc, tc)
    prompt = np.random.default_rng(9).integers(0, 256, (2, 4))
    want = np.asarray(jgen.generate(pj, jc, jnp.asarray(prompt, jnp.int32),
                                    max_new_tokens=4))
    out = tgen.generate(pt, tc, torch.tensor(prompt), 4)
    np.testing.assert_array_equal(out.numpy(), want)
    seq = torch.tensor(prompt)
    for _ in range(4):
        nxt = ttfm.forward(pt, seq, tc)[:, -1].argmax(-1)
        seq = torch.cat([seq, nxt[:, None]], dim=1)
    np.testing.assert_array_equal(out.numpy(), seq[:, 4:].numpy())


def test_ragged_moe_rows_match_reference_and_solo():
    """Ragged prompts at capacity factor 0.1: pad columns must not take
    expert slots from real tokens (zero-drop prefill and decode)."""
    jc, tc = configs(capacity_factor=0.1)
    pj, pt, _ = param_pair(jc, tc, seed=1)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, 256, n) for n in (2, 7)]
    padded, lens = tgen.pad_prompts(prompts)
    out = tgen.generate(pt, tc, padded, 6, prompt_lens=lens)
    jpad, jlens = jgen.pad_prompts([p.astype(np.int32) for p in prompts])
    want = np.asarray(jgen.generate(pj, jc, jpad, 6, prompt_lens=jlens))
    np.testing.assert_array_equal(out.numpy(), want)
    for i, p in enumerate(prompts):
        solo = tgen.generate(pt, tc, torch.tensor(p)[None], 6)
        np.testing.assert_array_equal(out[i].numpy(), solo[0].numpy(),
                                      err_msg=f"moe row {i}")


ENGINE_LENS = (5, 19, 40, 9)
ENGINE_NEW = (7, 5, 9, 12)


def _co_batched(engine, prompts, news):
    outs = [None] * len(prompts)

    def call(i):
        outs[i] = np.asarray(engine.Generate(prompts[i], news[i]))

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert all(o is not None for o in outs)
    return outs


@pytest.fixture(scope="module")
def engine_case():
    """Co-batched MoE requests (a shared 16-token prefix, chunked
    prefill) through the reference engine at capacity factor 0.1."""
    jc, tc = configs(capacity_factor=0.1)
    pj, pt, _ = param_pair(jc, tc, seed=2)
    rng = np.random.default_rng(8)
    shared = rng.integers(1, 256, 16)
    prompts = [np.concatenate([shared, rng.integers(1, 256, n)])
               for n in ENGINE_LENS]
    ref = JPaged(jc, params=pj, n_slots=2, block_tokens=16,
                 prefill_chunk=24)
    try:
        want = _co_batched(ref, [jnp.asarray(p, jnp.int32)[None]
                                 for p in prompts], ENGINE_NEW)
    finally:
        ref.close()
    return tc, pt, prompts, want


@pytest.mark.parametrize("attn", ["gather", "kernel"])
def test_paged_engine_moe_matches_reference_engine(engine_case, attn):
    tc, pt, prompts, want = engine_case
    eng = PagedGeneratorActor(tc, params=pt, device="cpu", n_slots=2,
                              block_tokens=16, prefill_chunk=24, attn=attn)
    try:
        got = _co_batched(eng, [torch.tensor(p)[None] for p in prompts],
                          ENGINE_NEW)
        info = eng.Info()
        assert info["max_live_slots"] == 2 and info["prefix_hits"] >= 1
        assert eng.pool.check_invariants() == []
    finally:
        eng.close()
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")


# ---------------------------------------------------------------- training


def batch_np(seed, B, S):
    toks = np.random.default_rng(seed).integers(0, 256, (B, S + 1))
    toks = toks.astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_moe_loss_curve_matches_reference_train_step(grad_accum):
    """Five AdamW steps on five batches: the reference's
    ``make_train_step`` on a one-device ``{"data": 1}`` mesh and the
    port's ``Trainer`` give the same loss curve (aux included; with
    grad_accum 2 each microbatch adds its own aux / 2)."""
    jc, tc = configs()
    _, _, tree = param_pair(jc, tc, seed=5)
    batches = [batch_np(20 + i, 4, 32) for i in range(5)]
    mk = dict(lr=3e-3, warmup=2, decay_steps=50)
    mesh = build_mesh({"data": 1})
    opt = jtr.default_optimizer(**mk)
    state, sh = jtr.init_state(jax.random.PRNGKey(0), jc, mesh, opt)
    state = jtr.TrainState(
        jax.device_put(jax.tree_util.tree_map(jnp.asarray, tree), sh.params),
        state.opt_state, state.step)
    step = jtr.make_train_step(jc, mesh, opt, batch_keys=("tokens",
                                                          "targets"),
                               grad_accum=grad_accum)
    want = []
    for b in batches:
        state, out = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        want.append(float(out["loss"]))
    topt = ttr.default_optimizer(**mk)
    params = params_from_numpy(tree, tc)
    tstate = ttr.TrainState(params, topt.init(params), 0)
    tstep = ttr.make_train_step(tc, topt, grad_accum=grad_accum,
                                device="cpu")
    got = []
    for b in batches:
        tstate, out = tstep(tstate, b)
        got.append(float(out["loss"]))
    np.testing.assert_allclose(got, want, **CURVE_TOL)
    assert got[-1] < got[0]


def test_decay_mask_decays_the_router():
    jc, tc = configs()
    _, pt, _ = param_pair(jc, tc)
    mask = ttr._decay_mask(pt)
    assert mask["blocks"]["router"] is True
    assert mask["blocks"]["mlp_norm"] is False
    assert mask["blocks"]["w_gate"] is True


#: bf16 routing against the reference: the share of (token, layer)
#: top-k expert sets the two packages agree on. Measured 0.99915 (7 of
#: 8192 decisions flip) at tiny-moe, B=32, S=128, seed 0; the floor
#: leaves room for other CPU builds' summation orders.
ROUTE_AGREE_FLOOR = 0.995
#: bf16's machine epsilon (8 significant bits): a flipped choice must
#: be a near tie, its k-th and (k+1)-th router logits (the reference's)
#: closer than this share of the largest logit magnitude.
BF16_EPS = 2.0 ** -7


def test_bf16_expert_choice_agrees_with_the_reference_up_to_near_ties():
    """Both packages run tiny-moe's layers in bf16 from the same tokens
    and weights, each with its own numerics (dense attention), and pick
    each token's top-k experts from their own router logits (f32 over
    the bf16 hidden state). The choices agree but for near ties."""
    jc = jtfm.preset("tiny-moe", dtype=jnp.bfloat16)
    tc = ttfm.preset("tiny-moe", dtype=torch.bfloat16)
    pj, pt, _ = param_pair(jc, tc)
    toks = np.random.default_rng(0).integers(0, jc.vocab_size, (32, 128))
    B, S = toks.shape
    K = jc.expert_top_k
    xj = pj["embed"][jnp.asarray(toks)].astype(jc.dtype)
    xt = pt["embed"][torch.as_tensor(toks)].to(tc.dtype)
    sj, cj = jtfm.rope_tables(jc, S)
    st, ct = ttfm.rope_tables(tc, S)
    same, gaps, scale = [], [], 0.0
    for i in range(jc.n_layers):
        lj = jax.tree_util.tree_map(lambda w: w[i], pj["blocks"])
        lt = ttfm.layer_params(pt, i)
        q, k, v = jtfm.qkv_proj(xj, lj, jc, sj, cj)
        xj = jtfm.attn_residual(xj, jtfm._attention(q, k, v, jc), lj, jc)
        q, k, v = ttfm.qkv_proj(xt, lt, tc, st, ct)
        xt = ttfm.attn_residual(xt, ttfm._attention(q, k, v, tc), lt, tc)
        hj = jtfm.rms_norm(xj, lj["mlp_norm"]).reshape(B * S, -1)
        ht = ttfm.rms_norm(xt, lt["mlp_norm"]).reshape(B * S, -1)
        lg_j = np.asarray(hj.astype(jnp.float32)
                          @ lj["router"].astype(jnp.float32))
        lg_t = (ht.float() @ lt["router"].float()).numpy()
        pick_j = np.sort(np.argsort(-lg_j, axis=1)[:, :K], axis=1)
        pick_t = np.sort(np.argsort(-lg_t, axis=1)[:, :K], axis=1)
        same.append((pick_j == pick_t).all(axis=1))
        desc = -np.sort(-lg_j, axis=1)
        gaps.append(desc[:, K - 1] - desc[:, K])
        scale = max(scale, float(np.abs(lg_j).max()))
        xj, _ = jtfm.mlp_residual(xj, lj, jc)
        xt, _ = ttfm.mlp_residual(xt, lt, tc)
    same, gaps = np.concatenate(same), np.concatenate(gaps)
    # The measurement itself (shown with ``pytest -s``).
    print(f"bf16 top-{K} agreement {same.mean():.5f} "
          f"({int((~same).sum())} of {same.size} flipped), flip gaps "
          f"{np.sort(gaps[~same]).tolist()}, bound {BF16_EPS * scale:.5f}")
    assert same.mean() >= ROUTE_AGREE_FLOOR, same.mean()
    assert (gaps[~same] < BF16_EPS * scale).all(), (gaps[~same], scale)
