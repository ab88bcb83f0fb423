"""The port's GPipe and 1F1B pipeline over the ``stage`` axis against the
reference's ``tests/test_pipeline.py``, on gloo ranks: each reference
test has a counterpart here, the port's pipelined logits, losses and
gradients held against the reference's dense ones (and the two
schedules against each other) with the reference's tolerances, on the
reference's seed-0 tiny weights carried across.

One spawn of 2 ranks and one of 4 (``tests/torch_ranks.py`` suite
"pipeline", ranks on a ``{"stage": n}`` mesh); the reference runs in
this process while they do. The counterpart of
``tests/test_profiling.py``'s pipeline ``compiled_cost`` test is here
too."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptype_tpu.models import transformer as jtfm
from ptype_tpu.parallel import pipeline as jpp
from ptype_tpu.parallel.mesh import build_mesh
from ptype_tpu.train import trainer as jtr
from ptype_tpu_torch.errors import ClusterError
from ptype_tpu_torch.models import transformer as tfm
from ptype_tpu_torch.parallel import pipeline as pp
from torch_ranks import Ranks

CFG = jtfm.preset("tiny", n_layers=4, dtype=jnp.float32)
OPT = dict(lr=1e-3, warmup=1, decay_steps=50)
#: The reference's tolerances: pipelined forward 1e-4 (rtol and atol),
#: the linear chain 1e-5, grads 2e-3 relative with 2e-5 absolute, the
#: 1F1B loss 1e-5 relative, two schedules' step losses 1e-4 relative.
FWD = dict(rtol=1e-4, atol=1e-4)
CHAIN = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=2e-3, atol=2e-5)
LOSS = dict(rtol=1e-5)
STEPS = dict(rtol=1e-4)
#: bf16 losses of two layouts of one model: the reference's bound
#: (~3e-3 relative, tests/test_train.py).
BF16 = dict(rtol=3e-3)


def _inputs(tmp):
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k: jtfm.init_params(k, CFG))(jax.random.PRNGKey(0)))
    tb = rng.integers(0, CFG.vocab_size, (8, 16)).astype(np.int32)
    return {"params": params,
            "tokens_a": rng.integers(0, CFG.vocab_size,
                                     (4, 16)).astype(np.int32),
            "tokens_b": tb, "mask": (tb % 3 != 0).astype(np.float32),
            "chain_w": (rng.standard_normal((4, 8, 8)) * 0.5).astype(
                np.float32),
            "chain_x": rng.standard_normal((6, 8)).astype(np.float32),
            "opt": OPT, "ckpt_dir": str(tmp / "ckpt")}


def _dense_grads(params, tokens, mask=None):
    batch = {"tokens": jnp.asarray(tokens), "targets": jnp.asarray(tokens)}
    if mask is not None:
        batch["loss_mask"] = jnp.asarray(mask)
    loss, grads = jax.value_and_grad(
        lambda p: jtfm.loss_fn(p, batch, CFG))(params)
    return float(loss), jax.tree_util.tree_map(np.asarray, grads)


def _ref_train(params, batch, steps=3):
    """The reference's dense train step (a one-device mesh) — the state
    layout the pipelined step shares."""
    mesh = build_mesh({"data": 1})
    opt = jtr.default_optimizer(**OPT)
    state, sh = jtr.init_state(jax.random.PRNGKey(0), CFG, mesh, opt)
    state = jtr.TrainState(jax.device_put(params, sh.params),
                           state.opt_state, state.step)
    step = jtr.make_train_step(CFG, mesh, opt,
                               batch_keys=tuple(sorted(batch)))
    losses = []
    for _ in range(steps):
        state, out = step(state, batch)
        losses.append(float(out["loss"]))
    return losses


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Rank 0's outputs of both spawns (and every rank's cost), and the
    reference's dense results."""
    tmp = tmp_path_factory.mktemp("pipe")
    inp = _inputs(tmp)
    spawns = {n: Ranks("pipeline", n, tmp_path_factory.mktemp(f"pipe{n}"),
                       inp) for n in (2, 4)}
    try:
        p = jax.tree_util.tree_map(jnp.asarray, inp["params"])
        want = {
            "logits": np.asarray(jtfm.forward(
                p, jnp.asarray(inp["tokens_a"]), CFG)),
            "a": _dense_grads(p, inp["tokens_a"]),
            "b": _dense_grads(p, inp["tokens_b"]),
            "train": _ref_train(p, {
                "tokens": jnp.asarray(inp["tokens_b"]),
                "targets": jnp.asarray(inp["tokens_b"]),
                "loss_mask": jnp.asarray(inp["mask"])}),
        }
        got = {}
        for n, r in spawns.items():
            outs = r.join()
            got.update(outs[0])
            if n == 4:
                got["costs"] = [o["cost"] for o in outs]
    except BaseException:
        for r in spawns.values():
            r._kill()
        raise
    return got, want, inp


def _check_grads(got, want, tol=GRAD):
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    flat_g = {k: v for k, v in jax.tree_util.tree_flatten_with_path(got)[0]}
    assert set(flat_g) == set(flat_w)
    for path, leaf in flat_w.items():
        np.testing.assert_allclose(flat_g[path], leaf, err_msg=str(path),
                                   **tol)


def test_split_merge_roundtrip():
    params = jax.tree_util.tree_map(np.asarray, jtfm.init_params(
        jax.random.PRNGKey(0), CFG))
    blocks = {k: torch.from_numpy(np.array(v)) for k, v in
              params["blocks"].items()}
    staged = pp.split_stages(blocks, 2)
    assert staged["wq"].shape[:2] == (2, 2)
    want = jpp.split_stages(params["blocks"], 2)
    for k, v in staged.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]))
    for k, v in pp.merge_stages(staged).items():
        np.testing.assert_array_equal(v.numpy(), params["blocks"][k])


def test_split_indivisible_raises():
    blocks = {"wq": torch.zeros(4, 2)}
    with pytest.raises(ClusterError, match="not divisible"):
        pp.split_stages(blocks, 3)


def test_pipeline_apply_linear_chain(ranks):
    """4 stages of y = x @ w, 3 microbatches, against the sequential
    product (and the reference's pipeline_apply)."""
    got, _, inp = ranks
    want = inp["chain_x"]
    for w in inp["chain_w"]:
        want = want @ w
    np.testing.assert_allclose(got["chain"], want, **CHAIN)
    ref = jpp.pipeline_apply(
        lambda w, x: x @ w[0], jnp.asarray(inp["chain_w"]).reshape(
            4, 1, 8, 8), jnp.asarray(inp["chain_x"]),
        build_mesh({"stage": 4}), n_microbatches=3)
    np.testing.assert_allclose(got["chain"], np.asarray(ref), **CHAIN)


@pytest.mark.parametrize("n_mb", [2, 4])
def test_transformer_pipeline_matches_dense(ranks, n_mb):
    got, want, _ = ranks
    np.testing.assert_allclose(got[f"fwd{n_mb}"], want["logits"], **FWD)


def test_pipeline_grads_match_dense(ranks):
    """Backward through the GPipe loop (each send's backward the reverse
    rotation) equals the reference's dense grads."""
    got, want, _ = ranks
    loss, grads = want["a"]
    np.testing.assert_allclose(got["gpipe_loss"], loss, **LOSS)
    _check_grads(got["gpipe_grads"], grads)


def test_pipeline_train_step(ranks):
    """bf16, 4 stages × 4 microbatches: each rank holds a quarter of the
    layer stack and of its moments; 3 steps learn the repeated batch,
    the first step's loss the reference dense model's at bf16."""
    got, _, inp = ranks
    held = got["held"]
    assert held["wq"][0] == 1 and held["mu_wq"] == held["wq"]
    assert tuple(held["spec"]) == ("stage",)
    assert held["embed"] == tuple(inp["params"]["embed"].shape)
    losses = got["train_bf16"]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    bf = jtfm.preset("tiny", n_layers=4)
    p = jax.tree_util.tree_map(jnp.asarray, inp["params"])
    tb = jnp.asarray(inp["tokens_b"])
    ref = float(jtfm.loss_fn(p, {"tokens": tb, "targets": tb}, bf))
    np.testing.assert_allclose(losses[0], ref, **BF16)


def test_pipeline_refuses_moe():
    cfg = tfm.preset("tiny-moe")
    toks = torch.zeros((2, 8), dtype=torch.int64)
    with pytest.raises(ClusterError, match="MoE"):
        pp.transformer_pipeline_forward({}, toks, cfg, None, 2)
    with pytest.raises(ClusterError, match="MoE"):
        pp.pipeline_loss_and_grads_1f1b(
            {}, {"tokens": toks, "targets": toks}, cfg, None, 2)


def test_1f1b_loss_and_grads_match_gpipe(ranks):
    """The hand-scheduled 1F1B (recomputed stage VJPs, grads summed in
    the ring, the tail's VJP on the last stage) at 4 stages × 8
    microbatches computes GPipe's loss and grads — and the reference's
    dense ones."""
    got, want, _ = ranks
    np.testing.assert_allclose(got["f1b_loss"], got["gpipe8_loss"], **LOSS)
    _check_grads(got["f1b_grads"], got["gpipe8_grads"])
    loss, grads = want["b"]
    np.testing.assert_allclose(got["f1b_loss"], loss, **LOSS)
    _check_grads(got["f1b_grads"], grads)


def test_1f1b_train_step_parity_and_masked_loss(ranks):
    """``schedule="1f1b"`` drops into the train step: losses track
    GPipe's step for step with the mask honored, and the reference's
    dense train step's; the saved state is the reference's layout."""
    from ptype_tpu_torch.train import trainer as ttr

    got, want, inp = ranks
    gpipe, f1b = got["train_gpipe"], got["train_1f1b"]
    np.testing.assert_allclose(f1b, gpipe, **STEPS)
    np.testing.assert_allclose(f1b, want["train"], **STEPS)
    assert f1b[-1] < f1b[0]
    state = ttr.load_reference_state(inp["ckpt_dir"], tfm.preset(
        "tiny", n_layers=4, dtype=torch.float32), device="cpu")
    assert state.step == 3 and state.opt_state.count == 3
    np.testing.assert_array_equal(state.params["blocks"]["wq"].numpy(),
                                  got["final_wq"])


def test_1f1b_schedule_accounting():
    """4 stages, 8 microbatches: 1F1B bounds the live stash at 2S-1,
    GPipe's is M; at GPipe's budget 1F1B scales M and the bubble falls.
    Every figure equals the reference's."""
    S, M = 4, 8
    for sched in ("gpipe", "1f1b"):
        for m in (M, 4 * M):
            assert pp.schedule_info(S, m, sched) == \
                jpp.schedule_info(S, m, sched)
    gp, fb = pp.schedule_info(S, M, "gpipe"), pp.schedule_info(S, M, "1f1b")
    assert fb["stash_microbatches"] == 2 * S - 1 == 7
    assert gp["stash_microbatches"] == M == 8
    gp_at_budget = pp.schedule_info(S, gp["stash_microbatches"], "gpipe")
    fb_scaled = pp.schedule_info(S, 4 * M, "1f1b")
    assert fb_scaled["stash_microbatches"] == 7 < 4 * M
    assert fb_scaled["bubble_fraction"] < gp_at_budget["bubble_fraction"]
    with pytest.raises(ClusterError):
        pp.schedule_info(S, M, "nope")


def test_pipeline_with_flash_attention_matches_dense(ranks):
    """Stages resolve ``attn_impl`` like the dense path: "flash" (its
    plain twin on the CPU) pipelined matches the dense forward;
    sequence-parallel attention is refused, not run dense."""
    got, want, _ = ranks
    np.testing.assert_allclose(got["flash_fwd"], want["logits"], **FWD)
    ring = tfm.preset("tiny", n_layers=4, attn_impl="ring")
    with pytest.raises(ClusterError, match="nest"):
        pp.transformer_pipeline_forward({}, torch.zeros(
            (4, 16), dtype=torch.int64), ring, None, 2)


def test_pipeline_step_compiled_cost(ranks):
    """``health.profiling.compiled_cost`` prices a pipelined step (the
    counterpart of the reference's test_profiling check): every stage
    rank counts its own layers' matmuls and the replicated head, the
    same on each."""
    got, _, _ = ranks
    costs = got["costs"]
    assert all(c["flops"] > 0 and c["bytes_accessed"] > 0 for c in costs)
    assert len({c["flops"] for c in costs}) == 1
