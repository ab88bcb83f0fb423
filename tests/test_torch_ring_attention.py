"""The port's ring and Ulysses attention against dense attention, on
gloo ranks: the reference's ``tests/test_ring_attention.py``, each test
on ranks of the port. Each rank holds its sequence block (and batch or
head block) of seeded numpy q, k, v; outputs and the grads of
``sum(o ** 2)`` are gathered whole and held against the reference's
dense ``_attention`` and ``jax.grad`` in f32 at the reference's
tolerances. The head counts the collectives carry are read by spying on
``collectives.ring_send`` and ``all_to_all_dims``.

One spawn of 2 ranks and one of 4 (``tests/torch_ranks.py`` suite
"ring"); a case runs on the spawn of its mesh's size."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ptype_tpu.models import transformer as jtfm
from ptype_tpu.parallel.mesh import build_mesh
from ptype_tpu.parallel.ring_attention import _chunk_width as jchunk_width
from ptype_tpu.parallel.ring_attention import make_ring_attention
from ptype_tpu.train import trainer as jtr
from ptype_tpu_torch.parallel.ring_attention import _chunk_width
from test_torch_train import LOSS_TOL
from torch_ranks import Ranks

CFG = jtfm.preset("tiny", dtype=jnp.float32)
OPT = dict(lr=1e-3, warmup=1, decay_steps=50)
#: The reference's tolerances: forward 2e-4, grads 5e-4; the chunked
#: ring and the flash-inner Ulysses 2e-5 forward, 2e-4/2e-5 grads.
FWD = dict(rtol=2e-4, atol=2e-4)
GRAD = dict(rtol=5e-4, atol=5e-4)
FWD_TIGHT = dict(rtol=2e-5, atol=2e-5)
GRAD_TIGHT = dict(rtol=2e-4, atol=2e-5)


def qkv(seed, B=2, S=32, H=4, K=None, Dh=16):
    rng = np.random.default_rng(seed)
    K = K or H
    return {"q": rng.standard_normal((B, S, H, Dh)).astype(np.float32),
            "k": rng.standard_normal((B, S, K, Dh)).astype(np.float32),
            "v": rng.standard_normal((B, S, K, Dh)).astype(np.float32)}


#: name → (world, axes, kind, q/k/v, options)
CASES = {
    "ring_seq2": (2, {"seq": 2}, "ring", qkv(0), {}),
    "ring_seq4": (4, {"seq": 4}, "ring", qkv(0), {}),
    "ring_gqa": (4, {"seq": 4}, "ring", qkv(1, H=4, K=2), {}),
    "ring_data": (4, {"data": 2, "seq": 2}, "ring", qkv(2), {}),
    "ring_rotates_kv": (4, {"seq": 4}, "ring", qkv(6, H=8, K=2), {}),
    "uly_exchanges_kv": (4, {"seq": 4}, "ulysses", qkv(7, H=8, K=4), {}),
    "uly_gqa": (4, {"seq": 4}, "ulysses", qkv(8, H=8, K=4), {}),
    "uly_pad": (4, {"seq": 4}, "ulysses", qkv(9, H=8, K=2), {}),
    "ring_model_pad": (4, {"seq": 2, "model": 2}, "ring",
                       qkv(10, H=8, K=1), {}),
    "uly_dense": (4, {"seq": 4}, "ulysses", qkv(3), {}),
    "ring_grads": (4, {"seq": 4}, "ring", qkv(4), {}),
    "ring_chunked": (4, {"seq": 4}, "ring", qkv(3, S=64),
                     {"score_chunk": 4}),
    "uly_flash_inner": (2, {"seq": 2}, "ulysses", qkv(5, H=4, K=2),
                        {"flash_inner": True}),
}


def dense(c):
    q, k, v = (jnp.asarray(c[x]) for x in "qkv")

    def loss(q, k, v):
        return jnp.sum(jtfm._attention(q, k, v, CFG) ** 2)

    grads = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    return np.asarray(jtfm._attention(q, k, v, CFG)), [np.asarray(g)
                                                        for g in grads]


def train_batch():
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 256, (4, 64)).astype(np.int32)
    return {"tokens": toks, "targets": toks}


def ref_train_loss(params):
    """The reference's train step with ring attention on {data, seq}."""
    mesh = build_mesh({"data": 2, "seq": 2})
    opt = jtr.default_optimizer(**OPT)
    state, sh = jtr.init_state(jax.random.PRNGKey(0), CFG, mesh, opt)
    state = jtr.TrainState(jax.device_put(params, sh.params),
                           state.opt_state, state.step)
    step = jtr.make_train_step(CFG, mesh, opt,
                               attn_fn=make_ring_attention(mesh),
                               seq_axis=True)
    _, out = step(state, train_batch())
    return float(out["loss"])


def _spawn(n, tmp_path_factory, params):
    cases = [dict(name=name, world=w, axes=axes, kind=kind, **arrs, **opts)
             for name, (w, axes, kind, arrs, opts) in CASES.items()]
    cases += [dict(name="train_ring", world=4, axes={"data": 2, "seq": 2},
                   kind="train"),
              dict(name="degrade", world=n, axes={"data": n},
                   kind="degrade")]
    return Ranks("ring", n, tmp_path_factory.mktemp(f"ring{n}"),
                 {"cases": cases, "params": params, "opt": OPT,
                  "train_batch": train_batch()})


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{name: rank 0's row} over both spawns, the dense targets, and the
    reference's ring train-step loss."""
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k: jtfm.init_params(k, CFG))(jax.random.PRNGKey(0)))
    spawns = {n: _spawn(n, tmp_path_factory, params) for n in (2, 4)}
    try:
        want = {name: dense(c[3]) for name, c in CASES.items()}
        ref_loss = ref_train_loss(params)
        got = {}
        for n, r in spawns.items():
            outs = r.join()
            got.update({f"{k}@{n}" if k == "degrade" else k: v
                        for k, v in outs[0].items()})
            got[f"train_all@{n}"] = [o.get("train_ring") for o in outs]
    except BaseException:
        for r in spawns.values():
            r._kill()
        raise
    return got, want, ref_loss


def _check(got, want, fwd=FWD, grad=GRAD, grads=True):
    o, gs = want
    np.testing.assert_allclose(got["o"], o, **fwd)
    if grads:
        np.testing.assert_allclose(got["dq"], gs[0], **grad)
        np.testing.assert_allclose(got["dk"], gs[1], **grad)
        np.testing.assert_allclose(got["dv"], gs[2], **grad)


@pytest.mark.parametrize("name", ["ring_seq2", "ring_seq4"])
def test_ring_matches_dense(ranks, name):
    got, want, _ = ranks
    _check(got[name], want[name], grads=False)


def test_ring_gqa_matches_dense(ranks):
    got, want, _ = ranks
    _check(got["ring_gqa"], want["ring_gqa"], grads=False)


def test_ring_with_data_axis(ranks):
    got, want, _ = ranks
    _check(got["ring_data"], want["ring_data"], grads=False)


def test_ring_degrades_without_axis(ranks):
    got, _, _ = ranks
    for n in (2, 4):
        assert got[f"degrade@{n}"] == {"ring": True, "ulysses": True}


def test_ring_rotates_kv_heads_not_query_heads(ranks):
    """GQA-native ring: every send carries K/V at kv_heads=2, never
    repeated to H=8 — three sends a pass around 4 ranks."""
    got, want, _ = ranks
    row = got["ring_rotates_kv"]
    assert row["heads"] == [2, 2, 2]
    _check(row, want["ring_rotates_kv"], grads=False)


def test_ulysses_exchanges_kv_heads_not_query_heads(ranks):
    """K/V exchanged at their own 4 heads, q at 8, the output back at
    8/4 = 2 a rank."""
    got, _, _ = ranks
    assert got["uly_exchanges_kv"]["heads"] == [8, 4, 4, 2]


def test_ulysses_gqa_matches_dense(ranks):
    got, want, _ = ranks
    _check(got["uly_gqa"], want["uly_gqa"], grads=False)


def test_ulysses_gqa_indivisible_heads_pads_minimally(ranks):
    """K=2 kv heads over a 4-way seq axis: repeated by n/gcd(K, n) = 2,
    to 4 heads, not to H=8."""
    got, want, _ = ranks
    row = got["uly_pad"]
    assert row["heads"] == [8, 4, 4, 2]
    _check(row, want["uly_pad"], grads=False)


def test_ring_gqa_with_model_axis_pads_minimally(ranks):
    """seq × model where kv_heads=1 does not divide model=2: K/V padded
    to lcm(K, m) = 2 heads (one a model rank), not to H=8; the output
    matches dense."""
    got, want, _ = ranks
    row = got["ring_model_pad"]
    assert row["heads"] and all(h <= 2 for h in row["heads"])
    assert row["heads"] == [1]
    np.testing.assert_allclose(row["o"], want["ring_model_pad"][0], **FWD)


def test_ulysses_matches_dense(ranks):
    got, want, _ = ranks
    _check(got["uly_dense"], want["uly_dense"], grads=False)


def test_ring_grads_match_dense(ranks):
    """Backward through the ring (the sends' backward sends gradients
    the other way) matches dense grads."""
    got, want, _ = ranks
    _check(got["ring_grads"], want["ring_grads"])


def test_train_step_with_ring_attention(ranks):
    """A train step with the sequence axis split ({data: 2, seq: 2}):
    every rank the same finite loss, the reference's ring step's."""
    got, _, ref_loss = ranks
    rows = got["train_all@4"]
    assert all(r["step"] == 1 for r in rows)
    losses = [r["loss"] for r in rows]
    assert np.isfinite(losses).all() and len(set(losses)) == 1
    np.testing.assert_allclose(losses[0], ref_loss, **LOSS_TOL)


def test_ring_chunked_scores_match_dense_fwd_and_grad(ranks):
    """score_chunk 4 against S_loc 16: four key chunks a ring step, the
    online-softmax state carried across both loops."""
    got, want, _ = ranks
    _check(got["ring_chunked"], want["ring_chunked"], FWD_TIGHT, GRAD_TIGHT)


def test_ring_chunk_width_picks_divisor():
    for s, c in ((1024, 512), (256, 512), (96, 64), (7, 4)):
        assert _chunk_width(s, c) == jchunk_width(s, c)
    assert _chunk_width(96, 64) == 48
    assert _chunk_width(7, 4) == 1


def test_ulysses_flash_inner_matches_dense(ranks):
    """The flash path (its plain forward and backward here) as the
    Ulysses inner attention, with the GQA head scatter: values and
    grads."""
    got, want, _ = ranks
    _check(got["uly_flash_inner"], want["uly_flash_inner"], FWD_TIGHT,
           GRAD_TIGHT)
