"""The port's flash backward against the reference's Pallas backward
(``jax.vjp`` through its kernel in interpret mode, as the reference's
own tests run it on the CPU). On the CPU, ``_Flash`` runs the plain
forward and :func:`flash_attention_bwd_plain`; the CUDA kernels are
held against those plain versions on the card
(test_torch_kernels_cuda.py and chip_smoke.py)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptype_tpu_torch.ops import flash_attention as tflash

jflash = importlib.import_module("ptype_tpu.ops.flash_attention")
#: The reference's own tolerance for flash grads
#: (tests/test_flash_attention.py).
TOL = dict(rtol=5e-4, atol=5e-4)


def _inputs(seed, B=2, S=64, H=2, K=None, Dh=32):
    rng = np.random.default_rng(seed)
    K = K or H
    f = np.float32
    return (rng.normal(size=(B, S, H, Dh)).astype(f),
            rng.normal(size=(B, S, K, Dh)).astype(f),
            rng.normal(size=(B, S, K, Dh)).astype(f),
            rng.normal(size=(B, S, H, Dh)).astype(f))


def _reference_grads(q, k, v, do, causal):
    def f(q, k, v):
        return jflash.flash_attention(q, k, v, causal=causal, block_q=32,
                                      block_k=32, interpret=True)

    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


CASES = [  # (S, H, K, causal)
    (64, 2, 2, True), (64, 2, 2, False), (64, 4, 2, True),
    (96, 4, 2, False)]


@pytest.mark.parametrize("S,H,K,causal", CASES)
def test_bwd_plain_matches_reference_pallas_backward(S, H, K, causal):
    q, k, v, do = _inputs(S + H + K + causal, S=S, H=H, K=K)
    want = _reference_grads(q, k, v, do, causal)
    tq, tk, tv, tdo = map(torch.tensor, (q, k, v, do))
    o, lse = tflash.flash_attention_plain(tq, tk, tv, causal,
                                          return_lse=True)
    got = tflash.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo, causal)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), b, err_msg=f"d{name}", **TOL)


@pytest.mark.parametrize("S,H,K,causal", CASES)
def test_flash_function_grads_match_reference(S, H, K, causal):
    q, k, v, do = _inputs(7 + S + H + K, S=S, H=H, K=K)
    want = _reference_grads(q, k, v, do, causal)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    o = tflash.flash_attention(tq, tk, tv, causal=causal)
    assert o.grad_fn is not None
    o.backward(torch.tensor(do))
    for name, t, b in zip("qkv", (tq, tk, tv), want):
        np.testing.assert_allclose(t.grad.numpy(), b, err_msg=f"d{name}",
                                   **TOL)


def test_dq_and_dkv_wrappers_take_the_plain_version_on_the_cpu():
    q, k, v, do = map(torch.tensor, _inputs(3, H=4, K=2))
    o, lse = tflash.flash_attention_plain(q, k, v, True, return_lse=True)
    delta = tflash.bwd_delta(o, do)
    assert delta.shape == (2, 64, 4) and delta.dtype == torch.float32
    before = (tflash.flash_attention_dq.launches,
              tflash.flash_attention_dkv.launches)
    dq = tflash.flash_attention_dq(q, k, v, do, lse, delta)
    dk, dv = tflash.flash_attention_dkv(q, k, v, do, lse, delta)
    assert (tflash.flash_attention_dq.launches,
            tflash.flash_attention_dkv.launches) == before
    want = tflash.flash_attention_bwd_plain(q, k, v, o, lse, do)
    for a, b in zip((dq, dk, dv), want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="lse"):
        tflash.flash_attention_dq(q, k, v, do, lse.transpose(1, 2), delta)


def _spy_forward(monkeypatch):
    calls = []
    real = tflash._forward

    def spy(q, k, v, causal, want_lse):
        calls.append(want_lse)
        return real(q, k, v, causal, want_lse)

    monkeypatch.setattr(tflash, "_forward", spy)
    return calls


def test_no_grad_forward_saves_nothing_and_writes_no_lse(monkeypatch):
    calls = _spy_forward(monkeypatch)
    q, k, v, _ = (torch.tensor(x, requires_grad=True)
                  for x in _inputs(4, H=4, K=2))
    with torch.no_grad():
        o = tflash.flash_attention(q, k, v)
    assert o.grad_fn is None and not o.requires_grad
    assert calls == [False]
    # Inputs that need no grad take the same forward-only path.
    o = tflash.flash_attention(q.detach(), k.detach(), v.detach())
    assert o.grad_fn is None
    assert calls == [False, False]


def test_grad_mode_forward_writes_the_lse_and_saves_the_residuals(
        monkeypatch):
    calls = _spy_forward(monkeypatch)
    q, k, v, _ = (torch.tensor(x, requires_grad=True)
                  for x in _inputs(5, H=4, K=2))
    o = tflash.flash_attention(q, k, v)
    assert calls == [True]
    assert type(o.grad_fn).__name__ == "_FlashBackward"
    saved = o.grad_fn.saved_tensors
    assert [tuple(t.shape) for t in saved] == [
        (2, 64, 4, 32), (2, 64, 2, 32), (2, 64, 2, 32), (2, 64, 4, 32),
        (2, 4, 64)]


def test_return_lse_under_grad_gives_a_non_differentiable_lse():
    q, k, v, do = _inputs(6)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    o, lse = tflash.flash_attention(tq, tk, tv, return_lse=True)
    assert not lse.requires_grad and lse.shape == (2, 2, 64)
    ro, rl = tflash.flash_attention_plain(tq.detach(), tk.detach(),
                                          tv.detach(), return_lse=True)
    assert torch.equal(o.detach(), ro) and torch.equal(lse, rl)
    o.backward(torch.tensor(do))
    assert tq.grad is not None and tk.grad is not None
