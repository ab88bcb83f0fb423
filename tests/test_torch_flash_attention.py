"""ptype_tpu_torch.ops.flash_attention against the reference Pallas
kernel (interpret mode, as its own tests run it on the CPU). On the
CPU the wrapper runs the plain PyTorch version; the CUDA kernel itself
is held against that version on the card (test_torch_kernels_cuda.py
and chip_smoke.py)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptype_tpu_torch.ops import flash_attention as tflash_mod
from ptype_tpu_torch.ops.flash_attention import (flash_attention,
                                                 flash_attention_plain)

# The reference package re-exports the function under the module's name.
jflash = importlib.import_module("ptype_tpu.ops.flash_attention")
#: Forward tolerance of the reference's own flash tests.
TOL = dict(rtol=2e-4, atol=2e-4)


def _qkv(seed, B=2, S=64, H=2, K=None, Dh=32):
    rng = np.random.default_rng(seed)
    K = K or H
    return (rng.normal(size=(B, S, H, Dh)).astype(np.float32),
            rng.normal(size=(B, S, K, Dh)).astype(np.float32),
            rng.normal(size=(B, S, K, Dh)).astype(np.float32))


@pytest.mark.parametrize("S,H,K,causal", [
    (64, 2, 2, True), (128, 2, 2, True), (64, 2, 2, False),
    (64, 4, 2, True), (128, 4, 1, False)])
def test_plain_matches_reference_kernel(S, H, K, causal):
    q, k, v = _qkv(S + H + K, S=S, H=H, K=K)
    want = jflash.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal,
                                  block_q=32, block_k=32, interpret=True)
    got = flash_attention(torch.tensor(q), torch.tensor(k),
                          torch.tensor(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_lse_matches_reference_lane_replicated_lse():
    q, k, v = _qkv(7, S=64, H=4, K=2)
    sw = lambda x: jnp.swapaxes(jnp.asarray(x), 1, 2)  # noqa: E731
    o_j, lse_j = jflash._fwd(sw(q), sw(k), sw(v), block_q=32, block_k=32,
                             causal=True, interpret=True)
    o_t, lse_t = flash_attention(torch.tensor(q), torch.tensor(k),
                                 torch.tensor(v), return_lse=True)
    assert lse_t.shape == (2, 4, 64) and lse_t.dtype == torch.float32
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j)[..., 0],
                               **TOL)
    np.testing.assert_allclose(o_t.numpy(),
                               np.asarray(jnp.swapaxes(o_j, 1, 2)), **TOL)


def test_cpu_tensors_take_the_plain_version_without_counting():
    q, k, v = (torch.tensor(a) for a in _qkv(3))
    before = flash_attention.launches
    got = flash_attention(q, k, v)
    assert flash_attention.launches == before
    assert torch.equal(got, flash_attention_plain(q, k, v))


def test_input_validation():
    q, k, v = (torch.tensor(a) for a in _qkv(4, H=3, K=2))
    with pytest.raises(ValueError, match="divide"):
        flash_attention(q, k, v)
    q, k, v = (torch.tensor(a) for a in _qkv(4))
    with pytest.raises(ValueError, match="dtypes"):
        flash_attention(q.to(torch.bfloat16), k, v)
    with pytest.raises(ValueError, match="match"):
        flash_attention(q, k[:, :32], v[:, :32])


def test_kernel_head_dims_cover_the_serving_presets():
    from ptype_tpu_torch.models import transformer as ttfm

    for name in ("optimus-125m", "optimus-350m", "llama-3-8b"):
        assert ttfm.preset(name).head_dim in tflash_mod.KERNEL_HEAD_DIMS
