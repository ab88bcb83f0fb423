"""Flash attention forward — the port of ``ptype_tpu/ops/flash_attention.py``.

On a CUDA tensor :func:`flash_attention` launches the hand-written
Hopper kernel ``csrc/flash_fwd.cu`` (it replaces the Pallas
``_fwd_kernel``; the source's header says what bounds it on the card
and what its design does about that). On a CPU tensor it runs
:func:`flash_attention_plain`, the same function in plain PyTorch —
the CPU tests hold that against the reference. There is no fallback
from one to the other: a CUDA tensor the kernel does not take raises.

Layout as in the reference's public API: (B, S, H, Dh) queries and
(B, S, K, Dh) keys/values, GQA with ``H % K == 0``. The kernel reads
that layout directly (no head-major copies) and writes the LSE, when
asked for, as a plain (B, H, S) f32 tensor.

The backward kernels (the reference's ``_dq_kernel``/``_dkv_kernel``)
are not ported yet: serving runs the forward only (ROADMAP).
"""

from __future__ import annotations

import ctypes
import math

import torch

from ptype_tpu_torch.ops import _build

NEG_INF = -1e30
#: Head dims the CUDA kernel is built for.
KERNEL_HEAD_DIMS = (64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(q, k, v, causal: bool = True,
                          return_lse: bool = False):
    """Plain PyTorch attention with the kernel's semantics: f32 scores
    and softmax, GQA by grouping, fully masked rows give zeros. Returns
    o like q, and the (B, H, S) f32 LSE when ``return_lse``."""
    B, S, H, Dh = q.shape
    K = k.shape[2]
    G = H // K
    qg = q.float().reshape(B, S, K, G, Dh)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) / math.sqrt(Dh)
    if causal:
        mask = torch.tril(torch.ones(S, S, dtype=torch.bool,
                                     device=q.device))
        s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    lsum = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgqs,bskd->bqkgd", p / lsum, v.float())
    o = o.reshape(B, S, H, Dh).to(q.dtype)
    if not return_lse:
        return o
    lse = (m + torch.log(lsum)).reshape(B, H, S)
    return o, lse


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"flash_attention: want q (B,S,H,Dh), k/v "
                         f"(B,S,K,Dh); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, Dh = q.shape
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != Dh:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"flash_attention: n_heads {H} must divide by "
                         f"n_kv_heads {k.shape[2]}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("flash_attention: q, k, v dtypes differ")


def flash_attention(q, k, v, causal: bool = True,
                    return_lse: bool = False):
    """Flash attention forward over (B, S, H, Dh) tensors.

    CUDA tensors go through the Hopper kernel (bf16 or f32, Dh in
    :data:`KERNEL_HEAD_DIMS`; any S — the ragged last tile is masked);
    CPU tensors through :func:`flash_attention_plain`.
    ``flash_attention.launches`` counts kernel launches."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    B, S, H, Dh = q.shape
    K = k.shape[2]
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention: kernel takes bf16 or f32, "
                         f"got {q.dtype}")
    if Dh not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention: kernel takes head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got {Dh}")
    if not (k.device == v.device == q.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(q)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if return_lse else None)
    lib = _build.load("flash_fwd")
    fn = lib.flash_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_void_p]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
              lse.data_ptr() if lse is not None else None,
              B, S, H, K, Dh, _DTYPES[q.dtype], int(bool(causal)),
              1.0 / math.sqrt(Dh), stream)
    _build.check(code, "flash_fwd", lib)
    flash_attention.launches += 1
    return (o, lse) if return_lse else o


flash_attention.launches = 0
