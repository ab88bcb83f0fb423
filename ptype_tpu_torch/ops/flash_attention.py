"""Flash attention, forward and backward — the port of
``ptype_tpu/ops/flash_attention.py``.

On CUDA tensors three hand-written Hopper kernels run: the forward
``csrc/flash_fwd.cu`` (it replaces the Pallas ``_fwd_kernel``) and the
backward pair in ``csrc/flash_bwd.cu`` (``_dq_kernel`` and
``_dkv_kernel``); each source's header says what bounds it on the card
and what its design does about that. :class:`_Flash` wires them as a
``torch.autograd.Function``, the counterpart of the reference's
``jax.custom_vjp``: the forward writes the LSE row only when a gradient
will be asked for, and the backward launches the dq kernel, then the
dk/dv kernel. On CPU tensors the same function runs in plain PyTorch —
:func:`flash_attention_plain` and :func:`flash_attention_bwd_plain` —
which the CPU tests hold against the reference. There is no fallback
from a kernel to its plain version: a CUDA tensor a kernel does not
take raises.

Layout as in the reference's public API: (B, S, H, Dh) queries and
(B, S, K, Dh) keys/values, GQA with ``H % K == 0``. The kernels read
that layout directly (no head-major copies). The LSE is a plain
(B, H, S) f32 row and ``delta = rowsum(dO∘O)`` a (B, S, H) f32 row.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ptype_tpu_torch.ops import _build, count_launch

NEG_INF = -1e30
#: Head dims the CUDA kernels are built for.
KERNEL_HEAD_DIMS = (64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _causal_mask(S: int, device) -> torch.Tensor:
    return torch.tril(torch.ones(S, S, dtype=torch.bool, device=device))


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
        s = s.masked_fill(~_causal_mask(S, q.device), NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    lsum = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgqs,bskd->bqkgd", p / lsum, v.float())
    o = o.reshape(B, S, H, Dh).to(q.dtype)
    if not return_lse:
        return o
    lse = (m + torch.log(lsum)).reshape(B, H, S)
    return o, lse


def bwd_delta(o, do) -> torch.Tensor:
    """``delta = rowsum(dO∘O)``, the (B, S, H) f32 row both backward
    kernels read (the reference also forms it outside its kernels)."""
    return (o.float() * do.float()).sum(-1)


def _bwd_plain(q, k, v, do, lse, delta, causal, want_dq, want_dkv):
    """The backward from its explicit formulas, in f32:
    ``P = exp(S·scale − lse)``, ``dV = Σ_group Pᵀ dO``, ``dP = dO Vᵀ``,
    ``dS = P∘(dP − delta)·scale``, ``dQ = dS K``, ``dK = Σ_group dSᵀ Q``.
    Returns (dq | None, dk | None, dv | None) in the inputs' dtypes."""
    B, S, H, Dh = q.shape
    K = k.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(Dh)
    qg = q.float().reshape(B, S, K, G, Dh)
    dog = do.float().reshape(B, S, K, G, Dh)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * scale
    if causal:
        s = s.masked_fill(~_causal_mask(S, q.device), NEG_INF)
    p = torch.exp(s - lse.reshape(B, K, G, S, 1))
    dp = torch.einsum("bqkgd,bskd->bkgqs", dog, v.float())
    rows = delta.permute(0, 2, 1).reshape(B, K, G, S, 1)
    ds = p * (dp - rows) * scale
    dq = dk = dv = None
    if want_dq:
        dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.float())
        dq = dq.reshape(B, S, H, Dh).to(q.dtype)
    if want_dkv:
        dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qg).to(k.dtype)
        dv = torch.einsum("bkgqs,bqkgd->bskd", p, dog).to(v.dtype)
    return dq, dk, dv


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal: bool = True):
    """The whole backward in plain PyTorch — ``(dq, dk, dv)`` from the
    forward's ``o`` and (B, H, S) ``lse`` and the output gradient
    ``do``. Not autograd of the plain forward: the same algebra the
    kernels compute, so the CPU tests check that algebra."""
    return _bwd_plain(q, k, v, do, lse, bwd_delta(o, do), causal,
                      True, True)


def flash_attention_dq_plain(q, k, v, do, lse, delta, causal=True):
    """The dq kernel's function in plain PyTorch."""
    return _bwd_plain(q, k, v, do, lse, delta, causal, True, False)[0]


def flash_attention_dkv_plain(q, k, v, do, lse, delta, causal=True):
    """The dk/dv kernel's function in plain PyTorch: ``(dk, dv)``."""
    return _bwd_plain(q, k, v, do, lse, delta, causal, False, True)[1:]


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


def _check_kernel(what: str, *tensors) -> None:
    """What a kernel takes: CUDA tensors on one device, bf16 or f32,
    head_dim in :data:`KERNEL_HEAD_DIMS`."""
    q = tensors[0]
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"{what}: kernel takes bf16 or f32, got {q.dtype}")
    if q.shape[-1] not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{what}: kernel takes head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got {q.shape[-1]}")
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{what}: tensors on different devices")


def _bind(source: str, name: str, n_ptr: int):
    """C entry ``name`` of ``csrc/<source>.cu``: ``n_ptr`` pointers, then
    (B, S, H, K, Dh, dtype, causal), the scale and the stream."""
    return _build.bind(source, name, [ctypes.c_void_p] * n_ptr
                       + [ctypes.c_int] * 7 + [ctypes.c_float,
                                               ctypes.c_void_p])


def _dims(q, k, causal):
    B, S, H, Dh = q.shape
    return (B, S, H, k.shape[2], Dh, _DTYPES[q.dtype], int(bool(causal)),
            1.0 / math.sqrt(Dh),
            torch.cuda.current_stream(q.device).cuda_stream)


def _forward(q, k, v, causal: bool, want_lse: bool):
    """One forward over contiguous q, k, v: the kernel on CUDA tensors,
    the plain version on CPU tensors. Returns (o, lse | None)."""
    if q.device.type == "cpu":
        if want_lse:
            return flash_attention_plain(q, k, v, causal, True)
        return flash_attention_plain(q, k, v, causal), None
    _check_kernel("flash_attention", q, k, v)
    B, S, H, _ = q.shape
    o = torch.empty_like(q)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if want_lse else None)
    code = _bind("flash_fwd", "flash_fwd", 5)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr() if lse is not None else None, *_dims(q, k, causal))
    _build.check(code, "flash_fwd", "flash_fwd")
    count_launch(flash_attention)
    return o, lse


def _check_rows(q, lse, delta) -> None:
    B, S, H, _ = q.shape
    if lse.shape != (B, H, S) or delta.shape != (B, S, H):
        raise ValueError(f"flash backward: want lse (B,H,S) and delta "
                         f"(B,S,H) f32; got {tuple(lse.shape)}, "
                         f"{tuple(delta.shape)}")
    if lse.dtype != torch.float32 or delta.dtype != torch.float32:
        raise ValueError("flash backward: lse and delta must be f32")


def flash_attention_dq(q, k, v, do, lse, delta, causal: bool = True):
    """dq of flash attention. CUDA tensors launch the dq kernel of
    ``csrc/flash_bwd.cu`` (counted in ``flash_attention_dq.launches``);
    CPU tensors take :func:`flash_attention_dq_plain`."""
    _check(q, k, v)
    _check_rows(q, lse, delta)
    if q.device.type == "cpu":
        return flash_attention_dq_plain(q, k, v, do, lse, delta, causal)
    _check_kernel("flash_attention_dq", q, k, v, do, lse, delta)
    q, k, v, lse, delta = (t.contiguous() for t in (q, k, v, lse, delta))
    do = do.to(q.dtype).contiguous()
    dq = torch.empty_like(q)
    code = _bind("flash_bwd", "flash_bwd_dq", 7)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        *_dims(q, k, causal))
    _build.check(code, "flash_bwd_dq", "flash_bwd")
    count_launch(flash_attention_dq)
    return dq


def flash_attention_dkv(q, k, v, do, lse, delta, causal: bool = True):
    """(dk, dv) of flash attention, summed over each GQA group. CUDA
    tensors launch the dk/dv kernel of ``csrc/flash_bwd.cu`` (counted in
    ``flash_attention_dkv.launches``); CPU tensors take
    :func:`flash_attention_dkv_plain`."""
    _check(q, k, v)
    _check_rows(q, lse, delta)
    if q.device.type == "cpu":
        return flash_attention_dkv_plain(q, k, v, do, lse, delta, causal)
    _check_kernel("flash_attention_dkv", q, k, v, do, lse, delta)
    q, k, v, lse, delta = (t.contiguous() for t in (q, k, v, lse, delta))
    do = do.to(q.dtype).contiguous()
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    code = _bind("flash_bwd", "flash_bwd_dkv", 8)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *_dims(q, k, causal))
    _build.check(code, "flash_bwd_dkv", "flash_bwd")
    count_launch(flash_attention_dkv)
    return dk, dv


class _Flash(torch.autograd.Function):
    """Differentiable flash attention: the counterpart of the
    reference's ``_flash`` / ``_flash_fwd`` / ``_flash_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, return_lse):
        grads = any(ctx.needs_input_grad[:3])
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = _forward(q, k, v, causal, return_lse or grads)
        ctx.causal = causal
        if grads:
            ctx.save_for_backward(q, k, v, o, lse)
        if return_lse:
            ctx.mark_non_differentiable(lse)
            return o, lse
        return o

    @staticmethod
    def backward(ctx, do, *_):
        q, k, v, o, lse = ctx.saved_tensors
        if q.device.type == "cpu":
            dq, dk, dv = flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                   ctx.causal)
        else:
            delta = bwd_delta(o, do)
            do = do.contiguous()
            dq = flash_attention_dq(q, k, v, do, lse, delta, ctx.causal)
            dk, dv = flash_attention_dkv(q, k, v, do, lse, delta,
                                         ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = True,
                    return_lse: bool = False):
    """Flash attention over (B, S, H, Dh) tensors, differentiable.

    CUDA tensors go through the Hopper kernels (bf16 or f32, Dh in
    :data:`KERNEL_HEAD_DIMS`; any S — the ragged last tile is masked);
    CPU tensors through the plain versions. When autograd is recording
    and an input requires grad, the call goes through :class:`_Flash`:
    the forward also writes the LSE and saves (q, k, v, o, lse) for the
    backward. Otherwise (serving under ``torch.no_grad()``) it runs the
    forward alone and writes no LSE unless ``return_lse`` asks for it.

    Kernel launches are counted in ``flash_attention.launches``
    (forward), ``flash_attention_dq.launches`` and
    ``flash_attention_dkv.launches`` (backward)."""
    _check(q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Flash.apply(q, k, v, causal, return_lse)
    o, lse = _forward(q.contiguous(), k.contiguous(), v.contiguous(),
                      causal, return_lse)
    return (o, lse) if return_lse else o


flash_attention.launches = 0
flash_attention_dq.launches = 0
flash_attention_dkv.launches = 0
