"""Paged decode attention — the port of ``ptype_tpu/ops/paged_attention.py``.

On CUDA tensors :func:`paged_attention` launches the hand-written
Hopper kernels of ``csrc/paged_decode.cu`` (they replace the Pallas
``_paged_kernel``; the source's header says what bounds them on the card
and what the design does about that): a split-K pass over each row's
pages into an f32 workspace this module allocates, then an ordered
combine, one call and one count. On CPU tensors it runs
:func:`paged_attention_plain`, the same function in plain PyTorch. No
fallback between them: a CUDA input the kernel does not take raises.

The kernel reads the bank layer in its native ``(n_blocks, bt, Kh,
Dh)`` layout — the reference's whole-layer transpose (a Mosaic tiling
workaround) is not carried over. Convention as in the reference:
attend positions ``<= pos`` (the gather path is given ``pos + 1``).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ptype_tpu_torch.ops import _build

NEG_INF = -1e30
KERNEL_HEAD_DIMS = (64, 128)
#: Most query heads per kv head the kernel holds in registers.
KERNEL_MAX_GROUP = 8
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def paged_attention_plain(q, kc, vc, tables, pos):
    """Plain PyTorch decode attention through block tables: gather each
    row's blocks in table (= position) order, mask columns ``> pos``,
    f32 softmax. Rows that attend nothing give zeros."""
    B, _, H, Dh = q.shape
    _, bt, Kh, _ = kc.shape
    nb = tables.shape[1]
    tables = tables.long()
    ks = kc[tables].reshape(B, nb * bt, Kh, Dh).float()
    vs = vc[tables].reshape(B, nb * bt, Kh, Dh).float()
    qg = q.float().reshape(B, Kh, H // Kh, Dh)
    s = torch.einsum("bkgd,bskd->bkgs", qg, ks) / math.sqrt(Dh)
    cols = torch.arange(nb * bt, device=q.device)
    valid = cols[None, :] <= pos.long()[:, None]          # (B, S)
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * valid[:, None, None, :]
    lsum = p.sum(dim=-1, keepdim=True)
    lsum = torch.where(lsum == 0, torch.ones_like(lsum), lsum)
    o = torch.einsum("bkgs,bskd->bkgd", p / lsum, vs)
    return o.reshape(B, 1, H, Dh).to(q.dtype)


def kernel_geometry_problems(H: int, Kh: int, Dh: int,
                             dtype=torch.bfloat16) -> list[str]:
    """Why the CUDA kernel cannot take this geometry (empty: it can).
    The engine checks this at construction, as the reference's engine
    consulted ``check_tpu_lowering``."""
    bad = []
    if H % Kh:
        bad.append(f"n_heads {H} not divisible by kv_heads {Kh}")
    elif H // Kh > KERNEL_MAX_GROUP:
        bad.append(f"query group {H // Kh} exceeds {KERNEL_MAX_GROUP}")
    if Dh not in KERNEL_HEAD_DIMS:
        bad.append(f"head_dim {Dh} not in {KERNEL_HEAD_DIMS}")
    if dtype not in _DTYPES:
        bad.append(f"dtype {dtype} not bf16/f32")
    return bad


@functools.lru_cache(maxsize=64)
def _workspace_floats(device_index, B, H, Kh, Dh, nb) -> int:
    """f32 elements of the workspace the kernels need for these shapes
    (the split depends on the card's SM count, hence the device)."""
    fn = _build.bind("paged_decode", "paged_decode_workspace",
                     [ctypes.c_int] * 5, ctypes.c_longlong)
    with torch.cuda.device(device_index):
        return fn(B, H, Kh, Dh, nb) // 4


def paged_attention(q, kc, vc, tables, pos):
    """Decode attention through block tables, one bank layer at a time.

    q: (B, 1, H, Dh); kc/vc: (n_blocks, bt, Kh, Dh) bank layer;
    tables: (B, nb) int32 position-ordered block ids; pos: (B,) int32
    current position (attend ``<= pos``). Returns (B, 1, H, Dh).
    ``paged_attention.launches`` counts kernel calls (the split pass and
    its combine count once)."""
    B, Q, H, Dh = q.shape
    n_blocks, bt, Kh, Dh2 = kc.shape
    if Q != 1 or Dh2 != Dh or vc.shape != kc.shape:
        raise ValueError(f"paged_attention: want q (B,1,H,Dh) and bank "
                         f"(n_blocks,bt,Kh,Dh); got {tuple(q.shape)}, "
                         f"{tuple(kc.shape)}, {tuple(vc.shape)}")
    if H % Kh:
        raise ValueError(f"paged_attention: n_heads {H} must divide by "
                         f"kv_heads {Kh}")
    if q.device.type == "cpu":
        return paged_attention_plain(q, kc, vc, tables, pos)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    bad = kernel_geometry_problems(H, Kh, Dh, q.dtype)
    if bad:
        raise ValueError("paged_attention: " + "; ".join(bad))
    if not (kc.dtype == vc.dtype == q.dtype):
        raise ValueError("paged_attention: q and bank dtypes differ")
    for t in (kc, vc, tables, pos):
        if t.device != q.device:
            raise ValueError("paged_attention: inputs on different devices")
    if not (kc.is_contiguous() and vc.is_contiguous()):
        raise ValueError("paged_attention: bank layers must be contiguous")
    q = q.contiguous()
    tables = tables.to(torch.int32).contiguous()
    pos = pos.to(torch.int32).contiguous()
    nb = tables.shape[1]
    out = torch.empty_like(q)
    ws = torch.empty(_workspace_floats(q.device.index, B, H, Kh, Dh, nb),
                     dtype=torch.float32, device=q.device)
    fn = _build.bind("paged_decode", "paged_decode",
                     [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                     + [ctypes.c_float, ctypes.c_void_p])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = fn(q.data_ptr(), kc.data_ptr(), vc.data_ptr(),
              tables.data_ptr(), pos.data_ptr(), out.data_ptr(),
              ws.data_ptr(), B, H, Kh, Dh, bt, nb, _DTYPES[q.dtype],
              1.0 / math.sqrt(Dh), stream)
    _build.check(code, "paged_decode", "paged_decode")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
