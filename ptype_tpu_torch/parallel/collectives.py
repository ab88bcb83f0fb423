"""Block-scaled int8 leaf codec with error feedback — the port's copy
of the host-side wire codec of ``ptype_tpu/parallel/collectives.py``
(``_q_int8_blockwise``, ``_dq_int8_blockwise``, ``quantize_leaf``,
``dequantize_leaf``). The collectives themselves are not ported yet.

The arithmetic follows the reference step for step, so ``q`` and ``s``
match it bit for bit: the leaf is flattened to f32 and the residual
added in f32; each block's scale is ``amax / 127`` in f32 (1 for an
all-zero block); the quantized value is ``round(x / scale)`` — a
division, not a product with a reciprocal, rounded half to even —
clipped to ±127; the new residual is the f32 error cast back to the
leaf's dtype.
"""

from __future__ import annotations

import torch

#: Default elements per quantization scale block: small enough that one
#: outlier poisons a small share of a leaf, large enough that the f32
#: scale overhead stays under 1% of the int8 bytes.
DEFAULT_QUANT_BLOCK = 512

#: Marker key of a quantized leaf (the reference's wire name).
_Q8_KEY = "__ptype_q8__"

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64}


def _q_int8_blockwise(chunks: torch.Tensor, block: int | None):
    """Int8-quantize ``chunks: (m, c)`` f32 with one absmax scale per
    ``block`` contiguous elements (``None``: one scale per chunk). Each
    chunk zero-pads to a block multiple; zero blocks quantize exactly.
    Returns ``(q (m, nb, block) int8, scales (m, nb) f32)``."""
    m, c = chunks.shape
    block = c if block is None else min(int(block), c)
    pad = (-c) % block
    if pad:
        chunks = torch.nn.functional.pad(chunks, (0, pad))
    b = chunks.reshape(m, -1, block)
    amax = b.abs().amax(dim=2)
    # A tensor divisor: CUDA divides by a Python scalar as a product
    # with its reciprocal, which is 1 ulp off the quotient for ~5% of
    # values.
    scale = torch.where(amax == 0.0, torch.ones_like(amax),
                        amax / torch.full_like(amax, 127.0)
                        ).to(torch.float32)
    q = torch.clamp(torch.round(b.to(torch.float32) / scale[:, :, None]),
                    -127, 127).to(torch.int8)
    return q, scale


def _dq_int8_blockwise(q: torch.Tensor, scale: torch.Tensor, c: int):
    """Inverse of :func:`_q_int8_blockwise`: ``(m, nb, block)`` int8 +
    ``(m, nb)`` scales → ``(m, c)`` f32 (the block pad dropped)."""
    out = q.to(torch.float32) * scale[:, :, None]
    return out.reshape(q.shape[0], -1)[:, :c]


def quantize_leaf(x: torch.Tensor, q_block: int | None = DEFAULT_QUANT_BLOCK,
                  residual: torch.Tensor | None = None, *,
                  want_residual: bool = True):
    """Block-scaled int8 encoding of one tensor (+ an optional
    error-feedback residual added in before quantizing). Returns
    ``(wire_dict, new_residual)``; non-float tensors pass through
    unquantized (``new_residual=None``). ``want_residual=False`` skips
    the dequantize-and-subtract."""
    if not x.is_floating_point() or x.numel() == 0:
        return {_Q8_KEY: 0, "raw": x}, None
    flat = x.to(torch.float32).reshape(1, -1)
    if residual is not None and residual.numel() == x.numel():
        flat = flat + residual.reshape(1, -1).to(torch.float32)
    q, scale = _q_int8_blockwise(flat, q_block)
    new_res = None
    if want_residual:
        new_res = (flat - _dq_int8_blockwise(q, scale, flat.shape[1])
                   ).reshape(x.shape).to(x.dtype)
    return {_Q8_KEY: 1, "q": q[0], "s": scale[0], "shape": list(x.shape),
            "dtype": str(x.dtype).removeprefix("torch.")}, new_res


def dequantize_leaf(wire: dict) -> torch.Tensor:
    """Inverse of :func:`quantize_leaf`; ``q``/``s`` may be tensors or
    numpy arrays (a decoded wire)."""
    if not wire.get(_Q8_KEY):
        return wire["raw"]
    n = 1
    for d in wire["shape"]:
        n *= int(d)
    q, s = torch.as_tensor(wire["q"]), torch.as_tensor(wire["s"])
    out = _dq_int8_blockwise(q[None], s[None].to(q.device), n)
    return out.reshape(wire["shape"]).to(_DTYPES[wire["dtype"]])
