"""KV-block migration: the wire between serving classes — the port of
``ptype_tpu/serve_engine/migrate.py``.

Disaggregated serving splits the fleet into prefill-class and
decode-class replicas: a prefill replica fills a prompt's KV blocks,
then migrates the block set to the decode replica that owns the
request for its whole decode lifetime. This module is the wire between
them. Per migrated block:

- ``kv_wire="q8"`` (default): block-scaled int8 with per-block
  error-feedback residuals (:func:`~ptype_tpu_torch.parallel.
  collectives.quantize_leaf`). The residual stays on the PREFILL side,
  keyed by the block's chain hash — a shared prefix block re-exported
  to a second decode replica carries the previous transfer's
  quantization error folded in, so repeated transfers of the same
  content do not accumulate bias.
- ``kv_wire="exact"``: raw-dtype passthrough, the bit-exact mode that
  parity tests hold greedy tokens with. A bf16 bank ships its raw bits
  as ``uint8`` plus ``"dtype": "bfloat16"`` (numpy has no bfloat16) —
  the reference's own format, so either package unpacks the other's
  payload.

Only blocks the target does not already hold ride the wire: the
manifest is :func:`~ptype_tpu_torch.serve_engine.blocks.block_hashes`'s
chain-hash family, so the decode side's content-verified residency
check is exact, and dedup hits are counted, never re-sent.

Pack reads one block pair and copies it to the host: that copy is the
one sanctioned synchronization, and the engine runs it under its
dispatch lock on the stream it launches on, so it reads a finished
bank. Unpack uploads through pinned memory and writes the target banks
IN PLACE (``kb[:, bid].copy_(...)``): the engine's device mirrors, its
draft pool and its speculation windows hold references to the bank
tensors, so a bank is never rebound.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from ptype_tpu_torch import jitwatch
from ptype_tpu_torch.parallel.collectives import (_Q8_KEY,
                                                  DEFAULT_QUANT_BLOCK,
                                                  _dq_int8_blockwise,
                                                  _q_int8_blockwise,
                                                  dequantize_leaf,
                                                  quantize_leaf)

#: The two wire encodings ``kv_wire`` accepts.
WIRE_MODES = ("q8", "exact")


def _wire_leaf(t: torch.Tensor) -> dict:
    """Codec-safe exact-mode leaf from a host tensor: a dtype numpy has
    ships as itself; bf16 ships as its raw bits + the dtype name (bit
    exactness is a view, not a cast)."""
    if t.dtype == torch.bfloat16:
        return {"raw": t.view(torch.uint8).numpy(), "dtype": "bfloat16"}
    return {"raw": t.numpy()}


def _unwire_leaf(leaf: dict) -> torch.Tensor:
    """Inverse of :func:`_wire_leaf`: a host tensor (a decoded wire's
    numpy leaves, or tensors)."""
    raw = leaf["raw"]
    t = (torch.from_numpy(np.array(raw, copy=True))
         if isinstance(raw, np.ndarray) else raw.contiguous())
    if leaf.get("dtype") == "bfloat16":
        t = t.view(torch.bfloat16)
    return t


def _host(t: torch.Tensor) -> torch.Tensor:
    """The pack's wire hop: a device-to-host copy, the one sanctioned
    synchronisation of a migration."""
    with jitwatch.sanctioned_transfer("serve.migrate"):
        return t.detach().contiguous().cpu()


def _upload(arr, device: torch.device) -> torch.Tensor:
    """A host array or tensor on ``device``, through pinned memory on
    CUDA (a pageable host-to-device copy synchronizes the stream)."""
    t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(
        np.array(arr, copy=True))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class KVMigrator:
    """Per-engine wire state: pack/unpack plus the prefill-side
    error-feedback residual store.

    Residuals are keyed by the block's CHAIN hash (content-stable —
    the same key the pool's dedup index uses), bounded by an LRU of
    ``max_residuals`` block pairs, and live on the bank's device; the
    unsealed partial tail block of a prompt has no hash and carries no
    residual. Thread contract: calls come from request threads under
    the engine's dispatch lock."""

    def __init__(self, block_shape, bank_dtype: torch.dtype, *,
                 q_block: int | None = DEFAULT_QUANT_BLOCK,
                 max_residuals: int = 64):
        self.block_shape = tuple(int(d) for d in block_shape)
        self.bank_dtype = bank_dtype
        self.q_block = q_block
        self.max_residuals = int(max_residuals)
        #: hash -> (res_k, res_v), LRU oldest-first.
        self._res: collections.OrderedDict[int, tuple] = \
            collections.OrderedDict()

    # ------------------------------------------------------------- pack

    def pack_block(self, kb: torch.Tensor, vb: torch.Tensor, bid: int,
                   h: int | None, mode: str) -> tuple[dict, int]:
        """Encode block ``bid`` of banks ``(kb, vb)`` for the wire.
        Returns ``(payload, nbytes)``; the payload holds numpy leaves
        only (codec-marshalable)."""
        if mode not in WIRE_MODES:
            raise ValueError(f"kv_wire must be one of {WIRE_MODES}, "
                             f"got {mode!r}")
        if mode == "exact":
            k, v = _host(kb[:, bid]), _host(vb[:, bid])
            payload = {"k": _wire_leaf(k), "v": _wire_leaf(v)}
            nbytes = (k.numel() * k.element_size()
                      + v.numel() * v.element_size())
            return payload, nbytes
        if h is None:  # the partial tail: no residual is kept
            wk = quantize_leaf(kb[:, bid], self.q_block,
                               want_residual=False)[0]
            wv = quantize_leaf(vb[:, bid], self.q_block,
                               want_residual=False)[0]
        else:
            rk, rv = self._res.pop(h, (None, None))
            wk, rk = self._quantize_into(kb[:, bid], rk)
            wv, rv = self._quantize_into(vb[:, bid], rv)
            self._res[h] = (rk, rv)
            while len(self._res) > self.max_residuals:
                self._res.popitem(last=False)
        # One device-to-host copy of the four wire tensors.
        qk, sk, qv, sv = (_host(t) for t in (wk["q"], wk["s"], wv["q"],
                                              wv["s"]))
        payload = {"k": {"q": qk.numpy(), "s": sk.numpy()},
                   "v": {"q": qv.numpy(), "s": sv.numpy()}}
        nbytes = sum(t.numel() * t.element_size()
                     for t in (qk, sk, qv, sv))
        return payload, nbytes

    def _quantize_into(self, x: torch.Tensor, res: torch.Tensor | None):
        """:func:`quantize_leaf` of one block with its residual consumed
        in place (the reference's pack program donates it): the
        pre-quantization sum is built in a fresh f32 buffer and the new
        error is written into ``res``'s own storage, allocated on a
        block's first pack. Returns ``(wire, res)``."""
        flat = x.to(torch.float32, copy=True).reshape(1, -1)
        if res is not None and res.shape == x.shape:
            flat.add_(res.reshape(1, -1))
        else:
            res = torch.empty(x.shape, dtype=x.dtype, device=x.device)
        q, scale = _q_int8_blockwise(flat, self.q_block)
        torch.sub(flat, _dq_int8_blockwise(q, scale, flat.shape[1]),
                  out=res.view(1, -1))
        return {_Q8_KEY: 1, "q": q[0], "s": scale[0],
                "shape": list(x.shape),
                "dtype": str(x.dtype).removeprefix("torch.")}, res

    # ----------------------------------------------------------- unpack

    def unpack_block(self, kb: torch.Tensor, vb: torch.Tensor,
                     payload: dict, bid: int, mode: str) -> None:
        """Write one wire payload into banks at ``bid``, in place."""
        dev = kb.device
        if mode == "exact":
            k = _upload(_unwire_leaf(payload["k"]), dev)
            v = _upload(_unwire_leaf(payload["v"]), dev)
        else:
            shape = list(self.block_shape)
            dstr = str(kb.dtype).removeprefix("torch.")
            k, v = (dequantize_leaf({
                _Q8_KEY: 1, "q": _upload(payload[n]["q"], dev),
                "s": _upload(payload[n]["s"], dev), "shape": shape,
                "dtype": dstr}) for n in ("k", "v"))
        kb[:, bid].copy_(k.reshape(kb[:, bid].shape))
        vb[:, bid].copy_(v.reshape(vb[:, bid].shape))

    # -------------------------------------------------------- residuals

    def residual_count(self) -> int:
        return len(self._res)
