"""Ring and Ulysses attention over the ``seq`` mesh axis — the port of
``ptype_tpu/parallel/ring_attention.py``: sequence parallelism for long
contexts.

Each rank holds one contiguous sequence block of Q, K and V (the batch's
sequence dim split over ``seq``, ``batch_spec(seq_axis=True)``), and the
attention functions take and return this rank's blocks.

- :func:`make_ring_attention`: K/V blocks rotate around the ``seq``
  group (``send``/``recv`` a step, the autograd-aware
  ``collectives.ring_send``, whose backward sends gradients the other
  way) while a chunked online softmax accumulates the output, causal
  masking on global positions. The body is plain PyTorch, as the
  reference's is plain ``jnp``, and autograd differentiates it whole.
  K/V rotate at their own head count (GQA: query heads grouped onto kv
  heads, never repeated).
- :func:`make_ulysses_attention`: two ``all_to_all`` exchanges trade the
  sequence split for a head split around a full-sequence attention —
  the port's flash kernels on CUDA, dense attention on the CPU. K/V are
  exchanged at their own head count, repeated only as much as the axis
  needs (``n / gcd(K, n)``).

Both degrade to one rank's whole-sequence attention when the axis is
absent or of size 1: the flash kernels on CUDA, dense attention on the
CPU, chosen per call by the tensors' device. A ``model`` axis splits
heads before attention is called (``models/transformer.py``, whose
``tp_kv_heads`` pads K/V minimally when their count does not divide
it), so each rank's q and k/v heads arrive grouped consistently.
"""

from __future__ import annotations

import math

import torch

from ptype_tpu_torch.parallel import collectives as C
from ptype_tpu_torch.parallel.mesh import axis_index, axis_size

NEG_INF = -1e30

#: Key-chunk width of the fused inner loop: the score transient is
#: (B, K, G, S_loc, 512) f32, never an (S_loc × S_loc) block.
RING_SCORE_CHUNK = 512


def _chunk_width(s_loc: int, chunk: int) -> int:
    """Largest divisor of ``s_loc`` that is <= ``chunk``."""
    c = min(chunk, s_loc)
    while s_loc % c:
        c -= 1
    return c


def _local_attention(q, k, v, cfg):
    """Whole-sequence attention on this rank: the flash kernels on CUDA,
    dense attention on the CPU (chosen per call by the tensors'
    device)."""
    from ptype_tpu_torch.models.transformer import _attention, _flash_attn_fn

    fn = _flash_attn_fn if q.device.type == "cuda" else _attention
    return fn(q, k, v, cfg)


def _ring_body(q, k, v, mesh, axis: str, n: int, causal: bool,
               score_chunk: int):
    """This rank's ring attention. q: (B, S, H, Dh); k, v: (B, S, K, Dh),
    this rank's sequence block. The online-softmax state (o, m, l), all
    f32, runs across key chunks within a ring step and across the ring
    steps; at step t this rank holds the K/V block (K and V stacked: one
    send a step) that started at ring position ``(idx - t) mod n``. A
    block wholly in this rank's future (causal) is skipped: every one of
    its scores would be masked, and its terms are exact zeros."""
    idx = axis_index(mesh, axis)
    B, S, H, Dh = q.shape
    K = k.shape[2]
    G = H // K
    qg = q.reshape(B, S, K, G, Dh).float()
    scale = 1.0 / math.sqrt(Dh)
    dev = q.device
    q_pos = idx * S + torch.arange(S, device=dev)
    Cw = _chunk_width(S, score_chunk)
    o = torch.zeros((B, S, K, G, Dh), dtype=torch.float32, device=dev)
    m = torch.full((B, K, G, S), NEG_INF, dtype=torch.float32, device=dev)
    lsum = torch.zeros((B, K, G, S), dtype=torch.float32, device=dev)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=dev)
    kv = torch.stack([k, v])
    for t in range(n):
        src = (idx - t) % n
        if not (causal and src > idx):
            for c0 in range(0, S, Cw):
                ks = kv[0, :, c0:c0 + Cw].float()
                vs = kv[1, :, c0:c0 + Cw]
                scores = torch.einsum("bqngd,bsnd->bngqs", qg, ks) * scale
                if causal:
                    k_pos = src * S + c0 + torch.arange(Cw, device=dev)
                    allowed = q_pos[:, None] >= k_pos[None, :]
                    scores = torch.where(allowed[None, None, None], scores,
                                         neg)
                m_new = torch.maximum(m, scores.amax(dim=-1))
                corr = torch.exp(m - m_new)
                p = torch.exp(scores - m_new[..., None])
                lsum = lsum * corr + p.sum(dim=-1)
                pv = torch.einsum("bngqs,bsnd->bqngd", p.to(vs.dtype),
                                  vs).float()
                o = o * corr.permute(0, 3, 1, 2)[..., None] + pv
                m = m_new
        if t < n - 1:
            kv = C.ring_send(kv, mesh, axis)
    # Every rank must run every send's backward (each is a send/recv
    # pair), but a causal rank skips the blocks from its future, the
    # last one held among them: tie that block in with a zero weight so
    # the gradient chain back through all the sends exists everywhere.
    o = o / lsum.permute(0, 3, 1, 2)[..., None] + 0.0 * kv.sum()
    return o.reshape(B, S, H, Dh).to(q.dtype)


def make_ring_attention(mesh, axis: str = "seq",
                        score_chunk: int = RING_SCORE_CHUNK):
    """An ``attn_fn(q, k, v, cfg)`` running ring attention over ``axis``
    on this rank's sequence blocks; :func:`_local_attention` when the
    axis is absent or of size 1. ``score_chunk`` bounds the inner loop's
    score transient."""
    n = axis_size(mesh, axis)
    if n <= 1:
        return _local_attention

    def attn_fn(q, k, v, cfg):
        return _ring_body(q, k, v, mesh, axis, n, cfg.causal, score_chunk)

    return attn_fn


def make_ulysses_attention(mesh, axis: str = "seq", inner_attn=None):
    """Ulysses sequence parallelism: an ``all_to_all`` trades this
    rank's sequence block of every head for the whole sequence of
    ``1/n`` of the heads, ``inner_attn`` attends over it, and the
    inverse exchange trades back. ``inner_attn`` defaults to
    :func:`_local_attention`, which is also the whole function when the
    axis is absent or of size 1."""
    inner = inner_attn or _local_attention
    n = axis_size(mesh, axis)
    if n <= 1:
        return inner

    def attn_fn(q, k, v, cfg):
        H, K = q.shape[2], k.shape[2]
        if H % n:
            raise ValueError(
                f"ulysses: n_heads {H} must divide by seq axis size {n}")
        if K % n:
            # K/V heads that do not divide the axis: repeat each just
            # enough that they do, never all the way to H.
            rep = n // math.gcd(K, n)
            k = torch.repeat_interleave(k, rep, dim=2)
            v = torch.repeat_interleave(v, rep, dim=2)

        def exch(x):   # (B, S/n, h, Dh) → (B, S, h/n, Dh)
            return C.all_to_all_dims(x, mesh, axis, 2, 1)

        o = inner(exch(q), exch(k), exch(v), cfg)
        return C.all_to_all_dims(o, mesh, axis, 1, 2)

    return attn_fn
