"""Autoregressive generation — the port of ``ptype_tpu/models/generate.py``.

Contiguous KV-cache generation (:func:`prefill`, :func:`decode_step`,
:func:`generate`) and the paged steps the serving engine runs
(:func:`decode_step_paged`, :func:`prefill_paged_chunk`), with the
reference's semantics: left-padded ragged prompts, greedy or
temperature/top-k/top-p sampling, repetition penalty, stop/pad.

PyTorch idiom where JAX needed its own:

- the ``lax.scan`` over layers is a Python loop over the stacked dim;
  the reference's scanned decode loop is a Python loop over steps;
- cache and bank writes are IN PLACE (``kc[wr_b, wr_o] = k``) where the
  reference returned updated arrays through donated ``.at[].set`` —
  the functions still return the (same) tensors, so call sites read as
  in the reference;
- randomness comes from an explicit ``torch.Generator``: sampling step
  ``i`` draws one ``(B, V)`` uniform from it. The draws are Philox's,
  not threefry's, so sampled tokens match the reference in
  distribution, not draw for draw; greedy tokens match exactly.

Speculative decoding (:func:`truncated_draft_params`,
:func:`draft_propose_paged`, :func:`verify_step_paged`,
:func:`spec_accept_rows`) runs the draft and the verify through the
gather path, as the reference does. Where the reference folds a domain
constant into a row's key, a sampled row here carries two more
generators (:func:`folded_generator`), one for draft draws and one for
acceptance draws.

Every MoE layer runs at a zero-drop capacity (the entry point's token
count), as in the reference: dropping is a training regularizer, and
a dropped token at decode would change greedy output silently.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import numpy as np
import torch

from ptype_tpu_torch.models import transformer as tfm

NEG = -1e30


@dataclass
class KVCache:
    """Stacked per-layer KV: (L, B, Smax, Kh, Dh). Written in place."""

    k: torch.Tensor
    v: torch.Tensor


def init_cache(cfg: tfm.TransformerConfig, batch: int,
               max_seq: int | None = None, device="cpu") -> KVCache:
    S = max_seq or cfg.max_seq
    shape = (cfg.n_layers, batch, S, cfg.kv_heads, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=cfg.dtype, device=device),
                   torch.zeros(shape, dtype=cfg.dtype, device=device))


def _masked_softmax_attend(qg, ks, vs, mask, out_shape):
    """The grouped-GQA attention both cached paths share: scores
    computed in the compute dtype then cast to f32 (as the reference's
    ``einsum(...).astype(f32)``), masked with -1e30, softmax, probs
    cast back, einsum against V."""
    Dh = qg.shape[-1]
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, ks).float()
    scores = scores / math.sqrt(Dh)
    scores = torch.where(mask, scores, NEG)
    probs = torch.softmax(scores, dim=-1).to(qg.dtype)
    o = torch.einsum("bkgqs,bskd->bqkgd", probs, vs)
    return o.reshape(out_shape)


def _cached_attention(q, k_cache, v_cache, pos_limit, cfg,
                      valid_from=None):
    """q: (B, 1, H, Dh); caches (B, Smax, Kh, Dh); attend to positions
    < pos_limit (int, or (B,) per row). ``valid_from`` (B,): per-row
    first valid slot (left-padded ragged prompts)."""
    B, _, H, Dh = q.shape
    Kh = k_cache.shape[2]
    qg = q.reshape(B, 1, Kh, H // Kh, Dh)
    cols = torch.arange(k_cache.shape[1], device=q.device)
    pos_limit = torch.as_tensor(pos_limit, device=q.device)
    if pos_limit.dim() == 1:
        mask = cols[None, :] < pos_limit[:, None]
    else:
        mask = (cols < pos_limit)[None, :].expand(B, -1)
    if valid_from is not None:
        mask = mask & (cols[None, :] >= valid_from[:, None])
    return _masked_softmax_attend(qg, k_cache, v_cache,
                                  mask[:, None, None, None, :],
                                  (B, 1, H, Dh))


def _head_logits(params, x_last, cfg):
    return tfm.head_logits(x_last, tfm.head_weight(params, cfg), cfg)


def use_flash_prefill(cfg: tfm.TransformerConfig, S: int, ragged: bool,
                      device) -> bool:
    """The reference's prefill routing rule (``generate.py:166-170``):
    uniform causal prompts with S a multiple of 128 that the clamped
    1024 block divides, when the resolved impl is "flash". Both packages
    send the same shapes down the same path."""
    impl = cfg.attn_impl
    if impl == "auto":
        impl = tfm.default_attn_impl(device)
    return (not ragged and cfg.causal and impl == "flash"
            and S % 128 == 0 and S % min(1024, S) == 0)


def prefill(params: dict, tokens: torch.Tensor,
            cfg: tfm.TransformerConfig, cache: KVCache,
            prompt_lens: torch.Tensor | None = None,
            last_index: torch.Tensor | None = None):
    """Full-sequence forward, filling ``cache[:, :, :S]`` in place.
    Returns (logits (B, V) at the last column — or at ``last_index`` —
    and the cache). ``prompt_lens`` (B,): LEFT-padded ragged prompts.
    MoE layers run at the zero-drop capacity ``B·S``: dropping is a
    training regularizer, and here batch composition (left padding
    first in token priority) would decide which tokens drop."""
    B, S = tokens.shape
    dev = tokens.device
    x = params["embed"][tokens].to(cfg.dtype)
    if prompt_lens is None:
        sin, cos = tfm.rope_tables(cfg, S, device=dev)
        kv_mask = None
    else:
        pad = S - prompt_lens
        positions = torch.clamp(
            torch.arange(S, device=dev)[None, :] - pad[:, None], min=0)
        sin, cos = tfm.rope_tables(cfg, positions=positions)
        kv_mask = torch.arange(S, device=dev)[None, :] >= pad[:, None]

    if use_flash_prefill(cfg, S, kv_mask is not None, dev):
        from ptype_tpu_torch.ops.flash_attention import flash_attention

        def attn(q, k, v):
            return flash_attention(q, k, v, causal=True)
    else:
        def attn(q, k, v):
            return tfm._attention(q, k, v, cfg, kv_mask=kv_mask)

    for i in range(cfg.n_layers):
        layer = tfm.layer_params(params, i)
        q, k, v = tfm.qkv_proj(x, layer, cfg, sin, cos)
        x = tfm.attn_residual(x, attn(q, k, v), layer, cfg)
        x, _ = tfm.mlp_residual(x, layer, cfg, moe_capacity=B * S)
        cache.k[i, :, :S] = k
        cache.v[i, :, :S] = v
    x = tfm.rms_norm(x, params["final_norm"])
    x_last = (x[:, -1] if last_index is None
              else x[torch.arange(B, device=dev), last_index])
    return _head_logits(params, x_last, cfg), cache


def decode_step(params: dict, token: torch.Tensor, pos: int,
                cfg: tfm.TransformerConfig, cache: KVCache,
                rope_pos: torch.Tensor | None = None,
                valid_from: torch.Tensor | None = None):
    """One decode step: token (B,) at cache slot ``pos`` (int). Returns
    (logits (B, V), cache). Ragged prompts pass ``rope_pos`` (B,) token
    positions and ``valid_from`` (B,) first valid slots. MoE layers run
    at capacity ``B`` (each token's k experts are distinct)."""
    dev = token.device
    B = token.shape[0]
    x = params["embed"][token][:, None, :].to(cfg.dtype)
    if rope_pos is None:
        sin, cos = tfm.rope_tables(
            cfg, positions=torch.tensor([pos], device=dev))
    else:
        sin, cos = tfm.rope_tables(cfg, positions=rope_pos[:, None])
    for i in range(cfg.n_layers):
        layer = tfm.layer_params(params, i)
        q, k, v = tfm.qkv_proj(x, layer, cfg, sin, cos)
        kc, vc = cache.k[i], cache.v[i]
        kc[:, pos] = k[:, 0]
        vc[:, pos] = v[:, 0]
        o = _cached_attention(q, kc, vc, pos + 1, cfg,
                              valid_from=valid_from)
        x = tfm.attn_residual(x, o, layer, cfg)
        x, _ = tfm.mlp_residual(x, layer, cfg, moe_capacity=B)
    x = tfm.rms_norm(x, params["final_norm"])
    return _head_logits(params, x[:, 0], cfg), cache


def _paged_attention_gather(q, kc, vc, tables, pos_limit, cfg):
    """Attention through a block table by gathering the table's blocks
    (the reference's XLA gather path). q: (B, Q, H, Dh); kc/vc
    (n_blocks, bt, Kh, Dh); tables (B, nb); ``pos_limit`` (B,) per row
    or (B, Q) per query: attend columns < limit."""
    B, Q, H, Dh = q.shape
    nb = tables.shape[1]
    bt, Kh = kc.shape[1], kc.shape[2]
    tables = tables.long()
    ks = kc[tables].reshape(B, nb * bt, Kh, Dh)
    vs = vc[tables].reshape(B, nb * bt, Kh, Dh)
    qg = q.reshape(B, Q, Kh, H // Kh, Dh)
    cols = torch.arange(nb * bt, device=q.device)
    pos_limit = torch.as_tensor(pos_limit, device=q.device)
    if pos_limit.dim() == 1:
        mask = cols[None, None, :] < pos_limit[:, None, None]
    else:
        mask = cols[None, None, :] < pos_limit[:, :, None]
    return _masked_softmax_attend(qg, ks, vs, mask[:, None, None, :, :],
                                  (B, Q, H, Dh))


def decode_step_paged(params: dict, token: torch.Tensor,
                      pos: torch.Tensor, cfg: tfm.TransformerConfig,
                      kb: torch.Tensor, vb: torch.Tensor,
                      tables: torch.Tensor, wr_blocks: torch.Tensor,
                      wr_off: torch.Tensor, attn_impl: str = "gather"):
    """One decode step through per-sequence block tables. ``kb``/``vb``
    (L, n_blocks, bt, Kh, Dh) banks; row b writes its new K/V at
    ``(wr_blocks[b], wr_off[b])`` in place (the engine routes inactive
    rows to trash block 0) and attends through ``tables``.
    ``attn_impl="kernel"`` goes through :func:`ops.paged_attention`
    (the Hopper kernel on CUDA), "gather" through the gather path. MoE
    layers run at capacity ``B``. Returns (logits (B, V), kb, vb)."""
    if attn_impl not in ("gather", "kernel"):
        raise ValueError(f"attn_impl must be 'gather'|'kernel', "
                         f"got {attn_impl!r}")
    if attn_impl == "kernel":
        from ptype_tpu_torch.ops.paged_attention import paged_attention
    B = token.shape[0]
    x = params["embed"][token][:, None, :].to(cfg.dtype)
    sin, cos = tfm.rope_tables(cfg, positions=pos[:, None])
    wr_blocks, wr_off = wr_blocks.long(), wr_off.long()
    for i in range(cfg.n_layers):
        layer = tfm.layer_params(params, i)
        q, k, v = tfm.qkv_proj(x, layer, cfg, sin, cos)
        kc, vc = kb[i], vb[i]
        kc[wr_blocks, wr_off] = k[:, 0]
        vc[wr_blocks, wr_off] = v[:, 0]
        if attn_impl == "kernel":
            o = paged_attention(q, kc, vc, tables, pos)
        else:
            o = _paged_attention_gather(q, kc, vc, tables, pos + 1, cfg)
        x = tfm.attn_residual(x, o, layer, cfg)
        x, _ = tfm.mlp_residual(x, layer, cfg, moe_capacity=B)
    x = tfm.rms_norm(x, params["final_norm"])
    return _head_logits(params, x[:, 0], cfg), kb, vb


def prefill_paged_chunk(params: dict, tokens: torch.Tensor,
                        start: int | torch.Tensor,
                        length: int | torch.Tensor,
                        cfg: tfm.TransformerConfig, kb: torch.Tensor,
                        vb: torch.Tensor, table: torch.Tensor):
    """One chunk of paged prefill for one sequence: ``tokens`` (1, C)
    holds positions ``[start, start + length)`` (right-padded past
    ``length`` to the chunk's bucket C); ``table`` (nb,) its block
    table. ``start`` and ``length`` are ints or 0-d tensors on the
    tokens' device (the reference's ``jnp.int32``s): nothing here reads
    a tensor back, so the chunk can be captured as a graph and replayed
    over new inputs. K/V of real tokens are written in place into their
    blocks; a pad column writes the trash block 0's own value back (the
    reference writes the pad's K/V there: block 0 is never read, and
    this way the bank after a chunk does not depend on which of several
    writes to one trash slot lands last). Query c attends every
    position through ``start + c``. MoE layers run at the zero-drop
    capacity ``C``. Returns (logits (1, V) at the chunk's last real
    token, kb, vb)."""
    B, C = tokens.shape
    dev = tokens.device
    bt = kb.shape[2]
    nb = table.shape[0]
    x = params["embed"][tokens].to(cfg.dtype)
    pos_vec = start + torch.arange(C, device=dev)
    sin, cos = tfm.rope_tables(cfg, positions=pos_vec[None])
    valid = torch.arange(C, device=dev) < length
    wr_b = torch.where(valid,
                       table.long()[torch.clamp(pos_vec // bt, 0, nb - 1)],
                       0)
    wr_o = pos_vec % bt
    limits = torch.where(valid, pos_vec + 1, 0)
    keep = valid[:, None, None]
    for i in range(cfg.n_layers):
        layer = tfm.layer_params(params, i)
        q, k, v = tfm.qkv_proj(x, layer, cfg, sin, cos)
        kc, vc = kb[i], vb[i]
        kc[wr_b, wr_o] = torch.where(keep, k[0], kc[wr_b, wr_o])
        vc[wr_b, wr_o] = torch.where(keep, v[0], vc[wr_b, wr_o])
        o = _paged_attention_gather(q, kc, vc, table[None], limits[None],
                                    cfg)
        x = tfm.attn_residual(x, o, layer, cfg)
        x, _ = tfm.mlp_residual(x, layer, cfg, moe_capacity=C)
    x = tfm.rms_norm(x, params["final_norm"])
    # The last real token by a device index (an int length is filled in
    # on the device: no host-to-device copy).
    last = (length if isinstance(length, torch.Tensor)
            else torch.full((), int(length), device=dev)) - 1
    x_last = x.index_select(1, last.reshape(1).long())[:, 0]
    return _head_logits(params, x_last, cfg), kb, vb


# ------------------------------------------------- speculative decoding

#: RNG domain constants of the speculative path (the reference folds the
#: same two into a row's key): a sampled row's draft draws and its
#: acceptance draws come from generators seeded from the request's seed
#: and these, so neither shares a stream with the row's plain sampling
#: generator, which is seeded with the seed itself.
_DRAFT_FOLD = 0x5bec
_ACCEPT_FOLD = 0xacce


def folded_generator(seed: int, fold: int, device) -> torch.Generator:
    """The generator of one RNG domain of a request: seeded with a mix
    of the request's ``seed`` and the domain's ``fold`` constant."""
    mixed = (int(seed) * 0x100000001B3 + int(fold)) % (1 << 63)
    return torch.Generator(device=device).manual_seed(mixed)


def truncated_draft_params(params: dict, cfg: tfm.TransformerConfig,
                           n_layers: int = 1):
    """The shared-prefix-truncated draft: the target's embedding, final
    norm, LM head and FIRST ``n_layers`` blocks. The stacked blocks are
    sliced on their leading dim, so the draft's tensors are views of
    the target's: zero extra memory. Returns ``(draft_params,
    draft_cfg)`` for ``SpecConfig``."""
    if not 1 <= n_layers <= cfg.n_layers:
        raise ValueError(
            f"truncated draft needs 1 <= n_layers <= {cfg.n_layers}, "
            f"got {n_layers}")
    blocks = {name: w[:n_layers] for name, w in params["blocks"].items()}
    return dict(params, blocks=blocks), replace(cfg, n_layers=n_layers)


def verify_step_paged(params: dict, tokens: torch.Tensor,
                      pos0: torch.Tensor, cfg: tfm.TransformerConfig,
                      kb: torch.Tensor, vb: torch.Tensor,
                      tables: torch.Tensor, wr_b: torch.Tensor,
                      wr_o: torch.Tensor):
    """Target verification of one speculation window in one batched
    forward. ``tokens`` (B, W): each row's last committed token and its
    draft proposals, at positions ``pos0 + [0, W)``; every position's
    K/V is written in place at ``(wr_b, wr_o)`` (B, W) (the engine
    routes inactive lanes and positions past a row's span to trash
    block 0), and query ``j`` attends through position ``pos0 + j`` on
    the gather path. MoE layers run at capacity ``B·W``. Returns
    (logits (B, W, V) f32, kb, vb): ``logits[:, j]`` scores the token at
    position ``pos0 + j + 1``. Rejected positions need no clean-up:
    their writes sit in the row's own blocks, hidden by the position
    limit until overwritten."""
    B, W = tokens.shape
    x = params["embed"][tokens].to(cfg.dtype)
    pos = pos0.long()[:, None] + torch.arange(W, device=tokens.device)
    sin, cos = tfm.rope_tables(cfg, positions=pos)
    limits = pos + 1
    wr_b, wr_o = wr_b.long(), wr_o.long()
    for i in range(cfg.n_layers):
        layer = tfm.layer_params(params, i)
        q, k, v = tfm.qkv_proj(x, layer, cfg, sin, cos)
        kc, vc = kb[i], vb[i]
        kc[wr_b, wr_o] = k
        vc[wr_b, wr_o] = v
        o = _paged_attention_gather(q, kc, vc, tables, limits, cfg)
        x = tfm.attn_residual(x, o, layer, cfg)
        x, _ = tfm.mlp_residual(x, layer, cfg, moe_capacity=B * W)
    x = tfm.rms_norm(x, params["final_norm"])
    return _head_logits(params, x, cfg), kb, vb


def draft_propose_paged(params: dict, tok: torch.Tensor,
                        pos0: torch.Tensor, cfg: tfm.TransformerConfig,
                        kb: torch.Tensor, vb: torch.Tensor,
                        tables: torch.Tensor, wr_b: torch.Tensor,
                        wr_o: torch.Tensor, generators, temps, top_ks,
                        top_ps, n_steps: int, sampled: bool = True):
    """``n_steps`` draft decode steps through the draft's own block
    tables (:func:`decode_step_paged` on the gather path, capacity
    ``B``). Step ``j`` feeds the previous token at position ``pos0 + j``,
    writes its K/V at ``(wr_b[:, j], wr_o[:, j])`` and picks the next
    token: the argmax for greedy rows, a draw from the row's draft
    generator (``generators[b]``) over the same filtered, temperature-
    scaled logits the acceptance test scores for sampled rows. The
    engine runs ``n_steps = k + 1``: the last step's K/V covers the
    all-accepted case and its proposal is discarded. Returns
    (proposed (B, n_steps) int64, draft_logits (B, n_steps, V) f32, kb,
    vb)."""
    toks, lgs = [], []
    for j in range(n_steps):
        lg, kb, vb = decode_step_paged(params, tok, pos0 + j, cfg, kb, vb,
                                       tables, wr_b[:, j], wr_o[:, j])
        if sampled:
            tok = sample_token_rows(lg, generators, temps, top_ks, top_ps)
        else:
            tok = torch.argmax(lg, dim=-1)
        toks.append(tok)
        lgs.append(lg)
    return torch.stack(toks, dim=1), torch.stack(lgs, dim=1), kb, vb


def spec_accept_rows(draft_toks: torch.Tensor, draft_logits: torch.Tensor,
                     target_logits: torch.Tensor, generators, temps,
                     top_ks, top_ps, sampled: bool = True):
    """Acceptance over one speculation window. ``draft_toks`` (B, k),
    ``draft_logits`` (B, k, V) and ``target_logits`` (B, k+1, V) raw
    f32; ``temps``, ``top_ks`` and ``top_ps`` per row, as
    :func:`sample_token_rows` takes them.

    Greedy rows (``temps[b] == 0``): accept the longest draft prefix
    matching the target's argmax chain, then emit the target argmax at
    the first mismatch — the tokens sequential greedy decode gives,
    whatever the draft proposed. Sampled rows: token ``j`` is accepted
    with probability ``min(1, p_j(d_j) / q_j(d_j))``, where ``p`` and
    ``q`` are the filtered, temperature-scaled target and draft
    distributions; the first rejection draws from ``max(p − q, 0)``
    renormalised, and a window accepted whole draws its bonus token
    from ``p_k``, so the emitted stream is distributed as sampling the
    target directly. A sampled window computes every row that way on
    the device, with no host read, and ``where`` keeps the greedy
    result for rows with temperature 0, as the reference's vmapped rows
    do. Each row's acceptance generator (``generators[b]``; None draws
    nothing) draws k uniforms, then one (V,) Gumbel vector. Returns
    (out (B, k+1) int64, n_acc (B,)): row ``b`` emits
    ``out[b, :n_acc[b] + 1]``."""
    B, k = draft_toks.shape
    rows = torch.arange(B, device=draft_toks.device)
    gt = torch.argmax(target_logits, dim=-1)                   # (B, k+1)
    match = (draft_toks == gt[:, :k]).long()
    out = torch.cat([draft_toks, torch.zeros_like(draft_toks[:, :1])],
                    dim=1)
    if not sampled:
        n_acc = torch.cumprod(match, dim=1).sum(dim=1)
        out[rows, n_acc] = gt[rows, n_acc]
        return out, n_acc
    V, dev = target_logits.shape[-1], target_logits.device
    t = _row_values(temps, dev, torch.float32)
    tk = _row_values(top_ks, dev)[:, None]
    tp = _row_values(top_ps, dev, torch.float32)[:, None]

    def dist(lg):  # raw (B, n, V) logits -> filtered sampling probs
        x = _scaled(lg, t[:, None, None])
        return torch.softmax(_filter_logits_traced(x, tk, tp), dim=-1)

    p = dist(target_logits)                                    # (B, k+1, V)
    q = dist(draft_logits)                                     # (B, k, V)
    d = draft_toks[..., None]
    ratio = (p[:, :k].gather(2, d)[..., 0]
             / torch.clamp(q.gather(2, d)[..., 0], min=1e-30))
    u = _row_uniforms(generators, k, dev)
    g = _gumbel(_row_uniforms(generators, V, dev))
    samples = t > 0.0
    ok = torch.where(samples[:, None], u < torch.clamp(ratio, max=1.0),
                     match.bool())
    n_acc = torch.cumprod(ok.long(), dim=1).sum(dim=1)
    at = n_acc[:, None, None].expand(B, 1, V)
    p_at = p.gather(1, at)[:, 0]
    q_at = torch.cat([q, torch.zeros_like(q[:, :1])], dim=1).gather(1, at)
    res = torch.clamp(p_at - q_at[:, 0], min=0.0)
    rs = res.sum(dim=-1, keepdim=True)
    # A numerically empty residual (p == q to float precision, yet the
    # ratio test rejected) falls back to p itself.
    res = torch.where(rs > 0, res / torch.clamp(rs, min=1e-30), p_at)
    c = torch.argmax(torch.log(torch.clamp(res, min=1e-38)) + g, dim=-1)
    out[rows, n_acc] = torch.where(samples, c, gt[rows, n_acc])
    return out, n_acc


# ---------------------------------------------------------------- sampling


def _filter_logits(logits: torch.Tensor, top_k: int,
                   top_p: float) -> torch.Tensor:
    """Top-k / nucleus filtering of (B, V) f32 logits; ``top_k <= 0`` and
    ``top_p >= 1`` disable the respective filter."""
    if top_k > 0:
        k = min(top_k, logits.shape[-1])
        kth = torch.topk(logits, k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, -torch.inf, logits)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = (cum - probs) < top_p
        cutoff = torch.where(keep, sorted_logits,
                             torch.inf).amin(dim=-1, keepdim=True)
        logits = torch.where(logits < cutoff, -torch.inf, logits)
    return logits


def _filter_logits_traced(logits: torch.Tensor, top_k,
                          top_p) -> torch.Tensor:
    """:func:`_filter_logits` with per-row filters (the engine's per-slot
    ``top_k`` and ``top_p``): ``logits`` (..., V) f32, ``top_k`` and
    ``top_p`` tensors of the leading shape, or numbers. The same masking
    values, with the k-th largest value taken from one descending sort
    at ``clamp(top_k, 1, V) - 1`` and each filter gated by ``where``, so
    a disabled one is an exact no-op and nothing is read back."""
    V, dev = logits.shape[-1], logits.device
    top_k = torch.as_tensor(top_k, device=dev)[..., None]
    top_p = torch.as_tensor(top_p, dtype=torch.float32, device=dev)[..., None]
    desc = torch.sort(logits, dim=-1, descending=True).values
    at = (torch.clamp(top_k, 1, V) - 1).long()
    kth = desc.gather(-1, at.expand(*desc.shape[:-1], 1))
    logits = torch.where((top_k > 0) & (logits < kth), -torch.inf, logits)
    desc = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < top_p
    cutoff = torch.where(keep, desc, torch.inf).amin(dim=-1, keepdim=True)
    return torch.where((top_p < 1.0) & (logits < cutoff), -torch.inf,
                       logits)


def _row_values(values, device, dtype=None) -> torch.Tensor:
    """Per-row sampling parameters as a (B,) tensor on ``device``: the
    engine's mirror is used as it is (nothing moves); a sequence is
    copied in."""
    if not isinstance(values, torch.Tensor):
        values = np.asarray(values)
    return torch.as_tensor(values, dtype=dtype, device=device)


def _scaled(logits: torch.Tensor, temps: torch.Tensor) -> torch.Tensor:
    """f32 logits over their rows' temperatures (``temps`` broadcast
    against them; a temperature of 0, a greedy row's, divides by 1). A
    tensor divisor divides on every device, where a Python number would
    be multiplied by its reciprocal on CUDA: the engine's rows and the
    solo :func:`generate` scale alike."""
    return logits.float() / torch.where(temps > 0, temps, 1.0)


def _row_uniforms(generators, n: int, device) -> torch.Tensor:
    """(B, n) uniforms: row i one draw of n from ``generators[i]`` (the
    draw ``torch.rand((1, n))`` makes), zeros for a row with no
    generator, whose draws nothing reads."""
    u = torch.zeros((len(generators), n), dtype=torch.float32,
                    device=device)
    for i, g in enumerate(generators):
        if g is not None:
            u[i].uniform_(generator=g)
    return u


def _gumbel(u: torch.Tensor) -> torch.Tensor:
    """Gumbel noise from uniforms."""
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(torch.clamp(u, min=tiny)))


def sample_token_rows(logits: torch.Tensor, generators, temps, top_ks,
                      top_ps) -> torch.Tensor:
    """Per-row sampling for the continuous engine, on the device with no
    host read: row i draws one (1, V) uniform from ITS OWN generator
    (``generators[i]``; None draws nothing) and takes the Gumbel argmax
    of its temperature-scaled, filtered logits — exactly the draw the
    solo :func:`generate` makes for a one-row request, so a co-batched
    sampled request sees its solo RNG stream. Rows with temperature 0
    take the argmax. ``temps``, ``top_ks``, ``top_ps``: (B,) tensors
    (the engine's per-slot mirror) or sequences. logits (B, V) f32 ->
    (B,) int64."""
    V, dev = logits.shape[-1], logits.device
    t = _row_values(temps, dev, torch.float32)
    x = _filter_logits_traced(_scaled(logits, t[:, None]),
                              _row_values(top_ks, dev),
                              _row_values(top_ps, dev, torch.float32))
    sampled = torch.argmax(x + _gumbel(_row_uniforms(generators, V, dev)),
                           dim=-1)
    return torch.where(t > 0.0, sampled, torch.argmax(logits, dim=-1))


def pad_prompts(prompts, pad_token: int = 0, device="cpu"):
    """LEFT-pad 1-D token sequences to one (B, S) batch. Returns
    (padded int64 (B, S), lens int64 (B,))."""
    lens = np.asarray([len(p) for p in prompts], np.int64)
    S = int(lens.max())
    out = np.full((len(prompts), S), pad_token, np.int64)
    for i, p in enumerate(prompts):
        out[i, S - len(p):] = np.asarray(p, np.int64)
    return (torch.as_tensor(out, device=device),
            torch.as_tensor(lens, device=device))


@torch.no_grad()
def generate(params: dict, cfg: tfm.TransformerConfig,
             prompt: torch.Tensor, max_new_tokens: int,
             temperature: float = 0.0,
             generator: torch.Generator | None = None,
             top_k: int = 0, top_p: float = 1.0,
             stop_token: int = -1, pad_token: int = 0,
             repetition_penalty: float = 1.0,
             prompt_lens: torch.Tensor | None = None) -> torch.Tensor:
    """Generate ``max_new_tokens`` continuations of ``prompt`` (B, S) on
    the prompt's device. Greedy when ``temperature == 0``; else sampled
    from the temperature-scaled logits filtered by top-k/top-p, one
    (B, V) draw from ``generator`` per emitted token (a fresh
    generator seeded 0 when None). ``stop_token >= 0``: positions after
    a row's first stop token become ``pad_token``. ``prompt_lens``
    (B,): LEFT-padded ragged batch (:func:`pad_prompts`). Returns
    (B, max_new_tokens) int64."""
    B, S = prompt.shape
    dev = prompt.device
    if S + max_new_tokens > cfg.max_seq:
        raise ValueError(f"generate: prompt {S} + new {max_new_tokens} "
                         f"exceeds max_seq {cfg.max_seq}")
    if not 0.0 < top_p <= 1.0:
        raise ValueError(f"generate: top_p must be in (0, 1], got {top_p}")
    if repetition_penalty <= 0.0:
        raise ValueError(f"generate: repetition_penalty must be > 0, "
                         f"got {repetition_penalty}")
    if temperature == 0.0:
        top_k, top_p = 0, 1.0
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    temps = torch.full((B, 1), float(temperature), device=dev)
    lens = None
    if prompt_lens is not None:
        lens = torch.as_tensor(prompt_lens, device=dev).long()
        if tuple(lens.shape) != (B,):
            raise ValueError(f"generate: prompt_lens shape "
                             f"{tuple(lens.shape)} != ({B},)")
        if bool((lens <= 0).any()) or bool((lens > S).any()):
            raise ValueError(f"generate: prompt_lens must be in [1, {S}]")
    penalize = repetition_penalty != 1.0
    prompt = prompt.long()

    reach = min(cfg.max_seq, -(-(S + max_new_tokens) // 128) * 128)
    cache = init_cache(cfg, B, max_seq=reach, device=dev)
    logits, cache = prefill(params, prompt, cfg, cache, prompt_lens=lens)
    pad = None if lens is None else S - lens
    rows = torch.arange(B, device=dev)
    seen = None
    if penalize:
        seen = torch.zeros((B, cfg.vocab_size + 1), dtype=torch.bool,
                           device=dev)
        idx = prompt
        if lens is not None:
            valid = torch.arange(S, device=dev)[None, :] >= pad[:, None]
            idx = torch.where(valid, prompt, cfg.vocab_size)
        seen[rows[:, None], idx] = True
        seen = seen[:, :cfg.vocab_size]

    def sample(logits):
        if penalize:
            pen = torch.where(logits > 0, logits / repetition_penalty,
                              logits * repetition_penalty)
            logits = torch.where(seen, pen, logits)
        if temperature == 0.0:
            return torch.argmax(logits, dim=-1)
        x = _filter_logits(_scaled(logits, temps), top_k, top_p)
        u = torch.rand(x.shape, generator=generator, device=dev,
                       dtype=torch.float32)
        return torch.argmax(x + _gumbel(u), dim=-1)

    tok = sample(logits)
    out = [tok]
    for i in range(max_new_tokens - 1):
        if penalize:
            seen[rows, tok] = True
        logits, cache = decode_step(
            params, tok, S + i, cfg, cache,
            rope_pos=None if lens is None else lens + i, valid_from=pad)
        tok = sample(logits)
        out.append(tok)
    out = torch.stack(out, dim=1)
    if stop_token >= 0:
        hit = (out == stop_token).long()
        after = (torch.cumsum(hit, dim=1) - hit) > 0
        out = torch.where(after, torch.full_like(out, pad_token), out)
    return out
