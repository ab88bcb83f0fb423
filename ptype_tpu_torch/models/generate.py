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

The speculative-decoding functions are not ported yet (ROADMAP).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

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
    scores = torch.where(mask, scores,
                         torch.tensor(NEG, device=scores.device))
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
    and the cache). ``prompt_lens`` (B,): LEFT-padded ragged prompts."""
    tfm.check_dense(cfg)
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
        x = tfm.mlp_residual(x, layer, cfg)
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
    positions and ``valid_from`` (B,) first valid slots."""
    dev = token.device
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
        x = tfm.mlp_residual(x, layer, cfg)
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
    (the Hopper kernel on CUDA), "gather" through the gather path.
    Returns (logits (B, V), kb, vb)."""
    if attn_impl not in ("gather", "kernel"):
        raise ValueError(f"attn_impl must be 'gather'|'kernel', "
                         f"got {attn_impl!r}")
    if attn_impl == "kernel":
        from ptype_tpu_torch.ops.paged_attention import paged_attention
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
        x = tfm.mlp_residual(x, layer, cfg)
    x = tfm.rms_norm(x, params["final_norm"])
    return _head_logits(params, x[:, 0], cfg), kb, vb


def prefill_paged_chunk(params: dict, tokens: torch.Tensor, start: int,
                        length: int, cfg: tfm.TransformerConfig,
                        kb: torch.Tensor, vb: torch.Tensor,
                        table: torch.Tensor):
    """One chunk of paged prefill for one sequence: ``tokens`` (1, C)
    holds positions ``[start, start + length)`` (right-padded past
    ``length``); ``table`` (nb,) its block table. K/V of real tokens
    are written in place into their blocks (pad columns to trash block
    0); query c attends every position through ``start + c``. Returns
    (logits (1, V) at the chunk's last real token, kb, vb)."""
    tfm.check_dense(cfg)
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
    for i in range(cfg.n_layers):
        layer = tfm.layer_params(params, i)
        q, k, v = tfm.qkv_proj(x, layer, cfg, sin, cos)
        kc, vc = kb[i], vb[i]
        kc[wr_b, wr_o] = k[0]
        vc[wr_b, wr_o] = v[0]
        o = _paged_attention_gather(q, kc, vc, table[None], limits[None],
                                    cfg)
        x = tfm.attn_residual(x, o, layer, cfg)
        x = tfm.mlp_residual(x, layer, cfg)
    x = tfm.rms_norm(x, params["final_norm"])
    return _head_logits(params, x[:, int(length) - 1], cfg), kb, vb


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
    """:func:`_filter_logits` for one (V,) row with per-row ``top_k``
    and ``top_p`` (the engine's per-slot filters): the same masking,
    with a disabled filter an exact no-op."""
    V = logits.shape[-1]
    top_k = int(top_k)
    top_p = float(top_p)
    desc = torch.sort(logits, descending=True).values
    kth = desc[min(max(top_k, 1), V) - 1]
    if top_k > 0:
        logits = torch.where(logits < kth, -torch.inf, logits)
    desc2 = torch.sort(logits, descending=True).values
    probs = torch.softmax(desc2, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < top_p
    cutoff = torch.where(keep, desc2, torch.inf).amin()
    if top_p < 1.0:
        logits = torch.where(logits < cutoff, -torch.inf, logits)
    return logits


def _gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(torch.clamp(u, min=tiny)))


def sample_token_rows(logits: torch.Tensor, generators, temps, top_ks,
                      top_ps) -> torch.Tensor:
    """Per-row sampling for the continuous engine: row i with
    ``temps[i] > 0`` draws one (1, V) Gumbel sample from ITS OWN
    generator over its temperature-scaled, filtered logits — exactly
    the draw the solo :func:`generate` makes for a one-row request, so
    a co-batched sampled request sees its solo RNG stream. Rows with
    temperature 0 take the argmax. logits (B, V) f32 → (B,) int64."""
    out = torch.argmax(logits, dim=-1)
    for i in range(logits.shape[0]):
        t = float(temps[i])
        if t <= 0.0:
            continue
        x = logits[i].float() / t
        x = _filter_logits_traced(x, top_ks[i], top_ps[i])
        g = _gumbel((1, x.shape[-1]), generators[i], x.device)[0]
        out[i] = torch.argmax(x + g)
    return out


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
    tfm.check_dense(cfg)
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
        x = _filter_logits(logits / temperature, top_k, top_p)
        return torch.argmax(x + _gumbel(x.shape, generator, dev), dim=-1)

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
