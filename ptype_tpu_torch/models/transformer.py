"""Decoder-only transformer in PyTorch — the port of
``ptype_tpu/models/transformer.py``: the forward and the training loss.

Same architecture and parameter tree as the reference: RMSNorm, RoPE,
SwiGLU, grouped-query attention, all block parameters stacked on a
leading ``n_layers`` dim. Parameters are a plain dict of tensors with
the reference's names (``models/weights.py`` carries a reference tree
across). The reference's ``lax.scan`` over layers is a Python loop over
the stacked dim here; PyTorch runs eagerly, so there is nothing to
compile.

Precision policy as in the reference: matmuls in ``cfg.dtype`` (bf16
by default), parameters in ``cfg.param_dtype`` (f32), norms, RoPE,
softmax and logits in f32.

The loss is the reference's: the LM head fused with the cross-entropy
in row chunks (:func:`_chunked_nll`), each chunk's logits recomputed in
backward rather than saved. With ``attn_impl`` "flash" (the default on
CUDA) attention is differentiable through the flash kernels
(``ops/flash_attention.py``).

Not ported yet (ROADMAP): mixture-of-experts (``_moe_mlp``),
``param_specs``, remat, ring/Ulysses attention. A config with
``n_experts > 0`` raises ``NotImplementedError``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import torch


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32768
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    #: KV heads for grouped-query attention; None → MHA (== n_heads).
    n_kv_heads: int | None = None
    d_ff: int = 2048
    max_seq: int = 1024
    rope_theta: float = 10000.0
    #: Compute dtype for matmuls; params stay in param_dtype.
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    tie_embeddings: bool = True
    causal: bool = True
    #: "auto" (the port's flash kernel on CUDA, dense elsewhere),
    #: "xla" (dense; the reference's name for it), "flash".
    attn_impl: str = "auto"
    #: Mixture-of-experts width; the port raises for n_experts > 0 (the
    #: reference's other training and MoE knobs arrive with those slices).
    n_experts: int = 0

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


#: The reference's presets, same names and widths.
PRESETS: dict[str, TransformerConfig] = {
    "tiny": TransformerConfig(
        vocab_size=256, d_model=64, n_layers=2, n_heads=4, d_ff=128,
        max_seq=128,
    ),
    "optimus-125m": TransformerConfig(n_heads=6),
    "optimus-350m": TransformerConfig(
        d_model=1024, n_layers=24, n_heads=8, d_ff=2816,
    ),
    "bert-base": TransformerConfig(
        vocab_size=30592, d_model=768, n_layers=12, n_heads=12, d_ff=3072,
        max_seq=512, causal=False, tie_embeddings=True,
    ),
    "llama-3-8b": TransformerConfig(
        vocab_size=128256, d_model=4096, n_layers=32, n_heads=32,
        n_kv_heads=8, d_ff=14336, max_seq=8192, rope_theta=500000.0,
        tie_embeddings=False,
    ),
    "optimus-moe": TransformerConfig(d_ff=1024, n_experts=8),
    "tiny-moe": TransformerConfig(
        vocab_size=256, d_model=64, n_layers=2, n_heads=4, d_ff=64,
        max_seq=128, n_experts=4,
    ),
}


def preset(name: str, **overrides) -> TransformerConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    return replace(PRESETS[name], **overrides)


def check_dense(cfg: TransformerConfig) -> None:
    """Refuse what the port does not run yet."""
    if cfg.n_experts:
        raise NotImplementedError(
            "mixture-of-experts is not ported yet (ROADMAP.md, port "
            "queue: MoE)")


def count_params(params) -> int:
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    return params.numel()


def flops_per_token(cfg: TransformerConfig, seq_len: int,
                    n_params: int | None = None) -> float:
    """Fwd+bwd training FLOPs per token (PaLM appendix B convention):
    ``6·N_matmul + 12·L·D·S`` — the MFU denominator. ``N_matmul``
    counts matmul parameters only (norms excluded)."""
    if n_params is None:
        L, D = cfg.n_layers, cfg.d_model
        H, K, Dh, F = cfg.n_heads, cfg.kv_heads, cfg.head_dim, cfg.d_ff
        per_layer = D * Dh * (H + 2 * K) + H * Dh * D + 3 * D * F
        n_params = cfg.vocab_size * D + L * per_layer
        if not cfg.tie_embeddings:
            n_params += D * cfg.vocab_size
    return 6.0 * n_params + 12.0 * cfg.n_layers * cfg.d_model * seq_len


# ----------------------------------------------------------------- forward


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    rms = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (x32 * rms).to(x.dtype) * scale.to(x.dtype)


def rope_tables(cfg: TransformerConfig, seq_len: int | None = None,
                positions: torch.Tensor | None = None,
                device=None):
    """(sin, cos) tables of shape (..., head_dim/2), f32. Either
    ``seq_len`` (positions 0..S-1) or explicit ``positions`` of shape
    (S,) or (B, S)."""
    half = cfg.head_dim // 2
    if positions is None:
        positions = torch.arange(seq_len, device=device)
    dev = positions.device
    inv_freq = 1.0 / (
        torch.tensor(cfg.rope_theta, dtype=torch.float32, device=dev)
        ** (torch.arange(0, half, dtype=torch.float32, device=dev) / half)
    )
    angles = positions.to(torch.float32)[..., None] * inv_freq
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """Rotate pairs (x1, x2) of the head dim. x: (B, S, H, Dh); sin/cos
    (S, half) shared or (B, S, half) per row."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    if sin.dim() == 2:
        sin = sin[None, :, None, :]
        cos = cos[None, :, None, :]
    else:
        sin = sin[:, :, None, :]
        cos = cos[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _attention(q, k, v, cfg: TransformerConfig, kv_mask=None):
    """Dense GQA attention; q:(B,S,H,Dh) k,v:(B,S,K,Dh). Scores and
    softmax in f32 (the reference's ``preferred_element_type``), query
    heads grouped onto their kv head without repeating K/V.
    ``kv_mask`` (B, S) bool: keys where False are masked for every
    query (left-padded ragged prefill)."""
    B, S, H, Dh = q.shape
    K = k.shape[2]
    qg = q.reshape(B, S, K, H // K, Dh)
    scores = torch.einsum("bqngd,bsnd->bngqs", qg.float(), k.float())
    scores = scores / math.sqrt(Dh)
    neg = torch.tensor(-1e30, dtype=torch.float32, device=q.device)
    if cfg.causal:
        causal = torch.tril(torch.ones(S, S, dtype=torch.bool,
                                       device=q.device))
        scores = torch.where(causal[None, None, None], scores, neg)
    if kv_mask is not None:
        scores = torch.where(kv_mask[:, None, None, None, :], scores, neg)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    o = torch.einsum("bngqs,bsnd->bqngd", probs, v)
    return o.reshape(B, S, H, Dh)


def default_attn_impl(device) -> str:
    """THE 'auto' policy: the port's flash kernel on CUDA, dense
    elsewhere."""
    return "flash" if torch.device(device).type == "cuda" else "xla"


def _flash_attn_fn(q, k, v, cfg: TransformerConfig):
    """``attn_impl="flash"`` for :func:`forward`: the differentiable
    flash attention, with the same shape rule as the reference's
    ``make_flash_attn_fn`` (1024 blocks clamped to S; a sequence they do
    not tile falls back to dense)."""
    from ptype_tpu_torch.ops.flash_attention import flash_attention

    S = q.shape[1]
    if S % min(1024, S):
        return _attention(q, k, v, cfg)
    return flash_attention(q, k, v, causal=cfg.causal)


def resolve_attn_fn(cfg: TransformerConfig, device=None):
    """Resolve ``cfg.attn_impl`` to an ``attn_fn(q, k, v, cfg)``."""
    impl = cfg.attn_impl
    if impl == "auto":
        impl = default_attn_impl(device if device is not None else "cpu")
    if impl == "xla":
        return _attention
    if impl == "flash":
        return _flash_attn_fn
    raise ValueError(f"unknown or unported attn_impl {impl!r}; "
                     "want auto|xla|flash")


def _proj(h, w, dt):
    """(B, S, D) @ (D, *out) → (B, S, *out), operands in ``dt``."""
    D = w.shape[0]
    out = h @ w.reshape(D, -1).to(dt)
    return out.reshape(*h.shape[:-1], *w.shape[1:])


def qkv_proj(x, layer, cfg: TransformerConfig, sin, cos):
    """Pre-norm + Q/K/V projections + RoPE. x: (B, S, D) → three
    (B, S, H|K, Dh)."""
    dt = cfg.dtype
    h = rms_norm(x, layer["attn_norm"])
    q = _proj(h, layer["wq"], dt)
    k = _proj(h, layer["wk"], dt)
    v = _proj(h, layer["wv"], dt)
    return apply_rope(q, sin, cos), apply_rope(k, sin, cos), v


def attn_residual(x, o, layer, cfg: TransformerConfig):
    """Output projection + residual add. o: (B, S, H, Dh)."""
    B, S, H, Dh = o.shape
    wo = layer["wo"].reshape(H * Dh, -1).to(cfg.dtype)
    return x + o.reshape(B, S, H * Dh) @ wo


def mlp_residual(x, layer, cfg: TransformerConfig):
    """Pre-norm dense SwiGLU + residual."""
    check_dense(cfg)
    dt = cfg.dtype
    h = rms_norm(x, layer["mlp_norm"])
    gate = h @ layer["w_gate"].to(dt)
    up = h @ layer["w_up"].to(dt)
    return x + (torch.nn.functional.silu(gate) * up) @ layer["w_down"].to(dt)


def layer_params(params: dict, i: int) -> dict:
    """Layer ``i`` of the stacked block parameters (views, no copy)."""
    return {name: w[i] for name, w in params["blocks"].items()}


def hidden_with_aux(params: dict, tokens: torch.Tensor,
                    cfg: TransformerConfig, attn_fn=None):
    """Backbone through the final norm: (x (B,S,D) in compute dtype,
    aux). aux is 0.0 — the port runs dense MLPs only."""
    check_dense(cfg)
    attn_fn = attn_fn or resolve_attn_fn(cfg, tokens.device)
    S = tokens.shape[1]
    x = params["embed"][tokens].to(cfg.dtype)
    sin, cos = rope_tables(cfg, S, device=tokens.device)
    for i in range(cfg.n_layers):
        layer = layer_params(params, i)
        q, k, v = qkv_proj(x, layer, cfg, sin, cos)
        x = attn_residual(x, attn_fn(q, k, v, cfg), layer, cfg)
        x = mlp_residual(x, layer, cfg)
    return (rms_norm(x, params["final_norm"]),
            torch.zeros((), device=tokens.device))


def head_weight(params: dict, cfg: TransformerConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def head_logits(x: torch.Tensor, head: torch.Tensor,
                cfg: TransformerConfig) -> torch.Tensor:
    """LM head: operands in the compute dtype, logits returned in f32."""
    return (x.to(cfg.dtype) @ head.to(cfg.dtype)).float()


def forward_with_aux(params: dict, tokens: torch.Tensor,
                     cfg: TransformerConfig, attn_fn=None):
    """(logits (B, S, V) f32, aux) — aux is 0.0 (dense MLPs only)."""
    x, aux = hidden_with_aux(params, tokens, cfg, attn_fn)
    return head_logits(x, head_weight(params, cfg), cfg), aux


def forward(params: dict, tokens: torch.Tensor, cfg: TransformerConfig,
            attn_fn=None) -> torch.Tensor:
    """Logits (B, S, V) in f32."""
    return forward_with_aux(params, tokens, cfg, attn_fn)[0]


# -------------------------------------------------------------------- loss


def nll_terms_from_logits(logits: torch.Tensor, batch: dict):
    """(nll_sum, denom) — the unnormalized pieces of the (masked) mean
    cross-entropy, so gradient accumulation can sum them across
    microbatches and divide once."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, batch["targets"][..., None].long())
    nll = logz - gold[..., 0]
    mask = batch.get("loss_mask")
    if mask is None:
        return nll.sum(), torch.tensor(float(nll.numel()),
                                       device=nll.device)
    mask = mask.to(nll.dtype)
    return (nll * mask).sum(), torch.clamp(mask.sum(), min=1.0)


def nll_from_logits(logits: torch.Tensor, batch: dict) -> torch.Tensor:
    """(Masked) mean cross-entropy from precomputed logits."""
    nll_sum, denom = nll_terms_from_logits(logits, batch)
    return nll_sum / denom


#: Rows of (tokens × vocab) logits materialized at once by the fused
#: loss head: 8192 × 32k vocab f32 is about 1 GB of transient per chunk,
#: and the full (B·S, V) tensor never exists.
LOSS_CHUNK_ROWS = 8192


def _chunk_rows(n: int) -> int:
    """The largest divisor of ``n`` within :data:`LOSS_CHUNK_ROWS`
    (global batch 12 × seq 1024 chunks at 6144, not one dense chunk);
    below 512 rows (odd or prime ``n``) one dense chunk beats a scan of
    tiny ones."""
    chunk = min(n, LOSS_CHUNK_ROWS)
    while n % chunk:
        chunk -= 1
    return n if chunk < 512 else chunk


class _ChunkedNLL(torch.autograd.Function):
    """Σ mask·(logsumexp(x·W) − (x·W)[target]) over row chunks.

    Forward keeps only the chunk sums. Backward recomputes each chunk's
    logits and forms ``(softmax − onehot)·mask·g`` for it, so no
    (rows, V) tensor lives from forward to backward: the saved state is
    x, W, the targets and the mask, O(rows·D)."""

    @staticmethod
    def forward(ctx, x, head, targets, mask, chunk, dt):
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        hdt = head.to(dt)
        for i in range(0, x.shape[0], chunk):
            logits = (x[i:i + chunk].to(dt) @ hdt).float()
            gold = torch.gather(logits, 1, targets[i:i + chunk, None])
            nll = torch.logsumexp(logits, dim=-1) - gold[:, 0]
            total += (nll * mask[i:i + chunk]).sum()
        ctx.save_for_backward(x, head, targets, mask)
        ctx.chunk, ctx.dt = chunk, dt
        return total

    @staticmethod
    def backward(ctx, g):
        x, head, targets, mask = ctx.saved_tensors
        chunk, dt = ctx.chunk, ctx.dt
        hdt = head.to(dt)
        dx = torch.empty_like(x) if ctx.needs_input_grad[0] else None
        dhead = (torch.zeros(head.shape, dtype=torch.float32,
                             device=head.device)
                 if ctx.needs_input_grad[1] else None)
        for i in range(0, x.shape[0], chunk):
            xc = x[i:i + chunk].to(dt)
            logits = (xc @ hdt).float()
            d = torch.softmax(logits, dim=-1)
            rows = torch.arange(d.shape[0], device=d.device)
            d[rows, targets[i:i + chunk]] -= 1.0
            d = (d * (mask[i:i + chunk] * g)[:, None]).to(dt)
            if dx is not None:
                dx[i:i + chunk] = (d @ hdt.T).to(x.dtype)
            if dhead is not None:
                dhead += (xc.T @ d).float()
        if dhead is not None:
            dhead = dhead.to(head.dtype)
        return dx, dhead, None, None, None, None


def _chunked_nll(x, head, targets, mask, cfg: TransformerConfig):
    """(nll_sum, denom) with the LM head fused into the loss: rows
    stream through :data:`LOSS_CHUNK_ROWS`-sized chunks (the reference's
    checkpointed ``lax.scan``), and backward recomputes each chunk's
    logits instead of saving them."""
    B, S, D = x.shape
    n = B * S
    targets = targets.reshape(n).long()
    if mask is None:
        m = torch.ones(n, dtype=torch.float32, device=x.device)
        denom = torch.tensor(float(n), device=x.device)
    else:
        m = mask.reshape(n).float()
        denom = torch.clamp(m.sum(), min=1.0)
    nll_sum = _ChunkedNLL.apply(x.reshape(n, D), head, targets, m,
                                _chunk_rows(n), cfg.dtype)
    return nll_sum, denom


def loss_terms(params: dict, batch: dict, cfg: TransformerConfig,
               attn_fn=None):
    """(nll_sum, denom, aux) — the loss pieces gradient accumulation
    sums across microbatches (``train/trainer.py``). The LM head runs
    fused with the cross-entropy: full logits are never materialized."""
    x, aux = hidden_with_aux(params, batch["tokens"], cfg, attn_fn)
    nll_sum, denom = _chunked_nll(x, head_weight(params, cfg),
                                  batch["targets"], batch.get("loss_mask"),
                                  cfg)
    return nll_sum, denom, aux


def loss_fn(params: dict, batch: dict, cfg: TransformerConfig,
            attn_fn=None) -> torch.Tensor:
    """Mean next-token cross-entropy. ``batch``: tokens (B, S), targets
    (B, S), optional loss_mask (B, S)."""
    nll_sum, denom, _ = loss_terms(params, batch, cfg, attn_fn)
    return nll_sum / denom
