"""Decoder-only transformer in PyTorch — the port of
``ptype_tpu/models/transformer.py`` (forward path only).

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

Not ported yet (ROADMAP): mixture-of-experts (``_moe_mlp``), the loss
and its fused head, ``param_specs``, ring/Ulysses attention. A config
with ``n_experts > 0`` raises ``NotImplementedError``.
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
    """``attn_impl="flash"`` for :func:`forward`: the same shape rule as
    the reference's ``make_flash_attn_fn`` (1024 blocks clamped to S;
    a sequence they do not tile falls back to dense)."""
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
    return rms_norm(x, params["final_norm"]), torch.zeros(())


def head_weight(params: dict, cfg: TransformerConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def head_logits(x: torch.Tensor, head: torch.Tensor,
                cfg: TransformerConfig) -> torch.Tensor:
    """LM head: operands in the compute dtype, logits returned in f32."""
    return (x.to(cfg.dtype) @ head.to(cfg.dtype)).float()


def forward(params: dict, tokens: torch.Tensor, cfg: TransformerConfig,
            attn_fn=None) -> torch.Tensor:
    """Logits (B, S, V) in f32."""
    x, _ = hidden_with_aux(params, tokens, cfg, attn_fn)
    return head_logits(x, head_weight(params, cfg), cfg)
