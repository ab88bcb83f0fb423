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

Mixture-of-experts MLPs (``n_experts > 0``) route each token to its
top-k experts with the reference's static capacity and inverse-index
dispatch (:func:`_moe_mlp`); every shape is fixed by the config and the
token count, so no step reads a value back from the device.

Not ported yet (ROADMAP): ``param_specs`` and expert parallelism, remat,
ring/Ulysses attention.
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
    #: Mixture-of-experts: experts per MLP (0 = dense).
    n_experts: int = 0
    #: Experts routed per token (top-k, GShard-style).
    expert_top_k: int = 2
    #: Expert capacity = ceil(top_k · tokens/expert · this factor);
    #: overflow tokens fall back to the residual stream (dropped).
    capacity_factor: float = 1.25
    #: Coefficient of the router load-balancing aux loss.
    moe_aux_coef: float = 0.01

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
    "optimus-moe": TransformerConfig(
        d_ff=1024, n_experts=8, expert_top_k=2,
    ),
    "tiny-moe": TransformerConfig(
        vocab_size=256, d_model=64, n_layers=2, n_heads=4, d_ff=64,
        max_seq=128, n_experts=4, expert_top_k=2,
    ),
}


def preset(name: str, **overrides) -> TransformerConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    return replace(PRESETS[name], **overrides)


def count_params(params) -> int:
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    return params.numel()


def flops_per_token(cfg: TransformerConfig, seq_len: int,
                    n_params: int | None = None) -> float:
    """Fwd+bwd training FLOPs per token (PaLM appendix B convention):
    ``6·N_matmul + 12·L·D·S`` — the MFU denominator. ``N_matmul``
    counts ACTIVE matmul parameters only (norms excluded; for MoE the
    top-k routed experts and the router, not the whole bank)."""
    if n_params is None:
        L, D = cfg.n_layers, cfg.d_model
        H, K, Dh, F = cfg.n_heads, cfg.kv_heads, cfg.head_dim, cfg.d_ff
        if cfg.n_experts:
            mlp = cfg.expert_top_k * 3 * D * F + D * cfg.n_experts
        else:
            mlp = 3 * D * F
        per_layer = D * Dh * (H + 2 * K) + H * Dh * D + mlp
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
    # A Python base: no scalar tensor is copied to the device (a
    # pageable host-to-device copy waits for the stream).
    inv_freq = 1.0 / (
        cfg.rope_theta
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


def _moe_route(x, router, cfg: TransformerConfig):
    """Router in f32: softmax over experts, top-k, gates renormalised
    over the k picks, and the Switch load-balancing aux
    ``E · Σ_e frac_tokens_e · frac_prob_e``. x: (T, D) → (gate_w (T, k)
    f32, gate_e (T, k) int64, aux f32 scalar)."""
    E, topk = cfg.n_experts, cfg.expert_top_k
    probs = torch.softmax(x.float() @ router.float(), dim=-1)  # (T, E)
    gate_w, gate_e = torch.topk(probs, topk, dim=-1)
    gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)
    experts = torch.arange(E, device=x.device)
    dispatched = (gate_e[..., None] == experts).float().sum(1)  # (T, E)
    ce = dispatched.mean(0) / topk
    aux = E * (probs.mean(0) * ce).sum()
    return gate_w, gate_e, aux


def _moe_dispatch(x, gate_e, C: int, cfg: TransformerConfig):
    """Token-priority slots and the inverse-index gather. Each (token,
    pick) assignment, flattened t-major as ``(T, k) → (T·k)``, takes
    the next slot of its expert; slots ≥ ``C`` overflow and drop. Each
    kept assignment scatters its token id (one integer) into an
    ``(E, C)`` map, overflow into a trash column; token rows are then
    GATHERED into the ``(E, C, D)`` expert buffer in the compute dtype.
    Returns (X (E, C, D), flat_e (T·k,), slot (T·k,), keep (T·k,))."""
    T, D = x.shape
    E = cfg.n_experts
    dev = x.device
    flat_e = gate_e.reshape(-1)
    n = flat_e.shape[0]
    # A running count per expert, as ONE scan over the (E, T·k) one-hot
    # laid end to end, less each expert row's start: on CUDA a scan
    # along the long dim of a (T·k, E) tensor runs one thread a column.
    onehot = (torch.arange(E, device=dev)[:, None] == flat_e).to(torch.int32)
    run = torch.cumsum(onehot.reshape(-1), dim=0).reshape(E, n)
    start = torch.cat([run.new_zeros(1), run[:-1, -1]])
    pos = (run - start[:, None]).gather(0, flat_e[None])[0] - 1
    keep = pos < C
    tok = torch.arange(n, device=dev) // cfg.expert_top_k
    inv = torch.zeros((E, C + 1), dtype=torch.int64, device=dev)
    inv[flat_e, torch.where(keep, pos, C)] = tok + 1  # 0 = empty
    inv = inv[:, :C]
    # Empty slots read rows spread over the tokens and are zeroed, so the
    # gather's backward (an index_add_) adds into any row a few times at
    # most, and only exact zeros beyond a token's k real picks.
    spread = torch.arange(E * C, device=dev).reshape(E, C) % T
    src = torch.where(inv > 0, inv - 1, spread)
    rows = x.index_select(0, src.reshape(-1)).reshape(E, C, D)
    X = torch.where((inv > 0)[..., None], rows.to(cfg.dtype), 0.0)
    return X, flat_e, torch.clamp(pos, 0, C - 1), keep


def _moe_experts(X, layer, cfg: TransformerConfig):
    """The stacked experts' SwiGLUs as three batched products over the
    expert dim: (E, C, D) → (E, C, D)."""
    dt = cfg.dtype
    g = torch.bmm(X, layer["w_gate"].to(dt))
    u = torch.bmm(X, layer["w_up"].to(dt))
    return torch.bmm(torch.nn.functional.silu(g) * u, layer["w_down"].to(dt))


def _moe_combine(Y, flat_e, slot, keep, gate_w, cfg: TransformerConfig):
    """Gather each assignment's expert output back, zero the dropped
    ones, weight by the gates and sum a token's k picks: → (T, D)."""
    dt = cfg.dtype
    E, C, D = Y.shape
    y_tok = Y.reshape(E * C, D).index_select(0, flat_e * C + slot)
    y_tok = y_tok * keep[:, None].to(dt)
    y_tok = y_tok * gate_w.reshape(-1)[:, None].to(dt)
    return y_tok.reshape(-1, cfg.expert_top_k, D).sum(1)


def _moe_mlp(h, layer, cfg: TransformerConfig, capacity: int | None = None):
    """GShard-style top-k MoE MLP (the reference's ``_moe_mlp``).
    h: (B, S, D) → (y, aux).

    Static expert capacity ``C = ceil(k·T/E · capacity_factor)``, or
    ``capacity`` when given (generation passes a zero-drop bound, the
    exact per-call token count, so no decode token is dropped). Every
    shape follows from the config, ``T`` and ``C``: nothing is read back
    from the device, so a step stays capturable in a CUDA graph."""
    B, S, D = h.shape
    T = B * S
    E, topk = cfg.n_experts, cfg.expert_top_k
    x = h.reshape(T, D)
    gate_w, gate_e, aux = _moe_route(x, layer["router"], cfg)
    C = (capacity if capacity is not None
         else max(math.ceil(topk * T / E * cfg.capacity_factor), 1))
    X, flat_e, slot, keep = _moe_dispatch(x, gate_e, C, cfg)
    Y = _moe_experts(X, layer, cfg)
    y = _moe_combine(Y, flat_e, slot, keep, gate_w, cfg)
    return y.reshape(B, S, D), aux


def mlp_residual(x, layer, cfg: TransformerConfig,
                 moe_capacity: int | None = None):
    """Pre-norm MLP (dense SwiGLU or MoE) + residual → (x, aux); a dense
    MLP's aux is the float 0.0 (no device work)."""
    dt = cfg.dtype
    h = rms_norm(x, layer["mlp_norm"])
    if cfg.n_experts:
        y, aux = _moe_mlp(h, layer, cfg, capacity=moe_capacity)
        return x + y, aux
    gate = h @ layer["w_gate"].to(dt)
    up = h @ layer["w_up"].to(dt)
    x = x + (torch.nn.functional.silu(gate) * up) @ layer["w_down"].to(dt)
    return x, 0.0


def layer_params(params: dict, i: int) -> dict:
    """Layer ``i`` of the stacked block parameters (views, no copy)."""
    return {name: w[i] for name, w in params["blocks"].items()}


def hidden_with_aux(params: dict, tokens: torch.Tensor,
                    cfg: TransformerConfig, attn_fn=None):
    """Backbone through the final norm: (x (B,S,D) in compute dtype,
    aux) — aux is the MoE router loss summed over layers (0.0 dense)."""
    attn_fn = attn_fn or resolve_attn_fn(cfg, tokens.device)
    S = tokens.shape[1]
    x = params["embed"][tokens].to(cfg.dtype)
    sin, cos = rope_tables(cfg, S, device=tokens.device)
    aux = torch.zeros((), device=tokens.device)
    for i in range(cfg.n_layers):
        layer = layer_params(params, i)
        q, k, v = qkv_proj(x, layer, cfg, sin, cos)
        x = attn_residual(x, attn_fn(q, k, v, cfg), layer, cfg)
        x, layer_aux = mlp_residual(x, layer, cfg)
        if cfg.n_experts:
            aux = aux + layer_aux
    return rms_norm(x, params["final_norm"]), aux


def head_weight(params: dict, cfg: TransformerConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def head_logits(x: torch.Tensor, head: torch.Tensor,
                cfg: TransformerConfig) -> torch.Tensor:
    """LM head: operands in the compute dtype, logits returned in f32."""
    return (x.to(cfg.dtype) @ head.to(cfg.dtype)).float()


def forward_with_aux(params: dict, tokens: torch.Tensor,
                     cfg: TransformerConfig, attn_fn=None):
    """(logits (B, S, V) f32, aux) — aux is the summed MoE router loss
    (0.0 for dense MLPs)."""
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
        # A fill, not torch.tensor: a pageable upload waits for the stream.
        denom = torch.full((), float(n), dtype=torch.float32,
                           device=x.device)
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
    """Mean next-token cross-entropy, plus ``moe_aux_coef · aux`` for
    an MoE config. ``batch``: tokens (B, S), targets (B, S), optional
    loss_mask (B, S)."""
    nll_sum, denom, aux = loss_terms(params, batch, cfg, attn_fn)
    loss = nll_sum / denom
    if cfg.n_experts:
        loss = loss + cfg.moe_aux_coef * aux
    return loss
