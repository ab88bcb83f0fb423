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

Remat (``cfg.remat``) checkpoints each layer's block with
``torch.utils.checkpoint``: policy "none" saves only the block's inputs,
"dots" also saves the outputs of the 2-D weight products (``aten.mm``)
and recomputes the rest — the counterpart of the reference's
``dots_with_no_batch_dims_saveable``; the batched attention products
and the flash kernel's output are recomputed under both. The
reference's ``scan_unroll`` is a knob of XLA's compile of ``lax.scan``;
a Python loop over layers has nothing to unroll, so it is left out.

On a mesh (``mesh=`` of :func:`hidden_with_aux` and :func:`loss_terms`)
each rank holds its block of every leaf under :func:`param_specs` and
of the batch under :func:`batch_spec` (:class:`MeshLayout`): weights
split over ``fsdp`` are allgathered just before use (their gradients
reduce-scattered back), the attention and MLP are Megatron's column /
row pairs over ``model`` with one allreduce on each residual write, the
embedding is split over the vocabulary (a masked lookup and an
allreduce), and the LM head is gathered whole over ``model`` for the
fused loss.

A mixture-of-experts config trains on every mesh the placements name:
the expert bank split over ``expert`` (and ``fsdp`` on D, ``model`` on
F), with the reference's global capacity, token order and router aux
(:meth:`MeshLayout.moe`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from functools import partial

import torch
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)


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
    #: Rematerialize each block in backward (torch.utils.checkpoint).
    remat: bool = False
    #: Policy when ``remat``: "none" saves nothing inside a block,
    #: "dots" saves the 2-D weight products' outputs and recomputes the
    #: elementwise chains and attention.
    remat_policy: str = "none"
    causal: bool = True
    #: "auto" (the port's flash kernel on CUDA, dense elsewhere),
    #: "xla" (dense; the reference's name for it), "flash", and
    #: "ring" / "ulysses" (sequence-parallel over the "seq" mesh axis:
    #: they need a mesh, ``parallel/ring_attention.py``).
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
        tie_embeddings=False, remat=True,
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


def resolve_attn_fn(cfg: TransformerConfig, device=None, mesh=None):
    """Resolve ``cfg.attn_impl`` to an ``attn_fn(q, k, v, cfg)``.
    "ring" and "ulysses" need a mesh with a "seq" axis (the Trainer
    passes its own); without one they raise rather than run dense."""
    impl = cfg.attn_impl
    if impl == "auto":
        impl = default_attn_impl(device if device is not None else "cpu")
    if impl == "xla":
        return _attention
    if impl == "flash":
        return _flash_attn_fn
    if impl in ("ring", "ulysses"):
        if mesh is None:
            raise ValueError(
                f"attn_impl={impl!r} needs a mesh with a 'seq' axis: use "
                "the Trainer (which passes its mesh) or pass attn_fn "
                "explicitly (parallel/ring_attention.py)")
        from ptype_tpu_torch.parallel.ring_attention import (
            make_ring_attention, make_ulysses_attention)

        make = (make_ring_attention if impl == "ring"
                else make_ulysses_attention)
        return make(mesh)
    raise ValueError(f"unknown attn_impl {impl!r}; "
                     "want auto|xla|flash|ring|ulysses")


def _proj(h, w, dt):
    """(B, S, D) @ (D, *out) → (B, S, *out), operands in ``dt``."""
    D = w.shape[0]
    out = h @ w.reshape(D, -1).to(dt)
    return out.reshape(*h.shape[:-1], *w.shape[1:])


class LocalLayout:
    """The model on one device: every parameter whole and every hook
    the identity. The block (:func:`qkv_proj`, :func:`attn_residual`,
    :func:`mlp_residual`) calls these hooks where a mesh needs a
    collective, so the one body runs on one device and, through
    :class:`MeshLayout`, on a mesh."""

    def embed(self, params: dict, tokens: torch.Tensor) -> torch.Tensor:
        """The embedding rows of ``tokens``."""
        return params["embed"][tokens]

    def positions(self, tokens: torch.Tensor) -> torch.Tensor:
        """The RoPE positions of this rank's sequence block."""
        return torch.arange(tokens.shape[1], device=tokens.device)

    def layer(self, layer: dict) -> dict:
        """One layer's weights as the block uses them."""
        return layer

    def attn_in(self, h):
        """The normed input of the Q/K/V products."""
        return h

    def kv_weights(self, wk, wv):
        return wk, wv

    def kv_heads(self, k):
        """This rank's K or V heads of the projection."""
        return k

    def attn_out(self, y):
        """The output projection's product, before the residual add."""
        return y

    def mlp_in(self, h):
        return h

    def mlp_out(self, y):
        return y

    def moe(self, h, layer, cfg, capacity=None):
        """The mixture-of-experts MLP: (y, aux)."""
        return _moe_mlp(h, layer, cfg, capacity=capacity)


_LOCAL = LocalLayout()


def qkv_proj(x, layer, cfg: TransformerConfig, sin, cos, hooks=_LOCAL):
    """Pre-norm + Q/K/V projections + RoPE. x: (B, S, D) → three
    (B, S, H|K, Dh)."""
    dt = cfg.dtype
    h = hooks.attn_in(rms_norm(x, layer["attn_norm"]))
    wk, wv = hooks.kv_weights(layer["wk"], layer["wv"])
    q = _proj(h, layer["wq"], dt)
    k = _proj(h, wk, dt)
    v = _proj(h, wv, dt)
    return (apply_rope(q, sin, cos), hooks.kv_heads(apply_rope(k, sin, cos)),
            hooks.kv_heads(v))


def attn_residual(x, o, layer, cfg: TransformerConfig, hooks=_LOCAL):
    """Output projection + residual add. o: (B, S, H, Dh)."""
    B, S, H, Dh = o.shape
    wo = layer["wo"].reshape(H * Dh, -1).to(cfg.dtype)
    return x + hooks.attn_out(o.reshape(B, S, H * Dh) @ wo)


def _moe_router(x, router, cfg: TransformerConfig):
    """Router in f32: softmax over experts, top-k, gates renormalised
    over the k picks. x: (T, D) → (probs (T, E), gate_w (T, k) f32,
    gate_e (T, k) int64, dispatched (T, E): each token's picks one-hot
    summed)."""
    E, topk = cfg.n_experts, cfg.expert_top_k
    probs = torch.softmax(x.float() @ router.float(), dim=-1)  # (T, E)
    gate_w, gate_e = torch.topk(probs, topk, dim=-1)
    gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)
    experts = torch.arange(E, device=x.device)
    dispatched = (gate_e[..., None] == experts).float().sum(1)  # (T, E)
    return probs, gate_w, gate_e, dispatched


def _moe_route(x, router, cfg: TransformerConfig):
    """:func:`_moe_router` and the Switch load-balancing aux
    ``E · Σ_e frac_tokens_e · frac_prob_e`` over the tokens of ``x``.
    x: (T, D) → (gate_w (T, k) f32, gate_e (T, k) int64, aux f32
    scalar)."""
    probs, gate_w, gate_e, dispatched = _moe_router(x, router, cfg)
    ce = dispatched.mean(0) / cfg.expert_top_k
    aux = cfg.n_experts * (probs.mean(0) * ce).sum()
    return gate_w, gate_e, aux


def _moe_dispatch(x, gate_e, C: int, cfg: TransformerConfig, offset=None,
                  lo: int = 0, n_local: int | None = None,
                  C_buf: int | None = None):
    """Token-priority slots and the inverse-index gather. Each (token,
    pick) assignment, flattened t-major as ``(T, k) → (T·k)``, takes
    the next slot of its expert; slots ≥ ``C`` overflow and drop. Each
    kept assignment scatters its token id (one integer) into an
    ``(E, C)`` map, overflow into a trash column; token rows are then
    GATHERED into the ``(E, C, D)`` expert buffer in the compute dtype.
    Returns (X (E, C, D), flat_e (T·k,), slot (T·k,), keep (T·k,)).

    On a mesh (:meth:`MeshLayout.moe`) the slots are global: ``offset``
    (T·k,) adds the assignments of the same expert that come before
    each one in the global token order, so ``keep`` is the global
    capacity's; the buffer holds only experts ``lo .. lo+n_local-1``
    and ``C_buf`` slots each (this rank's kept assignments of an expert
    are the first of its own, so their local slots stay below both
    ``C`` and its token count)."""
    T, D = x.shape
    E = cfg.n_experts
    n_local = E if n_local is None else n_local
    C_buf = C if C_buf is None else C_buf
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
    keep = pos < C if offset is None else pos + offset < C
    mine = keep
    if n_local != E:
        mine = keep & (flat_e >= lo) & (flat_e < lo + n_local)
    tok = torch.arange(n, device=dev) // cfg.expert_top_k
    inv = torch.zeros((n_local, C_buf + 1), dtype=torch.int64, device=dev)
    inv[torch.clamp(flat_e - lo, 0, n_local - 1),
        torch.where(mine, pos, C_buf)] = tok + 1  # 0 = empty
    inv = inv[:, :C_buf]
    # Empty slots read rows spread over the tokens and are zeroed, so the
    # gather's backward (an index_add_) adds into any row a few times at
    # most, and only exact zeros beyond a token's k real picks.
    spread = torch.arange(n_local * C_buf, device=dev).reshape(
        n_local, C_buf) % T
    src = torch.where(inv > 0, inv - 1, spread)
    rows = x.index_select(0, src.reshape(-1)).reshape(n_local, C_buf, D)
    X = torch.where((inv > 0)[..., None], rows.to(cfg.dtype), 0.0)
    return X, flat_e, torch.clamp(pos, 0, C_buf - 1), keep


def _moe_experts(X, layer, cfg: TransformerConfig):
    """The stacked experts' SwiGLUs as three batched products over the
    expert dim: (E, C, D) → (E, C, D)."""
    dt = cfg.dtype
    g = torch.bmm(X, layer["w_gate"].to(dt))
    u = torch.bmm(X, layer["w_up"].to(dt))
    return torch.bmm(torch.nn.functional.silu(g) * u, layer["w_down"].to(dt))


def _moe_combine(Y, flat_e, slot, keep, gate_w, cfg: TransformerConfig,
                 lo: int = 0):
    """Gather each assignment's expert output back, zero the dropped
    ones, weight by the gates and sum a token's k picks: → (T, D).
    ``Y`` may hold experts ``lo ..`` only (a rank's share on a mesh):
    assignments to other experts then count zero here."""
    dt = cfg.dtype
    E, C, D = Y.shape
    if E != cfg.n_experts:
        local = flat_e - lo
        keep = keep & (local >= 0) & (local < E)
        flat_e = torch.clamp(local, 0, E - 1)
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
                 moe_capacity: int | None = None, hooks=_LOCAL):
    """Pre-norm MLP (dense SwiGLU or MoE) + residual → (x, aux); a dense
    MLP's aux is the float 0.0 (no device work)."""
    dt = cfg.dtype
    h = rms_norm(x, layer["mlp_norm"])
    if cfg.n_experts:
        y, aux = hooks.moe(h, layer, cfg, moe_capacity)
        return x + y, aux
    h = hooks.mlp_in(h)
    gate = h @ layer["w_gate"].to(dt)
    up = h @ layer["w_up"].to(dt)
    y = (torch.nn.functional.silu(gate) * up) @ layer["w_down"].to(dt)
    return x + hooks.mlp_out(y), 0.0


def layer_params(params: dict, i: int) -> dict:
    """Layer ``i`` of the stacked block parameters (views, no copy)."""
    return {name: w[i] for name, w in params["blocks"].items()}


#: The remat policies; "dots" saves the outputs of these ops.
REMAT_POLICIES = ("none", "dots")
_SAVED_DOTS = ("mm", "addmm")


def _remat_kwargs(cfg: TransformerConfig) -> dict:
    """``torch.utils.checkpoint`` options of ``cfg.remat_policy``."""
    if cfg.remat_policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}; "
                         f"want one of {REMAT_POLICIES}")
    kw = dict(use_reentrant=False, preserve_rng_state=False)
    if cfg.remat_policy == "dots":
        ops = [getattr(torch.ops.aten, n).default for n in _SAVED_DOTS]
        kw["context_fn"] = partial(create_selective_checkpoint_contexts, ops)
    return kw


def _layers(x, params: dict, cfg: TransformerConfig, body):
    """``x`` through every layer's ``body(x, *leaves) -> (x, aux)``,
    ``leaves`` the layer's slices of the stacked block parameters in
    ``params["blocks"]`` order. Under ``cfg.remat`` each layer runs
    checkpointed, its slices passed in, so the recompute captures them
    and not the whole stacks (with no gradient recorded there is nothing
    to recompute, and it runs plain). Returns (x, aux summed over layers)."""
    names = list(params["blocks"])
    kw = (_remat_kwargs(cfg) if cfg.remat and torch.is_grad_enabled()
          else None)
    aux = torch.zeros((), device=x.device)
    for i in range(cfg.n_layers):
        leaves = [params["blocks"][n][i] for n in names]
        if kw is None:
            x, layer_aux = body(x, *leaves)
        else:
            x, layer_aux = checkpoint(body, x, *leaves, **kw)
        if cfg.n_experts:
            aux = aux + layer_aux
    return x, aux


def hidden_with_aux(params: dict, tokens: torch.Tensor,
                    cfg: TransformerConfig, attn_fn=None, mesh=None):
    """Backbone through the final norm: (x (B,S,D) in compute dtype,
    aux) — aux is the MoE router loss summed over layers (0.0 dense).
    With ``mesh``, ``params`` and ``tokens`` are this rank's blocks
    (:class:`MeshLayout`) and so is ``x``."""
    hooks = MeshLayout(cfg, mesh) if mesh is not None else _LOCAL
    attn_fn = attn_fn or resolve_attn_fn(cfg, tokens.device, mesh)
    x = hooks.embed(params, tokens).to(cfg.dtype)
    sin, cos = rope_tables(cfg, positions=hooks.positions(tokens))
    names = list(params["blocks"])

    def body(x, *leaves):
        layer = hooks.layer(dict(zip(names, leaves)))
        q, k, v = qkv_proj(x, layer, cfg, sin, cos, hooks)
        x = attn_residual(x, attn_fn(q, k, v, cfg), layer, cfg, hooks)
        return mlp_residual(x, layer, cfg, hooks=hooks)

    x, aux = _layers(x, params, cfg, body)
    return rms_norm(x, params["final_norm"]), aux


def head_weight(params: dict, cfg: TransformerConfig,
                mesh=None) -> torch.Tensor:
    """The LM head (D, V); on a mesh gathered whole for the fused loss
    from this rank's block."""
    if mesh is not None:
        return MeshLayout(cfg, mesh).head(params)
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def head_logits(x: torch.Tensor, head: torch.Tensor,
                cfg: TransformerConfig) -> torch.Tensor:
    """LM head: operands in the compute dtype, logits returned in f32."""
    return (x.to(cfg.dtype) @ head.to(cfg.dtype)).float()


#: Leaves the forward reads in f32 whatever ``cfg.dtype``: the MoE
#: router (:func:`_moe_router`).
F32_LEAVES = ("router",)


def compute_params(params: dict, cfg: TransformerConfig) -> dict:
    """The tree a server decodes with: every leaf but :data:`F32_LEAVES`
    cast to ``cfg.dtype`` once — the embedding and head, the norm scales
    and the matrices, each of which every use casts to ``cfg.dtype``
    (the norms cast to their input's, which is ``cfg.dtype`` on the
    forward's path). Each use's ``.to(cfg.dtype)`` then returns its
    input with no launch, and the results are bitwise those of
    ``params``. At an f32 ``cfg.dtype`` the leaves are ``params``' own.
    Training keeps its per-use casts: its weights change every step."""
    def cast(name, v):
        if isinstance(v, dict):
            return {k: cast(k, x) for k, x in v.items()}
        return v if name in F32_LEAVES else v.to(cfg.dtype)

    with torch.no_grad():
        return cast(None, params)


def forward_with_aux(params: dict, tokens: torch.Tensor,
                     cfg: TransformerConfig, attn_fn=None, mesh=None):
    """(logits (B, S, V) f32, aux) — aux is the summed MoE router loss
    (0.0 for dense MLPs)."""
    x, aux = hidden_with_aux(params, tokens, cfg, attn_fn, mesh)
    return head_logits(x, head_weight(params, cfg, mesh), cfg), aux


def forward(params: dict, tokens: torch.Tensor, cfg: TransformerConfig,
            attn_fn=None, mesh=None) -> torch.Tensor:
    """Logits (B, S, V) in f32."""
    return forward_with_aux(params, tokens, cfg, attn_fn, mesh)[0]


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
               attn_fn=None, mesh=None):
    """(nll_sum, denom, aux) — the loss pieces gradient accumulation
    sums across microbatches (``train/trainer.py``). The LM head runs
    fused with the cross-entropy: full logits are never materialized.
    With ``mesh`` the sums are over this rank's rows only."""
    x, aux = hidden_with_aux(params, batch["tokens"], cfg, attn_fn, mesh)
    nll_sum, denom = _chunked_nll(x, head_weight(params, cfg, mesh),
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


# ---------------------------------------------------------------- sharding


def _maybe(axis: str | None, size: int, axis_sizes: dict[str, int]):
    """Use the axis in a spec only if present and it divides ``size``:
    strategies degrade to replication when an axis is absent."""
    if axis is None or axis not in axis_sizes:
        return None
    return axis if size % axis_sizes[axis] == 0 else None


def param_specs(cfg: TransformerConfig, axis_sizes: dict[str, int]) -> dict:
    """Placement tree matching ``init_params`` (the reference's
    ``param_specs``, each ``P(...)`` a tuple): ``model`` (TP) splits the
    head and ff dims, Megatron's column/row pairs; ``fsdp`` splits the
    d_model dim of every matmul weight. Block placements lead with None
    for the stacked layer dim."""
    D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    H, K, E = cfg.n_heads, cfg.kv_heads, cfg.n_experts
    fsdp = partial(_maybe, "fsdp", axis_sizes=axis_sizes)
    tp = partial(_maybe, "model", axis_sizes=axis_sizes)
    ep = partial(_maybe, "expert", axis_sizes=axis_sizes)
    if E:
        mlp = {"mlp_norm": (None, None),
               "router": (None, fsdp(D), None),
               "w_gate": (None, ep(E), fsdp(D), tp(F)),
               "w_up": (None, ep(E), fsdp(D), tp(F)),
               "w_down": (None, ep(E), tp(F), fsdp(D))}
    else:
        mlp = {"mlp_norm": (None, None),
               "w_gate": (None, fsdp(D), tp(F)),
               "w_up": (None, fsdp(D), tp(F)),
               "w_down": (None, tp(F), fsdp(D))}
    specs = {
        "embed": (tp(V), fsdp(D)),
        "blocks": {
            "attn_norm": (None, None),
            "wq": (None, fsdp(D), tp(H), None),
            "wk": (None, fsdp(D), tp(K), None),
            "wv": (None, fsdp(D), tp(K), None),
            "wo": (None, tp(H), None, fsdp(D)),
            **mlp,
        },
        "final_norm": (None,),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = (fsdp(D), tp(V))
    return specs


def batch_spec(axis_sizes: dict[str, int], seq_axis: bool = False) -> tuple:
    """Token batch placement: the batch dim over every data-like axis
    present (data and fsdp both act as data for activations), and the
    sequence dim over ``seq`` when ``seq_axis`` (ring attention)."""
    batch_axes = tuple(a for a in ("data", "fsdp") if a in axis_sizes)
    first = (batch_axes[0] if len(batch_axes) == 1  # P's own normal form
             else batch_axes or None)
    second = "seq" if (seq_axis and "seq" in axis_sizes) else None
    return (first, second)


def tp_kv_heads(k: torch.Tensor, cfg: TransformerConfig, m: int,
                r: int) -> torch.Tensor:
    """This model rank's K/V heads when ``kv_heads`` does not divide the
    ``model`` axis (``m`` ranks, this one ``r``) and K/V are computed
    whole: each kv head repeated just enough (``m / gcd(K, m)``, or up
    to ``H`` when the padded count cannot group with the query heads),
    then the rank's contiguous share, aligned with its query heads."""
    K, H = cfg.kv_heads, cfg.n_heads
    rep = m // math.gcd(K, m)
    if H % (K * rep):
        rep = H // K
    k = torch.repeat_interleave(k, rep, dim=2)
    n = k.shape[2] // m
    return k[:, :, r * n:(r + 1) * n]


class MeshLayout(LocalLayout):
    """The model laid out on a mesh: :func:`param_specs` and
    :func:`batch_spec`, and the block's hooks (:class:`LocalLayout`)
    over this rank's blocks. Every rank of the mesh runs the same
    forward (the collectives pair up).

    The collectives (``parallel/collectives.py``, each the identity on
    an axis of size 1): a weight split over ``fsdp`` is allgathered
    before use, its gradient reduce-scattered; over ``model`` the block
    input enters the column-parallel products through "f" (gradient
    allreduced) and each row-parallel product leaves through "g"
    (allreduced); K/V weights kept whole under a split attention get
    "f" too, since each rank uses its own heads of them. Gradients over
    the batch axes are the trainer's to sum.

    A mixture-of-experts MLP (:meth:`moe`) keeps the reference's global
    program: the capacity is the global batch's, each assignment's slot
    counts the same expert's assignments of every token before it in
    the global ``(b, s)`` order (an exclusive prefix of per-row counts
    allgathered over the token axes: ``data``, ``fsdp`` and ``seq``),
    and the router's aux is taken over the global batch. The bank is
    split over ``expert`` (and ``model`` on F); the batch is replicated
    along ``expert``, so each rank routes its tokens in full, runs its
    own experts' SwiGLUs and the partial outputs are summed over
    ``expert`` and ``model``: "f" on the token rows and gates entering
    the experts, "g" on their output. Every mesh that names ``expert``
    takes this branch, whatever the axis size (``moe_calls`` counts
    it)."""

    #: Calls of :meth:`moe` (the mesh's MoE branch), summed over layers.
    moe_calls = 0

    def __init__(self, cfg: TransformerConfig, mesh):
        from ptype_tpu_torch.parallel.mesh import axis_index

        self.cfg, self.mesh = cfg, mesh
        self.sizes = {n: int(mesh.shape[n]) for n in mesh.axis_names}
        self.specs = param_specs(cfg, self.sizes)
        live = {n for n, s in self.sizes.items() if s > 1}
        b = self.specs["blocks"]
        self.model = "model" if "model" in live else None
        self.attn_tp = self.model is not None and b["wq"][2] == "model"
        self.kv_whole = self.attn_tp and b["wk"][2] is None
        self.mlp_tp = (self.model is not None and not cfg.n_experts
                       and b["w_gate"][-1] == "model")
        self.vocab_tp = (self.model is not None
                         and self.specs["embed"][0] == "model")
        self.seq = "seq" if "seq" in live else None
        #: The axes that split the batch: a leaf's gradient is summed
        #: over those it is not split on.
        self.batch_axes = tuple(a for a in ("data", "fsdp", "seq")
                                if a in live)
        #: The axes that split the batch's rows (not its sequence).
        self.row_axes = tuple(a for a in mesh.axis_names
                              if a in live and a in ("data", "fsdp"))
        self.m = self.sizes.get("model", 1)
        self.m_rank = axis_index(mesh, "model") if self.model else 0
        if cfg.n_experts:
            split = b["w_gate"][1] == "expert"
            self.n_experts_local = (cfg.n_experts // self.sizes["expert"]
                                    if split else cfg.n_experts)
            self.expert_lo = (axis_index(mesh, "expert")
                              * self.n_experts_local if split else 0)
            #: The axes a rank's expert outputs are partial over.
            self.moe_axes = tuple(
                a for a in mesh.axis_names if a in live and (
                    (a == "expert" and split)
                    or (a == "model" and b["w_gate"][-1] == "model")))
            #: The axes whose ranks hold different tokens, mesh order.
            self.token_axes = tuple(a for a in mesh.axis_names
                                    if a in self.batch_axes)

    def use(self, w: torch.Tensor, spec) -> torch.Tensor:
        """``w`` whole over ``fsdp`` (allgathered on each split dim)."""
        from ptype_tpu_torch.parallel.collectives import gather_for_use

        for dim, entry in enumerate(spec):
            if entry == "fsdp":
                w = gather_for_use(w, self.mesh, "fsdp", dim)
        return w

    def _embed(self, params: dict) -> torch.Tensor:
        return self.use(params["embed"], self.specs["embed"])

    def head(self, params: dict) -> torch.Tensor:
        """The whole LM head (D, V): gathered over ``fsdp`` (gradient
        reduce-scattered) and over ``model`` (each model rank computes
        the same loss from it, so its gradient's own block comes back)."""
        from ptype_tpu_torch.parallel.collectives import gather_replicated

        if self.cfg.tie_embeddings:
            e = self._embed(params)
            if self.vocab_tp:
                e = gather_replicated(e, self.mesh, "model", 0)
            return e.T
        w = self.use(params["lm_head"], self.specs["lm_head"])
        if self.specs["lm_head"][1] == "model" and self.model:
            w = gather_replicated(w, self.mesh, "model", 1)
        return w

    def embed(self, params: dict, tokens: torch.Tensor) -> torch.Tensor:
        """The embedding rows; split over the vocabulary, a masked
        lookup of this rank's rows and an allreduce over ``model``."""
        from ptype_tpu_torch.parallel import collectives as C

        e = self._embed(params)
        if not self.vocab_tp:
            return e[tokens]
        lo = self.m_rank * e.shape[0]
        idx = tokens - lo
        hit = (idx >= 0) & (idx < e.shape[0])
        rows = e[torch.where(hit, idx, torch.zeros_like(idx))]
        rows = torch.where(hit[..., None], rows, torch.zeros_like(rows))
        return C.reduce_from(rows, self.mesh, "model")

    def positions(self, tokens: torch.Tensor) -> torch.Tensor:
        from ptype_tpu_torch.parallel.mesh import axis_index

        S = tokens.shape[1]
        pos0 = axis_index(self.mesh, "seq") * S if self.seq else 0
        return torch.arange(pos0, pos0 + S, device=tokens.device)

    def layer(self, layer: dict) -> dict:
        specs = self.specs["blocks"]
        return {n: self.use(w, specs[n][1:]) for n, w in layer.items()}

    def _f(self, x, on: bool):
        from ptype_tpu_torch.parallel import collectives as C

        return C.copy_to(x, self.mesh, self.model) if on else x

    def _g(self, y, on: bool):
        from ptype_tpu_torch.parallel import collectives as C

        return C.reduce_from(y, self.mesh, self.model) if on else y

    def attn_in(self, h):
        return self._f(h, self.attn_tp)

    def kv_weights(self, wk, wv):
        return self._f(wk, self.kv_whole), self._f(wv, self.kv_whole)

    def kv_heads(self, k):
        if not self.kv_whole:
            return k
        return tp_kv_heads(k, self.cfg, self.m, self.m_rank)

    def attn_out(self, y):
        return self._g(y, self.attn_tp)

    def mlp_in(self, h):
        return self._f(h, self.mlp_tp)

    def mlp_out(self, y):
        return self._g(y, self.mlp_tp)

    def _slot_offsets(self, gate_e, B: int, S: int) -> torch.Tensor:
        """Per assignment (T·k,), the count of assignments of its expert
        that come before it in the global token order but not before it
        in this rank's own (the flat ``(b, s)`` order: the row blocks
        of the batch ranks in turn, and within a row the sequence
        blocks of the ``seq`` ranks); None when this rank's tokens are
        all the tokens."""
        from ptype_tpu_torch.parallel import collectives as C
        from ptype_tpu_torch.parallel.mesh import axis_index

        if not self.token_axes:
            return None
        E, k = self.cfg.n_experts, self.cfg.expert_top_k
        flat_e = gate_e.reshape(-1)
        hits = torch.arange(E, device=flat_e.device)[:, None] == flat_e
        cnt = hits.to(torch.int64).reshape(E, B, S * k).sum(-1)  # (E, B)
        axes = self.token_axes
        got = C.all_gather(cnt, self.mesh, axes)         # (n, E, B)
        rows = tuple(a for a in axes if a != "seq")
        order = [axes.index(a) for a in rows] + (
            [axes.index("seq")] if self.seq else [])
        got = got.reshape(*(self.sizes[a] for a in axes), E, B).permute(
            *order, len(axes), len(axes) + 1)
        got = got.reshape(-1, self.sizes["seq"] if self.seq else 1, E, B)
        j = axis_index(self.mesh, rows) if rows else 0
        q = axis_index(self.mesh, "seq") if self.seq else 0
        mine = got[j]                                     # (n_s, E, B)
        row_tot = mine.sum(0)
        before = (got[:j].sum((0, 1, 3))[:, None]          # earlier ranks
                  + torch.cumsum(row_tot, 1) - row_tot     # earlier rows
                  + mine[:q].sum(0))                       # earlier seq
        own = mine[q]
        delta = before - (torch.cumsum(own, 1) - own)
        row = torch.arange(flat_e.shape[0], device=flat_e.device) // (S * k)
        return delta[flat_e, row]

    def moe(self, h, layer, cfg, capacity=None):
        """The mixture-of-experts MLP on this rank's tokens as a piece of
        the reference's global program (the class docstring): (y, this
        rank's share of the global aux). The shares sum to the aux over
        the token axes, and the aux's gradient comes out global once the
        trainer sums the gradients over them."""
        from ptype_tpu_torch.parallel import collectives as C

        MeshLayout.moe_calls += 1
        B, S, D = h.shape
        T = B * S
        E, k = cfg.n_experts, cfg.expert_top_k
        x = h.reshape(T, D)
        probs, gate_w, gate_e, dispatched = _moe_router(x, layer["router"],
                                                        cfg)
        axes = self.token_axes
        n_tok = math.prod(self.sizes[a] for a in axes)
        T_g = T * n_tok
        me = C.sum_over(probs.sum(0), self.mesh, axes) / T_g
        ce = dispatched.sum(0)
        if axes:
            ce = C.all_reduce(ce, self.mesh, axes)
        aux = E * (me * (ce / T_g / k)).sum() / n_tok
        cap = (capacity if capacity is not None
               else max(math.ceil(k * T_g / E * cfg.capacity_factor), 1))
        offset = self._slot_offsets(gate_e, B, S)
        part = self.moe_axes
        X, flat_e, slot, keep = _moe_dispatch(
            C.copy_to(x, self.mesh, part), gate_e, cap, cfg, offset=offset,
            lo=self.expert_lo, n_local=self.n_experts_local,
            C_buf=min(cap, T))
        Y = _moe_experts(X, layer, cfg)
        y = _moe_combine(Y, flat_e, slot, keep,
                         C.copy_to(gate_w, self.mesh, part), cfg,
                         lo=self.expert_lo)
        return C.reduce_from(y, self.mesh, part).reshape(B, S, D), aux
