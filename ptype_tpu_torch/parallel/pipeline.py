"""Pipeline parallelism over the ``stage`` mesh axis — the port of
``ptype_tpu/parallel/pipeline.py``: the GPipe and 1F1B schedules.

The reference runs all stages as ONE compiled SPMD program: a
``lax.scan`` over pipeline ticks whose activations travel around the
``stage`` ring by ``lax.ppermute``, autodiff giving the reverse pipeline
(``ppermute``'s transpose is the reverse rotation). The port runs one
process a stage rank, so a schedule is an eager loop over the same
ticks in every rank, each tick ending in one :func:`~ptype_tpu_torch.
parallel.collectives.ring_send` over the ``stage`` group:

- **GPipe** (:func:`pipeline_apply`): autograd through the loop; each
  send's backward sends the gradient back the other way. Every rank
  must run the sends' backwards in one order, so each send is chained
  after the previous tick's receive (:class:`_After`, a zero-gradient
  edge) and the last receive is tied into the output: every rank's
  autograd then walks the ticks in exact reverse. A rank computes only
  its ticks with work (the reference's SPMD program computes masked
  garbage in the bubble).
- **1F1B** (:func:`pipeline_loss_and_grads_1f1b`): hand-scheduled, as
  in the reference — each tick one forward and one backward microbatch
  where the schedule has them, the backward recomputed from the
  stashed stage input, so the live stash stays within 2S-1 inputs;
  activations go forward and cotangents back by two ring shifts a tick.

Layer split: the transformer's stacked blocks (leading ``n_layers``
dim) split into ``S`` contiguous chunks; a stage rank holds only its
own (``L/S`` layers of every block leaf, :func:`pipeline_state_shardings`
placements) and their AdamW moments. Embedding, final norm and head are
replicated on every rank. Attention inside the stages is the resolved
implementation — the flash kernels on CUDA; the sequence-parallel ones
cannot nest inside the stage ring and are refused.

(The registry-driven actor pipeline, PID→stage over RPC, is
``train/actor_pipeline.py``; this module is the throughput path.)
"""

from __future__ import annotations

import dataclasses

import torch

from ptype_tpu_torch.device import device_work
from ptype_tpu_torch.errors import ClusterError
from ptype_tpu_torch.models import transformer as tfm
from ptype_tpu_torch.parallel import collectives as C
from ptype_tpu_torch.parallel.mesh import axis_index, axis_n, shard_of
from ptype_tpu_torch.train.trainer import (AdamW, TrainState, _at,
                                           _batch_on, _flatten, _unflatten,
                                           default_optimizer, tree_leaves)

_MOE_REFUSAL = ("pipeline parallelism does not support MoE configs yet "
                "(router aux loss would be dropped); use dp/fsdp/tp/ep")


def split_stages(blocks: dict, n_stages: int) -> dict:
    """Reshape stacked block params (L, ...) → (S, L/S, ...)."""

    def resh(x):
        L = x.shape[0]
        if L % n_stages:
            raise ClusterError(
                f"pipeline: {L} layers not divisible into {n_stages} stages")
        return x.reshape(n_stages, L // n_stages, *x.shape[1:])

    return {k: resh(v) for k, v in blocks.items()}


def merge_stages(blocks: dict) -> dict:
    """Inverse of :func:`split_stages`: (S, L/S, ...) → (L, ...)."""
    return {k: v.reshape(v.shape[0] * v.shape[1], *v.shape[2:])
            for k, v in blocks.items()}


def _local_blocks(blocks: dict, cfg, mesh, axis: str) -> dict:
    """This rank's layers of every block leaf: a whole ``(L, ...)`` leaf
    is cut to its ``L/S`` block, a leaf already that size is kept."""
    if cfg.n_layers % axis_n(mesh, axis):
        raise ClusterError(f"pipeline: {cfg.n_layers} layers not divisible "
                           f"into {axis_n(mesh, axis)} stages")
    return {k: shard_of(v, (axis,), mesh) if v.shape[0] == cfg.n_layers
            else v for k, v in blocks.items()}


class _After(torch.autograd.Function):
    """``x``, with ``deps`` made inputs of it: their gradients (zeros)
    are ready only after ``x``'s has flowed, which orders the backward
    of whatever made them after everything downstream of ``x`` — and
    puts them on every gradient path through ``x``."""

    @staticmethod
    def forward(ctx, x, *deps):
        ctx.deps = [(d.shape, d.dtype, d.device) for d in deps]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(shape, dtype=dtype, device=device)
                     for shape, dtype, device in ctx.deps))


class _FromLast(torch.autograd.Function):
    """The last stage's value on every stage rank (a broadcast). Every
    rank computes the same loss from it, so the gradient is the last
    stage's own cotangent; the others' is zero."""

    @staticmethod
    def forward(ctx, y, mesh, axis):
        S = axis_n(mesh, axis)
        ctx.last = axis_index(mesh, axis) == S - 1
        return C.broadcast(y, mesh, axis, src=S - 1)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.last else torch.zeros_like(g)), None, None


def pipeline_apply(stage_fn, stage_params, x: torch.Tensor, mesh,
                   n_microbatches: int, axis: str = "stage") -> torch.Tensor:
    """Apply a stage-split layer stack to ``x`` through the GPipe
    schedule; differentiable.

    ``stage_fn(params, x_mb) -> y_mb`` runs this rank's chunk on one
    microbatch (same shape and dtype out as in); ``stage_params`` is this
    rank's chunk (its block of :func:`split_stages`' leaves, the stage
    dim dropped). ``x``: (B, ...), the same on every rank, B divisible by
    ``n_microbatches``. Returns the last stage's output, on every rank;
    ``x``'s gradient (stage 0's) is summed onto every rank. Every rank of
    the ``axis`` group calls, and runs backward through the result.

    The sends form one chain on every rank (each after the previous
    receive; the first after ``x`` and every tensor leaf of
    ``stage_params``, so any gradient a rank asks for runs the whole
    chain): the ranks' backwards pair their sends tick by tick."""
    S, s = axis_n(mesh, axis), axis_index(mesh, axis)
    M = n_microbatches
    B = x.shape[0]
    if B % M:
        raise ClusterError(f"pipeline: batch {B} not divisible into {M} "
                           "microbatches")
    x = C.copy_to(x, mesh, axis)
    x_mb = x.reshape(M, B // M, *x.shape[1:])
    state = torch.zeros_like(x_mb[0])
    roots = [x] + [p for p in tree_leaves(stage_params) if p.requires_grad]
    outs = []
    for t in range(M + S - 1):
        m = t - s
        if 0 <= m < M:
            y = stage_fn(stage_params, x_mb[m] if s == 0 else state)
            if s == S - 1:
                outs.append(y)
        else:  # a bubble tick: pass the (unused) arrival along
            y = state
        if S > 1:
            y = _After.apply(y, *([state] if t else roots))
        state = C.ring_send(y, mesh, axis)
    if S == 1:
        return torch.stack(outs).reshape(B, *x.shape[1:])
    out = (torch.stack(outs) if s == S - 1
           else torch.zeros_like(x_mb).to(state.dtype))
    out = _FromLast.apply(_After.apply(out, state), mesh, axis)
    return out.reshape(B, *out.shape[2:])


def _stage_attn(cfg, device):
    """Attention for the blocks inside the stage ring: the resolved
    implementation (the flash kernels on CUDA). The sequence-parallel
    ones cannot nest inside the stage ring: refused, never run dense."""
    if cfg.attn_impl in ("ring", "ulysses"):
        raise ClusterError(
            f"pipeline stages cannot nest seq-parallel attention "
            f"(attn_impl={cfg.attn_impl!r}); use auto/flash/xla")
    return tfm.resolve_attn_fn(cfg, device)


def _stage_fn(cfg, attn, sin, cos):
    """``(blocks, x) -> x`` over a chunk's layers: the transformer's
    block body (under ``cfg.remat``, checkpointed a layer)."""

    def stage_fn(blocks: dict, x: torch.Tensor) -> torch.Tensor:
        names = list(blocks)

        def body(x, *leaves):
            layer = dict(zip(names, leaves))
            q, k, v = tfm.qkv_proj(x, layer, cfg, sin, cos)
            x = tfm.attn_residual(x, attn(q, k, v, cfg), layer, cfg)
            return tfm.mlp_residual(x, layer, cfg)

        chunk = dataclasses.replace(cfg, n_layers=blocks[names[0]].shape[0])
        return tfm._layers(x, {"blocks": blocks}, chunk, body)[0]

    return stage_fn


def schedule_info(n_stages: int, n_microbatches: int,
                  schedule: str = "gpipe") -> dict:
    """Tick, stash and bubble accounting of a schedule. GPipe runs a
    forward pass of M+S-1 ticks and its reverse, every stage stashing
    all M microbatches for the backward; 1F1B runs one pass of M+2S-1
    ticks, each doing one forward and one backward microbatch in steady
    state, its live stash bounded by the schedule depth 2S-1 — at a
    fixed activation budget it can raise M until the bubble fraction
    (idle ticks / ticks) is small, where GPipe's stash grows with M."""
    S, M = n_stages, n_microbatches
    if schedule == "gpipe":
        return {"ticks": 2 * (M + S - 1), "stash_microbatches": M,
                "bubble_fraction": (S - 1) / (M + S - 1)}
    if schedule == "1f1b":
        ticks = M + 2 * S - 1
        return {"ticks": ticks, "stash_microbatches": 2 * S - 1,
                "bubble_fraction": (2 * S - 2) / ticks}
    raise ClusterError(f"unknown pipeline schedule {schedule!r}")


def _grad(out, inputs: list, ct=None) -> list:
    """Gradients of ``out`` (along ``ct``) at ``inputs``; an input the
    output does not use gets zeros."""
    gs = torch.autograd.grad(out, inputs, ct, allow_unused=True)
    return [torch.zeros_like(i) if g is None else g
            for i, g in zip(inputs, gs)]


def pipeline_loss_and_grads_1f1b(params: dict, batch: dict, cfg, mesh,
                                 n_microbatches: int, axis: str = "stage"):
    """(loss, grads) of the transformer with the block stack pipelined
    under the hand-written 1F1B schedule — the counterpart of autograd
    through :func:`transformer_pipeline_forward` (GPipe). ``params`` as a
    stage rank holds them (its blocks, or the whole tree); the grads
    come back in the same layout, the blocks' this rank's. Every rank of
    the ``axis`` group calls.

    Schedule (tick t, stage s): the forward of microbatch m at t = m+s;
    stage S-1 runs the tail (final norm, head, loss) and its VJP in the
    tick its forward finishes and carries the cotangent one tick to its
    own backward; the backward of m at t = m + 2S-1-s, recomputed from
    the stashed stage input. The embedding's gradient is the scatter of
    stage 0's input cotangents, plus the tied head's."""
    if cfg.n_experts:
        raise ClusterError(_MOE_REFUSAL)
    S, s = axis_n(mesh, axis), axis_index(mesh, axis)
    M = n_microbatches
    tokens, targets = batch["tokens"], batch["targets"]
    B, T = tokens.shape
    if B % M:
        raise ClusterError(f"pipeline: batch {B} not divisible into {M} "
                           "microbatches")
    mb = B // M
    dev = tokens.device
    tgt_mb = targets.reshape(M, mb, T)
    mask = batch.get("loss_mask")
    mask_mb = (torch.ones((M, mb, T), dtype=torch.float32, device=dev)
               if mask is None else mask.reshape(M, mb, T))
    with torch.no_grad():
        x_mb = params["embed"][tokens.reshape(M, mb, T)].to(cfg.dtype)
    sin, cos = tfm.rope_tables(cfg, T, device=dev)
    blocks = {k: v.detach() for k, v in
              _local_blocks(params["blocks"], cfg, mesh, axis).items()}
    names = list(blocks)
    head = tfm.head_weight(params, cfg).detach()
    wnorm = params["final_norm"].detach()
    stage_fn = _stage_fn(cfg, _stage_attn(cfg, dev), sin, cos)
    zeros_mb = torch.zeros_like(x_mb[0])
    f32 = dict(dtype=torch.float32, device=dev)

    gblocks = {k: torch.zeros_like(v) for k, v in blocks.items()}
    gnorm, ghead = torch.zeros_like(wnorm), torch.zeros_like(head)
    xct = torch.zeros_like(x_mb)
    nll, den = torch.zeros((), **f32), torch.zeros((), **f32)
    fwd_in, bwd_ct, self_ct = zeros_mb, zeros_mb, zeros_mb
    stash: dict[int, torch.Tensor] = {}
    for t in range(M + 2 * S - 1):
        # forward op: microbatch t - s
        m_f = t - s
        y, new_self_ct = zeros_mb, self_ct
        if 0 <= m_f < M:
            x_in = x_mb[m_f] if s == 0 else fwd_in
            stash[m_f] = x_in
            with torch.no_grad():
                y = stage_fn(blocks, x_in)
            if s == S - 1:
                wn, hd = wnorm.requires_grad_(True), head.requires_grad_(True)
                yy = y.detach().requires_grad_(True)
                with torch.enable_grad():
                    h = tfm.rms_norm(yy, wn)
                    nll_m, den_m = tfm.nll_terms_from_logits(
                        tfm.head_logits(h, hd, cfg),
                        {"targets": tgt_mb[m_f], "loss_mask": mask_mb[m_f]})
                dwn, dhd, dy = _grad(nll_m, [wn, hd, yy])
                nll, den = nll + nll_m.detach(), den + den_m.detach()
                gnorm, ghead = gnorm + dwn, ghead + dhd
                new_self_ct = dy.to(x_mb.dtype)
        # backward op: microbatch t - (2S-1) + s
        m_b = t - (2 * S - 1) + s
        dx = zeros_mb
        if 0 <= m_b < M:
            ct = self_ct if s == S - 1 else bwd_ct
            xs = stash.pop(m_b).detach().requires_grad_(True)
            leaves = [blocks[k].requires_grad_(True) for k in names]
            with torch.enable_grad():
                out = stage_fn(dict(zip(names, leaves)), xs)
            *dp, dx = _grad(out, leaves + [xs], ct)
            for k, g in zip(names, dp):
                gblocks[k] += g
            if s == 0:
                xct[m_b] = dx
        self_ct = new_self_ct
        if S > 1:
            fwd_in = C.ring_shift(y, mesh, axis, 1)
            bwd_ct = C.ring_shift(dx.to(x_mb.dtype), mesh, axis, -1)

    if S > 1:  # the tail's sums from the last stage, xct from the first
        nll, den, gnorm, ghead = (C.broadcast(v, mesh, axis, src=S - 1)
                                  for v in (nll, den, gnorm, ghead))
        xct = C.broadcast(xct, mesh, axis, src=0)
    # Unnormalized sums accumulate in the ring; normalize once, so loss
    # and grads do not depend on M.
    loss = nll / den
    inv = 1.0 / den

    def scale(g):
        return (g * inv).to(g.dtype)

    dembed = torch.zeros_like(params["embed"]).index_add_(
        0, tokens.reshape(-1), xct.reshape(B * T, -1).float() * inv)
    grads = {"embed": dembed,
             "blocks": {k: scale(g) for k, g in gblocks.items()},
             "final_norm": scale(gnorm)}
    if cfg.tie_embeddings:
        grads["embed"] = grads["embed"] + scale(ghead).T
    else:
        grads["lm_head"] = scale(ghead)
    return loss, grads


# ------------------------------------------------- transformer integration


def transformer_pipeline_forward(params: dict, tokens: torch.Tensor, cfg,
                                 mesh, n_microbatches: int,
                                 axis: str = "stage") -> torch.Tensor:
    """``models/transformer.forward`` with the block stack pipelined
    (GPipe): logits (B, S, V) in f32, on every rank. Embedding and head
    stay outside the pipeline; ``params`` as a stage rank holds them
    (its blocks, or the whole tree). Every rank of the ``axis`` group
    calls."""
    if cfg.n_experts:
        # The stage ring carries activations only: refusing beats
        # optimizing another objective than the dense path's.
        raise ClusterError(_MOE_REFUSAL)
    attn = _stage_attn(cfg, tokens.device)
    T = tokens.shape[1]
    x = params["embed"][tokens].to(cfg.dtype)
    sin, cos = tfm.rope_tables(cfg, T, device=tokens.device)
    blocks = _local_blocks(params["blocks"], cfg, mesh, axis)
    x = pipeline_apply(_stage_fn(cfg, attn, sin, cos), blocks, x, mesh,
                       n_microbatches, axis)
    x = tfm.rms_norm(x, params["final_norm"])
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return torch.einsum("bsd,dv->bsv", x.float(), head.float())


def pipeline_state_shardings(params_like: dict,
                             axis: str = "stage") -> dict:
    """The placement tree of a pipelined ``TrainState`` in the
    checkpoint layout (``train.trainer.state_placements``'s form): block
    leaves split on their layer dim over ``axis`` (each stage rank holds
    its ``L/S`` layers), every other leaf replicated, the AdamW moments
    mirroring the params, None for the counts."""
    specs = {k: ({n: (axis,) for n in v} if k == "blocks" else ())
             for k, v in params_like.items()}
    return {"0": specs,
            "1": {"1": {"0": {".count": None, ".mu": specs, ".nu": specs},
                        "2": {".count": None}}},
            "2": None}


def init_pipeline_state(cfg, mesh, params: dict, optimizer=None,
                        axis: str = "stage"):
    """This rank's ``TrainState`` for :func:`make_pipeline_train_step`
    from ``params`` (the whole tree, every rank passing the same, or
    this rank's blocks already): its blocks, the replicated leaves, and
    zero moments of the same shapes. Returns ``(state, placements)``;
    ``train.trainer.state_tree(state, placements, mesh)`` writes the
    reference's global checkpoint layout, as the ``Trainer``'s does."""
    optimizer = optimizer or default_optimizer()
    local = {k: v for k, v in params.items()}
    local["blocks"] = _local_blocks(params["blocks"], cfg, mesh, axis)
    local = {k: ({n: t.detach().to(mesh.device, cfg.param_dtype).clone()
                  for n, t in v.items()} if isinstance(v, dict)
                 else v.detach().to(mesh.device, cfg.param_dtype).clone())
             for k, v in local.items()}
    state = TrainState(local, optimizer.init(local), 0)
    return state, pipeline_state_shardings(local, axis=axis)


def _global_norm(grads: dict, mesh, axis: str) -> torch.Tensor:
    """The clip's norm: the blocks' squares summed over the stage ranks,
    every replicated leaf's once."""
    def sq(leaves):
        return sum(torch.sum(g.float() * g.float()) for g in leaves)

    blocks = sq(grads["blocks"].values())
    if axis_n(mesh, axis) > 1:
        blocks = C.all_reduce(blocks, mesh, axis)
    rest = sq(v for k, v in grads.items() if k != "blocks")
    return torch.sqrt(blocks + rest)


def make_pipeline_train_step(cfg, mesh, n_microbatches: int,
                             optimizer=None, axis: str = "stage",
                             schedule: str = "gpipe"):
    """``(state, batch) → (state, metrics)`` with the block stack
    pipelined; the state (:func:`init_pipeline_state`) is updated in
    place and its layout is the ``Trainer``'s, so checkpoints
    interchange between pipelined and dense training. ``batch`` is the
    global batch, the same on every rank. The optimizer is the port's
    :class:`~ptype_tpu_torch.train.trainer.AdamW` (the default recipe),
    its clip on the global norm over all stages.

    ``schedule``: "gpipe" (autograd through :func:`pipeline_apply`;
    every stage stashes all M microbatches) or "1f1b"
    (:func:`pipeline_loss_and_grads_1f1b`, stash bounded at 2S-1). A
    mixture-of-experts config is refused at its first step."""
    if schedule not in ("gpipe", "1f1b"):
        raise ClusterError(f"unknown pipeline schedule {schedule!r}")
    optimizer = optimizer or default_optimizer()
    if not isinstance(optimizer, AdamW):
        raise TypeError("the pipeline train step applies the port's AdamW; "
                        f"got {type(optimizer).__name__}")

    def step(state, batch: dict):
        with device_work():
            return _step(state, batch)

    def _step(state, batch: dict):
        batch = _batch_on(batch, mesh.device)
        params = state.params
        if schedule == "1f1b":
            loss, grads = pipeline_loss_and_grads_1f1b(
                params, batch, cfg, mesh, n_microbatches, axis)
            # the optimizer pairs leaves in the params' order
            grads = _unflatten((path, _at(grads, path))
                               for path, _ in _flatten(params))
        else:
            paths, leaves = zip(*_flatten(params))
            for p in leaves:
                p.requires_grad_(True)
            logits = transformer_pipeline_forward(
                params, batch["tokens"], cfg, mesh, n_microbatches, axis)
            loss = tfm.nll_from_logits(logits, batch)
            grads = _unflatten(zip(paths, torch.autograd.grad(loss, leaves)))
            loss = loss.detach()
        gnorm = _global_norm(grads, mesh, axis)
        optimizer.update(params, grads, state.opt_state, gnorm=gnorm)
        state.step += 1
        return state, {"loss": loss, "grad_norm": gnorm, "step": state.step}

    return step
