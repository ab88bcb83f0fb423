"""The train step and ``Trainer`` — the port of
``ptype_tpu/train/trainer.py``, on one device or on a mesh.

One step: the loss (:func:`~ptype_tpu_torch.models.transformer.loss_fn`,
its head fused into row chunks; attention through the differentiable
flash kernels on CUDA) → grads → the reference's default recipe, AdamW
with a warmup-cosine schedule, a decay mask that exempts norms, and a
global-norm clip. The recipe is written out elementwise, as XLA runs it
in the reference, in the same order of operations as ``optax``.

PyTorch dispatches asynchronously on its own: :meth:`Trainer.step`
returns the loss and grad norm as device scalars, and reading them is
what waits. ``Trainer`` drains the queue every ``sync_every`` steps so
its throughput counts completed work only.

On a mesh (``Trainer(cfg, mesh=...)``, one process a rank) every rank
holds its blocks of the state under the reference's placements
(``models/transformer.py`` ``param_specs``; the moments mirror the
params, and ``shard_update`` also splits them over ``data`` on their
first unsplit divisible dim — ZeRO-1 by placement). A step runs the
sharded forward and backward on this rank's block of the batch
(:meth:`Trainer.shard_batch`), divides by the GLOBAL token count,
sums each gradient over the batch axes it is not split on, takes the
clip's global norm by summing each leaf's squares over the axes it is
split on (and only those), and updates each block in place. A
``shard_update`` leaf is updated on this rank's moment block and
allgathered over ``data``. Checkpoints write each block at its offset,
so a step directory is the reference's global layout either way, and
restore reads back only the rank's own block.

Mixture-of-experts configs train on one device or on any mesh, the
expert bank split over ``expert`` (expert parallelism,
``models/transformer.py`` ``MeshLayout.moe``): the capacity, the token
order and the router aux are the global batch's, and with
``grad_accum > 1`` each microbatch is the reference's slice of the
global batch. Data-parallel training through the Store, with the ZeRO
ladder, is ``train/store_dp.py``; it applies the same AdamW arithmetic
(:func:`adamw_leaf_`). The async param server and the stage actors
(``train/param_server.py``, ``train/actor_pipeline.py``) step through
:func:`make_apply_fn`, the stage actors with :class:`Adam` or
:class:`SGD` (``optax.adam`` / ``optax.sgd``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from ptype_tpu_torch import logs, metrics
from ptype_tpu_torch.device import device_work, resolve_device
from ptype_tpu_torch.models import transformer as tfm
from ptype_tpu_torch.models.weights import init_params, param_shapes
from ptype_tpu_torch.parallel import collectives as C
from ptype_tpu_torch.parallel.mesh import (axis_index, axis_n, block_of,
                                           owns_block, shard_of)
from ptype_tpu_torch.parallel.topology import DATA_AXIS

#: Batch keys the loss reads; other keys of a stream are dropped.
BATCH_KEYS = ("tokens", "targets", "loss_mask")


def _flatten(tree: dict, prefix: tuple = ()) -> list[tuple[tuple, Any]]:
    """(path, leaf) pairs of a nested dict, in key order."""
    out = []
    for key, val in tree.items():
        if isinstance(val, dict):
            out += _flatten(val, prefix + (key,))
        else:
            out.append((prefix + (key,), val))
    return out


def _unflatten(pairs) -> dict:
    tree: dict = {}
    for path, leaf in pairs:
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def tree_map(fn: Callable, tree):
    """``fn`` on every leaf of a tree of dicts, lists and tuples (a bare
    tensor is a tree of one leaf); the structure is kept."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves of a tree in :func:`tree_map`'s order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


@dataclass
class TrainState:
    """Parameters, optimizer state and the step count. The step updates
    all three in place (the reference donates them to its jitted
    step)."""

    params: dict
    opt_state: Any
    step: int


def _decay_mask(params: dict) -> dict:
    """True for leaves that take weight decay: matmul weights only. A
    leaf whose name holds "norm" is exempt (block norm scales carry a
    leading layer dim, so ndim alone would not catch them), and so is
    any leaf of ndim <= 1."""
    return _unflatten((path, "norm" not in path[-1] and leaf.dim() > 1)
                      for path, leaf in _flatten(params))


def warmup_cosine_decay(init_value: float, peak_value: float, warmup: int,
                        decay_steps: int, end_value: float):
    """``optax.warmup_cosine_decay_schedule`` (exponent 1) as a host
    function of the update count, in float32 and in optax's order of
    operations: linear from ``init_value`` to ``peak_value`` over
    ``warmup`` counts, then a cosine to ``end_value`` at
    ``decay_steps``. Count 0 gives ``init_value``."""
    if decay_steps - warmup <= 0:
        raise ValueError("warmup_cosine_decay: decay_steps must exceed "
                         f"warmup, got {decay_steps} <= {warmup}")
    f32 = np.float32
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    span = decay_steps - warmup

    def schedule(count: int) -> np.float32:
        if count < warmup:
            frac = f32(1) - f32(min(max(count, 0), warmup)) / f32(warmup)
            return f32(init_value - peak_value) * frac + f32(peak_value)
        c = f32(min(count - warmup, span))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c / f32(span)))
        return f32(peak_value) * (f32(1 - alpha) * cosine + f32(alpha))

    return schedule


@dataclass(frozen=True)
class OptHParams:
    """The default recipe's hyperparameters as one record."""

    lr: float = 3e-4
    weight_decay: float = 0.1
    warmup: int = 100
    decay_steps: int = 100_000
    clip: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8

    def schedule(self):
        return warmup_cosine_decay(0.0, self.lr, self.warmup,
                                   self.decay_steps, self.lr * 0.1)


def default_optimizer_hparams(**overrides) -> OptHParams:
    """The default :class:`OptHParams` (overridable per field)."""
    return OptHParams(**overrides)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """IEEE (correctly rounded) f32 sqrt. CUDA's sqrtf is; PyTorch's
    vectorized CPU sqrt is off by an ulp on ~0.6% of inputs, so on the
    CPU the root is taken in f64 and rounded once to f32, which is exact
    for sqrt — the update then matches optax's bit for bit."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


@dataclass
class AdamWState:
    count: int
    mu: dict
    nu: dict


@torch.no_grad()
def adamw_leaf_(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                n: torch.Tensor, decay, count: int, hp: OptHParams,
                lr: float) -> None:
    """One AdamW update of one tensor, IN PLACE on ``p``, ``m`` and
    ``n`` — the recipe's one elementwise arithmetic, which the
    whole-tree :class:`AdamW`, the per-bucket applies and the ZeRO
    shard-local applies (``parallel/zero.py``) all run.

    ``g`` is the clipped gradient in f32, ``count`` the update count
    before this one, ``lr`` the schedule's value at it. ``decay``: a
    bool for a whole leaf, or an f32 0/1 mask tensor for a flat of many
    leaves (``wd·mask·p``: the same values as the per-leaf rule)."""
    f32 = np.float32
    m.mul_(hp.b1).add_(g * (1 - hp.b1))
    n.mul_(hp.b2).add_((g * g) * (1 - hp.b2))
    t = count + 1
    bc1 = float(f32(1) - f32(hp.b1) ** f32(t))
    bc2 = float(f32(1) - f32(hp.b2) ** f32(t))
    u = (m / bc1) / (_sqrt(n / bc2) + hp.eps)
    if torch.is_tensor(decay):
        u = u + hp.weight_decay * decay * p
    elif decay:
        u = u + hp.weight_decay * p
    p.add_((-lr * u).to(p.dtype))


def clip_scale(sqnorm: torch.Tensor, clip: float) -> torch.Tensor:
    """The global-norm clip as one scale, a device value: 1 below
    ``clip``, else ``clip / ||g||`` (divided by a tensor, as XLA
    divides)."""
    gnorm = torch.sqrt(sqnorm)
    return torch.where(gnorm < clip, torch.ones_like(gnorm),
                       torch.full_like(gnorm, clip) / gnorm)


class AdamW:
    """``optax.chain(clip_by_global_norm(clip), adamw(schedule, b1, b2,
    eps, weight_decay, mask))`` written out elementwise.

    Per leaf, with ``g`` the clipped gradient, ``t`` the update count
    after this one and ``lr = schedule(t - 1)``:
    ``mu = (1-b1)·g + b1·mu``, ``nu = (1-b2)·g² + b2·nu``,
    ``u = (mu/(1-b1^t)) / (sqrt(nu/(1-b2^t)) + eps)``, plus
    ``weight_decay·p`` where the mask says so, then ``p += -lr·u``
    (:func:`adamw_leaf_`). The global norm is taken over the raw
    gradients and returned.

    ``mask``: a function of the params giving the decay tree, or the
    tree itself."""

    def __init__(self, hp: OptHParams | None = None, mask=_decay_mask):
        self.hp = hp or OptHParams()
        self.schedule = self.hp.schedule()
        self.mask = mask

    def init(self, params: dict) -> AdamWState:
        def zeros(p):
            return torch.zeros_like(p, dtype=torch.float32,
                                    requires_grad=False)

        return AdamWState(0, tree_map(zeros, params), tree_map(zeros, params))

    @torch.no_grad()
    def update(self, params: dict, grads: dict, state: AdamWState,
               scale: torch.Tensor | None = None,
               gnorm: torch.Tensor | None = None, zero1=None):
        """Apply one update to ``params`` and ``state`` IN PLACE (the
        counterpart of the reference's donated buffers: no second copy
        of the parameters or moments exists). Returns the global norm of
        the raw ``grads``.

        With ``scale`` (a clip scale coordinated across buckets, as the
        overlap trainer's per-bucket apply passes it) the gradients are
        multiplied by it instead of clipped here, and nothing is
        returned: the reference's ``adamw`` without the clip.

        On a mesh ``params``, ``grads`` and the moments are this rank's
        blocks: ``gnorm`` is then the global norm, summed across ranks,
        that the clip uses. ``zero1`` is ``(i, gather)`` when a leaf's
        moments may be a smaller block of its param along one dim (ZeRO-1
        over the mesh's data axis): such a leaf is updated on block ``i``
        of that dim, and ``gather(block, dim)`` makes the param whole."""
        hp = self.hp
        p_leaves = [p for _, p in _flatten(params)]
        g_leaves = [g for _, g in _flatten(grads)]
        mu = [m for _, m in _flatten(state.mu)]
        nu = [n for _, n in _flatten(state.nu)]
        mask = self.mask(params) if callable(self.mask) else self.mask
        decay = [d for _, d in _flatten(mask)]
        if scale is None:
            if gnorm is None:
                gnorm = torch.sqrt(sum(torch.sum(g.float() * g.float())
                                       for g in g_leaves))
            keep = gnorm < hp.clip
        lr = float(self.schedule(state.count))
        for p, g, m, n, d in zip(p_leaves, g_leaves, mu, nu, decay):
            if scale is None:
                g = g.float()
                g = torch.where(keep, g, (g / gnorm) * hp.clip)
            else:
                g = (g.float() * scale).to(g.dtype).float()
            if m.shape == p.shape:
                adamw_leaf_(p, g, m, n, d, state.count, hp, lr)
                continue
            i, gather = zero1
            dim = next(k for k, (a, b) in enumerate(zip(m.shape, p.shape))
                       if a != b)
            size = m.shape[dim]
            pv = p.narrow(dim, i * size, size)
            adamw_leaf_(pv, g.narrow(dim, i * size, size), m, n, d,
                        state.count, hp, lr)
            p.copy_(gather(pv.contiguous(), dim))
        state.count += 1
        return None if scale is not None else gnorm


@dataclass
class AdamState:
    count: int
    mu: Any
    nu: Any


class Adam:
    """``optax.adam(lr, b1, b2, eps, eps_root)`` written out
    elementwise, in optax's order of operations: ``mu = (1-b1)·g +
    b1·mu``, ``nu = (1-b2)·g² + b2·nu``, ``u = (mu/(1-b1^t)) /
    (sqrt(nu/(1-b2^t) + eps_root) + eps)``, ``p += -lr·u`` — no clip,
    no decay. Any tree of tensors (dicts, lists, a bare tensor); the
    moments take the params' dtype, as optax's do."""

    def __init__(self, lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, eps_root: float = 0.0):
        self.lr, self.b1, self.b2 = lr, b1, b2
        self.eps, self.eps_root = eps, eps_root

    def init(self, params) -> AdamState:
        def zeros(p):
            return torch.zeros_like(p, requires_grad=False)

        return AdamState(0, tree_map(zeros, params), tree_map(zeros, params))

    @torch.no_grad()
    def update(self, params, grads, state: AdamState) -> None:
        """One step on ``params`` and ``state`` IN PLACE."""
        f32 = np.float32
        t = state.count + 1
        bc1 = float(f32(1) - f32(self.b1) ** f32(t))
        bc2 = float(f32(1) - f32(self.b2) ** f32(t))
        for p, g, m, n in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(state.mu), tree_leaves(state.nu)):
            g = g.to(m.dtype)
            m.mul_(self.b1).add_(g * (1 - self.b1))
            n.mul_(self.b2).add_((g * g) * (1 - self.b2))
            v = n / bc2
            if self.eps_root:
                v = v + self.eps_root
            u = (m / bc1) / (_sqrt(v) + self.eps)
            p.add_((-self.lr * u).to(p.dtype))
        state.count = t


@dataclass
class SGDState:
    count: int


class SGD:
    """``optax.sgd(lr)`` (no momentum): ``p += -lr·g``, on any tree."""

    def __init__(self, lr: float):
        self.lr = lr

    def init(self, params) -> SGDState:
        return SGDState(0)

    @torch.no_grad()
    def update(self, params, grads, state: SGDState) -> None:
        """One step on ``params`` IN PLACE."""
        for p, g in zip(tree_leaves(params), tree_leaves(grads)):
            p.add_((g * -self.lr).to(p.dtype))
        state.count += 1


def make_apply_fn(optimizer):
    """``(params, grads, opt_state) -> (params, opt_state)``: one
    optimizer step — the helper the eager trainers share (the param
    server, the stage actors). The step runs on a copy of ``params``, so
    a tree a caller already holds (a pulled snapshot, a stage's params
    mid-sweep) never changes under it, as the reference's immutable
    arrays never do; the optimizer state is updated in place."""

    def apply(params, grads, opt_state):
        new = tree_map(lambda p: p.detach().clone(), params)
        optimizer.update(new, grads, opt_state)
        return new, opt_state

    return apply


def default_optimizer(lr: float = 3e-4, weight_decay: float = 0.1,
                      warmup: int = 100, decay_steps: int = 100_000,
                      clip: float = 1.0) -> AdamW:
    """AdamW + warmup-cosine schedule + global-norm clip, weight decay
    on matmul weights only — the reference's default recipe."""
    return AdamW(OptHParams(lr=lr, weight_decay=weight_decay, warmup=warmup,
                            decay_steps=decay_steps, clip=clip))


def default_optimizer_pieces(lr: float = 3e-4, weight_decay: float = 0.1,
                             warmup: int = 100, decay_steps: int = 100_000,
                             clip: float = 1.0):
    """The default recipe split at its one cross-leaf coupling, the
    global-norm clip: ``(clip, make_inner)``, where ``make_inner(mask)``
    builds the AdamW for any sub-tree (``update`` with the coordinated
    ``scale``). The overlap trainer runs it per gradient bucket as each
    bucket lands (``train/store_dp.py``)."""
    hp = OptHParams(lr=lr, weight_decay=weight_decay, warmup=warmup,
                    decay_steps=decay_steps, clip=clip)
    return hp.clip, lambda mask: AdamW(hp, mask=mask)


# ------------------------------------------------------- checkpoints


def state_tree(state: TrainState, placements: dict | None = None,
               mesh=None) -> dict:
    """``state`` in the reference ``TrainState``'s checkpoint layout: a
    ``Checkpointer`` writes the reference's flat keys — ``0.<param>``,
    ``1.1.0..count``, ``1.1.0..mu.<param>``, ``1.1.0..nu.<param>``,
    ``1.1.2..count`` (the schedule's count) and ``2`` (the step) — so a
    step directory moves between the packages either way. (The
    reference's state is ``(params, optax chain state, step)``: the
    chain's clip state and the mask wrapper hold no arrays.)

    With ``placements`` (the same tree of placement tuples,
    :func:`state_placements`) the leaves are this rank's blocks on
    ``mesh``: a split leaf becomes a ``checkpoint.Shard`` at its offset
    on the one rank that writes that block (its coordinate 0 on every
    axis the leaf is not split on) and is left out elsewhere, and a
    whole leaf stays whole (the writer's rank 0 writes it)."""
    opt = state.opt_state
    count = np.int32(opt.count)
    tree = {"0": state.params,
            "1": {"1": {"0": {".count": count, ".mu": opt.mu, ".nu": opt.nu},
                        "2": {".count": count}}},
            "2": np.int32(state.step)}
    if placements is None:
        return tree
    from ptype_tpu_torch.checkpoint import Shard

    def place(path, leaf):
        spec = _at(placements, path)
        if not torch.is_tensor(leaf) or not any(spec or ()):
            return leaf
        if not owns_block(spec, mesh):
            return None
        spec = tuple(spec) + (None,) * (leaf.dim() - len(spec))
        full = tuple(d * (1 if e is None else axis_n(mesh, e))
                     for d, e in zip(leaf.shape, spec))
        start, _ = block_of(full, spec, mesh)
        return Shard(leaf, tuple(start), full)

    return _unflatten((p, place(p, x)) for p, x in _flatten(tree))


def _at(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def read_state(reader, state: TrainState, placements: dict | None = None,
               mesh=None) -> TrainState:
    """Copy a saved step in the reference's ``TrainState`` layout
    (:func:`state_tree`) into ``state``'s tensors in place, from a
    checkpoint ``StepReader``: this package's saves, or the reference
    ``Checkpointer``'s of its ``TrainState`` (params, the default
    recipe's optax state, step). With ``placements`` each tensor is
    this rank's block on ``mesh`` and only that block is read. Returns
    ``state``."""
    with torch.no_grad():
        for path, leaf in _flatten(state_tree(state)):
            if not torch.is_tensor(leaf):
                continue
            key = ".".join(path)
            spec = _at(placements, path) if placements is not None else ()
            if any(spec or ()):
                shape = reader.entry(key)["shape"]
                start, size = block_of(shape, spec, mesh)
                leaf.copy_(reader.read_block(key, start, size))
            else:
                leaf.copy_(reader.read(key))
    state.opt_state.count = int(reader.read("1.1.0..count"))
    state.step = int(reader.read("2"))
    return state


def load_reference_state(directory: str, cfg: tfm.TransformerConfig,
                         step: int | None = None, device=None) -> TrainState:
    """The ``TrainState`` a reference ``Checkpointer`` saved under
    ``directory`` (latest complete step by default) as the port's, on
    ``device``: params in ``cfg.param_dtype``, AdamW moments in f32.
    Entry point: ``cuda`` unless ``device`` names another."""
    from ptype_tpu_torch.checkpoint import Checkpointer

    device = resolve_device(device)
    params = _unflatten((path, torch.zeros(shape, dtype=cfg.param_dtype,
                                           device=device))
                        for path, shape in _flatten(param_shapes(cfg)))
    state = TrainState(params, AdamW().init(params), 0)
    return read_state(Checkpointer(directory).reader(step), state)


def _batch_on(batch: dict, device) -> dict:
    out = {k: torch.as_tensor(v).to(device) for k, v in batch.items()
           if k in BATCH_KEYS}
    if "tokens" not in out or "targets" not in out:
        raise ValueError("batch must contain 'tokens' and 'targets'")
    return out


def grads_of(params: dict, batch: dict, cfg: tfm.TransformerConfig,
             attn_fn=None, grad_accum: int = 1, layout=None):
    """(loss, grads) of :func:`tfm.loss_fn` at ``params``, whose leaves
    require grad. ``grad_accum > 1`` splits the batch into that many
    microbatches and sums their grads; the normalizer is the whole
    batch's token count (or mask sum), computed up front, so loss and
    grads match ``grad_accum=1`` even when microbatches hold different
    numbers of valid tokens. An MoE config's microbatch also adds
    ``moe_aux_coef · aux / grad_accum``, as the reference's does.

    With ``layout`` (a :class:`~tfm.MeshLayout`) ``params`` and
    ``batch`` are this rank's blocks: the normalizer is the GLOBAL one
    (the mask sums over the batch axes), so the loss and grads returned
    are this rank's terms of the global ones, before any sum across
    ranks. An MoE config's microbatches are the reference's: microbatch
    i is rows ``[i·B/g, (i+1)·B/g)`` of the GLOBAL batch
    (:func:`_microbatch_rows`), since its capacity and aux depend on
    which tokens share one."""
    paths, leaves = zip(*_flatten(params))
    mesh = layout.mesh if layout is not None else None
    if grad_accum == 1 and mesh is None:
        loss = tfm.loss_fn(params, batch, cfg, attn_fn)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), _unflatten(zip(paths, grads))
    B = batch["tokens"].shape[0]
    if B % grad_accum:
        raise ValueError(f"batch {B} does not split into {grad_accum} "
                         "microbatches")
    mask = batch.get("loss_mask")
    if mesh is None:
        denom = (torch.clamp(mask.float().sum(), min=1.0)
                 if mask is not None else float(batch["targets"].numel()))
    else:
        denom = _global_denom(batch, layout)
    if mesh is not None and cfg.n_experts:
        batch = _microbatch_rows(batch, layout, grad_accum)
    loss, grads = 0.0, None
    for i in range(grad_accum):
        mb = {k: v.chunk(grad_accum)[i] for k, v in batch.items()}
        nll_sum, _, aux = tfm.loss_terms(params, mb, cfg, attn_fn, mesh)
        part = nll_sum / denom
        if cfg.n_experts:
            part = part + cfg.moe_aux_coef * aux / grad_accum
        g = torch.autograd.grad(part, leaves)
        grads = g if grads is None else [a + b for a, b in zip(grads, g)]
        loss = loss + part.detach()
    return loss, _unflatten(zip(paths, grads))


# ------------------------------------------------------------ the mesh


def _sum_over(x: torch.Tensor, layout) -> torch.Tensor:
    """``x`` summed over the batch axes of ``layout`` (every rank of the
    mesh calls)."""
    if not layout.batch_axes:
        return x
    return C.all_reduce(x, layout.mesh, layout.batch_axes)


def _microbatch_rows(batch: dict, layout, grad_accum: int) -> dict:
    """This rank's rows regrouped so that chunk i of them is its block
    of global microbatch i, the global rows ``[i·B/g, (i+1)·B/g)``: the
    rows are allgathered over the row axes (``data``, ``fsdp``) and each
    microbatch cut into the ranks' blocks in their order."""
    axes = layout.row_axes
    if grad_accum == 1 or not axes:
        return batch
    n, j = axis_n(layout.mesh, axes), axis_index(layout.mesh, axes)
    out = {}
    for key, v in batch.items():
        full = C.all_gather_dim(v, layout.mesh, axes, 0)
        if full.shape[0] % (grad_accum * n):
            raise ValueError(f"global batch {full.shape[0]} does not split "
                             f"into {grad_accum} microbatches of {n} "
                             "rank blocks")
        per = full.shape[0] // (grad_accum * n)
        out[key] = torch.cat([full[(i * n + j) * per:(i * n + j + 1) * per]
                              for i in range(grad_accum)])
    return out


def _global_denom(batch: dict, layout) -> torch.Tensor:
    """The loss normalizer of a global batch from this rank's block:
    the mask (or token) count summed over the batch axes, clamped once
    to at least 1, as the reference's over the whole batch."""
    mask = batch.get("loss_mask")
    local = (mask.float().sum() if mask is not None else torch.full(
        (), float(batch["targets"].numel()), device=batch["targets"].device))
    return torch.clamp(_sum_over(local, layout), min=1.0)


def _spec_axes(spec) -> set:
    out = set()
    for entry in spec or ():
        if entry is not None:
            out.update(entry if isinstance(entry, tuple) else (entry,))
    return out


def _shard_update_spec(spec: tuple, shape: tuple, axis: str,
                       size: int) -> tuple:
    """``axis`` added on the first unsplit, divisible dim of a moment's
    placement (cross-replica weight-update sharding, ZeRO-1); the
    placement unchanged when no dim qualifies."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    for i, (e, d) in enumerate(zip(entries, shape)):
        if e is None and d >= size and d % size == 0:
            entries[i] = axis
            return tuple(entries)
    return tuple(spec)


def opt_state_placements(layout, shard_update: bool = False) -> dict:
    """The AdamW moments' placements: the params', and with
    ``shard_update`` also split over ``data`` (a warning, and the
    params' placements, when the mesh has no data axis of size > 1)."""
    specs = layout.specs
    size = layout.sizes.get(DATA_AXIS, 1)
    if not shard_update:
        return specs
    if size <= 1:
        logs.get_logger("train").warning(
            "shard_update requested but the mesh has no data axis of "
            "size > 1 — optimizer moments stay unsharded",
            kv={"axes": layout.sizes})
        return specs
    shapes = dict(_flatten(param_shapes(layout.cfg)))
    return _unflatten((path, _shard_update_spec(spec, shapes[path],
                                                DATA_AXIS, size))
                      for path, spec in _flatten(specs))


def _sum_grads(grads: dict, layout) -> dict:
    """Each gradient summed over the batch axes it is not split on (one
    bucketed allreduce per set of axes)."""
    groups: dict = {}
    for path, g in _flatten(grads):
        axes = tuple(a for a in layout.batch_axes
                     if a not in _spec_axes(_at(layout.specs, path)))
        groups.setdefault(axes, []).append((path, g))
    out = {}
    for axes, pairs in groups.items():
        leaves = [g for _, g in pairs]
        if axes:
            leaves = C.bucketed_all_reduce(leaves, layout.mesh, axes)
        out.update(zip([p for p, _ in pairs], leaves))
    return _unflatten((p, out[p]) for p, _ in _flatten(grads))


def _global_norm(grads: dict, layout) -> torch.Tensor:
    """The clip's global norm: each leaf's squares summed over the axes
    it is split on, and only those (a whole leaf counts once)."""
    live = [a for a in layout.mesh.axis_names if layout.sizes[a] > 1]
    sums: dict = {}
    for path, g in _flatten(grads):
        split = _spec_axes(_at(layout.specs, path))
        key = tuple(a for a in live if a in split)
        sq = torch.sum(g.float() * g.float())
        sums[key] = sq if key not in sums else sums[key] + sq
    total = None
    for key, sq in sums.items():
        if key:
            sq = C.all_reduce(sq, layout.mesh, key)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def state_placements(layout, shard_update: bool = False) -> dict:
    """The placement tree of a mesh ``TrainState`` in the checkpoint
    layout (:func:`state_tree`): the params', the moments'
    (:func:`opt_state_placements`), None for the counts."""
    mom = opt_state_placements(layout, shard_update)
    return {"0": layout.specs,
            "1": {"1": {"0": {".count": None, ".mu": mom, ".nu": mom},
                        "2": {".count": None}}},
            "2": None}


def shard_params(params: dict, layout) -> dict:
    """This rank's block of every leaf under ``layout.specs``; a leaf
    already of its block's shape is kept as it is."""
    shapes = dict(_flatten(param_shapes(layout.cfg)))

    def block(path, p):
        if tuple(p.shape) != tuple(shapes[path]):
            return p
        return shard_of(p, _at(layout.specs, path), layout.mesh)

    return _unflatten((path, block(path, p)) for path, p in _flatten(params))


def init_state(cfg: tfm.TransformerConfig, mesh, params: dict,
               optimizer=None, shard_update: bool = False
               ) -> tuple[TrainState, dict]:
    """This rank's :class:`TrainState` on ``mesh`` from ``params``: the
    full tree (every rank passes the same) or this rank's blocks of it
    (:func:`shard_params`). The state holds the blocks (the tensor
    itself where the block is all of it) and zero moments in their
    placements. Returns ``(state, state_placements)``."""
    optimizer = optimizer or default_optimizer()
    layout = tfm.MeshLayout(cfg, mesh)
    local = shard_params(params, layout)
    moments = opt_state_placements(layout, shard_update)
    shapes = dict(_flatten(param_shapes(cfg)))

    def zeros(path, p):
        _, size = block_of(tuple(shapes[path]), _at(moments, path), mesh)
        return torch.zeros(size, dtype=torch.float32, device=p.device)

    mu = _unflatten((path, zeros(path, p)) for path, p in _flatten(local))
    nu = _unflatten((path, zeros(path, p)) for path, p in _flatten(local))
    return (TrainState(local, AdamWState(0, mu, nu), 0),
            state_placements(layout, shard_update))


def make_train_step(cfg: tfm.TransformerConfig, optimizer=None,
                    attn_fn: Callable | None = None, grad_accum: int = 1,
                    device=None, mesh=None):
    """The train step: ``(state, batch) → (state, metrics)``, metrics
    holding the loss, the pre-clip ``grad_norm`` (device scalars) and
    the step count. The state is updated in place.

    With ``mesh`` the state is this rank's blocks (:func:`init_state`
    with the same ``shard_update``) and ``batch`` this rank's block of the
    global batch (``Trainer.shard_batch``); the loss and grad norm
    returned are the global ones, on every rank. The mesh step applies
    the port's :class:`AdamW` (``optimizer`` must be one)."""
    optimizer = optimizer or default_optimizer()
    layout = None
    if mesh is not None:
        if not isinstance(optimizer, AdamW):
            raise TypeError("the mesh train step applies the port's AdamW; "
                            f"got {type(optimizer).__name__}")
        layout = tfm.MeshLayout(cfg, mesh)
        zero1 = (axis_index(mesh, DATA_AXIS) if DATA_AXIS in layout.sizes
                 else 0,
                 lambda t, dim: C.all_gather_dim(t, mesh, DATA_AXIS, dim))
    device = mesh.device if mesh is not None else resolve_device(device)
    attn_fn = attn_fn or tfm.resolve_attn_fn(cfg, device, mesh)

    def step(state: TrainState, batch: dict):
        for _, p in _flatten(state.params):
            p.requires_grad_(True)
        loss, grads = grads_of(state.params, _batch_on(batch, device), cfg,
                               attn_fn, grad_accum, layout)
        kw = {}
        if layout is not None:
            loss = _sum_over(loss, layout)
            grads = _sum_grads(grads, layout)
            kw = {"gnorm": _global_norm(grads, layout), "zero1": zero1}
        gnorm = optimizer.update(state.params, grads, state.opt_state, **kw)
        state.step += 1
        return state, {"loss": loss, "grad_norm": gnorm, "step": state.step}

    return step


def make_eval_step(cfg: tfm.TransformerConfig,
                   attn_fn: Callable | None = None, device=None, mesh=None):
    """The evaluation step: ``(params, batch) → (nll_sum, denom)`` as
    device scalars — the train step's loss with no gradient and no state
    change, unnormalized so callers token-weight across batches. With
    ``mesh``, on this rank's blocks, the sums global."""
    layout = tfm.MeshLayout(cfg, mesh) if mesh is not None else None
    device = mesh.device if mesh is not None else resolve_device(device)
    attn_fn = attn_fn or tfm.resolve_attn_fn(cfg, device, mesh)

    @torch.no_grad()
    def step(params: dict, batch: dict):
        batch = _batch_on(batch, device)
        nll_sum, denom, _ = tfm.loss_terms(params, batch, cfg, attn_fn, mesh)
        if layout is not None:
            return _sum_over(nll_sum, layout), _global_denom(batch, layout)
        return nll_sum, denom

    return step


def evaluate(params: dict, cfg: tfm.TransformerConfig, batches, steps: int,
             attn_fn: Callable | None = None, device=None,
             mesh=None) -> dict:
    """Mean loss and perplexity over ``steps`` batches, token-weighted
    (NLL and token counts summed, divided once), so ragged masks cannot
    skew the mean. The sums stay on the device until the end. With
    ``mesh``, ``params`` and each batch are this rank's blocks."""
    step = make_eval_step(cfg, attn_fn, device, mesh)
    nll, tok = 0.0, 0.0
    for _ in range(steps):
        n, d = step(params, next(batches))
        nll, tok = nll + n, tok + d
    nll_total, tok_total = float(nll), float(tok)
    loss = nll_total / max(tok_total, 1.0)
    return {"loss": loss, "perplexity": math.exp(min(loss, 700.0)),
            "tokens": int(tok_total)}


class Trainer:
    """Init + train step + throughput stats, on one device or a mesh.

    ``params`` (a parameter dict, e.g. from ``params_from_numpy``) are
    copied onto ``device``; without them :func:`init_params` draws from
    ``generator`` (a CPU generator seeded 0 when None, as the serving
    actors do). Entry point: runs on ``cuda`` unless ``device`` names
    another, and raises with no CUDA device and none named.

    With ``mesh`` (a ``parallel.mesh.Mesh``; every rank constructs one
    together, with the same ``params`` or ``generator`` seed) the
    trainer runs on the mesh's device and keeps this rank's blocks of
    the state (:func:`init_state`); :meth:`step` takes the GLOBAL
    batch, every rank the same, and trains on its own block of it.
    ``shard_update`` splits the moments over ``data`` (ZeRO-1);
    ``seq_axis`` splits the batch's sequence dim over ``seq`` (set for
    ``attn_impl`` "ring" and "ulysses")."""

    def __init__(self, cfg: tfm.TransformerConfig, device=None,
                 optimizer=None, generator: torch.Generator | None = None,
                 params: dict | None = None, attn_fn=None,
                 sync_every: int = 16, mesh=None,
                 shard_update: bool = False, seq_axis: bool = False):
        self.cfg = cfg
        self.mesh = mesh
        self.device = mesh.device if mesh is not None \
            else resolve_device(device)
        self.optimizer = optimizer or default_optimizer()
        self.layout = tfm.MeshLayout(cfg, mesh) if mesh is not None else None

        def block(path, t):
            # This rank's block of a leaf (the leaf with no mesh), taken
            # leaf by leaf, so no rank holds the whole model at once.
            if mesh is None:
                return t
            return shard_of(t, _at(self.layout.specs, path), mesh)

        if params is None:
            generator = (generator if generator is not None
                         else torch.Generator().manual_seed(0))
            params = init_params(generator, cfg, device=self.device,
                                 place=block)
        else:
            def own(path, t):  # a private copy, whatever the caller passed
                t = (t.detach() if torch.is_tensor(t)
                     else torch.from_numpy(np.array(t)))
                return block(path, t).to(device=self.device,
                                         dtype=cfg.param_dtype).clone()

            params = _unflatten((path, own(path, t))
                                for path, t in _flatten(params))
        self.n_params = sum(math.prod(shape) for _, shape in
                            _flatten(param_shapes(cfg)))
        if mesh is None:
            self.state = TrainState(params, self.optimizer.init(params), 0)
        else:
            self.state, self._placements = init_state(
                cfg, mesh, params, self.optimizer, shard_update)
            del params
        for _, p in _flatten(self.state.params):
            p.requires_grad_(True)
        self._shard_update = shard_update
        self._seq_axis = seq_axis or (attn_fn is None and cfg.attn_impl in
                                      ("ring", "ulysses"))
        self._attn_fn = attn_fn or tfm.resolve_attn_fn(cfg, self.device,
                                                       mesh)
        self._step_fn = make_train_step(cfg, self.optimizer, self._attn_fn,
                                        device=self.device, mesh=mesh)
        self._stats: metrics.StepStats | None = None
        self._peak = metrics.device_peak_tflops(self.device)
        #: Drain the device queue every N steps (0 = never): the stats
        #: stay honest without a per-step sync, and host input prep
        #: overlaps device compute in between.
        self.sync_every = sync_every
        self._pending_tokens = 0
        self._pending_steps = 0

    def shard_batch(self, batch: dict) -> dict:
        """This rank's block of a global batch (the batch itself with no
        mesh), on the trainer's device."""
        batch = _batch_on(batch, self.device)
        if self.mesh is None:
            return batch
        spec = tfm.batch_spec(self.layout.sizes, self._seq_axis)
        return {k: shard_of(v, spec, self.mesh) for k, v in batch.items()}

    def _drain(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def step(self, batch: dict) -> dict:
        """Dispatch one step without waiting for it: loss and grad_norm
        come back as device scalars (reading them waits). Throughput
        stats advance only at drain boundaries (every ``sync_every``
        steps, or :meth:`sync`), so they never credit queued work."""
        batch = _batch_on(batch, self.device)
        tokens = batch["tokens"]
        if self._stats is None:
            self._stats = metrics.StepStats(
                flops_per_token=tfm.flops_per_token(self.cfg,
                                                    tokens.shape[1]),
                n_chips=self.mesh.size if self.mesh is not None else 1,
                peak_tflops=self._peak)
            self._stats.start()
        n_tokens = tokens.numel()
        batch = self.shard_batch(batch)
        # train.step is the health-plane seam too (goodput ledger,
        # trace span). This trainer dispatches without waiting, so on
        # CUDA the region times the host's dispatch (which waits once
        # the launch queue is full), not the step; the StoreDPTrainer,
        # which reads the loss every step, is the per-step-accurate
        # goodput source.
        with metrics.annotate("train.step"), \
                metrics.step_annotation(self.state.step), device_work():
            self.state, out = self._step_fn(self.state, batch)
        metrics.metrics.counter("train.steps").add(1)
        self._pending_tokens += n_tokens
        self._pending_steps += 1
        if self.sync_every and self.state.step % self.sync_every == 0:
            self._drain()
            # The loss is materialized at the drain anyway: stamp the
            # health gauge without adding a sync.
            metrics.metrics.gauge("train.loss").set(float(out["loss"]))
            self._fold_pending()
        return {"loss": out["loss"], "grad_norm": out["grad_norm"],
                "step": self.state.step, **self.throughput()}

    def _fold_pending(self) -> None:
        if self._stats is not None and self._pending_steps:
            self._stats.step(self._pending_tokens, self._pending_steps)
            self._pending_tokens = 0
            self._pending_steps = 0

    def sync(self) -> None:
        """Drain the device queue (call before reading final stats)."""
        self._drain()
        self._fold_pending()

    def save(self, ckpt, background: bool = False) -> int:
        """Checkpoint the state at its current step with ``ckpt`` (a
        :class:`~ptype_tpu_torch.checkpoint.Checkpointer`) in the
        reference's layout; ``background`` snapshots now and writes on
        the checkpointer's thread (``ckpt.wait()`` joins it). Returns
        the step."""
        step = int(self.state.step)
        tree = state_tree(self.state)
        if self.mesh is not None:
            if self.mesh.size > 1 and getattr(ckpt, "mesh", None) is None:
                raise ValueError(
                    "Trainer.save on a mesh of more than one rank needs a "
                    "Checkpointer built with the mesh (one writer a rank)")
            tree = state_tree(self.state, self._placements, self.mesh)
        if background:
            ckpt.async_save(step, tree)
        else:
            ckpt.save(step, tree)
        return step

    def restore(self, ckpt, step: int | None = None) -> int:
        """Load a saved step (latest by default) into this trainer's
        state in place: this package's :meth:`save`, or a reference
        ``TrainState`` saved by the reference's ``Checkpointer``. On a
        mesh each rank reads only its own blocks. Returns the step."""
        self.sync()
        if self.mesh is None:
            read_state(ckpt.reader(step), self.state)
        else:
            read_state(ckpt.reader(step), self.state, self._placements,
                       self.mesh)
        return int(self.state.step)

    def evaluate(self, batches, steps: int) -> dict:
        """Held-out mean loss and perplexity at the current parameters,
        with this trainer's attention and layout; no state changes. On a
        mesh each batch is global, every rank passing the same."""
        self.sync()
        if self.mesh is not None:
            batches = map(self.shard_batch, batches)
        return evaluate(self.state.params, self.cfg, batches, steps,
                        attn_fn=self._attn_fn, device=self.device,
                        mesh=self.mesh)

    def throughput(self) -> dict:
        """Drained rates: tokens/s and MFU (None on a device without a
        known peak). Call after :meth:`sync` for completed work."""
        if self._stats is None:
            return {"tokens_per_sec": 0.0, "tokens_per_sec_per_chip": 0.0,
                    "mfu": None}
        return {"tokens_per_sec": self._stats.tokens_per_sec,
                "tokens_per_sec_per_chip":
                    self._stats.tokens_per_sec_per_chip,
                "mfu": self._stats.mfu}
