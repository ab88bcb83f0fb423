"""The train step and ``Trainer`` — the port of
``ptype_tpu/train/trainer.py`` for one device, with no mesh.

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

Mixture-of-experts configs train on one device, their experts
unsharded. Data-parallel training through the Store, with the ZeRO
ladder, is ``train/store_dp.py``; it applies the same AdamW arithmetic
(:func:`adamw_leaf_`). Out of scope here (ROADMAP): ``param_specs`` and
shardings, expert parallelism, the GSPMD ``shard_update``,
``param_server``, ``actor_pipeline`` and remat.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from ptype_tpu_torch import metrics
from ptype_tpu_torch.device import resolve_device
from ptype_tpu_torch.models import transformer as tfm
from ptype_tpu_torch.models.weights import init_params, param_shapes

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


def tree_map(fn: Callable, tree: dict) -> dict:
    return _unflatten((p, fn(x)) for p, x in _flatten(tree))


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
               scale: torch.Tensor | None = None):
        """Apply one update to ``params`` and ``state`` IN PLACE (the
        counterpart of the reference's donated buffers: no second copy
        of the parameters or moments exists). Returns the global norm of
        the raw ``grads``.

        With ``scale`` (a clip scale coordinated across buckets, as the
        overlap trainer's per-bucket apply passes it) the gradients are
        multiplied by it instead of clipped here, and nothing is
        returned: the reference's ``adamw`` without the clip."""
        hp = self.hp
        p_leaves = [p for _, p in _flatten(params)]
        g_leaves = [g for _, g in _flatten(grads)]
        mu = [m for _, m in _flatten(state.mu)]
        nu = [n for _, n in _flatten(state.nu)]
        mask = self.mask(params) if callable(self.mask) else self.mask
        decay = [d for _, d in _flatten(mask)]
        gnorm = None
        if scale is None:
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
            adamw_leaf_(p, g, m, n, d, state.count, hp, lr)
        state.count += 1
        return gnorm


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


def state_tree(state: TrainState) -> dict:
    """``state`` in the reference ``TrainState``'s checkpoint layout: a
    ``Checkpointer`` writes the reference's flat keys — ``0.<param>``,
    ``1.1.0..count``, ``1.1.0..mu.<param>``, ``1.1.0..nu.<param>``,
    ``1.1.2..count`` (the schedule's count) and ``2`` (the step) — so a
    step directory moves between the packages either way. (The
    reference's state is ``(params, optax chain state, step)``: the
    chain's clip state and the mask wrapper hold no arrays.)"""
    opt = state.opt_state
    count = np.int32(opt.count)
    return {"0": state.params,
            "1": {"1": {"0": {".count": count, ".mu": opt.mu, ".nu": opt.nu},
                        "2": {".count": count}}},
            "2": np.int32(state.step)}


def read_state(reader, state: TrainState) -> TrainState:
    """Copy a saved step in the reference's ``TrainState`` layout
    (:func:`state_tree`) into ``state``'s tensors in place, from a
    checkpoint ``StepReader``: this package's saves, or the reference
    ``Checkpointer``'s of its ``TrainState`` (params, the default
    recipe's optax state, step). Returns ``state``."""
    with torch.no_grad():
        for path, leaf in _flatten(state_tree(state)):
            if torch.is_tensor(leaf):
                leaf.copy_(reader.read(".".join(path)))
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
             attn_fn=None, grad_accum: int = 1):
    """(loss, grads) of :func:`tfm.loss_fn` at ``params``, whose leaves
    require grad. ``grad_accum > 1`` splits the batch into that many
    microbatches and sums their grads; the normalizer is the whole
    batch's token count (or mask sum), computed up front, so loss and
    grads match ``grad_accum=1`` even when microbatches hold different
    numbers of valid tokens. An MoE config's microbatch also adds
    ``moe_aux_coef · aux / grad_accum``, as the reference's does."""
    paths, leaves = zip(*_flatten(params))
    if grad_accum == 1:
        loss = tfm.loss_fn(params, batch, cfg, attn_fn)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), _unflatten(zip(paths, grads))
    B = batch["tokens"].shape[0]
    if B % grad_accum:
        raise ValueError(f"batch {B} does not split into {grad_accum} "
                         "microbatches")
    mask = batch.get("loss_mask")
    denom = (torch.clamp(mask.float().sum(), min=1.0) if mask is not None
             else float(batch["targets"].numel()))
    loss, grads = 0.0, None
    for i in range(grad_accum):
        mb = {k: v.chunk(grad_accum)[i] for k, v in batch.items()}
        nll_sum, _, aux = tfm.loss_terms(params, mb, cfg, attn_fn)
        part = nll_sum / denom
        if cfg.n_experts:
            part = part + cfg.moe_aux_coef * aux / grad_accum
        g = torch.autograd.grad(part, leaves)
        grads = g if grads is None else [a + b for a, b in zip(grads, g)]
        loss = loss + part.detach()
    return loss, _unflatten(zip(paths, grads))


def make_train_step(cfg: tfm.TransformerConfig, optimizer=None,
                    attn_fn: Callable | None = None, grad_accum: int = 1,
                    device=None):
    """The train step: ``(state, batch) → (state, metrics)``, metrics
    holding the loss, the pre-clip ``grad_norm`` (device scalars) and
    the step count. The state is updated in place."""
    optimizer = optimizer or default_optimizer()
    device = resolve_device(device)
    attn_fn = attn_fn or tfm.resolve_attn_fn(cfg, device)

    def step(state: TrainState, batch: dict):
        for _, p in _flatten(state.params):
            p.requires_grad_(True)
        loss, grads = grads_of(state.params, _batch_on(batch, device), cfg,
                               attn_fn, grad_accum)
        gnorm = optimizer.update(state.params, grads, state.opt_state)
        state.step += 1
        return state, {"loss": loss, "grad_norm": gnorm, "step": state.step}

    return step


def make_eval_step(cfg: tfm.TransformerConfig,
                   attn_fn: Callable | None = None, device=None):
    """The evaluation step: ``(params, batch) → (nll_sum, denom)`` as
    device scalars — the train step's loss with no gradient and no state
    change, unnormalized so callers token-weight across batches."""
    device = resolve_device(device)
    attn_fn = attn_fn or tfm.resolve_attn_fn(cfg, device)

    @torch.no_grad()
    def step(params: dict, batch: dict):
        nll_sum, denom, _ = tfm.loss_terms(params, _batch_on(batch, device),
                                           cfg, attn_fn)
        return nll_sum, denom

    return step


def evaluate(params: dict, cfg: tfm.TransformerConfig, batches, steps: int,
             attn_fn: Callable | None = None, device=None) -> dict:
    """Mean loss and perplexity over ``steps`` batches, token-weighted
    (NLL and token counts summed, divided once), so ragged masks cannot
    skew the mean. The sums stay on the device until the end."""
    step = make_eval_step(cfg, attn_fn, device)
    nll, tok = 0.0, 0.0
    for _ in range(steps):
        n, d = step(params, next(batches))
        nll, tok = nll + n, tok + d
    nll_total, tok_total = float(nll), float(tok)
    loss = nll_total / max(tok_total, 1.0)
    return {"loss": loss, "perplexity": math.exp(min(loss, 700.0)),
            "tokens": int(tok_total)}


class Trainer:
    """Init + train step + throughput stats on one device.

    ``params`` (a parameter dict, e.g. from ``params_from_numpy``) are
    copied onto ``device``; without them :func:`init_params` draws from
    ``generator`` (a CPU generator seeded 0 when None, as the serving
    actors do). Entry point: runs on ``cuda`` unless ``device`` names
    another, and raises with no CUDA device and none named."""

    def __init__(self, cfg: tfm.TransformerConfig, device=None,
                 optimizer=None, generator: torch.Generator | None = None,
                 params: dict | None = None, attn_fn=None,
                 sync_every: int = 16):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.optimizer = optimizer or default_optimizer()
        if params is None:
            generator = (generator if generator is not None
                         else torch.Generator().manual_seed(0))
            params = init_params(generator, cfg, device=self.device)
        else:
            def own(t):  # a private copy, whatever the caller passed
                t = (t.detach() if torch.is_tensor(t)
                     else torch.from_numpy(np.array(t)))
                return t.to(device=self.device,
                            dtype=cfg.param_dtype).clone()

            params = tree_map(own, params)
        for _, p in _flatten(params):
            p.requires_grad_(True)
        self.state = TrainState(params, self.optimizer.init(params), 0)
        self._attn_fn = attn_fn or tfm.resolve_attn_fn(cfg, self.device)
        self._step_fn = make_train_step(cfg, self.optimizer, self._attn_fn,
                                        device=self.device)
        self.n_params = tfm.count_params(params)
        self._stats: metrics.StepStats | None = None
        self._peak = metrics.device_peak_tflops(self.device)
        #: Drain the device queue every N steps (0 = never): the stats
        #: stay honest without a per-step sync, and host input prep
        #: overlaps device compute in between.
        self.sync_every = sync_every
        self._pending_tokens = 0
        self._pending_steps = 0

    def _drain(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def step(self, batch: dict) -> dict:
        """Dispatch one step without waiting for it: loss and grad_norm
        come back as device scalars (reading them waits). Throughput
        stats advance only at drain boundaries (every ``sync_every``
        steps, or :meth:`sync`), so they never credit queued work."""
        batch = _batch_on(batch, self.device)
        if self._stats is None:
            self._stats = metrics.StepStats(
                flops_per_token=tfm.flops_per_token(
                    self.cfg, batch["tokens"].shape[1]),
                n_chips=1, peak_tflops=self._peak)
            self._stats.start()
        # train.step is the health-plane seam too (goodput ledger,
        # trace span). This trainer dispatches without waiting, so on
        # CUDA the region times the host's dispatch (which waits once
        # the launch queue is full), not the step; the StoreDPTrainer,
        # which reads the loss every step, is the per-step-accurate
        # goodput source.
        with metrics.annotate("train.step"), \
                metrics.step_annotation(self.state.step):
            self.state, out = self._step_fn(self.state, batch)
        metrics.metrics.counter("train.steps").add(1)
        self._pending_tokens += batch["tokens"].numel()
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
        if background:
            ckpt.async_save(step, state_tree(self.state))
        else:
            ckpt.save(step, state_tree(self.state))
        return step

    def restore(self, ckpt, step: int | None = None) -> int:
        """Load a saved step (latest by default) into this trainer's
        state in place: this package's :meth:`save`, or a reference
        ``TrainState`` saved by the reference's ``Checkpointer``.
        Returns the step."""
        self.sync()
        read_state(ckpt.reader(step), self.state)
        return int(self.state.step)

    def evaluate(self, batches, steps: int) -> dict:
        """Held-out mean loss and perplexity at the current parameters,
        with this trainer's attention; no state changes."""
        self.sync()
        return evaluate(self.state.params, self.cfg, batches, steps,
                        attn_fn=self._attn_fn, device=self.device)

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
