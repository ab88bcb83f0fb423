"""Actor-per-layer pipeline — registry PID→stage: the port of
``ptype_tpu/train/actor_pipeline.py`` (BASELINE "ResNet-50
actor-per-layer pipeline (registry PID→stage)").

Unlike ``parallel/pipeline.py`` (one schedule over the ``stage`` process
group — the throughput path), each stage here is an ACTOR owning its
layer chunk, discovered through the registry and called over the
balanced RPC client. Activations and gradients travel stage to stage as
tensor-codec payloads over TCP, or as the device tensors themselves
between actors of one process (the local dispatch path). Stages can live
in different processes and hosts, die, and be registered again.

Training (GPipe semantics): within one :meth:`PipelineClient.train_step`
sweep the stage parameters are FROZEN. ``Forward(mb, x)`` stashes the
stage input per microbatch; ``Backward(mb, g)`` recomputes the stage
from that input under autograd against the frozen parameters, ADDS the
parameter gradient to the sweep's sum and returns the input gradient;
``Apply()``, called once per sweep after every microbatch's backward,
takes one optimizer step on the mean. Each stage owns its optimizer
state. Microbatches traverse the stages concurrently (one chain per
microbatch), so stage i works on microbatch m while stage i+1 works on
m-1.

Service naming: ``<pipeline>-stage<i>`` (:func:`stage_service`): the
registry's service map IS the pipeline topology, and the client refuses
a pipeline whose stage indices have a hole.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Sequence

import torch

from ptype_tpu_torch import logs
from ptype_tpu_torch.device import device_work
from ptype_tpu_torch.errors import ClusterError
from ptype_tpu_torch.train.trainer import (Adam, make_apply_fn, tree_leaves,
                                           tree_map)

log = logs.get_logger("actor_pipeline")

SERVICE_SEP = "-stage"


def stage_service(pipeline: str, idx: int) -> str:
    return f"{pipeline}{SERVICE_SEP}{idx}"


def discover_stages(registry, pipeline: str) -> list[str]:
    """Stage service names of a pipeline, in stage order, from the live
    registry (the PID→stage map). Raises if the indices are not
    contiguous from 0: a hole is a dead or unregistered stage, and
    piping around it would compute garbage."""
    prefix = pipeline + SERVICE_SEP
    found = []
    for svc in registry.services():
        if svc.startswith(prefix):
            try:
                found.append((int(svc[len(prefix):]), svc))
            except ValueError:
                continue
    found.sort()
    indices = [i for i, _ in found]
    if indices and indices != list(range(len(indices))):
        raise ClusterError(
            f"pipeline {pipeline!r} has non-contiguous stages {indices} "
            "— a stage is missing/unregistered")
    return [svc for _, svc in found]


def _like(tree, leaves: list):
    """``leaves`` in the structure of ``tree`` (:func:`tree_map`'s
    order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


class StageActor:
    """One pipeline stage: parameters (any tree of tensors) and a plain
    function ``fn(params, x) -> y``.

    Drops into an ActorServer (``server.register(stage, "Stage")``).
    Thread-safe; the per-microbatch stash lets several microbatches be in
    flight. The parameters change only in ``Apply`` (each step makes a
    new tree), so the Forward/Backward calls of one sweep all see one
    version. The optimizer defaults to ``Adam(1e-3)``, the reference's
    ``optax.adam(1e-3)``."""

    def __init__(self, fn: Callable, params, optimizer=None):
        self.fn = fn
        self.params = params
        self.optimizer = optimizer or Adam(1e-3)
        self.opt_state = self.optimizer.init(params)
        self._stash: dict[int, torch.Tensor] = {}
        self._accum = None
        self._accum_count = 0
        self._lock = threading.Lock()
        self._apply = make_apply_fn(self.optimizer)

    def Forward(self, mb: int, x):
        """Run the stage on microbatch ``mb``, stashing ``x`` for its
        backward."""
        with device_work():
            with self._lock:
                self._stash[mb] = x
                params = self.params
            with torch.no_grad():
                return self.fn(params, x)

    def _vjp(self, params, x, g):
        """(parameter grads, input grad | None): the stage recomputed
        from its input under autograd, pulled back along ``g``."""
        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        x = x.detach()
        if x.is_floating_point():
            x.requires_grad_(True)
        with torch.enable_grad():
            y = self.fn(p, x)
        inputs = tree_leaves(p) + ([x] if x.requires_grad else [])
        grads = torch.autograd.grad(y, inputs, g.to(y.dtype),
                                    allow_unused=True)
        grads = [torch.zeros_like(t) if d is None else d
                 for t, d in zip(inputs, grads)]
        n = len(inputs) - x.requires_grad
        return _like(params, grads[:n]), (grads[n] if x.requires_grad
                                          else None)

    def Backward(self, mb: int, g):
        """The input gradient of microbatch ``mb`` against the frozen
        parameters; its parameter gradient is added to the sweep's."""
        with device_work():
            with self._lock:
                x = self._stash.pop(mb)
                params = self.params
            dparams, dx = self._vjp(params, x, g)
            with self._lock:
                if self._accum is None:
                    self._accum = dparams
                else:
                    summed = [a + b for a, b in zip(
                        tree_leaves(self._accum), tree_leaves(dparams))]
                    self._accum = _like(self._accum, summed)
                self._accum_count += 1
            return dx

    def Apply(self, mean: bool = True):
        """One optimizer step on the grads added up this sweep (their
        mean over microbatches by default, matching the dense loss's
        mean). Returns the number of microbatches folded in."""
        with device_work(), self._lock:
            grads, n = self._accum, self._accum_count
            self._accum, self._accum_count = None, 0
            if grads is None:
                return 0
            if mean and n > 1:
                grads = tree_map(lambda t: t * (1.0 / n), grads)
            self.params, self.opt_state = self._apply(self.params, grads,
                                                      self.opt_state)
            return n

    def Infer(self, x):
        """Stateless forward (no stash) — the inference path."""
        with device_work():
            with self._lock:
                params = self.params
            with torch.no_grad():
                return self.fn(params, x)


class PipelineClient:
    """Drives microbatches through registry-discovered stage actors."""

    def __init__(self, cluster, pipeline: str,
                 stages: Sequence[str] | None = None, conn_cfg=None):
        names = list(stages) if stages is not None else discover_stages(
            cluster.registry, pipeline)
        if not names:
            raise ClusterError(
                f"no stages registered for pipeline {pipeline!r}")
        self.stage_names = names
        self._clients = [cluster.new_client(n, conn_cfg) for n in names]

    @property
    def n_stages(self) -> int:
        return len(self._clients)

    def infer(self, x):
        for c in self._clients:
            x = c.call("Stage.Infer", x)
        return x

    def train_step(self, x, loss_grad_fn, n_microbatches: int = 1):
        """One pipelined forward + backward sweep, then every stage's
        Apply.

        ``loss_grad_fn(y) -> (loss, dy)`` gives the loss and its
        gradient at the pipeline's output (the caller owns the loss, the
        stages own the layers). One concurrent chain per microbatch
        walks forward through the stages, through the loss, then back,
        so the sweep takes about (S+M-1) stage times, not S·M. Raises if
        a stage applied another count of microbatch grads than M."""
        B = x.shape[0]
        if B % n_microbatches:
            raise ValueError(
                f"batch {B} not divisible by {n_microbatches}")
        mbs = x.reshape(n_microbatches, B // n_microbatches, *x.shape[1:])

        def chain(m):
            a = mbs[m]
            for c in self._clients:
                a = c.call("Stage.Forward", m, a)
            loss, g = loss_grad_fn(a)
            for c in reversed(self._clients):
                g = c.call("Stage.Backward", m, g)
            return float(loss)

        with ThreadPoolExecutor(max_workers=n_microbatches) as pool:
            losses = list(pool.map(chain, range(n_microbatches)))

        applied = [c.call("Stage.Apply") for c in self._clients]
        if any(n != n_microbatches for n in applied):
            raise ClusterError(
                f"pipeline sweep incomplete: stages applied {applied} "
                f"microbatch grads, expected {n_microbatches}")
        return sum(losses) / len(losses)

    def close(self) -> None:
        for c in self._clients:
            c.close()
