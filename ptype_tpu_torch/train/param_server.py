"""Async param-server training — Store put/get WITHOUT a barrier: the
port of ``ptype_tpu/train/param_server.py``.

The BASELINE configuration "BERT-base async param-server mode (Store
push/pull, no allreduce)":

- the **server** (:class:`ParamServer`) owns the canonical parameters,
  published through a :class:`~ptype_tpu_torch.parallel.tensorstore.
  TensorStore`, and applies gradient pushes as they arrive — no
  barrier, no allreduce; each push is one optimizer step
  (Hogwild/Downpour-style);
- **workers** (:class:`AsyncWorker`) pull a (possibly stale) snapshot,
  compute gradients on their own batch (attention through the flash
  kernels on CUDA) and push them back. A staleness bound rejects pushes
  computed against parameters more than ``max_staleness`` versions old.

The server's methods are plain callables, so it drops into an
:class:`~ptype_tpu_torch.actor.ActorServer` (``register(server,
"ParamServer")``): workers call ``ParamServer.Pull`` / ``Push`` over the
balanced RPC client, payloads riding the tensor codec. A push may be
the int8 tree wire (:func:`~ptype_tpu_torch.parallel.collectives.
quantize_tree`, about 4× fewer bytes) with a worker-side error-feedback
residual.

Each applied push makes a new parameter version out of place
(:func:`~ptype_tpu_torch.train.trainer.make_apply_fn`): a snapshot a
worker pulled never changes under it, as the reference's immutable
arrays never do.
"""

from __future__ import annotations

import threading

import torch

from ptype_tpu_torch.device import device_work, resolve_device
from ptype_tpu_torch.models import transformer as tfm
from ptype_tpu_torch.models.weights import init_params
from ptype_tpu_torch.parallel import collectives
from ptype_tpu_torch.train.trainer import (_at, _batch_on, _flatten,
                                           _unflatten, default_optimizer,
                                           grads_of, make_apply_fn)


class StalePushError(Exception):
    """Grad push rejected: computed against too-old parameters."""


def _is_stale(e: Exception) -> bool:
    """True for a staleness rejection, local or remote: over the actor
    wire the server's StalePushError arrives as a RemoteError carrying
    the exception's name."""
    return isinstance(e, StalePushError) or "StalePushError" in str(e)


class ParamServer:
    """Canonical parameter owner; applies async gradient pushes.

    Thread-safe: concurrent pushes serialize on a lock. The parameters
    live on the store's device. ``params`` (a parameter tree, e.g. from
    ``params_from_numpy``) is copied in; without it :func:`init_params`
    draws from ``generator`` (a CPU generator seeded 0 when None). The
    default wire is the store's, so one config covers collective and
    RPC gradients."""

    def __init__(self, cfg: tfm.TransformerConfig, store, optimizer=None,
                 generator: torch.Generator | None = None,
                 max_staleness: int = 8,
                 wire: collectives.WireConfig | None = None,
                 params: dict | None = None):
        self.cfg = cfg
        self.store = store
        self.device = store.device
        self.optimizer = optimizer or default_optimizer()
        self.max_staleness = max_staleness
        self.wire = wire if wire is not None else store.wire
        self._quantized = 0
        if params is None:
            generator = (generator if generator is not None
                         else torch.Generator().manual_seed(0))
            params = init_params(generator, cfg, device=self.device)
        else:
            params = _unflatten(
                (path, torch.as_tensor(t).detach().to(
                    device=self.device, dtype=cfg.param_dtype).clone())
                for path, t in _flatten(params))
        self._params = params
        self._opt_state = self.optimizer.init(params)
        self._version = 0
        self._applied = 0
        self._rejected = 0
        self._lock = threading.Lock()
        self.store.put_tree("params", params)
        self._apply_fn = make_apply_fn(self.optimizer)

    # Capitalized methods are the actor RPC surface (net/rpc naming).

    def Pull(self) -> dict:
        """Parameter snapshot + its version (the un-barriered Get)."""
        with self._lock:
            return {"params": self._params, "version": self._version}

    def _as_grads(self, grads) -> dict:
        """``grads`` in the parameters' structure and order, on the
        server's device (a reference worker's tree arrives in its own
        key order)."""
        return _unflatten((path, torch.as_tensor(_at(grads, path)).to(
            self.device)) for path, _ in _flatten(self._params))

    def Push(self, grads, version: int) -> dict:
        """Apply one worker's grads (the un-barriered Put). ``version``
        is the parameter version they were computed against. ``grads``
        is a tree or a quantized tree wire, reassembled against the
        server's own parameter structure."""
        with device_work():
            return self._push(grads, version)

    def _push(self, grads, version: int) -> dict:
        quantized = collectives.is_quantized_tree(grads)
        if quantized:
            # Staleness needs only the version: reject BEFORE paying the
            # whole tree's dequantize. The check re-runs under the lock
            # below; the version only grows, so this verdict stands.
            with self._lock:
                self._check_staleness_locked(version)
            grads = collectives.dequantize_tree(grads, self._params)
        grads = self._as_grads(grads)
        with self._lock:
            staleness = self._check_staleness_locked(version)
            self._params, self._opt_state = self._apply_fn(
                self._params, grads, self._opt_state)
            self._version += 1
            self._applied += 1
            if quantized:  # applied quantized pushes only
                self._quantized += 1
            return {"version": self._version, "staleness": staleness}

    def _check_staleness_locked(self, version: int) -> int:
        """Raise (and count) when ``version`` is too far behind; callers
        hold the lock. Returns the staleness."""
        staleness = self._version - int(version)
        if staleness > self.max_staleness:
            self._rejected += 1
            raise StalePushError(
                f"push at version {version} is {staleness} behind "
                f"(max_staleness={self.max_staleness})")
        return staleness

    def Sync(self) -> dict:
        """Publish the current parameters into the TensorStore (for
        checkpointers and late joiners reading the manifest)."""
        with self._lock:
            self.store.put_tree("params", self._params)
            return {"version": self._version}

    def Stats(self) -> dict:
        with self._lock:
            return {"version": self._version, "applied": self._applied,
                    "rejected": self._rejected,
                    "quantized": self._quantized,
                    "wire": self.wire.compress}


class AsyncWorker:
    """Pull → local grads → push, against a ParamServer-shaped peer:
    the in-process object or a proxy over the RPC client.

    ``wire``: None pushes the exact tree; ``WireConfig(compress="int8")``
    pushes the int8 tree wire, with an error-feedback residual per leaf
    when ``wire.error_feedback`` (the quantization error rides into the
    next push). Other compressions are refused. Entry point: computes on
    ``cuda`` unless ``device`` names another."""

    def __init__(self, cfg: tfm.TransformerConfig, server,
                 worker_id: int = 0,
                 wire: collectives.WireConfig | None = None, device=None,
                 attn_fn=None):
        if wire is not None and wire.compress not in (None, "int8"):
            raise ValueError(
                f"AsyncWorker: wire compress {wire.compress!r} is not "
                f"implemented on the RPC tier (use 'int8' or None)")
        self.cfg = cfg
        self.server = server
        self.worker_id = worker_id
        self.steps = 0
        self.stale_rejections = 0
        self.wire = wire
        self.device = resolve_device(device)
        self._attn_fn = attn_fn or tfm.resolve_attn_fn(cfg, self.device)
        self._residuals: list | None = None

    def _grads(self, params: dict, batch: dict):
        leaves = _unflatten(
            (path, torch.as_tensor(t).detach().to(self.device)
             .requires_grad_(True)) for path, t in _flatten(params))
        return grads_of(leaves, _batch_on(batch, self.device), self.cfg,
                        self._attn_fn)

    def step(self, batch: dict) -> dict:
        snap = self.server.Pull()
        prev_residuals = self._residuals
        # The pull and the push stay outside device_work: over RPC the
        # server's handler enters it on another thread, which a pending
        # profiler switch holds back while it waits for this one.
        with device_work():
            loss, grads = self._grads(snap["params"], batch)
            if self.wire is not None and self.wire.compress == "int8":
                ef = self.wire.error_feedback
                grads, res = collectives.quantize_tree(
                    grads, self.wire.q_block,
                    self._residuals if ef else None, want_residuals=ef)
                if ef:
                    self._residuals = res
        try:
            out = self.server.Push(grads, snap["version"])
        except Exception as e:  # noqa: BLE001 — see _is_stale
            # Any failed push dropped the wire that carried the
            # accumulated quantization error: restore the pre-push
            # residual (stale rejections and transport faults alike).
            self._residuals = prev_residuals
            if not _is_stale(e):
                raise
            self.stale_rejections += 1
            return {"loss": float(loss), "applied": False,
                    "worker": self.worker_id}
        self.steps += 1
        return {"loss": float(loss), "applied": True,
                "version": out["version"], "staleness": out["staleness"],
                "worker": self.worker_id}

    def run(self, batches, n_steps: int) -> list[dict]:
        return [self.step(next(batches)) for _ in range(n_steps)]
