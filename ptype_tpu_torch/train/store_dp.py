"""Store-backed data-parallel training — the port of
``ptype_tpu/train/store_dp.py``: an optimus trainer whose gradient
exchange IS the Store (``parallel/tensorstore.py``), its push/pull
lowered to collectives over ``torch.distributed``.

One process per rank. Every rank calls :meth:`StoreDPTrainer.step` with
the same global batch and takes rows ``[r·B/n, (r+1)·B/n)`` of it
(``train.data``); its loss and gradients run through the model on its
device (the flash kernels on CUDA); ``TensorStore.push_tree("grads",
...)`` averages the gradients over the ranks; the optimizer applies them
(``train.opt``) and ``put_tree`` commits the params back. The step's
loss is the mean over the ranks (an allreduce), the reference's number.

Gradient-exchange modes (``overlap``):

- ``False``: every bucket's collective dispatched, then the whole-tree
  AdamW;
- ``"drain"``: the same, but the buckets are waited one by one in their
  ``store.push_wait`` regions before the apply — the synchronous
  accounting baseline (on gloo the host waits there; on NCCL a wait
  orders the stream and the host never blocks);
- ``True``: buckets dispatch lazily (``push_tree_iter``); bucket i is
  waited while bucket i+1 is on the wire, and the default recipe applies
  per BUCKET, the global-norm clip coordinated through per-bucket square
  sums as a device value. A custom ``optimizer`` falls back to the
  whole-tree apply.

``zero`` picks a rung of the ladder (``parallel/zero.py``); each shards
the AdamW moments 1/n:

- ``1``: grads ride the allreduce stream whole; each rank updates its
  shard of params and grads and allgathers the params;
- ``2`` (also ``True``): grads reduce-SCATTER bucket by bucket, each
  rank's grad shard feeding its update directly;
- ``3``: params are resident as shards too, gathered for the forward
  (``params()``), updated in place, and committed to the store as
  ``params/bucketNNNNN`` flats.

Entry point: runs on ``cuda`` unless ``device`` names another (the
store's mesh's device); with no CUDA device and none named it raises.

Live elasticity: :meth:`StoreDPTrainer.reshard` moves a ZeRO trainer
onto a survivor mesh in memory (``ZeroState.reshard``, the store
re-homed, params re-committed); :func:`measure_reshard` sets it against
the checkpoint round trip it replaces, in step units.

Counted cost: :meth:`StoreDPTrainer.compiled_cost` gives the FLOPs and
bytes of a step (the gradient program and the optimizer apply of the
trainer's mode) for the goodput ledger's ``mfu_compiled``.

Probes: :func:`measure_overlap`, :func:`measure_zero` (replicated
against ZeRO: optimizer bytes a replica, step time, final losses),
:func:`measure_zero_ladder` and :func:`measure_reshard`.
"""

from __future__ import annotations

import time as _time

import numpy as np
import torch

from ptype_tpu_torch import jitwatch
from ptype_tpu_torch.device import device_work, resolve_device
from ptype_tpu_torch.errors import ClusterError
from ptype_tpu_torch.metrics import (annotate, metrics,
                                     set_annotate_observer)
from ptype_tpu_torch.models import transformer as tfm
from ptype_tpu_torch.models.weights import init_params
from ptype_tpu_torch.parallel import collectives
from ptype_tpu_torch.parallel.collectives import (WireConfig, tree_flatten,
                                                  tree_unflatten)
from ptype_tpu_torch.parallel.mesh import axis_index, axis_n
from ptype_tpu_torch.parallel.tensorstore import TensorStore
from ptype_tpu_torch.parallel.zero import ShardPlan, ZeroState
from ptype_tpu_torch.train.trainer import (_batch_on, _decay_mask,
                                           clip_scale, default_optimizer,
                                           default_optimizer_hparams,
                                           default_optimizer_pieces)

_OVERLAP_MODES = (False, "drain", True)


def _sqnorm(leaves) -> torch.Tensor:
    """Σ x² over tensors, in f32."""
    return sum(torch.sum(v.float() * v.float()) for v in leaves)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _own(tree: dict, device, dtype) -> dict:
    """A tree of numpy arrays or tensors → private copies on ``device``
    in ``dtype``."""
    if isinstance(tree, dict):
        return {k: _own(v, device, dtype) for k, v in tree.items()}
    t = (tree.detach() if torch.is_tensor(tree)
         else torch.from_numpy(np.array(tree)))
    return t.to(device=device, dtype=dtype).clone()


def _at(tree: dict, path: tuple):
    for key in path:
        tree = tree[key]
    return tree


class StoreDPTrainer:
    """Data-parallel trainer whose gradient exchange IS the Store."""

    def __init__(self, cfg: tfm.TransformerConfig, store: TensorStore,
                 optimizer=None, overlap=False, zero=False,
                 zero_hparams=None, params: dict | None = None,
                 generator: torch.Generator | None = None, device=None,
                 attn_fn=None):
        if overlap not in _OVERLAP_MODES:
            raise ValueError(
                f"StoreDPTrainer: overlap must be one of "
                f"{_OVERLAP_MODES}, got {overlap!r}")
        # True predates the ladder and IS stage 2; the identity check
        # matters, since True == 1.
        if zero is True:
            zero_stage = 2
        elif zero in (False, 0, None):
            zero_stage = 0
        elif zero in (1, 2, 3):
            zero_stage = int(zero)
        else:
            raise ValueError(
                f"StoreDPTrainer: zero must be False, True (= stage "
                f"2), or a ZeRO ladder stage 1/2/3, got {zero!r}")
        if zero_stage and optimizer is not None:
            raise ValueError(
                "StoreDPTrainer: zero=True shards the DEFAULT AdamW "
                "recipe (parallel/zero.py); an arbitrary optimizer "
                "cannot be decomposed into shard-local flat applies — "
                "tune it via zero_hparams (trainer.OptHParams) or "
                "pass zero=False")
        if zero_hparams is not None and not zero_stage:
            raise ValueError(
                "StoreDPTrainer: zero_hparams only applies with "
                "zero=True")
        if zero_stage and overlap is not False:
            raise ValueError(
                "StoreDPTrainer: zero=True has its own streamed "
                "reduce-scatter pipeline; combine it with "
                "overlap=False")
        self.device = resolve_device(device)
        if self.device.type != store.device.type:
            raise ClusterError(f"StoreDPTrainer: device {self.device} is "
                               f"not the store's {store.device}")
        self.device = store.device
        self.cfg = cfg
        self.store = store
        self.mesh = store.mesh
        self.axis = store.axis
        self.n_workers = axis_n(self.mesh, self.axis)
        self.overlap = overlap
        self.zero = zero_stage > 0
        self.zero_stage = zero_stage
        self._custom_opt = optimizer is not None
        self.optimizer = optimizer or default_optimizer()
        self._attn_fn = attn_fn or tfm.resolve_attn_fn(cfg, self.device)

        if params is None:
            generator = (generator if generator is not None
                         else torch.Generator().manual_seed(0))
            params = init_params(generator, cfg, device=self.device)
        else:
            params = _own(params, self.device, cfg.param_dtype)
        pairs = tree_flatten(params)
        # Leaves in the reference's treedef order (keys sorted at each
        # level); the store and the ZeRO slots use the sorted key
        # STRINGS, a second order (store-sorted).
        self._paths = [p for p, _ in pairs]
        self._keys = ["params/" + "/".join(p) for p in self._paths]
        self._key_index = {k: i for i, k in enumerate(self._keys)}
        self._param_leaves = [leaf for _, leaf in pairs]
        self._mask_leaves = [_at(_decay_mask(params), p) for p in self._paths]
        self.opt_state = (None if zero_stage
                          or (overlap is True and not self._custom_opt)
                          else self.optimizer.init(self._tree()))
        self._params_seq = self.store.put_tree("params", self._tree())
        self.step_count = 0

        # overlap=True with the default recipe: per-bucket optimizers,
        # built on the first step, when the bucket plan is known.
        self._buckets: list[list[int]] | None = None
        self._bucket_opts: list | None = None
        self._bucket_states: list | None = None
        self._clip: float | None = None

        self._zero: ZeroState | None = None
        self._zero_order: list[int] | None = None
        if self.zero:
            order = sorted(range(len(self._keys)),
                           key=lambda i: self._keys[i])
            self._zero_order = order
            plan = ShardPlan.for_leaves(
                [self._param_leaves[i] for i in order], self.n_workers,
                self.store.wire.bucket_bytes)
            self._zero = ZeroState.create(
                plan, self.mesh, self.axis,
                zero_hparams or default_optimizer_hparams(),
                [self._mask_leaves[i] for i in order])
            if zero_stage == 3:
                # Params leave the replicated world: resident as this
                # rank's bucket shards, the store's leaf entries
                # replaced by per-bucket flat commits.
                self._zero.scatter_params(
                    [self._param_leaves[i] for i in order])
                for k in self._keys:
                    self.store.delete(k)
                for bi, flat in enumerate(self._zero.pflat):
                    self.store.commit_sharded(f"params/bucket{bi:05d}",
                                              flat)
                self._param_leaves = None
                self._params_seq = self.store.tree_seq("params")
        #: This rank's resident gradient bytes of the last exchange
        #: (whole leaves under zero=1, its shards under zero=2/3).
        self.last_grad_bytes: int | None = None
        #: (rows, seq) of this rank's last batch — what
        #: :meth:`compiled_cost` counts against.
        self._cost_shape: tuple[int, int] | None = None

    def _tree(self, leaves=None) -> dict:
        return tree_unflatten(self._paths, leaves if leaves is not None
                              else self._param_leaves)

    def params(self) -> dict:
        """The current parameter tree: the locally kept leaves, re-read
        from the store only when its write stamp says another writer
        touched ``params/`` since this trainer's own put. Under
        ``zero=3`` gathered from the resident shards (transient)."""
        if self.zero_stage == 3:
            gathered = self._zero.gather_params()
            leaves = [None] * len(self._keys)
            for slot, i in enumerate(self._zero_order):
                leaves[i] = gathered[slot]
            return self._tree(leaves)
        seq = self.store.tree_seq("params")
        if seq == self._params_seq and self._param_leaves is not None:
            return self._tree()
        flat = self.store.get_tree("params")
        self._param_leaves = [flat[k] for k in self._keys]
        self._params_seq = seq
        return self._tree()

    def step(self, batch: dict) -> dict:
        """One DP step on the global ``batch`` (leaves (B, S), B a
        multiple of the rank count), inside a ``train.step`` region.
        Returns the mean loss over the ranks (a host float: the step's
        one host read), the step count and the grad epoch."""
        with annotate("train.step"), device_work():
            out = self._step(batch)
        metrics.gauge("train.loss").set(out["loss"])
        metrics.counter("train.steps").add(1)
        return out

    def _stage(self, batch: dict) -> dict:
        B = batch["tokens"].shape[0]
        if B % self.n_workers:
            raise ValueError(
                f"batch size {B} not divisible by {self.n_workers} workers")
        b = B // self.n_workers
        r = axis_index(self.mesh, self.axis)
        self._cost_shape = (b, int(batch["tokens"].shape[1]))
        # The data leg's upload is the step's sanctioned host-to-device
        # seam: typed and counted, so the train.step region can refuse
        # every other host synchronisation.
        with annotate("train.data"), \
                jitwatch.sanctioned_transfer("train.data"):
            return _batch_on({k: v[r * b:(r + 1) * b]
                              for k, v in batch.items()}, self.device)

    def _local_grads(self, leaves: list, rows: dict):
        """(loss, grads tree) of this rank's rows at ``leaves``."""
        ps = [t.detach().requires_grad_(True) for t in leaves]
        loss = tfm.loss_fn(self._tree(ps), rows, self.cfg, self._attn_fn)
        grads = torch.autograd.grad(loss, ps)
        return loss.detach(), self._tree(list(grads))

    def _step(self, batch: dict) -> dict:
        rows = self._stage(batch)
        with jitwatch.hot_region("train.step", self.device):
            loss = self._grads_reduce_apply(rows)
        self.step_count += 1
        mean = collectives.all_reduce(loss, self.mesh, self.axis, "mean")
        return {"loss": float(mean), "step": self.step_count,
                "grad_epoch": self.store.epoch(self._grad_key0())}

    def _grads_reduce_apply(self, rows: dict) -> torch.Tensor:
        """The step's device work on staged ``rows``: grads, the
        exchange of the trainer's mode, the apply. Returns the local
        loss (a device value)."""
        tree = self.params()
        leaves = [_at(tree, p) for p in self._paths]
        # Under zero=3 the gathered leaves are transient: they die with
        # this call's locals once the grads exist.
        loss, grads = self._local_grads(leaves, rows)
        del tree, leaves
        if self.zero_stage == 1:
            self._reduce_apply_zero1(grads)
        elif self.zero_stage == 3:
            self._reduce_apply_zero3(grads)
        elif self.zero:
            self._reduce_apply_zero(grads)
        elif self.overlap is True:
            self._reduce_apply_overlapped(grads)
        else:
            if self.overlap == "drain":
                handles = self.store.push_tree_stream("grads", grads,
                                                      op="mean")
                for h in handles:
                    h.wait()
                reduced = self._grads_from(handles)
            else:
                flat = self.store.push_tree("grads", grads, op="mean")
                reduced = self._tree([flat["grads/" + "/".join(p)]
                                      for p in self._paths])
            with annotate("train.opt"):
                self.optimizer.update(self._tree(), reduced, self.opt_state)
            self._params_seq = self.store.put_tree("params", self._tree())
        return loss

    # ------------------------------------------------ streamed pushes

    @staticmethod
    def _drain(stream, consume) -> list:
        """Take every handle of ``stream``, waiting bucket i (and
        ``consume``-ing it) once bucket i+1 is dispatched."""
        handles, prev = [], None
        for h in stream:
            handles.append(h)
            if prev is not None:
                consume(prev.wait())
            prev = h
        if prev is not None:
            consume(prev.wait())
        return handles

    def _reduce_apply_zero(self, grads) -> None:
        """ZeRO-2: the reduce-scatter stream, per-bucket partial square
        sums, then shard-local AdamW + param allgather per bucket."""
        sqs = []
        handles = self._drain(
            self.store.push_tree_scatter_iter("grads", grads, op="mean"),
            lambda h: sqs.append(self._zero.partial_sqnorm(h.flat)))
        with annotate("train.opt/zero"):
            scale = self._zero.clip_scale(sqs)
            for bi, h in enumerate(handles):
                idxs = [self._zero_order[s.index] for s in h.bucket.slots]
                newp = self._zero.apply_bucket(
                    bi, [self._param_leaves[i] for i in idxs], h.flat, scale)
                for i, leaf in zip(idxs, newp):
                    self._param_leaves[i] = leaf
            self._zero.finish_step()
        self.last_grad_bytes = sum(_nbytes(h.flat) for h in handles)
        self._params_seq = self.store.put_tree("params", self._tree())

    def _reduce_apply_zero1(self, grads) -> None:
        """ZeRO-1: the allreduce stream (whole reduced leaves); each
        rank slices its shard of params and grads in the apply."""
        sqs = []
        handles = self._drain(
            self.store.push_tree_iter("grads", grads, op="mean"),
            lambda h: sqs.append(_sqnorm(h.values)))
        if len(handles) != len(self._zero.plan.buckets):
            raise ValueError(
                f"zero=1: grad stream produced {len(handles)} buckets, the "
                f"shard plan has {len(self._zero.plan.buckets)} — plans "
                "diverged")
        with annotate("train.opt/zero"):
            scale = self._zero.clip_scale(sqs, partial=False)
            grad_bytes = 0
            for bi, h in enumerate(handles):
                idxs = [self._grad_index(k) for k in h.keys]
                grad_bytes += sum(_nbytes(v) for v in h.values)
                newp = self._zero.apply_bucket_full(
                    bi, [self._param_leaves[i] for i in idxs], h.values,
                    scale)
                for i, leaf in zip(idxs, newp):
                    self._param_leaves[i] = leaf
            self._zero.finish_step()
        self.last_grad_bytes = grad_bytes
        self._params_seq = self.store.put_tree("params", self._tree())

    def _reduce_apply_zero3(self, grads) -> None:
        """ZeRO-3: grads reduce-scatter as in ZeRO-2; the update runs in
        place on the resident shards, each committed straight back to
        the store. The whole tree is never built on the update path."""
        sqs = []
        handles = self._drain(
            self.store.push_tree_scatter_iter("grads", grads, op="mean"),
            lambda h: sqs.append(self._zero.partial_sqnorm(h.flat)))
        with annotate("train.opt/zero"):
            scale = self._zero.clip_scale(sqs)
            for bi, h in enumerate(handles):
                self.store.commit_sharded(
                    f"params/bucket{bi:05d}",
                    self._zero.apply_bucket3(bi, h.flat, scale))
            self._zero.finish_step()
        self.last_grad_bytes = sum(_nbytes(h.flat) for h in handles)
        self._params_seq = self.store.tree_seq("params")

    def zero_state(self) -> ZeroState:
        """The 1/n-resident sharded optimizer state (zero only)."""
        if self._zero is None:
            raise ValueError("StoreDPTrainer: no ZeRO state — construct "
                             "with zero=True")
        return self._zero

    # ---------------------------------------------- live resharding

    def reshard(self, mesh, axis: str | None = None) -> dict:
        """LIVE reshard onto a survivor mesh — no checkpoint round trip.
        Every rank of the current mesh calls in step: a survivor passes
        the survivor mesh (:func:`~ptype_tpu_torch.parallel.mesh.
        survivor_mesh`), a rank that leaves passes None and only hands
        its shards over. Re-pads and re-places the resident ZeRO state
        (``ZeroState.reshard``: atomic, moments bit-preserved), re-homes
        the store and re-commits the params; the next :meth:`step` runs
        on the survivors.

        The move runs as a ``train.reshard`` region with the
        ``train.reshard_inflight`` gauge and the ``train.reshards``
        counter (the ``reshard-stall`` health rule's series). On a raise
        (the ``train.reshard`` seam's drop, a rank that cannot answer)
        everything is left intact and the inflight gauge stays up: that
        IS the stall signal, and the caller retries."""
        if not self.zero:
            raise ValueError(
                "StoreDPTrainer.reshard: live resharding needs the "
                "sharded ZeRO state — construct with zero=True/1/2/3 "
                "(replicated modes restart from a checkpoint instead)")
        axis = axis or self.axis
        old_n = self.n_workers
        new_n = None if mesh is None else axis_n(mesh, axis)
        t0 = _time.perf_counter()
        metrics.gauge("train.reshard_inflight").set(1.0)
        with annotate("train.reshard"):
            self.store._settle()
            self._zero.reshard(mesh, axis)
            if mesh is not None:
                self.store.reshard(mesh, axis)
                self.mesh = mesh
                self.axis = axis
                self.n_workers = new_n
                if self.zero_stage == 3:
                    for bi, flat in enumerate(self._zero.pflat):
                        self.store.commit_sharded(f"params/bucket{bi:05d}",
                                                  flat)
                    self._params_seq = self.store.tree_seq("params")
                else:
                    self._params_seq = self.store.put_tree("params",
                                                           self._tree())
            self._cost_shape = None
        metrics.gauge("train.reshard_inflight").set(0.0)
        metrics.counter("train.reshards").add(1)
        return {"old_n": old_n, "new_n": new_n,
                "reshard_ms": (_time.perf_counter() - t0) * 1e3}

    # --------------------------------------- compiled-cost accounting

    def compiled_cost(self) -> dict:
        """FLOPs/bytes per step, counted op by op — the ``mfu_compiled``
        numerator, fed to a goodput ledger via
        ``ledger.set_compiled_flops(trainer.compiled_cost()["flops"])``.

        Sums the gradient program
        (:func:`ptype_tpu_torch.health.profiling.transformer_grads_cost`
        over every rank's row block: the model's math with the plain
        attention, on the ``meta`` device) and the optimizer apply(s) of
        whichever exchange mode this trainer runs: the whole-tree apply,
        the per-bucket overlap applies, or the ZeRO shard-local applies
        — each counted on ``meta`` skeletons, so no state moves. FLOPs
        are ``FlopCounterMode``'s (matmul-class ops: an optimizer's
        count 0), bytes each op's tensors in and out. Requires one
        completed step (the batch shape comes from it)."""
        from ptype_tpu_torch.health import profiling

        if self._cost_shape is None:
            raise ValueError(
                "StoreDPTrainer.compiled_cost: run at least one step "
                "first (the cost programs count against the real batch "
                "shapes)")
        rows, seq = self._cost_shape
        grads = profiling.transformer_grads_cost(
            self.cfg, rows, seq, stacked=self.n_workers)
        programs = {"grads": {"flops": grads["flops"],
                              "bytes_accessed": grads["bytes_accessed"],
                              "device": grads["device"]}}
        if self.zero:
            programs["optimizer"] = self._zero.compiled_cost()
        elif self._bucket_opts is not None:
            flops = nbytes = 0.0
            scale = torch.ones((), dtype=torch.float32, device="meta")
            for bi, idxs in enumerate(self._buckets):
                subp = profiling.tree_avals(
                    {str(i): self._param_leaves[i] for i in idxs})
                c = profiling.compiled_cost(
                    self._bucket_opts[bi].update, subp,
                    profiling.tree_avals(subp),
                    profiling.tree_avals(self._bucket_states[bi]), scale)
                flops += c["flops"]
                nbytes += c["bytes_accessed"]
            programs["optimizer"] = {"flops": flops,
                                     "bytes_accessed": nbytes}
        elif self.opt_state is not None:
            tree = profiling.tree_avals(self.params())
            programs["optimizer"] = profiling.compiled_cost(
                self.optimizer.update, tree, profiling.tree_avals(tree),
                profiling.tree_avals(self.opt_state))
        tokens = grads["tokens_per_step"]
        flops = sum(p["flops"] for p in programs.values())
        return {
            "flops": flops,
            "bytes_accessed": sum(p["bytes_accessed"]
                                  for p in programs.values()),
            "tokens_per_step": tokens,
            "flops_per_token": flops / tokens,
            "programs": programs,
        }

    # ---------------------------------------------- fine-grained overlap

    def _reduce_apply_overlapped(self, grads) -> None:
        """Wait bucket i while bucket i+1 is on the wire, taking its
        square sum; then the per-bucket AdamW with the clip scale built
        from those sums on the device (no host read)."""
        sqs = []
        handles = self._drain(
            self.store.push_tree_iter("grads", grads, op="mean"),
            lambda h: sqs.append(_sqnorm(
                v for _, v in sorted(self._sub_grads(h).items()))))
        if self._buckets is None:
            self._init_bucket_apply(handles)
        with annotate("train.opt"):
            if self._custom_opt:
                self.optimizer.update(self._tree(), self._grads_from(handles),
                                      self.opt_state)
            else:
                scale = clip_scale(torch.sum(torch.stack(sqs)), self._clip)
                for bi, h in enumerate(handles):
                    idxs = self._buckets[bi]
                    subp = {str(i): self._param_leaves[i] for i in idxs}
                    self._bucket_opts[bi].update(
                        subp, self._sub_grads(h), self._bucket_states[bi],
                        scale)
        self._params_seq = self.store.put_tree("params", self._tree())

    def _grad_index(self, grad_key: str) -> int:
        return self._key_index[grad_key.replace("grads/", "params/", 1)]

    def _sub_grads(self, h) -> dict:
        return {str(self._grad_index(k)): v for k, v in h.items()}

    def _grads_from(self, handles) -> dict:
        leaves = [None] * len(self._keys)
        for h in handles:
            for k, v in h.items():
                leaves[self._grad_index(k)] = v
        return self._tree(leaves)

    def _init_bucket_apply(self, handles) -> None:
        """The per-bucket optimizers from the first step's plan: the
        default recipe over each bucket's sub-tree (same schedule and
        decay mask as the whole-tree recipe, from the same pieces)."""
        self._buckets = [[self._grad_index(k) for k in h.keys]
                         for h in handles]
        if self._custom_opt:
            return
        self._clip, make_inner = default_optimizer_pieces()
        self._bucket_opts, self._bucket_states = [], []
        for idxs in self._buckets:
            opt = make_inner({str(i): self._mask_leaves[i] for i in idxs})
            self._bucket_opts.append(opt)
            self._bucket_states.append(opt.init(
                {str(i): self._param_leaves[i] for i in idxs}))

    def _grad_key0(self) -> str:
        if self.zero_stage >= 2:
            return "grads/bucket00000"  # the scatter commits per bucket
        return self._keys[0].replace("params/", "grads/", 1)


# ----------------------------------------------------------- probes


def _probe_trainer(cfg, mesh, device, wire=None, **kw) -> StoreDPTrainer:
    store = TensorStore(mesh, wire=wire, device=device)
    return StoreDPTrainer(cfg, store, device=device, generator=torch.Generator(
        device=device).manual_seed(0), **kw)


def _batches(cfg, batch: int, seq: int, device, seed: int):
    from ptype_tpu_torch.train.data import synthetic_batches

    return synthetic_batches(cfg.vocab_size, batch, seq, seed=seed,
                             device=device)


def measure_overlap(mesh, preset: str = "tiny", steps: int = 6,
                    batch: int = 16, bucket_bytes: int = 64 * 1024,
                    compress: str | None = "int8", device=None) -> dict:
    """The collective's share of store-DP step time, synchronous
    baseline (``overlap="drain"``) vs fine-grained overlap (``True``):
    the host time inside ``store.push_tree/*`` and ``store.push_wait/*``
    regions over the wall time of ``steps`` steps, after one warm step.
    Every rank must call; the numbers are this rank's."""
    device = resolve_device(device)
    cfg = tfm.preset(preset)
    seq = min(cfg.max_seq, 128)

    def run(overlap):
        wire = WireConfig(compress=compress, bucket_bytes=bucket_bytes,
                          int8_min_bytes=0)
        trainer = _probe_trainer(cfg, mesh, device, wire, overlap=overlap)
        stream = _batches(cfg, batch, seq, device, seed=0)
        trainer.step(next(stream))
        spent = [0.0]

        def observe(name, dur_s):
            if name.startswith(("store.push_tree/", "store.push_wait/")):
                spent[0] += dur_s

        set_annotate_observer(observe)
        try:
            t0 = _time.perf_counter()
            for _ in range(steps):
                out = trainer.step(next(stream))
            wall = _time.perf_counter() - t0
        finally:
            set_annotate_observer(None)
        if out["loss"] != out["loss"]:
            raise ValueError(f"measure_overlap: loss is NaN ({overlap!r})")
        return spent[0] / wall * 100.0, wall / steps * 1e3

    share_base, drain_ms = run("drain")
    share_over, over_ms = run(True)
    return {
        "collective_share_drain_pct": share_base,
        "collective_share_overlap_pct": share_over,
        "collective_overlap_pct": (100.0 * (1.0 - share_over / share_base)
                                   if share_base else 0.0),
        "drain_step_ms": drain_ms, "overlap_step_ms": over_ms,
        "steps": steps, "bucket_bytes": bucket_bytes, "compress": compress,
    }


def measure_zero(mesh, preset: str = "tiny", steps: int = 6,
                 batch: int = 16, compress: str | None = None,
                 device=None) -> dict:
    """Optimizer-state bytes a replica and step time of ZeRO (``zero=True``,
    the reference's) against the replicated store-DP baseline, the same
    seed and stream: measured resident bytes of the moments (not a
    formula), the step ms (host clock, the device drained by the loss
    read) after one warm step, and both final losses, which must agree.
    Every rank must call."""
    device = resolve_device(device)
    cfg = tfm.preset(preset)
    seq = min(cfg.max_seq, 128)

    def run(zero: bool):
        wire = WireConfig(compress=compress, int8_min_bytes=0)
        trainer = _probe_trainer(cfg, mesh, device, wire, zero=zero)
        stream = _batches(cfg, batch, seq, device, seed=5)
        trainer.step(next(stream))
        t0 = _time.perf_counter()
        for _ in range(steps):
            out = trainer.step(next(stream))
        dt = (_time.perf_counter() - t0) / steps
        if zero:
            nbytes = trainer.zero_state().moment_bytes_per_replica()
        else:
            st = trainer.opt_state
            nbytes = sum(_nbytes(t) for _, t in
                         tree_flatten(st.mu) + tree_flatten(st.nu))
        return dt, nbytes, out["loss"]

    repl_dt, repl_bytes, repl_loss = run(False)
    zero_dt, zero_bytes, zero_loss = run(True)
    return {
        "zero_opt_mem_mb": round(zero_bytes / 2**20, 3),
        "repl_opt_mem_mb": round(repl_bytes / 2**20, 3),
        "opt_mem_ratio": (round(repl_bytes / zero_bytes, 2)
                          if zero_bytes else None),
        "zero_step_ms": round(zero_dt * 1e3, 2),
        "repl_step_ms": round(repl_dt * 1e3, 2),
        "final_loss_zero": round(float(zero_loss), 5),
        "final_loss_repl": round(float(repl_loss), 5),
        "n_replicas": axis_n(mesh, "data"),
        "steps": steps,
        "compress": compress,
    }


def measure_zero_ladder(mesh, preset: str = "tiny", steps: int = 4,
                        batch: int = 16, device=None) -> dict:
    """The ladder measured: replicated baseline vs ZeRO-1/2/3 on the
    same seed and stream — this rank's resident bytes of optimizer
    moments, the grad exchange and params, the step time (host clock,
    the device drained by the loss read) and the final loss, which must
    match across rungs. Every rank must call."""
    device = resolve_device(device)
    cfg = tfm.preset(preset)
    seq = min(cfg.max_seq, 128)
    rows = {}
    for stage in (0, 1, 2, 3):
        trainer = _probe_trainer(cfg, mesh, device, zero=stage)
        stream = _batches(cfg, batch, seq, device, seed=5)
        trainer.step(next(stream))
        t0 = _time.perf_counter()
        for _ in range(steps):
            out = trainer.step(next(stream))
        dt = (_time.perf_counter() - t0) / steps
        if stage:
            opt_b = trainer.zero_state().moment_bytes_per_replica()
            param_b = trainer.zero_state().param_bytes_per_replica()
        else:
            st = trainer.opt_state
            opt_b = sum(_nbytes(t) for _, t in
                        tree_flatten(st.mu) + tree_flatten(st.nu))
            param_b = 0
        if not param_b:
            param_b = sum(_nbytes(t) for _, t in
                          tree_flatten(trainer.params()))
        rows[f"zero{stage}" if stage else "repl"] = {
            "step_ms": dt * 1e3,
            "opt_mem_mb": opt_b / 2**20,
            "grad_mem_mb": (trainer.last_grad_bytes or 0) / 2**20,
            "param_mem_mb": param_b / 2**20,
            "final_loss": out["loss"],
        }
        del trainer
    return {
        "ladder": rows,
        "zero2_grad_mem_mb": rows["zero2"]["grad_mem_mb"],
        "zero3_param_mem_mb": rows["zero3"]["param_mem_mb"],
        "repl_grad_mem_mb": rows["zero1"]["grad_mem_mb"],
        "repl_param_mem_mb": rows["repl"]["param_mem_mb"],
        "n_replicas": axis_n(mesh, "data"),
        "steps": steps,
    }


def measure_reshard(mesh, survivors=None, preset: str = "tiny",
                    steps: int = 3, batch: int = 16, seq: int | None = None,
                    zero: int = 2, device=None,
                    workdir: str | None = None) -> dict:
    """Live reshard vs the checkpoint round trip it replaces: train on
    ``mesh``, move to the ``survivors`` (global ranks; default all of
    them) both ways, and report each recovery in STEP units
    (``reshard_resume_steps``: wall time until the first survivor step
    is done, over the steady step time; ``new_group_ms`` the part spent
    making the survivor group and running its first collective). The live path is
    :meth:`StoreDPTrainer.reshard`; the baseline is ``ZeroCheckpoint`` +
    ``StoreCheckpoint`` save → a fresh trainer on the survivors →
    restore → the first step. Every rank of ``mesh`` calls; a rank not
    among the survivors leaves after handing over its shards (its
    numbers are None). ``workdir``: where the checkpoints go (a shared
    directory), a temporary one when None."""
    import shutil
    import tempfile

    from ptype_tpu_torch.checkpoint import StoreCheckpoint, ZeroCheckpoint
    from ptype_tpu_torch.parallel.mesh import group_ranks, survivor_mesh

    device = resolve_device(device)
    if workdir is None and mesh.size > 1:
        raise ValueError("measure_reshard: ranks write one checkpoint "
                         "together; pass a shared workdir")
    cfg = tfm.preset(preset)
    seq = seq or min(cfg.max_seq, 128)
    ranks = group_ranks(mesh) if survivors is None else sorted(survivors)
    stays = torch.distributed.get_rank() in ranks

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def trained():
        tr = _probe_trainer(cfg, mesh, device, zero=zero)
        stream = _batches(cfg, batch, seq, device, seed=5)
        tr.step(next(stream))
        sync()
        t0 = _time.perf_counter()
        for _ in range(steps):
            tr.step(next(stream))
        sync()
        return tr, (_time.perf_counter() - t0) / steps, stream

    # Live path: the survivor group, reshard, the first survivor step.
    tr, step_s, stream = trained()
    t0 = _time.perf_counter()
    new = survivor_mesh(mesh, ranks, device=device)
    if stays:
        # The new group's first collective: NCCL builds its
        # communicator here, timed apart from the move.
        collectives.all_reduce(torch.zeros(1, device=device), new)
        sync()
    group_s = _time.perf_counter() - t0
    info = tr.reshard(new)
    if stays:
        tr.step(next(stream))
        sync()
    live_s = _time.perf_counter() - t0
    del tr

    # The checkpoint path on an identical twin: save, a fresh trainer on
    # the survivors, restore, the first step.
    twin, _, stream2 = trained()
    root = workdir or tempfile.mkdtemp(prefix="reshard-")
    try:
        t0 = _time.perf_counter()
        ZeroCheckpoint(root + "/zero").save(steps, twin.zero_state())
        StoreCheckpoint(twin.store, root + "/store",
                        keys_prefix="params/").save(steps)
        new2 = survivor_mesh(mesh, ranks, device=device)
        if stays:
            fresh = _probe_trainer(cfg, new2, device, zero=zero)
            StoreCheckpoint(fresh.store, root + "/store",
                            keys_prefix="params/").resume()
            ZeroCheckpoint(root + "/zero").restore_into(fresh.zero_state())
            if zero == 3:
                for bi, flat in enumerate(fresh.zero_state().pflat):
                    fresh.store.commit_sharded(f"params/bucket{bi:05d}",
                                               flat)
            fresh.step(next(stream2))
            sync()
        ckpt_s = _time.perf_counter() - t0
    finally:
        if workdir is None:
            shutil.rmtree(root, ignore_errors=True)
    if not stays:
        return {"zero_stage": zero, "left": True, "old_n": info["old_n"]}
    return {
        "zero_stage": zero,
        "old_n": info["old_n"], "new_n": info["new_n"],
        "step_ms": step_s * 1e3,
        "new_group_ms": group_s * 1e3,
        "reshard_ms": info["reshard_ms"],
        "live_resume_ms": live_s * 1e3,
        "ckpt_resume_ms": ckpt_s * 1e3,
        "reshard_resume_steps": live_s / step_s,
        "ckpt_resume_steps": ckpt_s / step_s,
        "resume_speedup": ckpt_s / live_s,
    }
