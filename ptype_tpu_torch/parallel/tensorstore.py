"""TensorStore — the Store's tensor tier: push/pull as collectives over
``torch.distributed``, the port of ``ptype_tpu/parallel/tensorstore.py``.

The reference Store's ``Put`` replicated a value to every member and its
``Get`` read it linearizably; the north star lowers that contract onto
the mesh:

- ``push(key, local)`` → allreduce: each rank passes its contribution,
  and every rank stores and returns the same reduced tensor;
- ``push_scatter(key, local)`` → reduce-scatter: rank r keeps shard r
  (half the bytes: the FSDP/ZeRO-style reduction);
- ``pull(key)`` → the stored tensor, or with ``gather=True`` the whole
  of a sharded one (an allgather).

Values live on the mesh's device under a per-key **binding**: a
placement (``()`` replicated, ``(axis,)`` dim 0 sharded: this rank
holds its shard) and a reduce op. Ordering comes from a per-key
**epoch** (every push bumps it) and a store-wide write stamp
(:meth:`tree_seq`), and an optional ``kv`` (anything with ``put(key,
value)``) receives ``{shape, dtype, spec, epoch}`` manifests, best
effort, catching up after a failed publish.

Compression (``WireConfig``): ``"bf16"`` halves the wire for float
buckets; ``"int8"`` is the block-scaled two-leg wire with per-leaf
error-feedback residuals (this rank's own quantization error, carried
into its next contribution). Buckets too small for int8, and integer
buckets, ride exact.

Streams: :meth:`push_tree_iter` and :meth:`push_tree_scatter_iter`
dispatch one bucket a step and yield a handle; a key commits (its epoch
bumps, its manifest publishes) when its bucket's reduction is waited —
by the handle's ``wait()``, or by the store itself, in dispatch order,
before any other access. The reference commits at dispatch, with the
value still in flight; a torch tensor cannot be read before its
collective is waited, so the port commits at the wait.

:meth:`TensorStore.reshard` re-homes the store on a survivor mesh (the
live elastic reshard's store leg). :func:`measure_push_tree` times a
whole gradient push of a model's parameter tree, bucketed against leaf
by leaf.

A ``topology`` (``parallel/topology.py``, the store built on its
``Topology.mesh``) routes every bucketed push through the two-leg wire
over the composite ``("inner", "outer")`` axis, which is then the
store's default axis: each leg with its own wire format, the per-leaf
residuals carried by the inner leg, and each push site's outer-leg
residuals (one flat a bucket) kept by the store across pushes and
dropped on a reshard, as the per-leaf ones are.
"""

from __future__ import annotations

import json
import threading
import time as _time
from dataclasses import dataclass, field

import torch

from ptype_tpu_torch import chaos, logs
from ptype_tpu_torch.device import resolve_device
from ptype_tpu_torch.errors import ClusterError, CoordinationError, NoKeyError
from ptype_tpu_torch.metrics import annotate, metrics
from ptype_tpu_torch.parallel import collectives
from ptype_tpu_torch.parallel.mesh import (Mesh, axis_group, axis_index,
                                           axis_n)
from ptype_tpu_torch.parallel.topology import INNER_AXIS, OUTER_AXIS

log = logs.get_logger("tensorstore")

TENSOR_PREFIX = "tensors"


def _store_fault(site: str, key: str) -> None:
    """Apply an armed store fault: ``delay`` (a straggler bucket)
    sleeps; ``timeout`` raises before any state changes, so the
    caller's retry re-runs a clean push."""
    f = chaos.hit(site, key)
    if f is None:
        return
    if f.action == "delay":
        f.sleep()
    elif f.action == "timeout":
        raise ClusterError(f"chaos: {site} timed out for {key!r}")


def spec_to_json(spec: tuple) -> str:
    return json.dumps([list(p) if isinstance(p, tuple) else p for p in spec])


def spec_from_json(raw: str) -> tuple:
    """Inverse of :func:`spec_to_json`; reads the reference's specs too
    (``["data", null]``: dim 0 sharded, the rest whole)."""
    return tuple(tuple(p) if isinstance(p, list) else p
                 for p in json.loads(raw))


@dataclass
class Binding:
    """Per-key placement + reduction policy."""

    spec: tuple = ()
    reduce_op: str = "mean"


@dataclass
class _Entry:
    value: torch.Tensor
    epoch: int = 0
    binding: Binding = field(default_factory=Binding)
    #: Store-wide monotonic write stamp: a writer of the key detects
    #: OTHER writers' mutations without re-pulling.
    seq: int = 0


class _Push:
    """A dispatched bucket of a stream. :meth:`wait` waits for its
    reduction (and any earlier one still in flight) inside a
    ``store.push_wait`` region and commits it."""

    def __init__(self, store: "TensorStore", prefix: str, reduction):
        self._store = store
        self.prefix = prefix
        self._reduction = reduction
        self.done = False

    def wait(self):
        with annotate(f"store.push_wait/{self.prefix}"):
            self._store._settle(self)
        return self

    def _finish(self) -> None:
        self._commit(*self._reduction.wait())
        self.done = True

    def _ready(self, what: str):
        if not self.done:
            raise RuntimeError(f"{what} before wait(): the bucket's "
                               "collective may still be in flight")


class BucketPush(_Push):
    """One bucket of :meth:`TensorStore.push_tree_iter`: after
    :meth:`wait`, ``values`` are the committed per-key reductions."""

    def __init__(self, store, prefix, reduction, keys):
        super().__init__(store, prefix, reduction)
        self.keys = keys
        self._values = None

    def _commit(self, outs, new_res) -> None:
        s = self._store
        self._values = [s._commit_reduced(k, v)
                        for k, v in zip(self.keys, outs)]
        if new_res is not None:
            s._store_residuals(self.keys, new_res)

    @property
    def values(self) -> list:
        self._ready("values")
        return self._values

    def items(self):
        return zip(self.keys, self.values)


class ShardPush(_Push):
    """One bucket of :meth:`TensorStore.push_tree_scatter_iter`: after
    :meth:`wait`, ``flat`` is this rank's shard of the bucket's reduced
    flat, committed under ``key`` with a ``(axis,)`` binding. ``keys``
    are the leaf keys packed into the bucket, in slot order."""

    def __init__(self, store, prefix, reduction, index, key, keys, op):
        super().__init__(store, prefix, reduction)
        self.index = index
        self.key = key
        self.bucket = reduction.bucket
        self.keys = keys
        self._op = op
        self._flat = None

    def _commit(self, flat, new_res) -> None:
        s = self._store
        self._flat = s._commit(self.key, flat, Binding((s.axis,), self._op))
        if new_res is not None:
            s._store_residuals(self.keys, new_res)

    @property
    def flat(self) -> torch.Tensor:
        self._ready("flat")
        return self._flat


class TensorStore:
    """Device-resident tensor KV over a mesh (the Store push/pull
    lowering). Entry point: runs on ``cuda`` unless ``device`` names
    another, which must be the mesh's device."""

    def __init__(self, mesh: Mesh, axis: str = "data", kv=None,
                 namespace: str = "params", compress: str | None = None,
                 wire: collectives.WireConfig | None = None,
                 topology=None, device=None):
        device = resolve_device(device)
        if device.type != mesh.device.type or (
                device.index is not None and device != mesh.device):
            raise ClusterError(f"TensorStore: device {device} is not the "
                               f"mesh's {mesh.device}")
        if (wire is not None and compress is not None
                and compress != wire.compress):
            raise ValueError(
                f"TensorStore: conflicting compress={compress!r} and "
                f"wire.compress={wire.compress!r} — pass one")
        #: A hierarchical topology: every bucketed push takes the two-leg
        #: wire, over the composite axis, which the default axis becomes
        #: (so the trainers on the store need no change).
        self.topology = topology
        if topology is not None and axis == "data":
            axis = topology.flat_axis
        axis_group(mesh, axis)
        self.wire = (wire if wire is not None
                     else collectives.WireConfig(compress=compress))
        self.mesh = mesh
        self.axis = axis
        self.device = mesh.device
        self.namespace = namespace
        self.compress = self.wire.compress
        self._kv = kv
        self._entries: dict[str, _Entry] = {}
        self._bindings: dict[str, Binding] = {}
        self._lock = threading.RLock()
        self._manifest_failed: set[str] = set()
        #: Per-key error-feedback residuals of THIS rank (the int8 wire).
        self._residuals: dict[str, torch.Tensor] = {}
        #: The two-leg wire's outer-leg residuals of THIS rank: push site
        #: → {bucket index → flat f32}. A bucket's slow-leg chunk cuts
        #: across leaf slots, so they are kept a bucket, popped and
        #: stored back as the per-leaf ones are.
        self._outer_residuals: dict[str, dict[int, torch.Tensor]] = {}
        #: Dispatched stream buckets not yet committed, in order.
        self._inflight: list[_Push] = []
        self._seq = 0
        #: prefix → highest write stamp under it (every "/"-ancestor of
        #: each written key): tree_seq in O(1).
        self._prefix_seq: dict[str, int] = {}

    @property
    def n(self) -> int:
        return axis_n(self.mesh, self.axis)

    # ---------------------------------------------------------- bindings

    def bind(self, key: str, spec: tuple = (), reduce_op: str = "mean"):
        """Declare a key's placement + reduction before first use.
        Unbound keys are replicated with mean reduction."""
        with self._lock:
            self._bindings[key] = Binding(tuple(spec), reduce_op)
            if key in self._entries:
                self._entries[key].binding = self._bindings[key]

    def binding(self, key: str) -> Binding:
        with self._lock:
            return self._bindings.get(key, Binding())

    # ------------------------------------------------------------- basic

    def _place(self, value, spec: tuple) -> torch.Tensor:
        """``value`` on the mesh's device under ``spec``: this rank's
        shard of dim 0 for a sharded spec. A tensor already there is
        stored as it is, not copied."""
        t = torch.as_tensor(value).to(self.device)
        if spec:
            n, r = self.n, axis_index(self.mesh, self.axis)
            if t.dim() < 1 or t.shape[0] % n:
                raise ValueError(f"placement {spec}: dim 0 of "
                                 f"{tuple(t.shape)} does not split {n} ways")
            s = t.shape[0] // n
            t = t[r * s:(r + 1) * s].clone()
        return t

    def put(self, key: str, value, spec: tuple | None = None,
            epoch: int = 0) -> torch.Tensor:
        """Place a value under the key's binding; no collective, epoch
        reset to ``epoch`` (a resume passes the saved one). ``spec``
        records a binding, as :meth:`bind` does."""
        self._settle()
        b = (self.binding(key) if spec is None
             else Binding(tuple(spec), self.binding(key).reduce_op))
        arr = self._place(value, b.spec)
        with self._lock:
            if spec is not None:
                self._bindings[key] = b
            self._entries[key] = _Entry(arr, epoch, b,
                                        self._stamp_locked(key))
        self._publish(key)
        return arr

    def get(self, key: str) -> torch.Tensor:
        """The stored tensor (this rank's shard, for a sharded key)."""
        self._settle()
        with self._lock:
            entry = self._entries.get(key)
        if entry is None:
            raise NoKeyError(key)
        return entry.value

    def _gathered(self, entry: _Entry) -> torch.Tensor:
        if not entry.binding.spec:
            return entry.value
        g = collectives.all_gather(entry.value, self.mesh, self.axis)
        return g.reshape((-1,) + tuple(entry.value.shape[1:]))

    def pull(self, key: str, gather: bool = False) -> torch.Tensor:
        """Get; with ``gather=True`` the whole value of a sharded key
        (the allgather lowering of a linearizable read)."""
        with annotate(f"store.pull/{key}"):
            _store_fault("store.pull", key)
            self._settle()
            with self._lock:
                entry = self._entries.get(key)
            if entry is None:
                raise NoKeyError(key)
            value = self._gathered(entry) if gather else entry.value
            chaos.note_ok("store.pull", key)
            return value

    def shard_leaf(self, key: str):
        """The key's value as a checkpoint leaf: the tensor itself when
        replicated, this rank's block as a
        :class:`~ptype_tpu_torch.checkpoint.Shard` when sharded."""
        from ptype_tpu_torch.checkpoint import Shard

        self._settle()
        with self._lock:
            entry = self._entries.get(key)
        if entry is None:
            raise NoKeyError(key)
        v = entry.value
        if not entry.binding.spec:
            return v
        r = axis_index(self.mesh, self.axis)
        return Shard(v, (r * v.shape[0],) + (0,) * (v.dim() - 1),
                     (self.n * v.shape[0],) + tuple(v.shape[1:]))

    def reshard(self, mesh: Mesh, axis: str | None = None) -> None:
        """Re-home the store on a new (survivor) mesh — the live elastic
        reshard's store leg, on each surviving rank. Replicated entries
        stay (every rank holds the same value) with their epochs;
        axis-SHARDED entries (scatter-path grad flats, ZeRO-3 param
        flats) are dropped, their payloads being padded for the OLD rank
        count: their owner re-commits them in the new layout. The
        error-feedback residuals reset for the same reason."""
        if mesh.device != self.device:
            raise ClusterError(f"TensorStore.reshard: mesh device "
                               f"{mesh.device} is not the store's "
                               f"{self.device}")
        axis = axis or self.axis
        axis_group(mesh, axis)
        self._settle()
        with self._lock:
            for key, entry in list(self._entries.items()):
                seq = self._stamp_locked(key)  # a re-home is a mutation
                if entry.binding.spec:
                    del self._entries[key]
                else:
                    self._entries[key] = _Entry(entry.value, entry.epoch,
                                                entry.binding, seq)
            self._residuals.clear()
            self._outer_residuals.clear()
            self.mesh = mesh
            self.axis = axis

    def delete(self, key: str) -> None:
        self._settle()
        with self._lock:
            if key not in self._entries:
                raise NoKeyError(key)
            del self._entries[key]
            self._stamp_locked(key)  # a deletion is a mutation
        if self._kv is not None:
            try:
                self._kv.delete(self._manifest_key(key))
            except NoKeyError:
                pass

    def keys(self) -> list[str]:
        self._settle()
        with self._lock:
            return sorted(self._entries)

    def epoch(self, key: str) -> int:
        self._settle()
        with self._lock:
            entry = self._entries.get(key)
        if entry is None:
            raise NoKeyError(key)
        return entry.epoch

    def tree_seq(self, prefix: str) -> int:
        """Highest write stamp under ``prefix/`` (0 when never written;
        deletions count). A writer that recorded this after its own
        put_tree detects whether ANY other writer touched the
        namespace since — the trainer's re-pull guard."""
        self._settle()
        with self._lock:
            return self._prefix_seq.get(prefix, 0)

    def _stamp_locked(self, key: str) -> int:
        self._seq += 1
        parts = key.split("/")
        for i in range(1, len(parts)):
            self._prefix_seq["/".join(parts[:i])] = self._seq
        return self._seq

    # ------------------------------------------------------------- push

    def push(self, key: str, local, op: str | None = None) -> torch.Tensor:
        """Reduce every rank's contribution into the key (the allreduce
        lowering of Store.Put) through the same single-bucket program as
        the tree pushes, int8 error feedback included; store and return
        the reduction."""
        op = op or self.binding(key).reduce_op
        local = torch.as_tensor(local).to(self.device)
        with annotate(f"store.push/{key}"):
            # The fault seam inside the region: a straggler delay is
            # charged to the collective, like a slow allreduce.
            _store_fault("store.push", key)
            self._settle()
            items = [(key, local)]
            res = self._group_residuals(items)
            ores = self._pop_outer(key)
            try:
                outs = collectives.bucketed_all_reduce(
                    [local], self.mesh, self.axis, op, residuals=res,
                    outer_residuals=ores, **self._wire_kwargs(None))
            except BaseException:
                self._restore_residuals(items, res)
                self._restore_outer(key, ores)
                raise
            if res is not None:
                outs, new_res = outs
                self._store_residuals([key], new_res)
            self._store_outer(key, ores)
        return self._commit_reduced(key, outs[0])

    def push_scatter(self, key: str, local,
                     op: str | None = None) -> torch.Tensor:
        """Reduce-scatter variant: rank r keeps shard r of dim 0 (the
        binding becomes ``(axis,)``). Pull with ``gather=True`` to
        reassemble. int8-ineligible values ride exact."""
        _store_fault("store.push", key)
        self._settle()
        b = Binding((self.axis,), op or self.binding(key).reduce_op)
        local = torch.as_tensor(local).to(self.device)
        if (self.compress == "int8"
                and collectives.quantized_all_reduce_eligible(
                    tuple(local.shape), self.n, b.reduce_op)):
            reduced = collectives.quantized_reduce_scatter(
                local, self.mesh, self.axis, b.reduce_op,
                q_block=self.wire.q_block)
        else:
            wire = (local.to(torch.bfloat16) if self.compress == "bf16"
                    else local)
            reduced = collectives.reduce_scatter(wire, self.mesh, self.axis,
                                                 b.reduce_op)
        if self.compress:
            reduced = reduced.to(local.dtype)
        return self._commit(key, reduced, b)

    def _commit(self, key: str, value: torch.Tensor,
                b: Binding) -> torch.Tensor:
        with self._lock:
            prev = self._entries.get(key)
            epoch = (prev.epoch + 1) if prev else 1
            self._entries[key] = _Entry(value, epoch, b,
                                        self._stamp_locked(key))
        self._publish(key)
        chaos.note_ok("store.push", key)
        return value

    def commit_sharded(self, key: str, flat: torch.Tensor) -> torch.Tensor:
        """Commit this rank's ALREADY-SHARDED flat under ``key`` with push
        epoch semantics (the ZeRO-3 trainer's per-step param commit). No
        collective, no copy."""
        self._settle()
        return self._commit(key, flat, Binding((self.axis,)))

    def _commit_reduced(self, key: str, out: torch.Tensor) -> torch.Tensor:
        """Place under the key's binding and commit: the per-key tail of
        every push path."""
        kb = self.binding(key)
        if kb.spec:
            out = self._place(out, kb.spec)
        return self._commit(key, out, kb)

    # -------------------------------------------------------------- tree

    def put_tree(self, prefix: str, tree: dict) -> int:
        """Place every leaf under its path-derived key (no collective),
        epoch 0. Returns the highest write stamp THIS call assigned —
        what a caller records to detect other writers."""
        self._settle()
        pairs = _flatten(prefix, tree)
        arrs = [self._place(leaf, self.binding(key).spec)
                for key, leaf in pairs]
        with self._lock:
            for (key, _), arr in zip(pairs, arrs):
                self._entries[key] = _Entry(arr, 0, self.binding(key),
                                            self._stamp_locked(key))
            assigned = self._seq
        for key, _ in pairs:
            self._publish(key)
        return assigned

    def push_tree(self, prefix: str, tree: dict, op: str | None = None, *,
                  bucketed: bool = True,
                  bucket_bytes: int | None = None) -> dict:
        """Push every leaf of a tree of this rank's contributions.

        Bucketed (the default): leaves group by reduce op, pack into
        same-dtype flat buckets, and reduce with one collective a
        bucket, every bucket on the wire before the first wait; the
        compression policy applies per bucket. Each key then commits
        its view (epoch bump, binding, manifest) as a per-leaf
        :meth:`push` would. ``bucketed=False`` pushes leaf by leaf.
        Returns ``{key: reduced}``."""
        pairs = _flatten(prefix, tree)
        if not bucketed:
            return {key: self.push(key, leaf, op) for key, leaf in pairs}
        t0 = _time.perf_counter()
        groups = self._push_groups(pairs, op)
        reduced: dict[str, torch.Tensor] = {}
        with annotate(f"store.push_tree/{prefix}"):
            _store_fault("store.push", prefix)
            self._settle()
            for group_op, items in groups.items():
                res = self._group_residuals(items)
                site = f"{prefix}|{group_op}"
                ores = self._pop_outer(site)
                try:
                    outs = collectives.bucketed_all_reduce(
                        [leaf for _, leaf in items], self.mesh, self.axis,
                        group_op, residuals=res, outer_residuals=ores,
                        **self._wire_kwargs(bucket_bytes))
                except BaseException:
                    self._restore_residuals(items, res)
                    self._restore_outer(site, ores)
                    raise
                if res is not None:
                    outs, new_res = outs
                    self._store_residuals([k for k, _ in items], new_res)
                self._store_outer(site, ores)
                for (key, _), out in zip(items, outs):
                    reduced[key] = out
        out = {key: self._commit_reduced(key, reduced[key])
               for key, _ in pairs}
        metrics.timing("store.push_tree").observe(_time.perf_counter() - t0)
        metrics.counter("store.push_tree.leaves").add(len(pairs))
        chaos.note_ok("store.push", prefix)
        return out

    def _push_groups(self, pairs, op: str | None) -> dict:
        """(key, leaf) pairs grouped by resolved reduce op (op=None
        honours each key's binding), leaves on the mesh's device."""
        groups: dict[str, list] = {}
        for key, leaf in pairs:
            resolved = op or self.binding(key).reduce_op
            groups.setdefault(resolved, []).append(
                (key, torch.as_tensor(leaf).to(self.device)))
        return groups

    def _wire_kwargs(self, bucket_bytes: int | None) -> dict:
        return {"bucket_bytes": bucket_bytes or self.wire.bucket_bytes,
                "compress": self.compress,
                "int8_min_bytes": self.wire.int8_min_bytes,
                "q_block": self.wire.q_block, "topology": self.topology}

    def _leg_armed(self, leg: str) -> bool:
        """Whether the topology's ``leg`` resolves to int8 with error
        feedback on."""
        t = self.topology
        if t is None or not self.wire.error_feedback:
            return False
        return t.resolve_leg(leg, self.compress, self.wire.q_block)[0] == \
            "int8"

    def _feedback_armed(self) -> bool:
        """Per-leaf feedback is armed by the int8+EF wire, or by a
        topology whose inner leg (which carries the per-leaf residual)
        resolves to int8 while the wire is exact."""
        return self.wire.feedback_armed or self._leg_armed(INNER_AXIS)

    def _group_residuals(self, items) -> list | None:
        """Per-leaf EF residuals for one push group (None when the wire
        carries no feedback; missing entries stay None and seed zeros).
        POPPED, not read: a concurrent pusher of the same key folds
        zeros instead of applying the same error twice."""
        if not self._feedback_armed():
            return None
        with self._lock:
            return [self._residuals.pop(key, None) for key, _ in items]

    def _store_residuals(self, keys, new_res: list) -> None:
        with self._lock:
            for key, r in zip(keys, new_res):
                if r is not None:
                    self._residuals[key] = r

    def _restore_residuals(self, items, popped: list | None) -> None:
        """Put popped-but-unconsumed residuals back (a failed push must
        not drop accumulated error), never over a fresher one."""
        if popped is None:
            return
        with self._lock:
            for (key, _), r in zip(items, popped):
                if r is not None:
                    self._residuals.setdefault(key, r)

    def _pop_outer(self, site: str) -> dict | None:
        """A push site's outer-leg residuals, popped (the collectives
        update the dict in place a bucket; :meth:`_store_outer` puts it
        back); None unless the outer leg carries int8 feedback."""
        if not self._leg_armed(OUTER_AXIS):
            return None
        with self._lock:
            return self._outer_residuals.pop(site, {})

    def _store_outer(self, site: str, ores: dict | None) -> None:
        """Write a push's outer residuals back: its buckets' are the
        freshest."""
        if ores:
            with self._lock:
                self._outer_residuals.setdefault(site, {}).update(ores)

    def _restore_outer(self, site: str, ores: dict | None) -> None:
        """A failed push's popped outer residuals back, never over a
        fresher one."""
        if ores:
            with self._lock:
                cur = self._outer_residuals.setdefault(site, {})
                for bi, r in ores.items():
                    cur.setdefault(bi, r)

    def _settle(self, upto: _Push | None = None) -> None:
        """Wait and commit in-flight stream buckets in dispatch order —
        all of them, or through ``upto``."""
        with self._lock:
            if upto is not None and upto.done:
                return
            while self._inflight:
                h = self._inflight.pop(0)
                h._finish()
                if h is upto:
                    return

    def _stream(self, prefix: str, tree: dict, op: str | None,
                bucket_bytes: int | None, scatter: bool):
        """The body of both stream pushes: per op group, dispatch one
        bucket an iteration and yield its handle. Residuals an int8
        bucket consumed come back with its wait; the rest are restored
        when the group ends, however it ends."""
        pairs = _flatten(prefix, tree)
        t0 = _time.perf_counter()
        groups = self._push_groups(pairs, op)
        stream = (collectives.bucketed_reduce_scatter_stream if scatter
                  else collectives.bucketed_all_reduce_stream)
        first, bucket_no = True, 0
        for group_op, items in groups.items():
            res = self._group_residuals(items)
            site = f"{prefix}|{group_op}"
            ores = self._pop_outer(site)
            pending = ({i: r for i, r in enumerate(res) if r is not None}
                       if res is not None else {})
            done = False
            try:
                it = stream([leaf for _, leaf in items], self.mesh,
                            self.axis, group_op, residuals=res,
                            outer_residuals=ores,
                            **self._wire_kwargs(bucket_bytes))
                while True:
                    # Each bucket's dispatch in its own region: the
                    # consumer's work between buckets is not charged
                    # to the collective.
                    with annotate(f"store.push_tree/{prefix}"):
                        if first:
                            _store_fault("store.push", prefix)
                            self._settle()
                            first = False
                        try:
                            b, red = next(it)
                        except StopIteration:
                            break
                        keys = [items[s.index][0] for s in b.slots]
                        if red.wire == "int8" and res is not None:
                            for s in b.slots:
                                pending.pop(s.index, None)
                        if scatter:
                            h = ShardPush(self, prefix, red, bucket_no,
                                          f"{prefix}/bucket{bucket_no:05d}",
                                          keys, group_op)
                            bucket_no += 1
                        else:
                            h = BucketPush(self, prefix, red, keys)
                        with self._lock:
                            self._inflight.append(h)
                    yield h
                done = True
            finally:
                if not done:
                    # Abandoned: every dispatched bucket still commits,
                    # as the reference's commit at dispatch does.
                    self._settle()
                if pending:
                    with self._lock:
                        for i, r in pending.items():
                            self._residuals.setdefault(items[i][0], r)
                self._store_outer(site, ores)
        metrics.timing("store.push_tree").observe(_time.perf_counter() - t0)
        metrics.counter("store.push_tree.leaves").add(len(pairs))
        chaos.note_ok("store.push", prefix)

    def push_tree_iter(self, prefix: str, tree: dict, op: str | None = None,
                       *, bucket_bytes: int | None = None):
        """The fine-grained-overlap variant of :meth:`push_tree`: a
        generator that dispatches ONE bucket's collective an iteration
        and yields its :class:`BucketPush`, so a consumer can wait and
        apply bucket i while bucket i+1 is on the wire."""
        return self._stream(prefix, tree, op, bucket_bytes, scatter=False)

    def push_tree_scatter_iter(self, prefix: str, tree: dict,
                               op: str | None = None, *,
                               bucket_bytes: int | None = None):
        """The ZeRO gradient leg: reduce-SCATTER every bucket, this rank
        keeping one contiguous flat shard a bucket, committed under
        ``<prefix>/bucketNNNNN`` with an ``(axis,)`` binding (pullable
        with ``gather=True``). Yields :class:`ShardPush` handles.
        Error-feedback residuals are keyed per LEAF, as on the
        allreduce paths, so a trainer switching paths carries them."""
        return self._stream(prefix, tree, op, bucket_bytes, scatter=True)

    def push_tree_stream(self, prefix: str, tree: dict,
                         op: str | None = None, *,
                         bucket_bytes: int | None = None) -> list:
        """:meth:`push_tree_iter` drained: every bucket dispatched,
        handles returned in bucket order for the caller to wait."""
        return list(self.push_tree_iter(prefix, tree, op,
                                        bucket_bytes=bucket_bytes))

    def get_tree(self, prefix: str, gather: bool = False) -> dict:
        """All keys under ``prefix/`` as a flat dict; ``gather=True``
        gives sharded keys whole. A ``store.pull_tree/<prefix>``
        region."""
        with annotate(f"store.pull_tree/{prefix}"):
            _store_fault("store.pull", prefix)
            self._settle()
            sep = prefix + "/"
            with self._lock:
                hits = {k: e for k, e in self._entries.items()
                        if k.startswith(sep)}
            if not hits:
                raise NoKeyError(prefix)
            out = {k: (self._gathered(e) if gather else e.value)
                   for k, e in sorted(hits.items())}
            chaos.note_ok("store.pull", prefix)
            return out

    # ---------------------------------------------------------- manifest

    def _manifest_key(self, key: str) -> str:
        return f"{TENSOR_PREFIX}/{self.namespace}/{key}"

    def _describe(self, entry: _Entry) -> dict:
        shape = list(entry.value.shape)
        if entry.binding.spec and shape:
            shape[0] *= self.n  # the whole value's shape, as the reference
        return {"shape": shape,
                "dtype": collectives.dtype_name(entry.value.dtype),
                "spec": spec_to_json(entry.binding.spec),
                "epoch": entry.epoch}

    def _publish(self, key: str) -> None:
        """Best-effort manifest publish + catch-up of earlier misses.
        Manifests are discovery metadata: a control-plane outage lags
        them and never fails the push; keys whose publish failed are
        republished on the next successful contact."""
        if self._kv is None or not self._try_publish(key):
            return
        with self._lock:
            missed = [k for k in self._manifest_failed
                      if k != key and k in self._entries]
        recovered = [k for k in missed if self._try_publish(k)]
        if recovered:
            log.info("manifest publishing recovered",
                     kv={"republished": len(recovered)})

    def _try_publish(self, key: str) -> bool:
        with self._lock:
            desc = self._describe(self._entries[key])
        try:
            self._kv.put(self._manifest_key(key),
                         json.dumps(desc, separators=(",", ":")))
        except CoordinationError as e:
            with self._lock:
                self._manifest_failed.add(key)
            log.warning("manifest publish failed; will retry on next "
                        "successful publish",
                        kv={"key": key, "err": str(e)})
            return False
        with self._lock:
            self._manifest_failed.discard(key)
        return True

    def manifest(self) -> dict[str, dict]:
        """Key → {shape, dtype, spec, epoch} for the whole namespace."""
        self._settle()
        with self._lock:
            return {k: self._describe(e) for k, e in self._entries.items()}


def _flatten(prefix: str, tree: dict) -> list[tuple[str, object]]:
    """Tree → (key, leaf) pairs with path-derived key names, sorted by
    key string (the reference's order)."""
    return sorted((("/".join((prefix,) + path), leaf)
                   for path, leaf in collectives.tree_flatten(tree)),
                  key=lambda kv: kv[0])



# ---------------------------------------------------------------- probes


def measure_push_tree(mesh: Mesh, axis="data", preset: str = "tiny",
                      iters: int = 3, compress: str | None = None,
                      bucket_bytes: int | None = None,
                      wire: collectives.WireConfig | None = None,
                      topology=None, device=None) -> dict:
    """Wall-clock a full param-tree gradient push, bucketed against
    per-leaf — the ``store_push_tree_ms`` metric.

    Builds the ``preset`` transformer's parameter tree (seed 0), pushes
    it as this rank's contribution (the reference stacks one copy a
    device) and times ``push_tree`` both ways after a warm push, the
    device drained before each clock read. GB/s is the ring convention,
    2(n-1)/n of the tree's bytes a rank: 0.0 at world 1, where the
    milliseconds time the bucketing alone. Every rank must call."""
    from ptype_tpu_torch.models import transformer as tfm
    from ptype_tpu_torch.models.weights import init_params

    device = resolve_device(device)
    cfg = tfm.preset(preset)
    params = init_params(torch.Generator(device=device).manual_seed(0),
                         cfg, device=device)
    n = axis_n(mesh, axis)
    store = TensorStore(mesh, axis, compress=compress, wire=wire,
                        topology=topology, device=device)
    leaves = [t for _, t in collectives.tree_flatten(params)]
    nbytes = sum(t.numel() * t.element_size() for t in leaves)

    def timed(bucketed: bool) -> float:
        store.push_tree("g", params, op="mean", bucketed=bucketed,
                        bucket_bytes=bucket_bytes)
        collectives._drain(device)
        t0 = _time.perf_counter()
        for _ in range(iters):
            store.push_tree("g", params, op="mean", bucketed=bucketed,
                            bucket_bytes=bucket_bytes)
        collectives._drain(device)
        return (_time.perf_counter() - t0) / iters

    per_leaf = timed(False)
    bucketed = timed(True)
    plan = collectives.plan_buckets(
        leaves, n, bucket_bytes or collectives.DEFAULT_BUCKET_BYTES)
    return {
        "bucketed_ms": round(bucketed * 1e3, 2),
        "per_leaf_ms": round(per_leaf * 1e3, 2),
        "speedup": round(per_leaf / bucketed, 2) if bucketed else None,
        "n_leaves": len(leaves),
        "n_buckets": len(plan),
        "payload_mb": round(nbytes / 2**20, 2),
        "gbps": round(2 * (n - 1) / n * nbytes / bucketed / 1e9, 2),
    }
