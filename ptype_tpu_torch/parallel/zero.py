"""ZeRO-style sharded optimizer update — reduce-scatter → shard-local
apply → allgather over the TensorStore's bucket space; the port of
``ptype_tpu/parallel/zero.py`` (after "Automatic Cross-Replica Sharding
of Weight Update in Data-Parallel Training", arXiv 2004.13336).

The ladder over the flat bucket space:

- **ZeRO-1** (:meth:`ZeroState.apply_bucket_full`): optimizer state
  sharded; grads arrive as whole allreduced leaves, and each rank
  slices its shard of params and grads;
- **ZeRO-2** (:meth:`ZeroState.apply_bucket`): grads ride the bucketed
  reduce-scatter and arrive as this rank's shard;
- **ZeRO-3** (:meth:`ZeroState.apply_bucket3` + :meth:`gather_bucket`):
  params are resident as flat shards too, allgathered just in time for
  the forward; the update is elementwise, in place on the shards.

:class:`ShardPlan` partitions the space with the gradient stream's own
planner (``plan_buckets`` over the leaves in store-sorted key order),
so rank r owns the same elements as the reference's device r: shard r
of every bucket. Bucket boundaries depend only on leaf order, dtypes
and ``bucket_bytes``, never on the rank count (only the tail pads do),
which makes saved state reshardable (:meth:`ZeroState.load_state_tree`).

Each rank holds its shards as plain tensors on the mesh's device. The
update is the recipe's one AdamW arithmetic
(``train/trainer.py`` :func:`adamw_leaf_`) on f32 flats, the decay
mask packed as a 0/1 vector. The global-norm clip is the recipe's one
cross-shard coupling: each rank's per-bucket square sums of its shards
are PARTIAL sums, allreduced (summed over ranks) into the global norm,
a device value the host never reads. The reference gets the same sum
from XLA, a ``jnp.sum`` over a sharded flat being global.

Live elasticity rides the same math: :meth:`ZeroState.reshard` applies
the ``ZeroCheckpoint`` re-pad in memory (strip the old tail pad, re-pad
for the survivor count, keep this rank's new shard), staged and swapped
in only after the last bucket lands, with the ``train.reshard`` chaos
seam decided once, on rank 0, for every rank. The move runs over the
OLD group while every old rank still answers; a rank whose process is
gone cannot hand over its shard, and then the way back is
``ZeroCheckpoint`` (the reshard raises ``ClusterError``).

Not ported yet (ROADMAP): ``compiled_cost`` (with the profiling module).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ptype_tpu_torch import chaos
from ptype_tpu_torch.checkpoint import Shard
from ptype_tpu_torch.errors import CheckpointError, ClusterError
from ptype_tpu_torch.parallel import collectives
from ptype_tpu_torch.parallel.collectives import (DEFAULT_BUCKET_BYTES,
                                                  Bucket, _unpack,
                                                  plan_buckets, torch_dtype)
from ptype_tpu_torch.parallel.mesh import (agreed_drop, axis_group,
                                           axis_index, axis_n)
from ptype_tpu_torch.train.trainer import adamw_leaf_, clip_scale

#: zero_plan.json schema version.
PLAN_VERSION = 1


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """Partition of the flat bucket space across ``n`` ranks: rank r
    owns the contiguous shard r (``elems/n``) of every bucket."""

    n: int
    bucket_bytes: int
    buckets: tuple  # tuple[Bucket, ...]

    @staticmethod
    def for_leaves(leaves, n: int,
                   bucket_bytes: int = DEFAULT_BUCKET_BYTES) -> "ShardPlan":
        """Plan over the leaves as a rank holds them (params; anything
        with ``shape`` and ``dtype``): the gradient stream's slots."""
        return ShardPlan(n, int(bucket_bytes),
                         tuple(plan_buckets(leaves, n, bucket_bytes)))

    def with_n(self, n: int) -> "ShardPlan":
        """The SAME flat space re-padded for ``n`` ranks: slots
        untouched, only the tail pads change."""
        n = int(n)
        if n <= 0:
            raise ValueError(f"with_n: need n >= 1, got {n}")
        buckets = tuple(dataclasses.replace(b, pad=(-(b.elems - b.pad)) % n)
                        for b in self.buckets)
        return ShardPlan(n, self.bucket_bytes, buckets)

    @property
    def n_slots(self) -> int:
        return sum(len(b.slots) for b in self.buckets)

    def shard_elems(self, bucket: Bucket) -> int:
        return bucket.elems // self.n

    def moment_bytes_per_replica(self, itemsize: int = 4) -> int:
        """Adam mu+nu bytes each rank holds under this plan."""
        return sum(2 * self.shard_elems(b) * itemsize for b in self.buckets)

    def manifest(self) -> dict:
        """JSON-able description: a restore validates it and re-pads for
        another rank count."""
        return {
            "version": PLAN_VERSION,
            "n": self.n,
            "bucket_bytes": self.bucket_bytes,
            "buckets": [
                {"dtype": b.dtype, "pad": b.pad,
                 "slots": [{"index": s.index, "offset": s.offset,
                            "size": s.size, "shape": list(s.shape)}
                           for s in b.slots]}
                for b in self.buckets],
        }


def check_plan_compatible(saved: dict, current: dict) -> None:
    """A saved plan restores into the current one iff the bucket SLOTS
    match exactly; only ``n`` and the tail pads may differ (the reshard
    case). Anything else is another flat space and fails loudly."""
    if saved.get("version") != PLAN_VERSION:
        raise CheckpointError(
            f"zero restore: plan version {saved.get('version')!r} != "
            f"{PLAN_VERSION}")

    def slots_of(m):
        return [(b["dtype"], [{**s, "shape": list(s["shape"])}
                              for s in b["slots"]]) for b in m["buckets"]]

    if slots_of(saved) != slots_of(current):
        raise CheckpointError(
            "zero restore: saved shard plan does not match this "
            "trainer's (different parameter space or bucket_bytes) — "
            f"saved {len(saved['buckets'])} buckets / "
            f"{sum(len(b['slots']) for b in saved['buckets'])} slots, "
            f"current {len(current['buckets'])} buckets / "
            f"{sum(len(b['slots']) for b in current['buckets'])} slots")


class ZeroState:
    """The sharded optimizer state of THIS rank: per-bucket flat Adam
    moments (``mu``/``nu``, f32, ``elems/n`` each), the packed decay
    masks, the shared step ``count``, and under ZeRO-3 the resident
    param shards (``pflat``)."""

    def __init__(self, plan: ShardPlan, mesh, axis: str, hparams,
                 mask_flats: list, mu: list, nu: list, count: int = 0,
                 pflat: list | None = None):
        self.plan = plan
        self.mesh = mesh
        self.axis = axis
        self.hparams = hparams
        self._masks = mask_flats
        self.mu = mu
        self.nu = nu
        self.count = int(count)
        #: ZeRO-3 only: per-bucket resident param shards (bucket
        #: dtype), installed by :meth:`scatter_params`.
        self.pflat = pflat
        self._schedule = hparams.schedule()

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    def _shard(self, flat: torch.Tensor) -> torch.Tensor:
        """This rank's contiguous shard of a full bucket flat (a view)."""
        s = flat.shape[0] // self.plan.n
        r = axis_index(self.mesh, self.axis)
        return flat[r * s:(r + 1) * s]

    @staticmethod
    def create(plan: ShardPlan, mesh, axis: str, hparams,
               mask_leaves: list) -> "ZeroState":
        """Moments sharded from step 0 (zeros of this rank's shard size
        only) and the decay mask (True = decay; ``mask_leaves`` aligned
        with the plan's slots) packed into per-bucket f32 flats."""
        if axis_n(mesh, axis) != plan.n:
            raise ValueError(f"ZeroState: plan for {plan.n} ranks on a "
                             f"{axis_n(mesh, axis)}-rank axis")
        state = ZeroState(plan, mesh, axis, hparams, [], [], [])
        for b in plan.buckets:
            vec = np.zeros((b.elems,), np.float32)
            for s in b.slots:
                if bool(mask_leaves[s.index]):
                    vec[s.offset:s.offset + s.size] = 1.0
            state._masks.append(
                state._shard(torch.from_numpy(vec)).to(mesh.device))
            # Moments are f32 whatever the param dtype.
            for acc in (state.mu, state.nu):
                acc.append(torch.zeros(plan.shard_elems(b),
                                       dtype=torch.float32,
                                       device=mesh.device))
        return state

    # ----------------------------------------------- ZeRO-3 residency

    @torch.no_grad()
    def scatter_params(self, param_leaves: list) -> None:
        """Install the params as the RESIDENT sharded layout (ZeRO-3):
        each bucket's leaves (plan slot order) packed, padded with
        zeros, and this rank's shard kept. After this the trainer holds
        no replicated params; :meth:`gather_bucket` materializes them."""
        self.pflat = []
        for b in self.plan.buckets:
            flat = collectives._pack_flat([param_leaves[s.index].to(
                self.device, torch_dtype(b.dtype)) for s in b.slots], b.pad)
            self.pflat.append(self._shard(flat).clone())

    def gather_bucket(self, bi: int) -> list:
        """Full params of bucket ``bi``, slot order: one allgather of the
        resident shards, unpacked into views of one transient buffer."""
        b = self.plan.buckets[bi]
        group, n = axis_group(self.mesh, self.axis), self.plan.n
        flat = collectives._gather(self.pflat[bi], group, n).reshape(-1)
        return _unpack(flat, b.slots)

    def gather_params(self) -> list:
        """Full param leaves (plan slot order): the one full-tree
        materialization under ZeRO-3 (``params()``, export, eval)."""
        if self.pflat is None:
            raise ValueError("gather_params: no resident param shards "
                             "(ZeRO-3 only; call scatter_params first)")
        out = [None] * self.plan.n_slots
        for bi, b in enumerate(self.plan.buckets):
            for s, leaf in zip(b.slots, self.gather_bucket(bi)):
                out[s.index] = leaf
        return out

    # --------------------------------------------------------- step ops

    @staticmethod
    def partial_sqnorm(flat: torch.Tensor) -> torch.Tensor:
        """Σ x² of one flat in f32 (this rank's shard: a partial sum)."""
        f = flat.to(torch.float32)
        return torch.sum(f * f)

    def clip_scale(self, sqnorms: list, partial: bool = True) -> torch.Tensor:
        """The global-norm clip scale from per-bucket square sums, a
        device value. ``partial``: the sums are over this rank's shards
        (ZeRO-2/3), so the per-bucket vector is summed over the ranks
        first (bucket by bucket, then over buckets: the reference's
        order); ZeRO-1's sums are over whole leaves and already global."""
        sq = torch.stack(sqnorms)
        if partial:
            sq = collectives.all_reduce(sq, self.mesh, self.axis, "sum")
        return clip_scale(torch.sum(sq), float(self.hparams.clip))

    @torch.no_grad()
    def _adamw_shard(self, bi: int, p_sh: torch.Tensor, g_sh: torch.Tensor,
                     scale: torch.Tensor) -> None:
        """AdamW on one bucket's shard, in place on ``p_sh`` and the
        bucket's moments."""
        g32 = g_sh.to(torch.float32) * scale
        adamw_leaf_(p_sh, g32, self.mu[bi], self.nu[bi], self._masks[bi],
                    self.count, self.hparams,
                    float(self._schedule(self.count)))

    def _gather_update(self, bi: int, p_sh: torch.Tensor) -> list:
        """Allgather the updated shards into the bucket's new leaves."""
        group, n = axis_group(self.mesh, self.axis), self.plan.n
        flat = collectives._gather(p_sh, group, n).reshape(-1)
        return _unpack(flat, self.plan.buckets[bi].slots)

    @torch.no_grad()
    def apply_bucket(self, bi: int, param_leaves: list, grad_shard, scale):
        """ZeRO-2: shard-local AdamW from this rank's grad shard, then
        allgather; updates ``mu``/``nu`` and returns the new param
        leaves (slot order). Call :meth:`finish_step` once a step."""
        b = self.plan.buckets[bi]
        p_sh = self._shard(collectives._pack_flat(param_leaves, b.pad)).clone()
        self._adamw_shard(bi, p_sh, grad_shard, scale)
        return self._gather_update(bi, p_sh)

    @torch.no_grad()
    def apply_bucket_full(self, bi: int, param_leaves: list,
                          grad_leaves: list, scale):
        """ZeRO-1: whole (allreduced) grad leaves in; this rank slices
        its shard of params and grads; otherwise :meth:`apply_bucket`."""
        b = self.plan.buckets[bi]
        p_sh = self._shard(collectives._pack_flat(param_leaves, b.pad)).clone()
        g_sh = self._shard(collectives._pack_flat(grad_leaves, b.pad))
        self._adamw_shard(bi, p_sh, g_sh, scale)
        return self._gather_update(bi, p_sh)

    def apply_bucket3(self, bi: int, grad_shard, scale) -> torch.Tensor:
        """ZeRO-3: elementwise, in place on the resident shard and the
        moments (no collective). Returns the updated shard, for the
        trainer to commit to the store."""
        if self.pflat is None:
            raise ValueError("apply_bucket3: no resident param shards "
                             "(ZeRO-3 only; call scatter_params first)")
        self._adamw_shard(bi, self.pflat[bi], grad_shard, scale)
        return self.pflat[bi]

    def finish_step(self) -> None:
        self.count += 1

    # ------------------------------------------------------- accounting

    def moment_bytes_per_replica(self) -> int:
        """Measured: the bytes of this rank's resident moment shards."""
        return sum(t.numel() * t.element_size()
                   for t in list(self.mu) + list(self.nu))

    def param_bytes_per_replica(self) -> int:
        """Measured bytes of this rank's resident ZeRO-3 param shards (0
        when params are replicated: ZeRO-1/2)."""
        if self.pflat is None:
            return 0
        return sum(t.numel() * t.element_size() for t in self.pflat)

    # ------------------------------------------------- live resharding

    @torch.no_grad()
    def reshard(self, mesh, axis: str | None = None) -> None:
        """Re-place the WHOLE resident state (moments, masks, and the
        ZeRO-3 param flats) onto the survivor ``mesh`` — the
        ``ZeroCheckpoint`` reshard math in memory. Every rank of the OLD
        mesh calls, in step; a rank that leaves passes ``mesh=None``: it
        hands its shards over and keeps its old state. Each bucket's
        flats are allgathered over the old group, and a survivor keeps
        the rows of its new shard: values in ``[:total]`` are byte
        copies, so the moments are bit-preserved.

        ATOMIC: everything is staged and swapped in only after the last
        bucket lands. The ``train.reshard`` seam fires once a bucket on
        rank 0, and its decision reaches every rank before the bucket's
        collective, so a ``drop`` raises ``ClusterError`` on all of them
        with the old plan, group and shards intact (the caller retries).
        A collective that fails (a rank whose process is gone) raises
        ``ClusterError`` too: the way back is ``ZeroCheckpoint``."""
        axis = axis or self.axis
        old_group, old_n = axis_group(self.mesh, self.axis), self.plan.n
        new_plan = (None if mesh is None
                    else self.plan.with_n(axis_n(mesh, axis)))
        groups = [("mu", self.mu), ("nu", self.nu), ("mask", self._masks)]
        if self.pflat is not None:
            groups.append(("p", self.pflat))
        staged = {name: [] for name, _ in groups}
        for i, old_b in enumerate(self.plan.buckets):
            key = f"bucket{i:05d}"
            if agreed_drop(self.mesh, "train.reshard", key):
                raise ClusterError(f"chaos: reshard dropped at bucket {i} "
                                   "(plan unchanged; retry)")
            total = old_b.elems - old_b.pad
            for name, acc in groups:
                try:
                    full = collectives._gather(acc[i], old_group,
                                               old_n).reshape(-1)
                except RuntimeError as e:
                    raise ClusterError(
                        f"reshard: bucket {i} {name} could not be "
                        f"gathered from the old group ({e}); a rank "
                        "that is gone cannot hand over its shard — "
                        "restore from a ZeroCheckpoint") from e
                if new_plan is None:
                    continue
                s = new_plan.shard_elems(new_plan.buckets[i])
                lo = axis_index(mesh, axis) * s
                hi = min(lo + s, total)
                out = torch.zeros(s, dtype=full.dtype, device=mesh.device)
                if hi > lo:
                    out[:hi - lo].copy_(full[lo:hi])
                staged[name].append(out)
            # Per-bucket recovery beacon, paired with the bucket's hit.
            chaos.note_ok("train.reshard", key)
        if new_plan is None:
            return
        # -- atomic swap: nothing above mutated self.
        self.plan = new_plan
        self.mesh = mesh
        self.axis = axis
        self.mu = staged["mu"]
        self.nu = staged["nu"]
        self._masks = staged["mask"]
        if self.pflat is not None:
            self.pflat = staged["p"]
        chaos.note_ok("train.reshard", f"n={new_plan.n}")

    # ------------------------------------------------------- checkpoint

    def _full(self, shard: torch.Tensor) -> np.ndarray:
        group = axis_group(self.mesh, self.axis)
        return collectives._gather(shard, group, self.plan.n).reshape(
            -1).cpu().numpy()

    def state_tree(self) -> dict:
        """The checkpointable tree in the reference's layout, each flat
        whole (allgathered to the host: every rank must call): per-bucket
        moments, the ZeRO-3 param flats, and the schedule count. Masks
        are derived state, rebuilt from the params. A checkpoint writes
        :meth:`shard_tree` instead."""
        nb = len(self.plan.buckets)
        tree = {"buckets": {f"{i:05d}": {"mu": self._full(self.mu[i]),
                                         "nu": self._full(self.nu[i])}
                            for i in range(nb)},
                "count": np.int32(self.count)}
        if self.pflat is not None:
            tree["pbuckets"] = {f"{i:05d}": {"p": self._full(self.pflat[i])}
                                for i in range(nb)}
        return tree

    def shard_tree(self) -> dict:
        """:meth:`state_tree`'s layout with each flat as this rank's own
        :class:`~ptype_tpu_torch.checkpoint.Shard` (``start = rank ·
        shard_len``) — what ``ZeroCheckpoint`` writes: no flat is ever
        gathered whole."""
        r = axis_index(self.mesh, self.axis)

        def own(shard, b):
            return Shard(shard, (r * shard.shape[0],), (b.elems,))

        buckets = self.plan.buckets
        tree = {"buckets": {f"{i:05d}": {"mu": own(self.mu[i], b),
                                         "nu": own(self.nu[i], b)}
                            for i, b in enumerate(buckets)},
                "count": np.int32(self.count)}
        if self.pflat is not None:
            tree["pbuckets"] = {f"{i:05d}": {"p": own(self.pflat[i], b)}
                                for i, b in enumerate(buckets)}
        return tree

    def load_state_tree(self, tree: dict, saved_plan: dict) -> None:
        """Install a saved state (whole host flats: this package's
        :meth:`state_tree`, or the reference's as numpy), RE-SHARDING
        when the saved rank count differs: strip the old tail pad, pad
        for this plan, keep this rank's shard."""

        def read(path, lo, hi):
            node = tree
            for k in path:
                node = node[k]
            full = (node if torch.is_tensor(node)
                    else torch.from_numpy(np.array(node)))
            return full.reshape(-1), full[lo:hi]

        self._load(read, saved_plan, "pbuckets" in tree)
        # reshape(-1)[0]: a checkpointer may round-trip 0-d as (1,).
        self.count = int(np.asarray(tree["count"]).reshape(-1)[0])

    def load_shards(self, reader, saved_plan: dict) -> None:
        """Install a saved step from a checkpoint ``StepReader``, reading
        only the rows of this rank's new shards (the re-pad of
        :meth:`load_state_tree`, without materializing any flat)."""

        def read(path, lo, hi):
            key = ".".join(path)
            return reader.entry(key), reader.read(key, lo, hi)

        has_p = "pbuckets.00000.p" in reader.manifest["leaves"]
        self._load(read, saved_plan, has_p)
        self.count = int(reader.read("count").reshape(-1)[0])

    def _load(self, read, saved_plan: dict, has_p: bool) -> None:
        """The restore re-pad: for each bucket and flat, ``read(path, lo,
        hi)`` gives (the saved flat or its manifest entry, its rows
        ``[lo, hi)``); rows past the saved total are the new tail pad."""
        check_plan_compatible(saved_plan, self.plan.manifest())
        saved_buckets = saved_plan["buckets"]
        r = axis_index(self.mesh, self.axis)
        groups = [("mu", "buckets", self.mu), ("nu", "buckets", self.nu)]
        if self.pflat is not None and has_p:
            groups.append(("p", "pbuckets", self.pflat))
        for i, b in enumerate(self.plan.buckets):
            total = b.elems - b.pad
            want = total + int(saved_buckets[i]["pad"])
            s = self.plan.shard_elems(b)
            lo = min(r * s, total)
            hi = max(lo, min((r + 1) * s, total))
            for name, top, acc in groups:
                whole, rows = read((top, f"{i:05d}", name), lo, hi)
                shape = (tuple(whole["shape"]) if isinstance(whole, dict)
                         else tuple(whole.shape))
                if shape != (want,):
                    raise CheckpointError(
                        f"zero restore: bucket {i} {name} has "
                        f"{shape} elements, manifest says {want}")
                out = torch.zeros(s, dtype=acc[i].dtype)
                out[:rows.shape[0]] = rows.to(out.dtype)
                acc[i] = out.to(self.device)
