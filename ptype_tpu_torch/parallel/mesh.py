"""Named-axis meshes over a ``torch.distributed`` process group — the
port of ``ptype_tpu/parallel/mesh.py``.

The reference is one controller: a ``jax.sharding.Mesh`` lays the n
devices of one process out on named axes. The port runs one process per
rank, so a :class:`Mesh` is the same axis layout over a process group:
this process is the rank-th position of the flattened axes (outer to
inner), and holds one device, ``mesh.device``. Collectives over an axis
are collectives over the group (``parallel/collectives.py``).

The process group comes from an explicit rendezvous,
:func:`init_distributed`: NCCL for ``cuda``, gloo for ``device="cpu"``.
There is no fallback from one backend to the other, and a mesh whose
axes do not cover the group exactly is refused, never shrunk to size 1.

Placements are the reference's partition specs written as tuples:
``()`` replicated, ``(axis,)`` dim 0 split into contiguous shards, rank
r holding shard r (:func:`replicated`).

Not ported: ``mesh_from_registry`` (the cluster plane, ROADMAP A8).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from ptype_tpu_torch.device import resolve_device
from ptype_tpu_torch.errors import ClusterError

#: The backend each device type's process group must use.
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


@dataclass(frozen=True, eq=False)
class Mesh:
    """Named axes over a process group, seen from one rank."""

    axis_names: tuple
    #: axis name → size, in axis order (``mesh.shape[name]``).
    shape: dict = field(hash=False)
    group: object
    rank: int
    device: torch.device

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)


def init_distributed(init_method: str, rank: int, world_size: int,
                     device=None) -> torch.device:
    """Join the default process group by an explicit rendezvous
    (``file:///path`` or ``tcp://host:port``) with the backend of the
    device: NCCL for ``cuda`` (unless the caller names another device,
    as for :func:`~ptype_tpu_torch.device.resolve_device`), gloo for
    ``cpu``. On ``cuda`` rank r takes card ``r % device_count``.
    Returns the device this rank computes on."""
    device = resolve_device(device)
    if device.type not in BACKENDS:
        raise ClusterError(f"init_distributed: no backend for {device}")
    if device.type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    dist.init_process_group(BACKENDS[device.type], init_method=init_method,
                            rank=int(rank), world_size=int(world_size))
    return device


def build_mesh(axes: dict[str, int], axis_names: tuple[str, ...] | None = None,
               group=None, device=None) -> Mesh:
    """A :class:`Mesh` over ``group`` (the default group when None)
    whose axis product is the group's size. ``axes`` is ordered (outer
    → inner); ``axis_names`` reorders or subsets it. ``device`` is this
    rank's device (cuda unless named; on cuda, the current card), and
    must match the group's backend: a cuda mesh never runs on gloo."""
    if not axes:
        raise ClusterError("build_mesh: no mesh axes configured")
    pairs = [(name, int(size)) for name, size in axes.items()]
    if axis_names is not None:
        by_name = dict(pairs)
        missing = [n for n in axis_names if n not in by_name]
        if missing:
            raise ClusterError(f"build_mesh: unknown axes {missing}")
        pairs = [(n, by_name[n]) for n in axis_names]
    if not dist.is_initialized():
        raise ClusterError("build_mesh: no process group; call "
                           "init_distributed first")
    group = group if group is not None else dist.group.WORLD
    need, have = math.prod(s for _, s in pairs), dist.get_world_size(group)
    if need != have:
        raise ClusterError(f"build_mesh: axes {dict(pairs)} need {need} "
                           f"ranks, the process group has {have}")
    device = resolve_device(device)
    backend = dist.get_backend(group)
    if BACKENDS.get(device.type) != backend:
        raise ClusterError(f"build_mesh: a {device.type} mesh needs the "
                           f"{BACKENDS.get(device.type)} backend, the group "
                           f"runs {backend}")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return Mesh(tuple(n for n, _ in pairs), dict(pairs), group,
                dist.get_rank(group), device)


def local_mesh(device=None, **axes: int) -> Mesh:
    """Convenience: ``local_mesh(data=8)`` over the default group."""
    return build_mesh(axes, device=device)


def axis_size(mesh: Mesh, name: str) -> int:
    """Size of a mesh axis, 1 if the axis is absent (strategy degrade)."""
    return int(mesh.shape[name]) if name in mesh.axis_names else 1


def axis_n(mesh: Mesh, axis) -> int:
    """Total extent of ``axis``: one name, or a tuple of names (a
    composite axis), whose sizes multiply."""
    if isinstance(axis, tuple):
        return int(math.prod(int(mesh.shape[a]) for a in axis))
    return int(mesh.shape[axis])


def axis_group(mesh: Mesh, axis):
    """The process group a collective over ``axis`` runs on. The port's
    collectives span the whole group, so ``axis`` must cover every rank
    (the other axes of size 1); sub-axis groups come with the trainer's
    shardings (ROADMAP A7)."""
    if axis_n(mesh, axis) != mesh.size:
        raise NotImplementedError(
            f"collectives over axis {axis!r} of a mesh {mesh.shape}: only "
            "an axis that spans every rank is ported (sub-axis groups: "
            "ROADMAP A7, the trainer's shardings)")
    return mesh.group


def axis_index(mesh: Mesh, axis) -> int:
    """This rank's linear index along ``axis`` (its shard number)."""
    axis_group(mesh, axis)
    return mesh.rank


def replicated(mesh: Mesh) -> tuple:
    """The replicated placement: every rank holds the whole value."""
    return ()
