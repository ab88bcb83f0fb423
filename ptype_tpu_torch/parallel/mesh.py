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

Every axis, and every combination of axes, has its own process group
on each rank (:func:`axis_group`): :func:`build_mesh` makes the groups
of each single axis and of each composite of axes, every rank making
every group in one fixed order (``dist.new_group`` names a group by a
per-process count, so a rank that skipped one or took them out of order
would hang the others). Ranks lie outer → inner, as the reference lays
out devices: this rank's coordinate on an axis is :func:`axis_index`.

Placements are the reference's partition specs written as tuples, one
entry a dim: ``None`` replicated, an axis name or a tuple of them (a
composite, outer first) split into contiguous blocks, the block at the
rank's coordinate its own; ``()`` is replicated (:func:`replicated`).
:func:`shard_of` cuts this rank's block out of a full tensor and
:func:`gather` puts the full tensor back together.

Elastic resharding builds a **survivor mesh** (:func:`survivor_mesh`):
one data axis over a ``dist.new_group`` of the surviving ranks, made by
every rank of the current mesh (the leavers included). Host-side
decisions that every rank must share (the elastic membership view, a
reshard's chaos fault) travel over the mesh's **control group**: the
group itself on gloo, a gloo group beside it on NCCL (made by
:func:`build_mesh`), so agreeing on one costs no device synchronization.

:func:`mesh_from_registry` lowers a service's registry entries (the
cluster plane's mesh map) to a mesh over the current group.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from ptype_tpu_torch import chaos
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
    #: A gloo group over the same ranks for host-side agreement (the
    #: group itself on gloo).
    control: object
    #: This rank's process group on each sub-axis: a tuple of the
    #: non-trivial axes it spans (mesh order) → group; ``()`` is the
    #: rank alone. Axes that span the mesh use ``group``.
    groups: dict = field(default_factory=dict, hash=False)
    #: The gloo twins of ``groups`` on NCCL (``groups`` itself on gloo).
    controls: dict = field(default_factory=dict, hash=False)

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
    must match the group's backend: a cuda mesh never runs on gloo.

    On NCCL it also makes the mesh's gloo control group, and every
    group gets a gloo twin. Every rank of ``group`` calls, and so does
    every rank of the default group when ``group`` is not it, as for
    any ``dist.new_group``."""
    if not dist.is_initialized():
        raise ClusterError("build_mesh: no process group; call "
                           "init_distributed first")
    group = group if group is not None else dist.group.WORLD
    names, shape, device = _layout(axes, axis_names, group, device)
    backend = dist.get_backend(group)
    gloo = backend == "gloo"
    ranks = dist.get_process_group_ranks(group)
    control = group if gloo else dist.new_group(ranks, backend="gloo")
    me = dist.get_rank(group)
    groups, controls = {}, {}
    for key, members in _sub_axis_groups(names, shape):
        g = dist.new_group([ranks[p] for p in members], backend=backend)
        c = g if gloo or len(members) == 1 else dist.new_group(
            [ranks[p] for p in members], backend="gloo")
        if me in members:
            groups[key], controls[key] = g, c
    return Mesh(names, shape, group, me, device, control, groups, controls)


def _coords(position: int, names, shape) -> dict:
    """The axis coordinates of a mesh position (the last axis
    innermost)."""
    out = {}
    for name in reversed(names):
        out[name] = position % shape[name]
        position //= shape[name]
    return out


def _sub_axis_groups(names, shape):
    """``(key, member positions)`` of every group a mesh needs beyond
    its own, in one fixed order: for each proper subset of the
    non-trivial axes (the empty one too: each rank alone), one group
    per coordinate of the other axes, its members in mesh order. A mesh
    of one non-trivial axis or fewer needs none but the singletons."""
    import itertools

    live = [n for n in names if shape[n] > 1]
    if not live:
        return []
    size = math.prod(shape.values())
    out = []
    for k in range(len(live)):
        for key in itertools.combinations(live, k):
            by_rest: dict = {}
            for p in range(size):
                c = _coords(p, names, shape)
                rest = tuple(c[n] for n in live if n not in key)
                by_rest.setdefault(rest, []).append(p)
            out += [(key, members) for members in by_rest.values()]
    return out


def _layout(axes, axis_names, group, device):
    """The checked (axis names, shape, device) of a mesh over ``group``."""
    if not axes:
        raise ClusterError("build_mesh: no mesh axes configured")
    pairs = [(name, int(size)) for name, size in axes.items()]
    if axis_names is not None:
        by_name = dict(pairs)
        missing = [n for n in axis_names if n not in by_name]
        if missing:
            raise ClusterError(f"build_mesh: unknown axes {missing}")
        pairs = [(n, by_name[n]) for n in axis_names]
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
    return tuple(n for n, _ in pairs), dict(pairs), device


def group_ranks(mesh: Mesh) -> list[int]:
    """The global ranks of the mesh's group, in group order."""
    return dist.get_process_group_ranks(mesh.group)


def survivor_mesh(mesh: Mesh, ranks, axis: str = "data",
                  device=None) -> Mesh | None:
    """A one-axis mesh over the global ``ranks`` (the survivors of an
    elastic membership change), with its control group; None on a rank
    of ``mesh`` that is not among them.

    Every rank of the CURRENT ``mesh`` calls, the leavers included, in
    the same order: ``dist.new_group`` names a group by a per-process
    count of the groups made so far, so the survivors agree on the name
    only if all of them made the same groups (a rank that left in an
    earlier reshard never joins a group again, and need not call)."""
    ranks = sorted(int(r) for r in ranks)
    if not ranks:
        raise ClusterError("survivor_mesh: no surviving ranks")
    have = group_ranks(mesh)
    if not set(ranks) <= set(have):
        raise ClusterError(f"survivor_mesh: ranks {ranks} are not all in "
                           f"the current group {have}")
    device = resolve_device(device)
    backend = BACKENDS.get(device.type)
    group = dist.new_group(ranks, backend=backend)
    ctrl = (group if backend == "gloo"
            else dist.new_group(ranks, backend="gloo"))
    if dist.get_rank() not in ranks:
        return None
    names, shape, device = _layout({axis: len(ranks)}, None, group, device)
    return Mesh(names, shape, group, dist.get_rank(group), device, ctrl)


def mesh_from_registry(registry, service_name: str, axes: dict[str, int],
                       axis_names: tuple[str, ...] | None = None,
                       device=None) -> Mesh:
    """Lower a service's registry entries to a :class:`Mesh` (the
    mesh-map path).

    As in the reference, nodes are ordered by ``process_id`` and their
    advertised ``device_ordinals`` concatenate into the global device
    order, which must be non-empty and free of duplicates. The port's
    mesh lays rank r at position r, so the registry must describe the
    current process group: its process ids are the group's ranks
    ``0..world-1``, and its device order is that rank order (each rank
    advertises its rank as its ordinal, ``cluster._local_device_ordinals``).
    Returns :func:`build_mesh` of ``axes`` over the default group."""
    nodes = registry.services().get(service_name, [])
    if not nodes:
        raise ClusterError(
            f"mesh_from_registry: no nodes registered for {service_name!r}")
    nodes = sorted(nodes, key=lambda n: n.process_id)
    ordinals: list[int] = []
    for node in nodes:
        ordinals.extend(node.device_ordinals)
    if not ordinals:
        raise ClusterError(
            f"mesh_from_registry: nodes of {service_name!r} advertise no "
            "device ordinals (control-plane-only processes?)")
    if len(set(ordinals)) != len(ordinals):
        raise ClusterError(
            f"mesh_from_registry: duplicate device ordinals across nodes "
            f"of {service_name!r}: {ordinals}")
    if not dist.is_initialized():
        raise ClusterError("mesh_from_registry: no process group; join "
                           "with num_processes > 1 or call "
                           "init_distributed first")
    ranks = list(range(dist.get_world_size()))
    pids = [n.process_id for n in nodes]
    if pids != ranks or ordinals != ranks:
        raise ClusterError(
            f"mesh_from_registry: {service_name!r} registers process ids "
            f"{pids} with device order {ordinals}; the process group's "
            f"ranks are {ranks}")
    return build_mesh(axes, axis_names, device=device)


def host_broadcast(mesh: Mesh, value: int) -> int:
    """Rank 0's ``value`` (an int) on every rank of the mesh, over the
    control group (no device sync)."""
    if mesh.size == 1:
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64)
    dist.broadcast(t, src=dist.get_global_rank(mesh.control, 0),
                   group=mesh.control)
    return int(t.item())


def agreed_drop(mesh: Mesh, site: str, key: str) -> bool:
    """A chaos seam decided ONCE for every rank of ``mesh``: rank 0
    consults the armed plan (a ``delay`` sleeps there) and every rank
    learns whether the fault is a ``drop``, before any rank enters the
    guarded collective — a fault that fired on one rank only would
    leave the others blocked in it."""
    drop = 0
    if mesh.rank == 0:
        f = chaos.hit(site, key)
        if f is not None:
            if f.action == "drop":
                drop = 1
            else:
                f.sleep()  # delay / wedge: stall this step
    return bool(host_broadcast(mesh, drop))


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


def _axis_key(mesh: Mesh, axis) -> tuple:
    """``axis`` (a name or a tuple of them) as the tuple of its
    non-trivial axes in mesh order; an unknown name is refused."""
    names = axis if isinstance(axis, tuple) else (axis,)
    unknown = [a for a in names if a not in mesh.axis_names]
    if unknown:
        raise ClusterError(f"mesh {mesh.shape} has no axis {unknown}")
    return tuple(a for a in mesh.axis_names
                 if a in names and mesh.shape[a] > 1)


def axis_group(mesh: Mesh, axis):
    """This rank's process group on ``axis`` (a name, or a tuple of
    names: a composite axis): the ranks that differ from this one only
    in their coordinates on it. An axis that spans the mesh is the
    mesh's own group."""
    key = _axis_key(mesh, axis)
    if axis_n(mesh, axis) == mesh.size:
        return mesh.group
    return mesh.groups[key]


def axis_index(mesh: Mesh, axis) -> int:
    """This rank's coordinate along ``axis`` (its shard number): for a
    composite axis the linear index over its axes, outer first — the
    rank's position in :func:`axis_group`."""
    coords = _coords(mesh.rank, mesh.axis_names, mesh.shape)
    idx = 0
    for a in _axis_key(mesh, axis):
        idx = idx * int(mesh.shape[a]) + coords[a]
    return idx


def replicated(mesh: Mesh) -> tuple:
    """The replicated placement: every rank holds the whole value."""
    return ()


def block_of(shape, spec, mesh: Mesh) -> tuple[list, list]:
    """``(start, size)`` per dim of this rank's block of an array of
    ``shape`` under placement ``spec``."""
    start, size = [], []
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    for dim, (d, entry) in enumerate(zip(shape, spec)):
        n = 1 if entry is None else axis_n(mesh, entry)
        if d % n:
            raise ClusterError(f"placement {spec}: dim {dim} ({d}) does "
                               f"not split into {n} blocks")
        i = 0 if entry is None else axis_index(mesh, entry)
        start.append(i * (d // n))
        size.append(d // n)
    return start, size


def owns_block(spec, mesh: Mesh) -> bool:
    """Whether this rank is the one writer of its block under ``spec``:
    its coordinate is 0 on every axis the placement does not split on
    (the block's other holders are its replicas)."""
    named = set()
    for entry in spec or ():
        if entry is not None:
            named.update(entry if isinstance(entry, tuple) else (entry,))
    coords = _coords(mesh.rank, mesh.axis_names, mesh.shape)
    return all(coords[a] == 0 for a in mesh.axis_names if a not in named)


def shard_of(x: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """This rank's contiguous block of the full tensor ``x`` under
    ``spec``: ``x`` itself when the block is all of it, else a copy (no
    view keeps the whole of ``x`` alive)."""
    start, size = block_of(tuple(x.shape), spec, mesh)
    if list(size) == list(x.shape):
        return x
    for dim, (a, n) in enumerate(zip(start, size)):
        x = x.narrow(dim, a, n)
    return x.clone(memory_format=torch.contiguous_format)


def gather(local: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """The inverse of :func:`shard_of`: the full tensor from every
    rank's block, on every rank (an allgather per sharded dim; every
    rank of the mesh calls)."""
    from ptype_tpu_torch.parallel.collectives import all_gather_dim

    for dim, entry in enumerate(spec):
        if entry is not None and axis_n(mesh, entry) > 1:
            local = all_gather_dim(local, mesh, entry, dim)
    return local
