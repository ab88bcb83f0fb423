"""Coordination service — the control-plane substrate; the port's copy
of ``ptype_tpu/coord/``, in-process for now.

A single coordinator serves a linearizable KV with leases and watches
(the model JAX's own distributed runtime uses, and the reference's
embedded etcd before it). Two tiers are ported:

- :class:`ptype_tpu_torch.coord.core.CoordState` — the authoritative
  in-memory state machine (KV + revisions, leases + TTL, prefix
  watches, members, barriers, the WAL);
- :class:`ptype_tpu_torch.coord.local.LocalCoord` — the in-process
  backend over a (possibly shared, named) ``CoordState``.

The TCP service and client, the standby and the witness
(``coord/service.py``, ``remote.py``, ``standby.py``, ``witness.py``)
are the cluster-plane slice (ROADMAP A8): :func:`connect` refuses any
address but ``local:<name>``.
"""

from ptype_tpu_torch.coord.core import (
    CoordState,
    Event,
    EventType,
    KVItem,
    Lease,
    Member,
    RangeOptions,
    SortOrder,
    SortTarget,
    Watch,
)
from ptype_tpu_torch.coord.local import (LocalCoord, local_coord,
                                         reset_local_coords)
from ptype_tpu_torch.coord.api import CoordBackend, connect

__all__ = [
    "CoordBackend",
    "CoordState",
    "Event",
    "EventType",
    "KVItem",
    "Lease",
    "Member",
    "RangeOptions",
    "SortOrder",
    "SortTarget",
    "Watch",
    "LocalCoord",
    "connect",
    "local_coord",
    "reset_local_coords",
]
