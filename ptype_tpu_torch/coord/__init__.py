"""Coordination service — the control-plane substrate; the port's copy
of ``ptype_tpu/coord/``.

A single coordinator serves a linearizable KV with leases and watches
(the model JAX's own distributed runtime uses, and the reference's
embedded etcd before it). Three tiers are ported:

- :class:`ptype_tpu_torch.coord.core.CoordState` — the authoritative
  in-memory state machine (KV + revisions, leases + TTL, prefix
  watches, members, barriers, the WAL);
- :class:`ptype_tpu_torch.coord.local.LocalCoord` — the in-process
  backend over a (possibly shared, named) ``CoordState``;
- :class:`ptype_tpu_torch.coord.service.CoordServer` /
  :class:`ptype_tpu_torch.coord.remote.RemoteCoord` — the TCP server
  and client of real multi-process clusters, protocol-compatible with
  the reference's.

The standby and the witness (the reference's ``coord/standby.py`` and
``witness.py``) are not ported yet.
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
from ptype_tpu_torch.coord.service import CoordServer
from ptype_tpu_torch.coord.remote import RemoteCoord
from ptype_tpu_torch.coord.api import CoordBackend, connect

__all__ = [
    "CoordBackend",
    "CoordServer",
    "CoordState",
    "Event",
    "EventType",
    "KVItem",
    "Lease",
    "Member",
    "RangeOptions",
    "RemoteCoord",
    "SortOrder",
    "SortTarget",
    "Watch",
    "LocalCoord",
    "connect",
    "local_coord",
    "reset_local_coords",
]
