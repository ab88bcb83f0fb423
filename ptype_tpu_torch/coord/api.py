"""Abstract coordination backend + connection factory — the port's copy
of ``ptype_tpu/coord/api.py``.

Everything above the coordination layer (registry, store, cluster) programs
against :class:`CoordBackend`, never a concrete transport — preserving the
reference's interface seam that made its RPC layer testable with a mock
registry (SURVEY.md §4 tier 2, registry.go:17-21).
"""

from __future__ import annotations

import abc

from ptype_tpu_torch.coord.core import Member, RangeOptions, RangeResult, Watch


class CoordBackend(abc.ABC):
    """KV + leases + watches + members + barrier, transport-agnostic."""

    # KV. sync=True acks only after every WAL follower attached at the
    # barrier mirrored the write (the raft-commit analog;
    # coord/core.wait_replicated) — raises if replication is not
    # acknowledged within sync_timeout (None = the shared
    # DEFAULT_SYNC_TIMEOUT). sync_min_followers>0 additionally fails
    # the put when fewer live followers are attached — otherwise a
    # zero-follower window (mirror reconnecting) degrades to an
    # indistinguishable unreplicated ack.
    @abc.abstractmethod
    def put(self, key: str, value: str, lease: int = 0,
            sync: bool = False,
            sync_timeout: float | None = None,
            sync_min_followers: int = 0) -> int: ...

    @abc.abstractmethod
    def range(self, key: str, options: RangeOptions | None = None) -> RangeResult: ...

    @abc.abstractmethod
    def delete(self, key: str, options: RangeOptions | None = None) -> int: ...

    # Leases
    @abc.abstractmethod
    def grant(self, ttl: float) -> int: ...

    @abc.abstractmethod
    def keepalive(self, lease_id: int) -> float: ...

    @abc.abstractmethod
    def revoke(self, lease_id: int) -> None: ...

    # Watches. start_rev > 0 replays retained history from that
    # revision at arm time (etcd watch start-revision; raises when
    # compacted).
    @abc.abstractmethod
    def watch(self, prefix: str, start_rev: int = 0) -> Watch: ...

    # Membership
    @abc.abstractmethod
    def member_add(self, name: str, peer_addr: str, metadata: dict | None = None) -> Member: ...

    @abc.abstractmethod
    def member_promote(self, member_id: int) -> Member: ...

    @abc.abstractmethod
    def member_remove(self, member_id: int) -> bool: ...

    @abc.abstractmethod
    def member_list(self) -> list[Member]: ...

    # Synchronization
    @abc.abstractmethod
    def barrier(self, name: str, count: int, timeout: float | None = None) -> bool: ...

    @abc.abstractmethod
    def close(self) -> None: ...


def connect(
    address: str | list[str],
    *,
    dial_timeout: float = 5.0,
    in_process: bool = False,
    discovery_interval: float = 0.0,
) -> CoordBackend:
    """Dial a coordination backend.

    ``in_process=True`` (or an address of the form ``local:<name>``) returns
    the shared in-process backend — the embedded-etcd-style test tier.
    Otherwise dials the TCP coordination service with the reference's 5s
    default dial timeout (registry.go:37). ``address`` may be a list of
    endpoints (primary + standbys); the client fails over between them.
    ``discovery_interval`` > 0 additionally polls the membership for
    promote-eligible standbys attached at runtime and extends the
    failover list with them (no-op for the in-process tier, which has
    no failover).
    """
    from ptype_tpu_torch.coord.local import local_coord
    from ptype_tpu_torch.coord.remote import RemoteCoord

    if isinstance(address, str) and (
            in_process or address.startswith("local:")):
        name = (address.split(":", 1)[1]
                if address.startswith("local:") else address)
        return local_coord(name)
    return RemoteCoord(address, dial_timeout=dial_timeout,
                       discovery_interval=discovery_interval)
