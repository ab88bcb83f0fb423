"""In-process coordination backend — the port's copy of
``ptype_tpu/coord/local.py``.

Wraps a :class:`CoordState` directly — the single-process analog of the
reference's embedded etcd (every ``Cluster`` in one process shares the
named state, the way the reference's test suite shared one embedded member
across suites, registry_test.go:17-39).
"""

from __future__ import annotations

import threading

from ptype_tpu_torch.coord.api import CoordBackend
from ptype_tpu_torch.coord.core import CoordState, Member, RangeOptions, RangeResult, Watch

_states: dict[str, CoordState] = {}
_states_lock = threading.Lock()


def local_coord(name: str = "default") -> "LocalCoord":
    """Return a backend over the process-local state named ``name``."""
    with _states_lock:
        state = _states.get(name)
        if state is None or state._closed.is_set():
            state = CoordState()
            _states[name] = state
    return LocalCoord(state)


def reset_local_coords() -> None:
    """Tear down all named local states (test isolation)."""
    with _states_lock:
        for state in _states.values():
            state.close()
        _states.clear()


class LocalCoord(CoordBackend):
    def __init__(self, state: CoordState | None = None):
        self.state = state or CoordState()

    def put(self, key: str, value: str, lease: int = 0,
            sync: bool = False,
            sync_timeout: float | None = None,
            sync_min_followers: int = 0) -> int:
        if sync_min_followers and not sync:
            raise ValueError(
                "sync_min_followers requires sync=True — without the "
                "barrier the floor would be silently ignored")
        rev = self.state.put(key, value, lease)
        if sync and not self.state.wait_replicated(
                timeout=sync_timeout, min_followers=sync_min_followers):
            from ptype_tpu_torch.errors import CoordinationError

            raise CoordinationError(
                f"sync put {key!r}: replication not acknowledged in "
                f"time (write IS applied on the primary)")
        return rev

    def range(self, key: str, options: RangeOptions | None = None) -> RangeResult:
        return self.state.range(key, options)

    def delete(self, key: str, options: RangeOptions | None = None) -> int:
        return self.state.delete(key, options)

    def grant(self, ttl: float) -> int:
        return self.state.grant(ttl)

    def keepalive(self, lease_id: int) -> float:
        return self.state.keepalive(lease_id)

    def revoke(self, lease_id: int) -> None:
        self.state.revoke(lease_id)

    def watch(self, prefix: str, start_rev: int = 0) -> Watch:
        return self.state.watch(prefix, start_rev=start_rev)

    def member_add(self, name: str, peer_addr: str, metadata: dict | None = None) -> Member:
        return self.state.member_add(name, peer_addr, metadata)

    def member_promote(self, member_id: int) -> Member:
        return self.state.member_promote(member_id)

    def member_remove(self, member_id: int) -> bool:
        return self.state.member_remove(member_id)

    def member_list(self) -> list[Member]:
        return self.state.member_list()

    def barrier(self, name: str, count: int, timeout: float | None = None) -> bool:
        return self.state.barrier(name, count, timeout)

    @property
    def closed(self) -> bool:
        """True once the underlying state is closed — keepalive loops
        use this to go quiet instead of warn-spinning forever."""
        return self.state._closed.is_set()

    def close(self) -> None:
        # Shared named states are closed via reset_local_coords(); closing a
        # handle must not tear down state other Cluster handles still use.
        pass
