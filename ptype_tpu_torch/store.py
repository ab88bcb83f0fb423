"""Replicated KV store — metadata tier; the port's copy of
``ptype_tpu/store.py``.

Capability parity with the reference's ``KVStore`` (cluster/store.go:18-74):
namespaced get/put/delete under ``store/`` with a typed no-key error, plus
the full query-option surface the reference re-exported from etcd
(cluster/store_config.go:33-103) so callers never import the coordination
layer directly.

This tier is for **small control-plane state** (hyperparameters, schedule
state, epoch counters, checkpoint manifests). The tensor tier — parameters
and gradients whose push/pull lowers to XLA collectives — lives in
``ptype_tpu_torch.parallel.tensorstore``.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Callable

from ptype_tpu_torch.coord.api import CoordBackend
from ptype_tpu_torch.coord.core import (
    KVItem,
    RangeOptions,
    SortOrder,
    SortTarget,
    prefix_range_end,
)
from ptype_tpu_torch.errors import NoKeyError

STORE_PREFIX = "store"

#: A query option is a pure transform of RangeOptions (functional options,
#: the shape the reference exposed as clientv3.OpOption).
Option = Callable[[RangeOptions], RangeOptions]


# ---------------------------------------------------------------- options
# Mirrors store_config.go:33-103 one for one.

def with_prefix() -> Option:
    """Match every key with the given key as prefix (store_config.go:63-65)."""
    return lambda o: replace(o, prefix=True)


def with_limit(n: int) -> Option:
    """Cap the number of results (store_config.go:69)."""
    return lambda o: replace(o, limit=n)


def with_sort(target: SortTarget, order: SortOrder) -> Option:
    """Sort results (store_config.go:33-37)."""
    return lambda o: replace(o, sort_target=target, sort_order=order)


def with_range(range_end: str) -> Option:
    """Explicit [key, range_end) interval (store_config.go:79-81)."""
    return lambda o: replace(o, range_end=range_end)


def with_from_key() -> Option:
    """All keys >= the given key (store_config.go:85)."""
    return lambda o: replace(o, from_key=True)


def with_serializable() -> Option:
    """Allow a serializable (non-linearizable) read (store_config.go:90-92).

    The single-coordinator backend serves every read linearizably, so this
    is accepted-and-satisfied rather than a relaxation.
    """
    return lambda o: replace(o, serializable=True)


def with_keys_only() -> Option:
    """Return keys with empty values (store_config.go:96-98)."""
    return lambda o: replace(o, keys_only=True)


def with_count_only() -> Option:
    """Return only the match count (store_config.go:101-103)."""
    return lambda o: replace(o, count_only=True)


def with_min_mod_rev(rev: int) -> Option:
    """Filter to entries modified at or after ``rev``."""
    return lambda o: replace(o, min_mod_rev=rev)


def with_rev(rev: int) -> Option:
    """Read AT a historical revision (store_config.go:71-73): the
    result is the store's state as of revision ``rev``, reconstructed
    from the coordinator's bounded MVCC history. Raises once the
    revision falls behind the retained window ("compacted", etcd
    parity) or is ahead of the head."""
    return lambda o: replace(o, rev=rev)


def get_prefix_range_end(prefix: str) -> str:
    """Exclusive upper bound of a prefix range (store_config.go:41-58)."""
    return prefix_range_end(prefix)


def _resolve(options: tuple[Option, ...]) -> RangeOptions:
    opts = RangeOptions()
    for opt in options:
        opts = opt(opts)
    return opts


def _store_key(key: str) -> str:
    return f"{STORE_PREFIX}/{key}"


# ------------------------------------------------------------------ store

class KVStore:
    """Namespaced KV over the coordination backend (ref: store.go:18-35)."""

    def __init__(self, coord: CoordBackend):
        self._coord = coord

    def get(self, key: str, *options: Option) -> list[str]:
        """Values for the best-matched key(s); raises NoKeyError when none
        match (ref: store.go:38-53)."""
        res = self._coord.range(_store_key(key), _resolve(options))
        if res.count == 0:
            raise NoKeyError(key)
        return [it.value for it in res.items]

    def get_one(self, key: str, *options: Option) -> str:
        """Single-value convenience over :meth:`get`."""
        return self.get(key, *options)[0]

    def get_items(self, key: str, *options: Option) -> list[KVItem]:
        """Full KV records (keys, revisions, lease ids) for a query."""
        res = self._coord.range(_store_key(key), _resolve(options))
        if res.count == 0:
            raise NoKeyError(key)
        return list(res.items)

    def count(self, key: str, *options: Option) -> int:
        """Match count without transferring values."""
        opts = _resolve(options + (with_count_only(),))
        return self._coord.range(_store_key(key), opts).count

    def put(self, key: str, value: str, sync: bool = False,
            sync_timeout: float | None = None,
            sync_min_followers: int = 0) -> None:
        """Set the value for the given key (ref: store.go:56-62).

        ``sync=True`` acks only once every attached WAL follower has
        mirrored the write — the raft-quorum-commit analog the
        reference's Put had for free: an acked write then survives an
        immediate primary death + standby takeover. Raises if not
        acknowledged within ``sync_timeout`` (None = default 5 s).
        ``sync_min_followers`` makes the put FAIL when fewer live
        mirrors are attached (e.g. the standby is mid-reconnect) —
        deployments that run a standby should set 1 so a degraded
        unreplicated ack can't masquerade as a replicated one."""
        self._coord.put(_store_key(key), value, sync=sync,
                        sync_timeout=sync_timeout,
                        sync_min_followers=sync_min_followers)

    def delete(self, key: str, *options: Option) -> None:
        """Delete key(s); raises NoKeyError when nothing was deleted
        (ref: store.go:65-74)."""
        deleted = self._coord.delete(_store_key(key), _resolve(options))
        if deleted == 0:
            raise NoKeyError(key)
