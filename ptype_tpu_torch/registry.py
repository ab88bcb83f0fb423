"""Service registry: lease-backed discovery with watch streams — the
port's copy of ``ptype_tpu/registry.py``.

Capability parity with the reference's ``Registry`` (cluster/registry.go:17-21):
``register`` / ``services`` / ``watch_service``, keys under
``services/<service>/<node>``, TTL-leased liveness with background keep-alive,
and watch streams with snapshot-then-delta semantics
(registry_test.go:164-190 contract).

TPU-native addition: a :class:`Node` carries the process id and **TPU device
ordinals** owned by that node, so the registry doubles as the pod's mesh map
(BASELINE.json north star: "registry.go maps actor PIDs onto TPU device
ordinals so the cluster topology *is* the pod mesh"); in the
port the elastic trainer reads a node's ``process_id`` as its rank
(:mod:`ptype_tpu_torch.elastic`).
"""

from __future__ import annotations

import abc
import atexit
import json
import threading
import time

from ptype_tpu_torch import lockcheck
import weakref
from dataclasses import dataclass, field

from ptype_tpu_torch import chaos, logs, retry
from ptype_tpu_torch.coord.api import CoordBackend
from ptype_tpu_torch.coord.core import RangeOptions
from ptype_tpu_torch.errors import CoordinationError

log = logs.get_logger("registry")

#: Every live Registration, for atexit quiescing: keepalive beats that
#: outlive the interpreter's logging teardown spew tracebacks into the
#: tail of otherwise-clean runs (daemon threads die abruptly; threads
#: mid-log die loudly). Weak so the set never keeps a handle alive.
_live_registrations: "weakref.WeakSet[Registration]" = weakref.WeakSet()


@atexit.register
def _quiesce_registrations() -> None:
    for r in list(_live_registrations):
        r._stop.set()

SERVICES_PREFIX = "services"

#: Reference hardcoded 2 s (registry.go:58-59); here it is the default,
#: overridable via platform config ``lease_ttl``.
DEFAULT_LEASE_TTL = 2.0


@dataclass(frozen=True)
class Node:
    """A registered service endpoint (ref: registry.go:23-26 + TPU fields)."""

    address: str
    port: int
    #: Host process index within the cluster (0-based).
    process_id: int = 0
    #: Device ordinals owned by this node's process (the port's elastic
    #: trainer reads ``process_id`` as the node's rank).
    device_ordinals: tuple[int, ...] = ()
    #: Free-form extras (e.g. pipeline stage, expert group).
    metadata: dict = field(default_factory=dict, hash=False, compare=False)

    def to_json(self) -> str:
        return json.dumps(
            {
                "address": self.address,
                "port": self.port,
                "process_id": self.process_id,
                "device_ordinals": list(self.device_ordinals),
                "metadata": self.metadata,
            },
            separators=(",", ":"),
            sort_keys=True,
        )

    @staticmethod
    def from_json(raw: str) -> "Node":
        d = json.loads(raw)
        return Node(
            address=d["address"],
            port=d["port"],
            process_id=d.get("process_id", 0),
            device_ordinals=tuple(d.get("device_ordinals", ())),
            metadata=d.get("metadata", {}),
        )


def _service_key(service: str, node: str = "") -> str:
    key = f"{SERVICES_PREFIX}/{service}"
    return f"{key}/{node}" if node else key


class NodeWatch:
    """Stream of full node-set snapshots for one service.

    Contract (ref: registry.go:119-150 + registry_test.go:164-190): the
    current snapshot is delivered immediately on watch start, then a fresh
    re-listed snapshot per change. Coalescing rapid churn is the RPC
    balancer's job (debounce), not the registry's.
    """

    def __init__(self):
        self._cond = lockcheck.condition("registry.node_watch")
        self._queue: list[list[Node]] = []
        self._closed = False
        self._cancel_cb = lambda: None

    def _push(self, nodes: list[Node]) -> None:
        with self._cond:
            if self._closed:
                return
            self._queue.append(nodes)
            self._cond.notify_all()

    def get(self, timeout: float | None = None) -> list[Node] | None:
        """Next snapshot, or None on timeout/close."""
        import time

        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while not self._queue and not self._closed:
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return None
                self._cond.wait(remaining)
            if self._queue:
                return self._queue.pop(0)
            return None

    def latest(self, timeout: float | None = None) -> list[Node] | None:
        """Newest queued snapshot, draining any older ones — the
        consumer shape for membership-as-state users (the gateway's
        replica pool): only the CURRENT node set matters, and replaying
        a churn burst snapshot-by-snapshot would dial/evict through
        intermediate states that no longer exist. Blocks like
        :meth:`get` when the queue is empty."""
        snap = self.get(timeout=timeout)
        if snap is None:
            return None
        with self._cond:
            if self._queue:
                snap = self._queue[-1]
                self._queue.clear()
        return snap

    def cancel(self) -> None:
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
        self._cancel_cb()

    @property
    def closed(self) -> bool:
        with self._cond:
            return self._closed

    def __iter__(self):
        while True:
            snap = self.get()
            if snap is None and self.closed:
                return
            if snap is not None:
                yield snap


class Registration:
    """Handle for a live registration; owns the lease keep-alive loop."""

    def __init__(self, registry: "CoordRegistry", service: str, node: str,
                 lease_id: int, ttl: float, node_json: str):
        self._registry = registry
        self.service = service
        self.node = node
        self.lease_id = lease_id
        self.ttl = ttl
        self._node_json = node_json
        self._stop = threading.Event()
        self._failures = 0
        # The loop holds only a WEAK reference to this handle between
        # beats: an abandoned Registration (a crash simulation's `del`,
        # a test that leaked one) becomes garbage, and its thread exits
        # on the next beat instead of heartbeating — and warning —
        # forever. A bound-method target would pin the handle alive.
        self._thread = threading.Thread(
            target=Registration._keepalive_entry,
            args=(weakref.ref(self), self._stop, ttl / 2.0),
            name=f"lease-keepalive-{service}/{node}",
            daemon=True,
        )
        self._thread.start()
        _live_registrations.add(self)

    @staticmethod
    def _keepalive_entry(ref: "weakref.ref[Registration]",
                         stop: threading.Event, interval: float) -> None:
        # Refresh at half the TTL, the usual heartbeat cadence
        # (ref: clientv3 KeepAlive drained in a goroutine, registry.go:69-83).
        while not stop.wait(interval):
            self = ref()
            if self is None:
                return  # handle was abandoned; nothing left to keep alive
            self._keepalive_once(stop)
            del self  # drop the strong ref before parking on the event

    def _keepalive_once(self, stop: threading.Event) -> None:
        if getattr(self._registry._coord, "closed", False):
            # Checked unconditionally, not just on error: a closed
            # LocalCoord's state still ANSWERS keepalives (close()
            # stops the sweeper but keeps leases), so an exception-path
            # check would never fire there and the loop would heartbeat
            # a closed state forever.
            log.debug("keepalive stopping: coordination client closed",
                      kv={"service": self.service, "node": self.node})
            stop.set()
            return
        try:
            self._registry._coord.keepalive(self.lease_id)
            if self._failures:
                log.info("lease refresh recovered",
                         kv={"service": self.service, "node": self.node})
            self._failures = 0
            log.debug("lease refreshed",
                      kv={"service": self.service, "node": self.node})
        except CoordinationError as e:
            if getattr(self._registry._coord, "closed", False):
                # Closed for good mid-flight; next beat exits via the
                # unconditional check — just don't warn about it.
                stop.set()
                return
            self._failures += 1
            if self._failures <= 3 or self._failures % 10 == 0:  # bound spam
                log.warning("lease refresh failed",
                            kv={"service": self.service, "node": self.node,
                                "err": str(e), "failures": self._failures})
            # If the lease itself is gone (expired server-side during a
            # partition), a retry can never succeed — re-register with a
            # fresh lease instead of heartbeating a dead registration.
            if "not found" in str(e).lower():
                self._reregister()

    def _reregister(self) -> None:
        # A close() racing with an in-flight keepalive must not resurrect
        # the registration with a fresh lease after the deliberate revoke.
        if self._stop.is_set():
            return
        try:
            lease_id = self._registry._coord.grant(self.ttl)
            self._registry._coord.put(
                _service_key(self.service, self.node), self._node_json,
                lease=lease_id,
            )
            self.lease_id = lease_id
            chaos.note_ok("coord.lease",
                          f"{self.service}/{self.node}")
            log.info("re-registered after lease loss",
                     kv={"service": self.service, "node": self.node,
                         "lease": lease_id})
        except CoordinationError as e:
            log.warning("re-registration failed",
                        kv={"service": self.service, "node": self.node,
                            "err": str(e)})

    def close(self, revoke: bool = True) -> None:
        """Stop keeping the registration alive.

        ``revoke=True`` deregisters immediately (an intentional fix over the
        reference, which only ever let the lease lapse — SURVEY.md §2).
        ``revoke=False`` abandons the lease so liveness expiry does the work,
        which is what a crashed process looks like.
        """
        self._stop.set()
        if revoke:
            try:
                self._registry._coord.revoke(self.lease_id)
            except CoordinationError:
                pass


class Registry(abc.ABC):
    """The mockable seam the reference's tests relied on (SURVEY.md §4)."""

    @abc.abstractmethod
    def register(self, service_name: str, node_name: str, host: str,
                 port: int, *, process_id: int = 0,
                 device_ordinals: tuple[int, ...] = (),
                 metadata: dict | None = None) -> Registration: ...

    @abc.abstractmethod
    def services(self) -> dict[str, list[Node]]: ...

    @abc.abstractmethod
    def watch_service(self, service_name: str) -> NodeWatch: ...


class CoordRegistry(Registry):
    """Registry over a coordination backend (the etcdRegistry analog)."""

    def __init__(self, coord: CoordBackend, lease_ttl: float = DEFAULT_LEASE_TTL):
        self._coord = coord
        self._lease_ttl = lease_ttl

    def register(self, service_name: str, node_name: str, host: str,
                 port: int, *, process_id: int = 0,
                 device_ordinals: tuple[int, ...] = (),
                 metadata: dict | None = None) -> Registration:
        node = Node(
            address=host,
            port=port,
            process_id=process_id,
            device_ordinals=tuple(device_ordinals),
            metadata=metadata or {},
        )
        lease_id = self._coord.grant(self._lease_ttl)
        self._coord.put(
            _service_key(service_name, node_name), node.to_json(), lease=lease_id
        )
        log.info("registered service node",
                 kv={"service": service_name, "node": node_name,
                     "addr": f"{host}:{port}",
                     "devices": list(device_ordinals)})
        return Registration(self, service_name, node_name, lease_id,
                            self._lease_ttl, node.to_json())

    def services(self) -> dict[str, list[Node]]:
        res = self._coord.range(
            SERVICES_PREFIX + "/", RangeOptions(prefix=True)
        )
        out: dict[str, list[Node]] = {}
        for item in res.items:
            parts = item.key.split("/")
            if len(parts) < 3:
                continue
            service = parts[1]
            try:
                out.setdefault(service, []).append(Node.from_json(item.value))
            except (json.JSONDecodeError, KeyError):
                log.warning("skipping malformed registry entry",
                            kv={"key": item.key})
        for nodes in out.values():
            nodes.sort(key=lambda n: (n.address, n.port))
        return out

    def nodes(self, service_name: str) -> list[Node]:
        res = self._coord.range(
            _service_key(service_name) + "/", RangeOptions(prefix=True)
        )
        nodes = []
        for item in res.items:
            try:
                nodes.append(Node.from_json(item.value))
            except (json.JSONDecodeError, KeyError):
                log.warning("skipping malformed registry entry",
                            kv={"key": item.key})
        nodes.sort(key=lambda n: (n.address, n.port))
        return nodes

    def watch_service(self, service_name: str) -> NodeWatch:
        nw = NodeWatch()
        coord_watch = self._coord.watch(_service_key(service_name) + "/")
        nw._cancel_cb = coord_watch.cancel

        def pump():
            # Initial snapshot first (registry_test.go:164-190 contract),
            # then one re-listed snapshot per event batch. A re-list that
            # dies mid-flight (coordinator failover, reconnect racing the
            # call) is TRANSIENT: retry it — terminating here killed the
            # NodeWatch forever while the underlying coord watch went on
            # to be re-armed. The pump ends only when the NodeWatch or
            # the coord watch is deliberately closed.
            need_list = True
            epoch = getattr(coord_watch, "epoch", 0)
            bo = retry.Backoff(base=0.3, cap=1.0)
            try:
                while not nw.closed and not coord_watch.closed:
                    if need_list:
                        try:
                            nw._push(self.nodes(service_name))
                        except CoordinationError as e:
                            if getattr(self._coord, "closed", False):
                                # Closed for good: the reader has (or
                                # will) cancel the coord watch; exit
                                # quietly instead of warn-spinning.
                                return
                            log.warning(
                                "service watch re-list failed; retrying",
                                kv={"service": service_name,
                                    "err": str(e)})
                            bo.sleep()
                            continue
                        need_list = False
                        bo.reset()
                    if coord_watch.get(timeout=0.5):
                        need_list = True
                    # A re-armed watch (reconnect) missed the outage's
                    # events — resync with a fresh list.
                    new_epoch = getattr(coord_watch, "epoch", 0)
                    if new_epoch != epoch:
                        epoch = new_epoch
                        need_list = True
            finally:
                nw.cancel()

        threading.Thread(
            target=pump, name=f"watch-{service_name}", daemon=True
        ).start()
        return nw
