"""Cluster membership: join, members, close, new_client — the port's
copy of ``ptype_tpu/cluster.py``.

Capability parity with the reference's L2 (cluster/cluster.go:20-103):
``join(cfg)`` wires up the coordination backend, registry, and store,
self-registers this node, and returns a :class:`Cluster`. Where the
reference started an embedded raft member in every process
(cluster.go:161-196), the model here is seed-hosts-coordination:
the process whose platform config says ``is_coordinator: true`` serves
:class:`CoordServer`; everyone (including the seed) speaks the same
:class:`CoordBackend` interface. ``local:<name>`` coordinator addresses
select the in-process backend — the embedded-etcd-style test tier.

Device wiring: a multi-process run (``num_processes > 1``) joins its
``torch.distributed`` process group inside ``join``, after the control
plane (``parallel.mesh.init_distributed``). When the platform config
declares mesh axes, join publishes this process's device ordinal on the
member record and its service registration, making the registry the
mesh map: :meth:`Cluster.mesh` lowers it with
``parallel.mesh.mesh_from_registry``.
"""

from __future__ import annotations

import socket
import threading

from ptype_tpu_torch import logs
from ptype_tpu_torch.config import Config
from ptype_tpu_torch.coord.api import CoordBackend, connect
from ptype_tpu_torch.coord.core import Member
from ptype_tpu_torch.coord.local import local_coord
from ptype_tpu_torch.coord.service import CoordServer
from ptype_tpu_torch.errors import ClusterError, CoordinationError
from ptype_tpu_torch.registry import CoordRegistry, Registration, Registry
from ptype_tpu_torch.rpc import Client, ConnConfig
from ptype_tpu_torch.store import KVStore

log = logs.get_logger("cluster")

# Coordination servers owned by this process, keyed by listen address —
# lets several in-process joins share one server (test topology parity
# with the reference's in-process multi-member suites, cluster_test.go).
_servers: dict[str, CoordServer] = {}
_servers_lock = threading.Lock()


def get_ip() -> str:
    """First non-loopback IPv4 of this host (ref: cluster.go:198-213)."""
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            # connect() on UDP sends no packets; it just resolves routing.
            s.connect(("10.255.255.255", 1))
            ip = s.getsockname()[0]
            if not ip.startswith("127."):
                return ip
    except OSError:
        pass
    try:
        for info in socket.getaddrinfo(socket.gethostname(), None,
                                       socket.AF_INET):
            ip = info[4][0]
            if not ip.startswith("127."):
                return ip
    except OSError:
        pass
    return "127.0.0.1"


def _local_device_ordinals(platform) -> tuple[int, ...]:
    """The global ordinal of the device this process computes on; ()
    when it computes on none (a control-plane-only process).

    The port runs one process per rank and each rank on one device
    (``parallel.mesh.init_distributed`` gives rank r card
    ``r % device_count``), so a process's global ordinal is its rank,
    ``platform.process_id``: ordinal i is the mesh's i-th position, and
    two processes of one host never advertise the same one. A process
    computes on a device when ``torch.cuda`` has a card, or when it is a
    rank of a ``torch.distributed`` group (a gloo rank on the CPU); in
    a group, its rank must be its ``process_id``."""
    import torch
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        rank = dist.get_rank()
        if rank != platform.process_id:
            raise ClusterError(
                f"join: process group rank {rank} is not this process's "
                f"process_id {platform.process_id}")
        return (rank,)
    if torch.cuda.is_available():
        return (platform.process_id,)
    return ()


class Cluster:
    """A joined cluster member (ref: cluster.go:20-26)."""

    def __init__(self, cfg: Config, coord: CoordBackend,
                 registry: Registry, store: KVStore,
                 member: Member, registration: Registration | None,
                 owned_server: CoordServer | None,
                 advertise_host: str,
                 device_ordinals: tuple[int, ...], device=None):
        self.cfg = cfg
        self.coord = coord
        self.registry = registry
        self.store = store
        self.member = member
        self.registration = registration
        self.advertise_host = advertise_host
        self.device_ordinals = device_ordinals
        #: The device ``join`` was given: reply tensors of
        #: :meth:`new_client` and the :meth:`mesh` compute on it.
        self.device = device
        self._owned_server = owned_server
        self._closed = False

    def member_list(self) -> list[Member]:
        """Ref: cluster.go:86-93."""
        return self.coord.member_list()

    def new_client(self, service_name: str,
                   cfg: ConnConfig | None = None) -> Client:
        """Load-balanced client for a service (ref: cluster.go:101-103);
        its reply tensors land on this cluster's ``device``."""
        return Client(self.advertise_host, service_name, self.registry, cfg,
                      self.device)

    def mesh(self, axis_names: tuple[str, ...] | None = None):
        """Mesh of the platform config's axes over this service's
        registered ranks — the registry-as-mesh-map lowering
        (``parallel.mesh.mesh_from_registry``). Every rank of the
        process group calls, once all of them have joined."""
        from ptype_tpu_torch.parallel.mesh import mesh_from_registry

        return mesh_from_registry(self.registry, self.cfg.service_name,
                                  self.cfg.platform.mesh_axes, axis_names,
                                  device=self.device)

    def close(self) -> None:
        """Leave the cluster (ref: cluster.go:95-99 — plus prompt
        deregistration, which the reference skipped; SURVEY.md §2)."""
        if self._closed:
            return
        self._closed = True
        if self.registration is not None:
            self.registration.close(revoke=True)
        try:
            self.coord.member_remove(self.member.id)
        except CoordinationError:
            pass
        self.coord.close()
        if self._owned_server is not None:
            with _servers_lock:
                addr = self._owned_server.address
                if _servers.get(addr) is self._owned_server:
                    del _servers[addr]
            self._owned_server.close()
        log.info("left cluster", kv={"node": self.cfg.node_name})


def _init_distributed(platform, device) -> None:
    """Join the multi-process ``torch.distributed`` group as part of
    join — Join does *everything* in the reference (cluster.go:28-84),
    whose translation was "Join ≈ jax.distributed.initialize + mesh
    construction". The rendezvous is ``jax_coordinator_address``
    (``host:port`` is dialled as ``tcp://``), else the coordinator's
    host with port+1. No-op when a group already exists (the launcher
    made it), so join stays idempotent."""
    import torch.distributed as dist

    from ptype_tpu_torch.parallel.mesh import init_distributed

    if dist.is_initialized():
        log.debug("torch.distributed already initialized")
        return
    addr = platform.jax_coordinator_address
    if not addr:
        host, _, port = platform.coordinator_address.rpartition(":")
        addr = f"{host}:{int(port) + 1}"
    if "://" not in addr:
        addr = f"tcp://{addr}"
    init_distributed(addr, platform.process_id, platform.num_processes,
                     device)
    log.info("torch distributed initialized",
             kv={"addr": addr, "process": platform.process_id,
                 "n": platform.num_processes})


def join(cfg: Config, device=None) -> Cluster:
    """Join (or seed) the cluster described by ``cfg`` (ref: cluster.go:28-84).

    ``device`` is where this member computes: the process group of a
    multi-process run takes its backend (NCCL on ``cuda``, gloo on
    ``cpu``), and the cluster's clients decode reply tensors onto it.
    ``cuda`` unless named, resolved only when needed — a
    control-plane-only member never resolves one."""
    logs.set_debug(cfg.debug)
    platform = cfg.platform

    owned_server: CoordServer | None = None
    coord_addr = platform.coordinator_address

    # Control plane FIRST, process group second: the seed must be
    # dialable before it blocks in the torch.distributed rendezvous, and
    # joiners must keep retrying within dial_timeout — simultaneous
    # process launch otherwise races join into "connection refused"
    # (observed in the reference: a joiner dialing in the ms between the
    # seed's runtime init and its server bind).
    if coord_addr.startswith("local:"):
        coord: CoordBackend = local_coord(coord_addr.split(":", 1)[1])
    elif platform.is_coordinator:
        with _servers_lock:
            server = _servers.get(coord_addr)
            if server is None:
                import os as _os

                # Durable control plane (ref: etcd data-dir): the seed
                # WALs its CoordState so registry/store survive restart.
                server = CoordServer(
                    coord_addr,
                    data_dir=(_os.path.join(platform.data_dir, "coord")
                              if platform.data_dir else None),
                    fsync=platform.wal_fsync,
                    witness_addr=platform.witness_address or None,
                    witness_ttl=platform.witness_ttl,
                )
                _servers[server.address] = server
                owned_server = server
        # The seed talks to its own state in-process — no self-dial.
        from ptype_tpu_torch.coord.local import LocalCoord

        coord = LocalCoord(server.state)
        log.debug("seeded coordination service", kv={"addr": server.address})
    else:
        # Join an existing cluster through any known client URL
        # (ref: joinExistingCluster, cluster.go:105-118), retrying the
        # endpoint list until dial_timeout: cluster launchers start the
        # seed and joiners at the same instant.
        import time as _time

        from ptype_tpu_torch import retry as _retry

        endpoints = cfg.initial_cluster_client_urls or [coord_addr]
        deadline = _time.monotonic() + platform.dial_timeout
        last: Exception | None = None
        coord = None  # type: ignore[assignment]
        join_bo = _retry.Backoff(base=0.2, cap=1.0)
        while coord is None:
            per_dial = max(0.5, deadline - _time.monotonic())
            try:
                # The FULL endpoint list goes to the client: on a later
                # connection loss it fails over to any standby
                # (coord.standby) in the list, not just the seed —
                # and discovery extends the list with promote-eligible
                # standbys attached after this process joined.
                coord = connect(endpoints, dial_timeout=per_dial,
                                discovery_interval=5.0)
            except CoordinationError as e:
                last = e
                if _time.monotonic() >= deadline:
                    raise ClusterError(
                        f"failed to reach coordination service via "
                        f"{endpoints}: {last}"
                    ) from e
                join_bo.sleep()

    if platform.num_processes > 1:
        _init_distributed(platform, device)

    device_ordinals = (
        _local_device_ordinals(platform) if platform.mesh_axes else ()
    )
    advertise_host = get_ip()

    member = coord.member_add(
        cfg.node_name,
        f"{advertise_host}:{cfg.port}",
        metadata={
            "service": cfg.service_name,
            "process_id": platform.process_id,
            "device_ordinals": list(device_ordinals),
        },
    )

    registry = CoordRegistry(coord, lease_ttl=platform.lease_ttl)
    store = KVStore(coord)

    registration = None
    if cfg.service_name:
        # Self-register (ref: cluster.go:69-73). Registration is always on:
        # a node that serves nothing is still discoverable for liveness.
        registration = registry.register(
            cfg.service_name, cfg.node_name, advertise_host, cfg.port,
            process_id=platform.process_id,
            device_ordinals=device_ordinals,
        )

    log.info("joined cluster",
             kv={"service": cfg.service_name, "node": cfg.node_name,
                 "member_id": member.id, "devices": list(device_ordinals)})
    return Cluster(cfg, coord, registry, store, member, registration,
                   owned_server, advertise_host, device_ordinals, device)
