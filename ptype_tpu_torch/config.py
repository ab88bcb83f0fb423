"""Two-level YAML configuration — the port's copy of
``ptype_tpu/config.py``, with the same field names, so one YAML file
loads in both packages.

Mirrors the reference contract (cluster/config.go:23-46): a *framework*
config names the service/node and points at a second, platform-level config
file that is resolved **relative to the framework config's directory** and
validated eagerly. In the reference the platform file was an etcd embed
config; here it is a TPU platform config (coordination endpoint + mesh
topology + durability dir), consumed by ``ptype_tpu_torch.cluster.join`` the way
``Join`` consumed ``embed.Config``.

Binaries choose their config via the ``CONFIG`` env var
(ref: example/*/server.go:22 etc.) — see ``config_from_env``.

Two deviations from the reference: PyYAML is imported when a file is
read, not with the module (a host without it can still build its
``Config`` in code; reading a file there raises :class:`ConfigError`
naming the missing module), and ``jax_coordinator_address`` keeps its
name for file compatibility but is the ``torch.distributed``
rendezvous (``tcp://host:port``, or any ``scheme://`` init method).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any

from ptype_tpu_torch.errors import ConfigError

#: Env var every binary reads its config path from (ref: server.go:22).
CONFIG_ENV_VAR = "CONFIG"


@dataclass
class PlatformConfig:
    """TPU platform topology — the etcd-embed-config equivalent.

    Validated eagerly at load time (ref: config.go:41-43 called
    ``etcdConfig.Validate()``).
    """

    #: Name of this coordination member (ref etcd yaml ``name``).
    name: str = "node"
    #: host:port the coordination service listens on / is reached at.
    #: The first address is the seed (coordinator); the reference kept a
    #: list of client URLs (config.go:17-18).
    coordinator_address: str = "127.0.0.1:7070"
    #: True if this node should host the coordination service (the seed).
    #: Equivalent of bootstrapping the first etcd member vs joining.
    is_coordinator: bool = False
    #: Logical mesh axes, ordered, name -> size. The product must equal the
    #: number of participating devices. e.g. {"data": 8} or
    #: {"data": 2, "fsdp": 2, "model": 2}.
    mesh_axes: dict[str, int] = field(default_factory=dict)
    #: Number of processes (hosts) in the cluster; 1 = single-host.
    num_processes: int = 1
    #: This process's index in [0, num_processes).
    process_id: int = 0
    #: Durability dir for Store snapshots + checkpoints (ref etcd
    #: ``data-dir``): Store contents survive restarts.
    data_dir: str = ""
    #: Lease TTL seconds for registry liveness (ref hardcoded 2s,
    #: registry.go:58-59 — here it is configurable, default preserved).
    lease_ttl: float = 2.0
    #: Dial timeout to the coordination service (ref: 5s, registry.go:37).
    dial_timeout: float = 5.0
    #: fsync the coordination WAL per record. Default off: flush-only
    #: survives coordinator PROCESS death (the elastic story's failure
    #: mode) at microsecond append cost. On = full etcd-raft-log parity
    #: (survives host power loss) at ~ms/append on typical disks.
    wal_fsync: bool = False
    #: host:port of the quorum witness (coord/witness.py). Set on the
    #: seed and every standby to get real partition tolerance: the
    #: primary self-fences when it can reach neither the witness nor a
    #: live WAL follower (the minority side of a partition must refuse
    #: clients rather than serve possibly-superseded state — raft
    #: parity, ref cluster_test.go:47-167), and a standby can only
    #: promote by taking the witness lease. Empty = crash-failover
    #: only (the pre-witness behavior).
    witness_address: str = ""
    #: Witness lease TTL seconds: failover detection floor and the
    #: window a minority primary may serve after the partition starts.
    witness_ttl: float = 3.0
    #: The ``torch.distributed`` rendezvous of a multi-process run
    #: (``num_processes > 1``): ``host:port`` (dialled as
    #: ``tcp://host:port``) or a full init method (``tcp://...``,
    #: ``file://...``). Empty = the ``coordinator_address`` host with
    #: port+1. ``join`` calls ``parallel.mesh.init_distributed`` with
    #: it. The name is the reference's, for file compatibility.
    jax_coordinator_address: str = ""

    def validate(self) -> None:
        if not self.name:
            raise ConfigError("platform config: name must be non-empty")
        host, sep, port = self.coordinator_address.rpartition(":")
        if not sep or not host or not port.isdigit():
            raise ConfigError(
                f"platform config: coordinator_address must be host:port, "
                f"got {self.coordinator_address!r}"
            )
        if not (0 < int(port) < 65536):
            raise ConfigError(
                f"platform config: coordinator port out of range: {port}"
            )
        for axis, size in self.mesh_axes.items():
            if not isinstance(size, int) or size < 1:
                raise ConfigError(
                    f"platform config: mesh axis {axis!r} must have a "
                    f"positive integer size, got {size!r}"
                )
        if self.num_processes < 1:
            raise ConfigError("platform config: num_processes must be >= 1")
        if not (0 <= self.process_id < self.num_processes):
            raise ConfigError(
                f"platform config: process_id {self.process_id} out of range "
                f"[0, {self.num_processes})"
            )
        if self.lease_ttl <= 0:
            raise ConfigError("platform config: lease_ttl must be > 0")
        if self.dial_timeout <= 0:
            raise ConfigError("platform config: dial_timeout must be > 0")


@dataclass
class Config:
    """Framework config (ref: cluster/config.go:12-21)."""

    service_name: str = ""
    node_name: str = ""
    port: int = 0
    #: Path to the platform YAML, relative to this config's directory
    #: (ref field ``etcd_config_file``, resolution config.go:35-37).
    platform_config_file: str = ""
    #: Seed coordination endpoints for joining an existing cluster
    #: (ref field ``initial_cluster_client_urls``).
    initial_cluster_client_urls: list[str] = field(default_factory=list)
    debug: bool = False

    #: Loaded + validated platform config (ref unexported ``etcdConfig``).
    platform: PlatformConfig = field(default_factory=PlatformConfig)

    def validate(self) -> None:
        if not self.service_name:
            raise ConfigError("config: service_name must be non-empty")
        if not self.node_name:
            raise ConfigError("config: node_name must be non-empty")
        if not (0 <= self.port < 65536):
            raise ConfigError(f"config: port out of range: {self.port}")
        self.platform.validate()


_CONFIG_FIELDS = {
    "service_name", "node_name", "port", "platform_config_file",
    "initial_cluster_client_urls", "debug",
}
_PLATFORM_FIELDS = {
    "name", "coordinator_address", "is_coordinator", "mesh_axes",
    "num_processes", "process_id", "data_dir", "lease_ttl", "dial_timeout",
    "jax_coordinator_address", "wal_fsync", "witness_address",
    "witness_ttl",
}


def _load_yaml(path: str, what: str) -> dict[str, Any]:
    try:
        import yaml
    except ImportError as e:
        raise ConfigError(
            f"cannot read {what} at {path}: the yaml module (PyYAML) is "
            f"not installed; build the Config in code instead") from e
    try:
        with open(path, "r") as f:
            raw = yaml.safe_load(f)
    except FileNotFoundError as e:
        raise ConfigError(f"failed to read {what} at {path}: {e}") from e
    except yaml.YAMLError as e:
        raise ConfigError(f"failed to read yaml of {what}: {e}") from e
    if raw is None:
        raw = {}
    if not isinstance(raw, dict):
        raise ConfigError(f"{what} at {path} must be a YAML mapping")
    return raw


def platform_config_from_file(path: str) -> PlatformConfig:
    """Load + validate a platform config (ref: embed.ConfigFromFile)."""
    raw = _load_yaml(path, "platform config")
    unknown = set(raw) - _PLATFORM_FIELDS
    if unknown:
        raise ConfigError(
            f"platform config {path}: unknown fields {sorted(unknown)}"
        )
    try:
        cfg = PlatformConfig(**raw)
    except TypeError as e:
        raise ConfigError(f"platform config {path}: {e}") from e
    cfg.validate()
    return cfg


def config_from_file(path: str) -> Config:
    """Load a framework config and its referenced platform config.

    Contract from the reference (config.go:23-46): missing file, bad YAML,
    missing/invalid platform config each raise a distinct, wrapped error;
    the platform path resolves relative to the framework config's dir.
    """
    raw = _load_yaml(path, "cluster config")
    unknown = set(raw) - _CONFIG_FIELDS
    if unknown:
        raise ConfigError(f"cluster config {path}: unknown fields {sorted(unknown)}")
    try:
        cfg = Config(**raw)
    except TypeError as e:
        raise ConfigError(f"failed to parse cluster config {path}: {e}") from e

    if cfg.platform_config_file:
        platform_path = os.path.join(
            os.path.dirname(path), cfg.platform_config_file
        )
        try:
            cfg.platform = platform_config_from_file(platform_path)
        except ConfigError as e:
            raise ConfigError(
                f"failed to read platform config from "
                f"{cfg.platform_config_file}: {e}"
            ) from e

    cfg.validate()
    return cfg


def config_from_env() -> Config:
    """Load the config named by ``$CONFIG`` (ref: server.go:22)."""
    path = os.environ.get(CONFIG_ENV_VAR, "")
    if not path:
        raise ConfigError(
            f"{CONFIG_ENV_VAR} env var not set; point it at a cluster YAML"
        )
    return config_from_file(path)
