"""Failure detection + live elastic recovery — the port of
``ptype_tpu/elastic.py``: stop → reshard onto the survivors → resume.

- :class:`FailureDetector` — watches a service's registry stream
  (snapshot-then-deltas) and reports joins and losses. Liveness is lease
  expiry, the reference's mechanism.
- :class:`ElasticTrainer` — the mesh ``Trainer`` + the detector +
  checkpoint → survivor mesh → restore into the new placements →
  resume: the reference's checkpoint-reshard-resume.
- :class:`ElasticZeroTrainer` — wraps the store-DP ZeRO trainer: ``step``
  raises :class:`MembershipChanged` when the detector saw churn;
  ``recover()`` reshards the resident sharded state in memory onto the
  survivors (``StoreDPTrainer.reshard``: moments bit-preserved), and the
  caller retries the step.
- :func:`inject_loss` revokes a registration the way a SIGKILL would
  (lease revoke ⇒ immediate expiry), so the path runs in-process.

One process per rank, where the reference has one controller. So:

- ONE membership view. The detector runs on rank 0 (the reference's
  controller); at each step boundary its decision reaches every rank
  over the mesh's gloo control group beside the NCCL data group
  (``parallel/mesh.py``), so the check costs no device sync a step, and
  every rank raises at the same step.
- The survivors are ranks: each registered node's ``process_id``,
  checked against the current group (:func:`survivor_ranks`, the
  counterpart of the reference's ``devices_from_nodes``).
- The departing rank's shards live in its own process: the move runs
  over the OLD group while every old rank still answers (the lease
  revoke is a membership event, as in the reference's ``inject_loss``),
  then the survivors switch to their new group. A rank whose process is
  truly gone cannot hand its shard over: ``recover`` raises
  ``ClusterError`` and the way back is ``ZeroCheckpoint``.

Each worker can hold its own lease through ``cluster.join`` over the
TCP coordinator, but the detector and the verdict stay on the group's
rank 0, so rank 0 may not leave.
"""

from __future__ import annotations

import threading
from typing import Callable

import torch
import torch.distributed as dist

from ptype_tpu_torch import chaos, lockcheck, logs
from ptype_tpu_torch.device import resolve_device
from ptype_tpu_torch.errors import ClusterError
from ptype_tpu_torch.parallel.mesh import (group_ranks, host_broadcast,
                                           survivor_mesh)
from ptype_tpu_torch.parallel.topology import DATA_AXIS

log = logs.get_logger("elastic")


class MembershipChanged(Exception):
    """Raised by ``ElasticZeroTrainer.step`` when the worker set changed;
    call ``recover()`` and retry the step."""

    def __init__(self, lost: list[str], joined: list[str]):
        super().__init__(f"lost={lost} joined={joined}")
        self.lost = lost
        self.joined = joined


class FailureDetector:
    """Watch a service; track node churn (lease-expiry liveness)."""

    def __init__(self, registry, service_name: str,
                 on_change: Callable | None = None):
        self.service_name = service_name
        self._watch = registry.watch_service(service_name)
        self._on_change = on_change
        self._lock = lockcheck.lock("elastic.fd")
        self._current: dict[str, object] = {}
        self._lost: list[str] = []
        self._joined: list[str] = []
        self._seeded = threading.Event()
        self._closed = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name=f"fd-{service_name}", daemon=True)
        self._thread.start()

    @staticmethod
    def _key(node) -> str:
        return f"{node.address}:{node.port}"

    def _run(self) -> None:
        for nodes in self._watch:
            if self._closed.is_set():
                break
            new = {self._key(n): n for n in nodes}
            with self._lock:
                if self._seeded.is_set():
                    lost = sorted(set(self._current) - set(new))
                    joined = sorted(set(new) - set(self._current))
                    self._lost.extend(lost)
                    self._joined.extend(joined)
                else:
                    lost, joined = [], []
                self._current = new
            self._seeded.set()
            if (lost or joined) and self._on_change is not None:
                self._on_change(lost, joined)
            if lost or joined:
                log.info("membership change",
                         kv={"service": self.service_name,
                             "lost": lost, "joined": joined})

    def wait_seeded(self, timeout: float = 5.0) -> None:
        if not self._seeded.wait(timeout):
            raise ClusterError(
                f"FailureDetector: no initial snapshot for "
                f"{self.service_name!r} within {timeout}s")

    def current(self) -> list:
        with self._lock:
            return sorted(self._current.values(),
                          key=lambda n: (n.process_id, n.address, n.port))

    def drain_changes(self) -> tuple[list[str], list[str]]:
        """(lost, joined) since the last drain; empties the buffers."""
        with self._lock:
            lost, self._lost = self._lost, []
            joined, self._joined = self._joined, []
        return lost, joined

    @property
    def changed(self) -> bool:
        with self._lock:
            return bool(self._lost or self._joined)

    def close(self, timeout: float = 5.0) -> None:
        """Stop watching and JOIN the watch thread (bounded)."""
        self._closed.set()
        self._watch.cancel()
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            log.warning("failure detector thread did not exit in time",
                        kv={"service": self.service_name,
                            "timeout": timeout})


def inject_loss(registration) -> None:
    """Fault injection: kill a member the lease way (revoke ⇒ expiry ⇒
    watch event), the in-process stand-in for SIGKILLing its host."""
    registration.close(revoke=True)


def survivor_ranks(detector: FailureDetector, mesh) -> list[int]:
    """The survivor rank set: every registered worker's ``process_id``,
    each of which must be a rank of ``mesh``'s current group. The
    group's rank 0 must be among them: its process holds the detector
    (and, in the in-process setup, the workers' registrations), so a
    live reshard cannot leave it behind."""
    ranks = sorted({int(n.process_id) for n in detector.current()})
    if not ranks:
        raise ClusterError("elastic: no surviving workers are registered")
    group = group_ranks(mesh)
    missing = [r for r in ranks if r not in group]
    if missing:
        raise ClusterError(f"elastic: registered ranks {missing} are not "
                           f"in the current group {group}")
    if group[0] not in ranks:
        raise ClusterError(
            f"elastic: rank {group[0]}, which holds the failure detector "
            f"and the registrations, is not among the survivors {ranks}; "
            "a live reshard cannot go on without it, restore the "
            "survivors from a ZeroCheckpoint instead")
    return ranks


def _share(mesh, obj):
    """Rank 0's picklable ``obj`` on every rank of ``mesh`` (over its
    control group)."""
    if mesh.size == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(
        box, src=dist.get_global_rank(mesh.control, 0), group=mesh.control)
    return box[0]


def _detector_on_rank0(registry, service_name: str, mesh):
    """Rank 0's seeded :class:`FailureDetector` (None elsewhere), its
    registered ranks checked to be the mesh's on every rank: the
    ClusterError rank 0 found is raised everywhere."""
    detector, err = None, None
    if mesh.rank == 0:
        detector = FailureDetector(registry, service_name)
        try:
            detector.wait_seeded()
            ranks = survivor_ranks(detector, mesh)
            if ranks != group_ranks(mesh):
                raise ClusterError(
                    f"elastic: registered ranks {ranks} are not the "
                    f"mesh's {group_ranks(mesh)}")
        except ClusterError as e:
            err = str(e)
    err = _share(mesh, err)
    if err is not None:
        if detector is not None:
            detector.close()
        raise ClusterError(err)
    return detector


class _Elastic:
    """The membership protocol both elastic trainers share: rank 0's
    detector, the churn every rank agrees on at a step boundary, and the
    survivor set."""

    detector: FailureDetector | None
    left: bool

    def _churn(self):
        """Rank 0's undrained (lost, joined), agreed by every rank at
        this step boundary: None when nothing changed."""
        changed = int(self.detector.changed) if self.detector else 0
        if not host_broadcast(self.mesh, changed):
            return None
        return _share(self.mesh, self.detector.drain_changes()
                      if self.detector else None)

    def _check_churn(self, who: str) -> None:
        if self.left:
            raise ClusterError(f"{who}: this rank left the group in a "
                               "recover")
        churn = self._churn()
        if churn is not None:
            raise MembershipChanged(*churn)

    def _survivors(self) -> list[int]:
        """Rank 0 drains the churn and reads the survivor set; every
        rank gets it, or the ClusterError it raised."""
        out = None
        if self.detector is not None:
            self.detector.drain_changes()
            try:
                out = survivor_ranks(self.detector, self.mesh)
            except ClusterError as e:
                out = str(e)
        out = _share(self.mesh, out)
        if isinstance(out, str):
            raise ClusterError(out)
        return out

    def _more_churn(self) -> bool:
        more = int(self.detector.changed) if self.detector else 0
        return bool(host_broadcast(self.mesh, more))

    def close(self) -> None:
        if self.detector is not None:
            self.detector.close()
            self.detector = None


class ElasticTrainer(_Elastic):
    """Mesh trainer + failure detector + checkpoint-reshard-resume.

    Every rank of ``mesh`` (one axis, ``mesh_axis``) constructs one,
    together; rank 0 passes the ``registry``. ``step`` raises
    :class:`MembershipChanged` on churn. ``recover`` saves the state
    (every rank writes its blocks to ``ckpt_dir``, a directory all ranks
    share), builds the survivor mesh (every current rank takes part;
    the leavers then stop, ``left``), makes a trainer over it and
    restores the saved step into the new placements, each survivor
    reading its own blocks; the caller retries the step. Churn that
    lands mid-recover re-runs the drain-and-rebuild loop over the latest
    survivors (at most 5 times); no survivors is refused with
    ``ClusterError``. Entry point: runs on the mesh's device."""

    def __init__(self, cfg, registry, service_name: str, ckpt_dir: str,
                 mesh, mesh_axis: str = DATA_AXIS, optimizer=None,
                 params=None, generator=None, attn_fn=None):
        from ptype_tpu_torch.checkpoint import Checkpointer
        from ptype_tpu_torch.train.trainer import Trainer, default_optimizer

        self.cfg = cfg
        self.mesh_axis = mesh_axis
        self.service_name = service_name
        self.ckpt_dir = ckpt_dir
        self.optimizer = optimizer or default_optimizer()
        self._attn_fn = attn_fn
        self.detector = _detector_on_rank0(registry, service_name, mesh)
        self.trainer = Trainer(cfg, optimizer=self.optimizer, params=params,
                               generator=generator, attn_fn=attn_fn,
                               mesh=mesh, sync_every=0)
        self.ckpt = Checkpointer(ckpt_dir, mesh=mesh)
        self.left = False
        log.info("elastic trainer up", kv={"ranks": mesh.size})

    @property
    def mesh(self):
        return self.trainer.mesh

    @property
    def state(self):
        return self.trainer.state

    def step(self, batch: dict) -> dict:
        self._check_churn("ElasticTrainer")
        return self.trainer.step(batch)

    def checkpoint(self) -> int:
        """Save the current step (every rank calls); returns it."""
        self.trainer.sync()
        return self.trainer.save(self.ckpt)

    def _rebuild(self, mesh) -> None:
        """A trainer over ``mesh`` (zero state of the right placements)
        and a checkpointer writing from it."""
        from ptype_tpu_torch.checkpoint import Checkpointer
        from ptype_tpu_torch.models.weights import param_shapes
        from ptype_tpu_torch.train.trainer import Trainer, _flatten, \
            _unflatten

        # Zero-stride zeros: each rank's Trainer copies out its own
        # block of each, and no whole leaf is ever allocated.
        zeros = _unflatten(
            (path, torch.zeros((), dtype=self.cfg.param_dtype).expand(shape))
            for path, shape in _flatten(param_shapes(self.cfg)))
        self.trainer = Trainer(self.cfg, optimizer=self.optimizer,
                               params=zeros, attn_fn=self._attn_fn,
                               mesh=mesh, sync_every=0)
        self.ckpt = Checkpointer(self.ckpt_dir, mesh=mesh)

    def recover(self) -> dict:
        """Checkpoint → survivor mesh → restore → resume (every rank
        calls). Returns ``{"restored_step", "devices"}``; on a rank that
        left, ``devices`` is None."""
        saved = self.checkpoint()
        old = self.mesh.size
        for _ in range(5):
            ranks = self._survivors()
            new = survivor_mesh(self.mesh, ranks, self.mesh_axis,
                                self.trainer.device)
            if new is None:
                self.left = True
                self.close()
                return {"restored_step": saved, "devices": None}
            self._rebuild(new)
            self.trainer.restore(self.ckpt, step=saved)
            if not self._more_churn():
                break
            log.info("membership changed again mid-recover; rebuilding",
                     kv={"step": saved})
        chaos.note_ok("elastic.recover", str(saved))
        log.info("elastic recovery complete",
                 kv={"step": saved, "old_devices": old,
                     "new_devices": self.mesh.size})
        return {"restored_step": saved, "devices": self.mesh.size}


class ElasticZeroTrainer(_Elastic):
    """Store-DP ZeRO trainer + failure detector + LIVE reshard-resume.

    Every rank of ``mesh`` constructs one, together; rank 0 passes the
    ``registry`` (its detector is the one membership view), the others
    may pass None. The registered workers' ``process_id`` s must be the
    mesh's ranks. Entry point: runs on ``cuda`` unless ``device`` names
    another (the mesh's device)."""

    def __init__(self, cfg, registry, service_name: str, mesh,
                 mesh_axis: str = DATA_AXIS, zero=2, wire=None,
                 zero_hparams=None, device=None, params=None,
                 generator=None, attn_fn=None):
        from ptype_tpu_torch.parallel.tensorstore import TensorStore
        from ptype_tpu_torch.train.store_dp import StoreDPTrainer

        device = resolve_device(device)
        self.cfg = cfg
        self.mesh_axis = mesh_axis
        self.service_name = service_name
        self.detector = _detector_on_rank0(registry, service_name, mesh)
        store = TensorStore(mesh, axis=mesh_axis, wire=wire, device=device)
        self.trainer = StoreDPTrainer(cfg, store, zero=zero,
                                      zero_hparams=zero_hparams,
                                      device=device, params=params,
                                      generator=generator, attn_fn=attn_fn)
        #: True on a rank that left the group in a recover.
        self.left = False
        log.info("elastic zero trainer up",
                 kv={"ranks": mesh.size, "zero_stage": self.trainer.zero_stage})

    @property
    def mesh(self):
        return self.trainer.mesh

    # ------------------------------------------------------------- step

    def step(self, batch: dict) -> dict:
        self._check_churn("ElasticZeroTrainer")
        return self.trainer.step(batch)

    def params(self) -> dict:
        return self.trainer.params()

    # ---------------------------------------------------------- recover

    def recover(self, reshard_retries: int = 3) -> dict:
        """Live reshard after :class:`MembershipChanged` (every rank
        calls). A bounded drain-and-rebuild loop: churn arriving
        mid-recover re-runs it over the LATEST survivor set. The reshard
        retries ``reshard_retries`` times: a mid-reshard fault (the
        ``train.reshard`` seam's drop, decided once for every rank)
        raises with the OLD plan, group and shards intact, so the retry
        runs against consistent state. A rank that is not among the
        survivors hands its shards over and leaves (``left``)."""
        old = int(self.trainer.n_workers)
        info: dict = {}
        for _ in range(5):
            ranks = self._survivors()
            new = survivor_mesh(self.mesh, ranks, self.mesh_axis,
                                self.trainer.device)
            stays = new is not None
            last: Exception | None = None
            for attempt in range(reshard_retries):
                try:
                    info = self.trainer.reshard(new, self.mesh_axis)
                    last = None
                    break
                except ClusterError as e:
                    last = e
                    log.warning("live reshard attempt failed; retrying",
                                kv={"attempt": attempt, "error": str(e)})
            if last is not None:
                raise last
            if not stays:
                self.left = True
                self.close()
                return {"old_devices": old, "new_devices": None, **info}
            if not self._more_churn():
                break
        chaos.note_ok("elastic.recover", f"{old}->{self.trainer.n_workers}")
        log.info("elastic live reshard complete",
                 kv={"old_devices": old,
                     "new_devices": self.trainer.n_workers,
                     "reshard_ms": info.get("reshard_ms")})
        return {"old_devices": old, "new_devices": self.trainer.n_workers,
                **info}
