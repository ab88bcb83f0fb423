"""Replica lifecycle: the ONE home for serving-replica processes — the
port's copy of ``ptype_tpu/reconciler/replica.py``.

A serving replica is more than an actor behind a socket — it is a
lifecycle: **spawning** (process up, model building) →
**warm** (params loaded, server answering, NOT registered — the
standby pool's state: invisible to the gateway, one ``Activate`` away
from serving) → **active** (registered under the public service; the
gateway's watch stream routes to it) → **draining** (deregistration
pending: refuses new work typed, finishes in-flight) → **drained**
(deregistered, exiting). This module owns every transition:

- :class:`ReplicaHost` — builds the actor, serves it (the one
  sanctioned ``ActorServer`` construction for serving replicas),
  registers the ``Replica.*`` control endpoints, and runs the
  warm-up / activate / drain / exit machinery;
- :class:`ReplicaCtl` — the actor-RPC control face
  (``Replica.Status`` / ``Activate`` / ``Drain`` / ``Exit``) the
  reconciler drives cross-process;
- :class:`LocalLauncher` / :class:`ProcessLauncher` — how replicas
  come to exist: in-process (tests, drills, simulated fleets — real
  sockets, same control surface) or as real OS processes
  (``python -m ptype_tpu_torch.reconciler.worker``, registered through
  the coordinator like any other cluster member);
- :class:`FakeGeneratorActor` — a model-free stand-in with the full
  drain surface, for control-plane tests and the scale bench.

Port rules: a replica's actor server decodes tensor arguments onto the
``device`` it was given (``cuda`` unless named, raising with no card —
see ``actor.py``); the fake actor answers a numpy int32 array, as the
reference's does; control calls to a worker dial with ``device="cpu"``,
so a reconciler on a host with no card never resolves ``cuda`` for them
(their replies are dicts). Nothing here imports torch: a ``fake``
replica's process never loads it.

Chaos seams: ``scale.spawn`` (``fail`` — the spawn dies before the
replica comes up; ``delay`` — slow spawn) fires in the launchers and
pairs with a ``note_ok`` once a spawned replica reports in;
``scale.drain`` (``wedge`` — hold the drain open past ``delay_s`` so
it blows its deadline and the reconciler's escalation path fires;
``delay``) fires in the drain worker and pairs when a drain (or its
escalation) completes.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time

from ptype_tpu_torch import chaos, lockcheck, logs
from ptype_tpu_torch import metrics as metrics_mod
from ptype_tpu_torch import retry, rpc as rpc_mod
from ptype_tpu_torch.actor import ActorServer
from ptype_tpu_torch.errors import ClusterError, ShedError
from ptype_tpu_torch.registry import Node, Registry

log = logs.get_logger("reconciler.replica")

#: ``serve.LIFECYCLE_CODES``, kept inline so a replica host never
#: imports ``serve`` (and with it torch); a test pins the two equal.
_LIFECYCLE_CODES = {name: i for i, name in enumerate(
    ("spawning", "warm", "active", "draining", "drained"))}


def serve_actor(actor, name: str = "Generator", host: str = "0.0.0.0",
                port: int = 0, device=None) -> ActorServer:
    """Construct + start the ActorServer for a serving replica — the
    sanctioned construction site outside :class:`ReplicaHost` (replica
    lifecycle has one home; ad-hoc fleets route through here). Tensor
    arguments decode onto ``device`` (``cuda`` unless named)."""
    server = ActorServer(host, port, device=device)
    server.register(actor, name)
    server.serve()
    return server


class FakeGeneratorActor:
    """A model-free generator with the FULL lifecycle surface
    (Generate/Info/begin_drain/drained): control-plane tests and the
    scale bench exercise spawn/route/drain semantics without building a
    model — the reconciler and gateway cannot tell. ``Generate``
    answers a numpy int32 array of ``fill``, as the reference's does:
    no torch op on the request path, whose dispatch runs on a fresh
    thread a call (torch's first op in a thread costs ~0.1 ms of CPU,
    a fifth of a local call)."""

    def __init__(self, delay_s: float = 0.0, fill: int = 7):
        self.delay_s = float(delay_s)
        self.fill = int(fill)
        self.calls = 0
        self.lifecycle = "active"
        self._draining = False
        self._in_flight = 0
        self._lock = lockcheck.lock("reconciler.fake_actor")

    def Generate(self, prompt, max_new_tokens: int = 8, *args):
        import numpy as np

        # Gate + count under ONE lock (drained() reads under the same
        # lock): a request can never be past the gate yet invisible
        # to the drain — the TOCTOU the real actors also guard.
        with self._lock:
            if self._draining:
                raise ShedError("replica draining (scale-down in "
                                "progress); route elsewhere",
                                retry_after_s=0.05)
            self.calls += 1
            self._in_flight += 1
        try:
            if self.delay_s:
                time.sleep(self.delay_s)
            rows = int(prompt.shape[0])
            return np.full((rows, int(max_new_tokens)), self.fill,
                           np.int32)
        finally:
            with self._lock:
                self._in_flight -= 1

    def Info(self) -> dict:
        with self._lock:
            in_flight = self._in_flight
            calls = self.calls
        return {"in_flight": in_flight,
                "queue_depth": max(0, in_flight - 1),
                "calls": calls, "lifecycle": self.lifecycle}

    def begin_drain(self) -> None:
        with self._lock:
            self._draining = True
        self.lifecycle = "draining"

    def drained(self) -> bool:
        with self._lock:
            return self._draining and self._in_flight == 0


class ReplicaCtl:
    """Actor-RPC control face of a :class:`ReplicaHost` — what the
    reconciler drives across processes (``Replica.Status`` etc.)."""

    def __init__(self, host: "ReplicaHost"):
        self._host = host

    def Status(self) -> dict:
        return self._host.status()

    def Activate(self) -> dict:
        self._host.activate()
        return self._host.status()

    def Drain(self, deadline_s: float = 30.0) -> dict:
        self._host.drain(float(deadline_s))
        return self._host.status()

    def Exit(self) -> bool:
        self._host.request_exit()
        return True


class ReplicaHost:
    """One serving replica's whole lifecycle, in one object.

    Builds the actor (``actor_factory``), serves it + the control
    endpoints over one ActorServer (tensor arguments decode onto
    ``device``), optionally warms it up (``warmup(actor)`` — e.g. one
    1-token Generate so activation never pays the first kernel load or
    launch), and owns the registry registration: present exactly while
    the replica is active or draining-in-flight.
    """

    def __init__(self, registry: Registry, service: str,
                 node_name: str, actor_factory, warmup=None,
                 host: str = "127.0.0.1", port: int = 0,
                 generator_name: str = "Generator",
                 process_id: int = 0, warm_hold: bool = False,
                 metrics_registry=None, domain: int | None = None,
                 device=None):
        self._registry = registry
        self.service = service
        self.node_name = node_name
        self.generator_name = generator_name
        self.process_id = int(process_id)
        #: Topology domain (the fast-interconnect island this replica
        #: lives in, parallel/topology.py): advertised in the registration
        #: metadata so the gateway's locality-aware routing and the
        #: ``obs topo`` view see placement without a probe.
        self.domain = None if domain is None else int(domain)
        self._reg_handle = None
        self._reg_lock = lockcheck.lock("reconciler.replica.reg")
        self._exit = threading.Event()
        self._drain_thread: threading.Thread | None = None
        self._drain_started: float | None = None
        self._escalated = False
        self._mreg = (metrics_registry if metrics_registry is not None
                      else metrics_mod.metrics)
        if self.domain is not None:
            # Telemetry mirror of the registration metadata: the
            # ``obs topo`` view groups replicas by this gauge.
            self._mreg.gauge("serve.domain").set(float(self.domain))
        self._set_lifecycle("spawning")
        self.actor = actor_factory()
        self.server = serve_actor(self.actor, generator_name,
                                  host=host, port=port, device=device)
        self.server.register(ReplicaCtl(self), "Replica")
        self.host = host if host != "0.0.0.0" else self.server.host
        self.port = self.server.port
        if warmup is not None:
            warmup(self.actor)
        self._set_lifecycle("warm")
        log.info("replica host up",
                 kv={"service": service, "node": node_name,
                     "addr": f"{self.host}:{self.port}",
                     "warm_hold": warm_hold})
        if not warm_hold:
            self.activate()

    # ---------------------------------------------------------- lifecycle

    def _set_lifecycle(self, state: str) -> None:
        self.lifecycle = state
        actor = getattr(self, "actor", None)
        if actor is not None and state != "draining":
            # "draining" is the actor's own transition (begin_drain);
            # everything else is host-driven and mirrored onto the
            # actor so Info() reports it to the gateway's probes.
            try:
                actor.lifecycle = state
            except AttributeError:
                pass
        self._mreg.gauge("serve.lifecycle").set(
            _LIFECYCLE_CODES.get(state, 2))

    @property
    def key(self) -> str:
        return f"{self.host}:{self.port}"

    def status(self) -> dict:
        info = {}
        try:
            info = self.actor.Info() or {}
        except Exception:  # noqa: BLE001 — status must always answer
            pass
        # One lock for both: activate() flips the lifecycle and
        # registers under it, so no reply pairs "warm" with registered.
        with self._reg_lock:
            lifecycle = self.lifecycle
            registered = self._reg_handle is not None
        return {"service": self.service, "node": self.node_name,
                "addr": self.key, "lifecycle": lifecycle,
                "registered": registered,
                "in_flight": int(info.get("in_flight", 0) or 0),
                "queue_depth": int(info.get("queue_depth", 0) or 0),
                "drained": bool(self._actor_drained()),
                "drain_started": self._drain_started,
                "escalated": self._escalated}

    def activate(self) -> None:
        """warm → active: register under the public service name; the
        gateway's watch stream picks the replica up from here.

        The lifecycle flips to ``active`` BEFORE the registration is
        visible (the reference registers, then flips): a gateway probe
        that follows the watch stream's listing then never reads
        ``warm``. A failed registration flips it back."""
        if self._exit.is_set():
            raise ClusterError("replica host is exiting")
        with self._reg_lock:
            if self._reg_handle is not None:
                return
            meta = {"lifecycle": "active"}
            if self.domain is not None:
                meta["domain"] = self.domain
            self._set_lifecycle("active")
            try:
                self._reg_handle = self._registry.register(
                    self.service, self.node_name, self.host, self.port,
                    process_id=self.process_id, metadata=meta)
            except Exception:
                self._set_lifecycle("warm")
                raise
        log.info("replica activated",
                 kv={"service": self.service, "node": self.node_name,
                     "addr": self.key})

    # -------------------------------------------------------------- drain

    def drain(self, deadline_s: float = 30.0) -> None:
        """active → draining → drained, in the zero-lost order: (1)
        stop admitting — the actor sheds new work typed and the
        frontdoor re-routes it, (2) finish in-flight, (3) deregister,
        (4) exit. The deadline is advisory here (the caller — the
        reconciler — owns escalation); past it the drain keeps trying
        so a late finish still loses nothing."""
        if self._drain_thread is not None or self._exit.is_set():
            return
        self._drain_started = time.monotonic()
        self._set_lifecycle("draining")
        begin = getattr(self.actor, "begin_drain", None)
        if callable(begin):
            begin()
        self._drain_thread = threading.Thread(
            target=self._drain_worker, args=(float(deadline_s),),
            name=f"drain-{self.node_name}", daemon=True)
        self._drain_thread.start()

    def _actor_drained(self) -> bool:
        fn = getattr(self.actor, "drained", None)
        if callable(fn):
            return bool(fn())
        try:
            return int((self.actor.Info() or {})
                       .get("in_flight", 0) or 0) == 0
        except Exception:  # noqa: BLE001 — a dead actor is drained
            return True

    def _drain_worker(self, deadline_s: float) -> None:
        # The scale.drain chaos seam: "wedge" holds the drain open for
        # delay_s (sized past the reconciler's deadline in drills, so
        # the escalation path fires); "delay" is a slow drain.
        hold_until = 0.0
        f = chaos.hit("scale.drain", self.node_name)
        if f is not None and f.action in ("wedge", "delay"):
            hold_until = time.monotonic() + f.delay_s
        while not self._exit.is_set():
            if self._actor_drained() and time.monotonic() >= hold_until:
                break
            self._exit.wait(0.02)
        if self._exit.is_set():
            return  # escalated / killed out from under the drain
        self.deregister()
        self._set_lifecycle("drained")
        chaos.note_ok("scale.drain", self.node_name)
        log.info("replica drained",
                 kv={"service": self.service, "node": self.node_name,
                     "wall_s": round(
                         time.monotonic() - self._drain_started, 3)})
        self.request_exit()

    def deregister(self) -> None:
        with self._reg_lock:
            handle, self._reg_handle = self._reg_handle, None
        if handle is not None:
            handle.close(revoke=True)

    # --------------------------------------------------------------- exit

    def request_exit(self) -> None:
        """Signal the host's owner (worker main loop / local handle)
        that this replica is done; idempotent."""
        self._exit.set()

    def wait_exit(self, timeout: float | None = None) -> bool:
        return self._exit.wait(timeout)

    @property
    def exiting(self) -> bool:
        return self._exit.is_set()

    def close(self) -> None:
        """Shut the replica down cleanly: deregister, quiesce the server
        (no new request; the replies of requests already running — the
        ``Replica.Drain`` or ``Replica.Exit`` that ended it — are
        written, for up to ``actor.QUIESCE_S``), close it, stop the
        actor."""
        self._teardown(quiesce=True)

    def _teardown(self, quiesce: bool) -> None:
        self._exit.set()
        self.deregister()
        if quiesce:
            self.server.quiesce()
        self.server.close()
        close = getattr(self.actor, "close", None)
        if callable(close):
            try:
                close()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
        # Thread hygiene: the drain worker is
        # daemonized AND joined bounded — a host torn down mid-drain
        # must not leave a worker waking against closed sockets.
        t = self._drain_thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=2.0)

    def kill(self) -> None:
        """Die the ungraceful way (drill stand-in for SIGKILL): the
        registration is revoked — the watch stream sees the loss like
        a lease expiry — and the sockets close mid-whatever."""
        self._escalated = True
        self._teardown(quiesce=False)


# ------------------------------------------------------------- handles


class ReplicaHandle:
    """The reconciler's view of one replica it manages — a uniform
    face over in-process hosts and OS-process workers."""

    name: str
    addr: str

    def status(self) -> dict:
        raise NotImplementedError

    def activate(self) -> None:
        raise NotImplementedError

    def drain(self, deadline_s: float) -> None:
        raise NotImplementedError

    def kill(self) -> None:
        raise NotImplementedError

    def alive(self) -> bool:
        raise NotImplementedError

    @property
    def lifecycle(self) -> str:
        try:
            return str(self.status().get("lifecycle", "unknown"))
        except Exception:  # noqa: BLE001 — unreachable replica
            return "dead"


class LocalReplicaHandle(ReplicaHandle):
    """Handle over an in-process :class:`ReplicaHost`."""

    def __init__(self, host: ReplicaHost):
        self._host = host
        self.name = host.node_name
        self.addr = host.key

    def status(self) -> dict:
        return self._host.status()

    def activate(self) -> None:
        self._host.activate()

    def drain(self, deadline_s: float) -> None:
        self._host.drain(deadline_s)

    def kill(self) -> None:
        self._host.kill()

    def alive(self) -> bool:
        return not self._host.exiting

    def close(self) -> None:
        self._host.close()


class ProcessReplicaHandle(ReplicaHandle):
    """Handle over a worker OS process, driven via ``Replica.*``
    control RPCs on the worker's own actor server."""

    def __init__(self, name: str, host: str, port: int,
                 proc: subprocess.Popen, dial_timeout: float = 2.0,
                 call_timeout: float = 5.0):
        self.name = name
        self.addr = f"{host}:{port}"
        self._node = Node(address=host, port=int(port))
        self._proc = proc
        self._dial_timeout = float(dial_timeout)
        self._call_timeout = float(call_timeout)
        self._conn = None
        self._lock = lockcheck.lock("reconciler.proc_handle")

    def _call(self, method: str, *args):
        with self._lock:
            conn = self._conn
        if conn is None or not conn.healthy:
            # Dial OUTSIDE the lock: a wedged worker would otherwise
            # hold every concurrent control call (status polls, drain
            # orders) hostage for the full dial timeout. The install
            # is double-checked — a racer's healthy conn wins and the
            # loser's dial is closed, never leaked. Control replies are
            # dicts: the CPU device keeps this host off the card.
            dialed = rpc_mod._dial(self._node, self._dial_timeout,
                                   device="cpu")
            stale = None
            with self._lock:
                cur = self._conn
                if cur is not None and cur.healthy and cur is not conn:
                    conn, stale = cur, dialed  # lost the dial race
                else:
                    self._conn, conn, stale = dialed, dialed, cur
            if stale is not None and stale is not conn:
                stale.close()
        fut = conn.call_async(method, args)
        try:
            return fut.result(timeout=self._call_timeout)
        except Exception:
            conn.forget(fut)
            raise

    def status(self) -> dict:
        return self._call("Replica.Status")

    def activate(self) -> None:
        self._call("Replica.Activate")

    def drain(self, deadline_s: float) -> None:
        self._call("Replica.Drain", deadline_s)

    def exit(self) -> None:
        try:
            self._call("Replica.Exit")
        except Exception:  # noqa: BLE001 — already gone is fine
            pass

    def kill(self) -> None:
        with self._lock:
            if self._conn is not None:
                self._conn.close()
                self._conn = None
        if self._proc.poll() is None:
            self._proc.kill()
        try:
            # Reap: an escalated drain / replaced death must not leave
            # a zombie per event for the reconciler's lifetime.
            self._proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            pass

    def alive(self) -> bool:
        return self._proc.poll() is None

    def close(self) -> None:
        self.exit()
        try:
            self._proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self._proc.kill()
        with self._lock:
            if self._conn is not None:
                self._conn.close()
                self._conn = None


# ------------------------------------------------------------ launchers

#: The directory that holds this package: it leads a worker's
#: ``PYTHONPATH``, so ``-m ptype_tpu_torch.reconciler.worker`` imports
#: the same package as its launcher from any working directory.
_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _spawn_fault(name: str) -> None:
    """The scale.spawn chaos seam, shared by both launchers."""
    f = chaos.hit("scale.spawn", name)
    if f is not None:
        if f.action == "delay":
            f.sleep()
        elif f.action == "fail":
            raise ClusterError(
                f"chaos: spawn of replica {name!r} failed")


class LocalLauncher:
    """Spawn replicas IN-PROCESS (real sockets, real registry, the
    full control surface — just no process isolation): the launcher
    for tests, chaos drills, and simulated fleets. The reconciler
    cannot tell it apart from :class:`ProcessLauncher`."""

    def __init__(self, registry: Registry, actor_factory,
                 warmup=None, service: str = "llm",
                 generator_name: str = "Generator",
                 metrics_registry=None, domain: int | None = None):
        self._registry = registry
        self._actor_factory = actor_factory
        self._warmup = warmup
        self._service = service
        self._generator_name = generator_name
        self._metrics_registry = metrics_registry
        #: Default topology domain for spawned replicas; a per-spawn
        #: ``domain=`` (the reconciler's placement hint) overrides it.
        self._domain = domain
        self.hosts: list[ReplicaHost] = []
        self._lock = lockcheck.lock("reconciler.launcher")

    def spawn(self, name: str, warm_hold: bool = False,
              domain: int | None = None) -> LocalReplicaHandle:
        _spawn_fault(name)
        host = ReplicaHost(
            self._registry, self._service, name,
            self._actor_factory, warmup=self._warmup,
            generator_name=self._generator_name, warm_hold=warm_hold,
            metrics_registry=self._metrics_registry,
            domain=domain if domain is not None else self._domain)
        with self._lock:
            self.hosts.append(host)
        chaos.note_ok("scale.spawn", name)
        return LocalReplicaHandle(host)

    def close(self) -> None:
        with self._lock:
            hosts, self.hosts = list(self.hosts), []
        for h in hosts:
            h.close()


class ProcessLauncher:
    """Spawn replicas as REAL OS processes: ``python -m
    ptype_tpu_torch.reconciler.worker``, configured by environment
    (``env`` adds to it: ``PTYPE_REPLICA_DEVICE``, a chaos plan, a
    factory's path), joined to the cluster through the coordinator
    address like any other member. The child finds this package from
    any working directory: its root leads the child's ``PYTHONPATH``.
    The worker writes a ready file (host/port/pid) once its server
    answers; spawn blocks on it (bounded), then returns a control
    handle. Replica kind:

    - ``fake``  — :class:`FakeGeneratorActor` (control-plane drills);
    - ``paged`` — the real :class:`~ptype_tpu_torch.serve_engine.engine.
      PagedGeneratorActor` over ``$PTYPE_REPLICA_PRESET`` on ``cuda``
      (or ``$PTYPE_REPLICA_DEVICE``), warmed with a 1-token Generate so
      activation never pays the first kernel load or launch;
    - ``custom`` — ``factory="module:function"``: any actor (a
      trainer, an eval server) rides the same lifecycle.

    ``serve_class`` (disaggregated serving) stamps every
    worker this launcher spawns as ``"prefill"``, ``"decode"``, or
    the default ``"unified"`` — a per-class fleet is two launchers
    (one per class) each driven by its own reconciler off its own
    gateway hint (``InferenceGateway.class_hint``).

    Elastic training: a reconciler scaling a
    ``kind="custom"`` trainer fleet needs no extra plumbing into the
    training loop. Spawning or killing a worker changes registry
    membership; each survivor's ``FailureDetector`` reports the
    churn; the running step raises ``MembershipChanged``; and
    ``ElasticZeroTrainer.recover`` live-reshards the ZeRO state
    across the survivor set in place (``elastic.py``) — no restart,
    no checkpoint round trip.
    """

    def __init__(self, coordinator_address: str, service: str = "llm",
                 kind: str = "fake", preset: str = "tiny",
                 factory: str = "",
                 spawn_timeout_s: float = 60.0,
                 env: dict | None = None,
                 serve_class: str = "unified",
                 domain: int | None = None):
        self.coordinator_address = coordinator_address
        self.service = service
        self.kind = kind
        self.preset = preset
        #: ``module:function`` for ``kind="custom"`` (trainer or any
        #: other actor riding the same lifecycle).
        self.factory = factory
        self.serve_class = serve_class
        #: Default topology domain stamped on spawned workers
        #: (``PTYPE_REPLICA_DOMAIN``); per-spawn ``domain=`` wins.
        self.domain = domain
        self.spawn_timeout_s = float(spawn_timeout_s)
        self._env = dict(env or {})
        self.procs: list[subprocess.Popen] = []

    def spawn(self, name: str, warm_hold: bool = False,
              domain: int | None = None) -> ProcessReplicaHandle:
        # Reap + prune exited children first: a long-lived reconciler
        # cycles many workers, and the list must not grow (nor hold
        # zombies) one entry per drained/killed replica forever.
        self.procs = [p for p in self.procs if p.poll() is None]
        _spawn_fault(name)
        fd, ready = tempfile.mkstemp(prefix=f"replica-{name}-",
                                     suffix=".json")
        os.close(fd)
        os.unlink(ready)  # the worker creates it; absence = not ready
        env = {**os.environ, **self._env,
               "PTYPE_REPLICA_COORD": self.coordinator_address,
               "PTYPE_REPLICA_SERVICE": self.service,
               "PTYPE_REPLICA_NODE": name,
               "PTYPE_REPLICA_KIND": self.kind,
               "PTYPE_REPLICA_PRESET": self.preset,
               "PTYPE_REPLICA_FACTORY": self.factory,
               "PTYPE_REPLICA_WARM": "1" if warm_hold else "0",
               "PTYPE_REPLICA_SERVE_CLASS": self.serve_class,
               "PTYPE_REPLICA_READY_FILE": ready}
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_PKG_ROOT, env.get("PYTHONPATH")) if p)
        dom = domain if domain is not None else self.domain
        if dom is not None:
            env["PTYPE_REPLICA_DOMAIN"] = str(int(dom))
        proc = subprocess.Popen(
            [sys.executable, "-m", "ptype_tpu_torch.reconciler.worker"],
            env=env)
        self.procs.append(proc)
        bo = retry.Backoff(base=0.05, cap=0.5)
        deadline = time.monotonic() + self.spawn_timeout_s
        while True:
            if os.path.exists(ready):
                try:
                    with open(ready, encoding="utf-8") as f:
                        info = json.load(f)
                    break
                except (OSError, json.JSONDecodeError):
                    pass  # mid-write; next poll reads it whole
            if proc.poll() is not None:
                raise ClusterError(
                    f"replica worker {name!r} exited rc="
                    f"{proc.returncode} before reporting ready")
            if time.monotonic() > deadline:
                proc.kill()
                raise ClusterError(
                    f"replica worker {name!r} not ready within "
                    f"{self.spawn_timeout_s:g}s")
            bo.sleep()
        try:
            os.unlink(ready)
        except OSError:
            pass
        handle = ProcessReplicaHandle(name, info["host"],
                                      int(info["port"]), proc)
        chaos.note_ok("scale.spawn", name)
        return handle

    def close(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.terminate()
        for p in self.procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
        self.procs = []
