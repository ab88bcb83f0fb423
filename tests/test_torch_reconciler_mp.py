"""The port's replica lifecycle over REAL OS processes: ``ProcessLauncher``
spawns ``python -m ptype_tpu_torch.reconciler.worker`` children that join
the port's TCP coordinator, hold warm, activate into the public service,
serve actor RPC and drain to a clean exit — every case of
``tests/test_reconciler_mp.py``, plus:

- a ``paged`` worker with no ``PTYPE_REPLICA_DEVICE`` raises before it
  reports ready on a host with no card (it never serves on the CPU
  unasked);
- the ``scale.spawn`` and ``scale.drain`` chaos seams armed through
  ``PTYPE_CHAOS_PLAN`` in a child process, each seen to fire;
- the ``Replica.*`` control endpoints across packages: the reference's
  ``ProcessReplicaHandle`` drives a port worker and the port's handle a
  reference worker, with the same lifecycle strings.

``fake`` workers never load torch (a
second or so to start). The ``paged`` drill on ``PTYPE_REPLICA_DEVICE=
cpu`` builds and warms a tiny engine in the child in a few seconds. So,
unlike the reference's, none of these drills is ``slow``. Every wait
has a deadline.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from ptype_tpu_torch import rpc as rpc_mod
from ptype_tpu_torch.chaos import FaultPlan, FaultSpec
from ptype_tpu_torch.coord.core import CoordState
from ptype_tpu_torch.coord.local import LocalCoord
from ptype_tpu_torch.coord.service import CoordServer
from ptype_tpu_torch.errors import ClusterError
from ptype_tpu_torch.metrics import MetricsRegistry
from ptype_tpu_torch.reconciler import (ProcessLauncher,
                                        ProcessReplicaHandle, Reconciler,
                                        ReconcilerConfig)
from ptype_tpu_torch.registry import CoordRegistry, Node

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def coord_server():
    """The port's TCP coordination service on an ephemeral port."""
    server = CoordServer("127.0.0.1:0", CoordState(sweep_interval=0.05))
    yield server
    server.close()


def _registry(coord_server):
    return CoordRegistry(LocalCoord(coord_server.state), lease_ttl=2.0)


def _until(cond, timeout):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return cond()


def _dial(addr):
    host, port = addr.split(":")
    return rpc_mod._dial(Node(address=host, port=int(port)), 5.0,
                         device="cpu")


def test_worker_process_warm_activate_serve_drain(coord_server, tmp_path,
                                                  monkeypatch):
    """One worker's whole lifecycle, launched from a directory outside
    the repository with no PYTHONPATH: spawn warm (server answering,
    NOT registered) → Activate (registered; Generate serves over the
    wire) → Drain (deregisters, process exits 0)."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("PYTHONPATH", raising=False)
    registry = _registry(coord_server)
    launcher = ProcessLauncher(coord_server.address, service="llm",
                               kind="fake", spawn_timeout_s=90.0)
    conn = None
    try:
        h = launcher.spawn("os-r0", warm_hold=True)
        assert h.alive()
        st = h.status()
        assert st["lifecycle"] == "warm" and not st["registered"]
        assert registry.nodes("llm") == []
        h.activate()
        assert _until(lambda: registry.nodes("llm"), 10)
        nodes = registry.nodes("llm")
        assert len(nodes) == 1 and nodes[0].port == int(
            h.addr.split(":")[1])
        conn = _dial(h.addr)
        out = conn.call_async(
            "Generator.Generate",
            (np.zeros((1, 4), np.int32), 6)).result(timeout=30)
        assert out.dtype == np.int32 and tuple(out.shape) == (1, 6)
        h.drain(30.0)
        assert _until(lambda: not h.alive(), 20)
        assert h._proc.returncode == 0
        assert _until(lambda: registry.nodes("llm") == [], 5)
    finally:
        if conn is not None:
            conn.close()
        launcher.close()


def test_paged_worker_process_behind_the_gateway(coord_server):
    """A real PagedGeneratorActor (tiny, ``PTYPE_REPLICA_DEVICE=cpu``) as
    an OS process, spawned warm (params loaded, one 1-token Generate
    run), activated — the gateway's watch stream picks it up — serving
    tokens end to end before a graceful drain exits it."""
    from ptype_tpu_torch.gateway import GatewayConfig, InferenceGateway

    registry = _registry(coord_server)
    launcher = ProcessLauncher(coord_server.address, service="llm",
                               kind="paged", preset="tiny",
                               spawn_timeout_s=240.0,
                               env={"PTYPE_REPLICA_DEVICE": "cpu"})
    gw = None
    try:
        gw = InferenceGateway(
            registry, "llm",
            GatewayConfig(probe_interval_s=0.2, probe_timeout_s=3.0,
                          default_deadline_s=60.0),
            metrics_registry=MetricsRegistry(), device="cpu")
        assert gw.pool.n_healthy() == 0
        h = launcher.spawn("paged-r0", warm_hold=True)
        st = h.status()
        assert st["lifecycle"] == "warm" and not st["registered"]
        h.activate()
        assert _until(lambda: gw.pool.n_healthy() == 1, 30)
        out = gw.generate(np.ones((1, 8), np.int32), 12, deadline_s=60.0)
        assert out.dtype == torch.int32 and tuple(out.shape) == (1, 12)
        snap = gw.pool.status()["replicas"][0]
        assert snap.get("lifecycle") == "active"
        assert "kv_free_blocks" in snap
        h.drain(60.0)
        assert _until(lambda: not h.alive(), 60)
        assert h._proc.returncode == 0
    finally:
        if gw is not None:
            gw.close()
        launcher.close()


def test_paged_worker_without_a_device_raises_without_a_card(
        coord_server, monkeypatch):
    """No ``PTYPE_REPLICA_DEVICE``: the engine wants ``cuda``; on a host
    with no card the worker exits before it reports ready."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    monkeypatch.delenv("PTYPE_REPLICA_DEVICE", raising=False)
    launcher = ProcessLauncher(coord_server.address, service="llm",
                               kind="paged", preset="tiny",
                               spawn_timeout_s=120.0)
    try:
        with pytest.raises(ClusterError, match="before reporting ready"):
            launcher.spawn("paged-nocard")
        assert all(p.returncode not in (None, 0) for p in launcher.procs)
    finally:
        launcher.close()


def test_custom_factory_worker_rides_the_same_lifecycle(
        coord_server, tmp_path):
    (tmp_path / "my_trainer.py").write_text(
        "class _Trainer:\n"
        "    lifecycle = 'active'\n"
        "    def __init__(self):\n"
        "        self.steps = 0\n"
        "    def Step(self):\n"
        "        self.steps += 1\n"
        "        return self.steps\n"
        "    def Info(self):\n"
        "        return {'steps': self.steps,\n"
        "                'lifecycle': self.lifecycle,\n"
        "                'in_flight': 0}\n"
        "def make():\n"
        "    return _Trainer()\n")
    registry = _registry(coord_server)
    launcher = ProcessLauncher(
        coord_server.address, service="trainer", kind="custom",
        factory="my_trainer:make", spawn_timeout_s=120.0,
        env={"PYTHONPATH": str(tmp_path) + os.pathsep
             + os.environ.get("PYTHONPATH", "")})
    conn = None
    try:
        h = launcher.spawn("tr-0")
        assert _until(lambda: len(registry.nodes("trainer")) == 1, 10)
        conn = _dial(h.addr)
        assert conn.call_async("Generator.Step",
                               ()).result(timeout=10) == 1
        assert h.status()["lifecycle"] == "active"
        h.drain(30.0)
        assert _until(lambda: not h.alive(), 20)
        assert registry.nodes("trainer") == []
    finally:
        if conn is not None:
            conn.close()
        launcher.close()


def test_reconciler_bootstraps_and_replaces_os_processes(coord_server):
    """Bootstrap to min_replicas with real processes, then SIGKILL one:
    the death is noticed through the registry (lease expiry) and a
    replacement process is spawned and registered."""
    registry = _registry(coord_server)
    launcher = ProcessLauncher(coord_server.address, service="llm",
                               kind="fake", spawn_timeout_s=90.0)
    mreg = MetricsRegistry()
    rec = Reconciler(
        registry, "llm", launcher,
        cfg=ReconcilerConfig(min_replicas=2, max_replicas=3,
                             tick_interval_s=0.2,
                             spawn_timeout_s=90.0),
        metrics_registry=mreg)
    try:
        def two_active():
            rec.tick()
            st = rec.status()
            return (not st["pending_spawns"]
                    and sum(1 for r in st["replicas"].values()
                            if r["lifecycle"] == "active") == 2)

        assert _until(two_active, 120)
        assert len(registry.nodes("llm")) == 2
        victim = rec._pick_victim()
        assert victim is not None
        victim._proc.kill()   # SIGKILL: no deregistration, no goodbye

        def replaced():
            rec.tick()
            return (mreg.counter("scale.replacements").value >= 1
                    and len(registry.nodes("llm")) == 2)

        assert _until(replaced, 120)
        assert mreg.counter("scale.replacements").value == 1
        assert mreg.counter("scale.deaths").value == 1
        live = {f"{n.address}:{n.port}" for n in registry.nodes("llm")}
        assert victim.addr not in live
    finally:
        rec.close(stop_fleet=True)
        launcher.close()


# ------------------------------------------- chaos armed from the env

#: A child process that runs the port's reconciler over in-process fake
#: replicas with ``PTYPE_CHAOS_PLAN`` armed at import, and prints what
#: the plan and the counters saw.
_SPAWN_CHILD = """
import json, time
from ptype_tpu_torch import chaos
from ptype_tpu_torch.coord.core import CoordState
from ptype_tpu_torch.coord.local import LocalCoord
from ptype_tpu_torch.metrics import MetricsRegistry
from ptype_tpu_torch.reconciler import (FakeGeneratorActor, LocalLauncher,
                                        Reconciler, ReconcilerConfig)
from ptype_tpu_torch.registry import CoordRegistry

state = CoordState(sweep_interval=0.05)
registry = CoordRegistry(LocalCoord(state), lease_ttl=2.0)
launcher = LocalLauncher(registry, FakeGeneratorActor, service="llm")
mreg = MetricsRegistry()
rec = Reconciler(registry, "llm", launcher,
                 cfg=ReconcilerConfig(min_replicas=2), metrics_registry=mreg)
failures_at, deadline = [], time.monotonic() + 30
while time.monotonic() < deadline:
    rec.tick()
    failures_at.append(mreg.counter("scale.spawn_failures").value)
    st = rec.status()
    if (not st["pending_spawns"] and sum(
            r["lifecycle"] == "active" for r in st["replicas"].values()) == 2):
        break
    time.sleep(0.05)
plan = chaos.current()
print(json.dumps({
    "armed": plan is not None,
    "fired": [[e.site, e.action] for e in plan.fired()],
    "unrecovered": plan.unrecovered(),
    "spawn_failures": mreg.counter("scale.spawn_failures").value,
    "spawns": mreg.counter("scale.spawns").value,
    "ticks": len(failures_at),
    "active": len(registry.nodes("llm"))}))
rec.close(stop_fleet=True)
launcher.close()
state.close()
"""


def test_scale_spawn_chaos_armed_from_the_environment():
    """``scale.spawn`` ``fail`` armed through ``PTYPE_CHAOS_PLAN`` in a
    child process: the first spawn fails, a later tick retries it, and
    the replica that comes up pairs the fault (``unrecovered() == {}``).
    """
    plan = FaultPlan([FaultSpec("scale.spawn", "fail", times=1)],
                     name="env-spawn")
    env = {**os.environ, "PTYPE_CHAOS_PLAN": plan.to_json(),
           "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-c", _SPAWN_CHILD], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["armed"]
    assert out["fired"] == [["scale.spawn", "fail"]]
    assert out["spawn_failures"] == 1 and out["spawns"] == 2
    assert out["unrecovered"] == {}
    assert out["active"] == 2


def test_scale_drain_chaos_armed_in_a_worker(coord_server):
    """``scale.drain`` ``wedge`` armed through ``PTYPE_CHAOS_PLAN`` in the
    worker processes: the ordered drain holds past its deadline (the
    worker still reports ``draining``), and the reconciler escalates —
    the victim is killed and the fleet reaches its desired size."""
    plan = FaultPlan([FaultSpec("scale.drain", "wedge", delay_s=60.0)],
                     name="env-drain")
    registry = _registry(coord_server)
    launcher = ProcessLauncher(coord_server.address, service="llm",
                               kind="fake", spawn_timeout_s=90.0,
                               env={"PTYPE_CHAOS_PLAN": plan.to_json()})
    mreg = MetricsRegistry()
    rec = Reconciler(
        registry, "llm", launcher,
        cfg=ReconcilerConfig(min_replicas=2, tick_interval_s=0.1,
                             drain_deadline_s=1.5, spawn_timeout_s=90.0),
        metrics_registry=mreg)
    try:
        def two_active():
            rec.tick()
            st = rec.status()
            return (not st["pending_spawns"]
                    and sum(1 for r in st["replicas"].values()
                            if r["lifecycle"] == "active") == 2)

        assert _until(two_active, 120)
        victim = rec._pick_victim()
        rec.desired = 1
        rec.tick()
        assert mreg.counter("scale.drains").value == 1
        seen = []

        def escalated():
            seen.append(victim.status())   # read before each tick
            rec.tick()
            return mreg.counter("scale.drain_escalations").value >= 1

        assert _until(escalated, 20)
        # An unwedged idle fake drains in ~20 ms; this one was still
        # draining and registered at the tick that escalated it.
        assert seen[-1]["lifecycle"] == "draining" and seen[-1]["registered"]
        assert not victim.alive()
        assert _until(lambda: len(registry.nodes("llm")) == 1, 10)
    finally:
        rec.close(stop_fleet=True)
        launcher.close()


# ------------------------------------------ control across packages


def _drive(handle, registry, service):
    """Status → Activate → Drain through ``handle``; the lifecycle read
    at each step and whether the worker exited 0."""
    seen = [handle.status()["lifecycle"]]
    handle.activate()
    seen.append(handle.status()["lifecycle"])
    assert _until(lambda: len(registry.nodes(service)) == 1, 10)
    handle.drain(30.0)
    assert _until(lambda: not handle.alive(), 30)
    seen.append(handle.lifecycle)
    assert _until(lambda: registry.nodes(service) == [], 10)
    return seen, handle._proc.returncode


def test_reference_handle_drives_a_port_worker(coord_server):
    from ptype_tpu.reconciler import ProcessReplicaHandle as JHandle

    registry = _registry(coord_server)
    launcher = ProcessLauncher(coord_server.address, service="x-port",
                               kind="fake", spawn_timeout_s=90.0)
    try:
        ph = launcher.spawn("port-w", warm_hold=True)
        host, port = ph.addr.split(":")
        jh = JHandle("port-w", host, int(port), ph._proc)
        assert _drive(jh, registry, "x-port") == (
            ["warm", "active", "dead"], 0)
    finally:
        launcher.close()


def test_port_handle_drives_a_reference_worker(coord_server):
    """A reference worker (``python -m ptype_tpu.reconciler.worker``)
    joined to the port's coordinator, driven by the port's handle."""
    from ptype_tpu.reconciler import ProcessLauncher as JLauncher

    registry = _registry(coord_server)
    launcher = JLauncher(coord_server.address, service="x-ref",
                         kind="fake", spawn_timeout_s=120.0,
                         env={"JAX_PLATFORMS": "cpu"})
    try:
        jh = launcher.spawn("ref-w", warm_hold=True)
        host, port = jh.addr.split(":")
        th = ProcessReplicaHandle("ref-w", host, int(port), jh._proc)
        assert _drive(th, registry, "x-ref") == (
            ["warm", "active", "dead"], 0)
    finally:
        launcher.close()
