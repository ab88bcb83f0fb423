"""The port's cluster membership (``ptype_tpu_torch.cluster``) held to
the contracts of ``tests/test_cluster.py`` — join and the member list,
close removing the member and its registration, a shared store, the
calculator end to end, the TCP seed topology, an unreachable
coordinator raising ``ClusterError``, a dead member not blocking a
join — plus what only separate processes show:

- a process probe: a JAX-free server process (``tests/
  torch_cluster_node.py calc``) joins over TCP with lease TTL 1.0 s and
  is SIGKILLed; the client's registry watch delivers the empty snapshot
  within TTL + sweep (+ 1 s of slack for a loaded host), the next call
  raises ``NoClientAvailableError``, and the port's
  ``elastic.FailureDetector`` over a ``RemoteCoord`` sees the loss;
- ``mesh_from_registry`` on 2 gloo rank processes that joined one TCP
  coordinator: its rank order equals the reference's rule
  (``ptype_tpu.parallel.mesh.mesh_from_registry``, read through the
  reference's ``RemoteCoord`` from the same coordinator), and an
  all-reduce over the mesh is exact.

Every server binds port 0; each subprocess has a deadline and is killed
in a ``finally``."""

import json
import os
import pathlib
import signal
import subprocess
import sys
import time

import pytest

from ptype_tpu_torch.actor import ActorServer
from ptype_tpu_torch.cluster import get_ip, join
from ptype_tpu_torch.config import Config, PlatformConfig
from ptype_tpu_torch.errors import ClusterError, NoClientAvailableError
from ptype_tpu_torch.rpc import ConnConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
NODE = ROOT / "tests" / "torch_cluster_node.py"


def local_cfg(service, node, port=0, cluster_name="torchcluster",
              **platform_kw):
    platform_kw.setdefault("lease_ttl", 0.5)
    return Config(service_name=service, node_name=node, port=port,
                  platform=PlatformConfig(
                      name=node, coordinator_address=f"local:{cluster_name}",
                      **platform_kw))


def seed_cfg(service="seed", ttl=1.0, **platform_kw):
    return Config(service_name=service, node_name="seed", port=9001,
                  platform=PlatformConfig(
                      name="seed", coordinator_address="127.0.0.1:0",
                      is_coordinator=True, lease_ttl=ttl, **platform_kw))


def conn_cfg(**kw):
    kw.setdefault("initial_node_timeout", 2.0)
    kw.setdefault("debounce_time", 0.1)
    kw.setdefault("retries", 1)
    return ConnConfig(**kw)


class Calculator:
    def Multiply(self, a, b):
        return a * b


@pytest.fixture(autouse=True)
def _reset_port_local_coords():
    yield
    from ptype_tpu_torch.coord.local import reset_local_coords

    reset_local_coords()


def test_join_and_member_list():
    c1 = join(local_cfg("calc", "n1", 9001))
    c2 = join(local_cfg("calc", "n2", 9002))
    try:
        assert [m.name for m in c1.member_list()] == ["n1", "n2"]
        assert {n.port for n in c1.registry.services()["calc"]} == {9001,
                                                                    9002}
        assert c1.device_ordinals == ()  # no mesh axes: control plane
    finally:
        c1.close()
        c2.close()


def test_close_removes_member_and_registration():
    c1 = join(local_cfg("calc", "n1", 9001))
    c2 = join(local_cfg("calc", "n2", 9002))
    try:
        c2.close()
        assert [m.name for m in c1.member_list()] == ["n1"]
        assert {n.port for n in c1.registry.services().get("calc", [])} == {
            9001}
    finally:
        c1.close()


def test_store_shared_between_members():
    c1 = join(local_cfg("calc", "n1"))
    c2 = join(local_cfg("calc", "n2"))
    try:
        c1.store.put("lr", "3e-4")
        assert c2.store.get_one("lr") == "3e-4"
    finally:
        c1.close()
        c2.close()


def test_end_to_end_calculator_rpc():
    """A calculator handles no tensors, so its server names no device."""
    server = ActorServer(get_ip(), 0)
    server.register(Calculator())
    server.serve()
    c_server = join(local_cfg("calc", "server-node", server.port))
    c_client = join(local_cfg("calc_client", "client-node"))
    try:
        client = c_client.new_client("calc", conn_cfg())
        assert client.call("Calculator.Multiply", 6, 7) == 42
        client.close()
    finally:
        c_server.close()
        c_client.close()
        server.close()


def test_tcp_seed_topology():
    seed = join(seed_cfg("calc", ttl=0.5))
    coord_addr = seed._owned_server.address
    joiner = join(Config(
        service_name="calc", node_name="joiner", port=9002,
        initial_cluster_client_urls=[coord_addr],
        platform=PlatformConfig(name="joiner", coordinator_address=coord_addr,
                                lease_ttl=0.5)))
    try:
        assert [m.name for m in seed.member_list()] == ["seed", "joiner"]
        assert [m.name for m in joiner.member_list()] == ["seed", "joiner"]
        joiner.store.put("k", "v")
        assert seed.store.get_one("k") == "v"
        assert {n.port for n in seed.registry.services()["calc"]} == {9001,
                                                                      9002}
    finally:
        joiner.close()
        seed.close()


def test_join_unreachable_coordinator_fails():
    cfg = Config(service_name="s", node_name="n", port=1,
                 initial_cluster_client_urls=["127.0.0.1:1"],
                 platform=PlatformConfig(name="n",
                                         coordinator_address="127.0.0.1:1",
                                         dial_timeout=0.3))
    with pytest.raises(ClusterError, match="failed to reach"):
        join(cfg)


def test_dead_member_does_not_block_join():
    c1 = join(local_cfg("calc", "n1", 9001))
    c2 = join(local_cfg("calc", "n2", 9002))
    c2.registration.close(revoke=False)
    time.sleep(1.2)
    c3 = join(local_cfg("calc", "n3", 9003))
    try:
        ports = {n.port for n in c3.registry.services()["calc"]}
        assert 9002 not in ports and {9001, 9003} <= ports
    finally:
        c1.close()
        c3.close()


# ------------------------------------------------------------ processes


def _spawn(*args, log=None):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, str(NODE), *args], cwd=ROOT,
                            env=env, stdout=subprocess.PIPE,
                            stderr=log if log is not None
                            else subprocess.STDOUT, text=True)


def _kill(proc):
    if proc.poll() is None:
        proc.kill()
    proc.wait(timeout=30)


def test_sigkilled_server_process_is_detected():
    from conftest import wait_output

    from ptype_tpu_torch.coord.remote import RemoteCoord
    from ptype_tpu_torch.elastic import FailureDetector
    from ptype_tpu_torch.registry import CoordRegistry

    seed = join(seed_cfg())
    addr = seed._owned_server.address
    sweep = seed._owned_server.state._sweep_interval
    proc = _spawn("calc", addr)
    remote, detector, client = None, None, None
    try:
        wait_output(proc, "READY", timeout=60)
        client = seed.new_client("calc", conn_cfg(retries=0))
        assert client.call("Calculator.Multiply", 6, 7) == 42
        remote = RemoteCoord(addr)
        detector = FailureDetector(CoordRegistry(remote, lease_ttl=1.0),
                                   "calc")
        detector.wait_seeded()
        assert len(detector.current()) == 1
        watch = seed.registry.watch_service("calc")
        assert len(watch.get(timeout=5)) == 1
        t0 = time.monotonic()
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=10)
        snap = watch.get(timeout=10)
        detect_s = time.monotonic() - t0
        watch.cancel()
        assert snap == [], snap
        assert detect_s <= 1.0 + sweep + 1.0, detect_s
        deadline = time.monotonic() + 5
        while detector.current() and time.monotonic() < deadline:
            time.sleep(0.02)
        lost, _ = detector.drain_changes()
        assert len(lost) == 1 and not detector.current()
        time.sleep(0.3)  # past the balancer's debounce
        with pytest.raises(NoClientAvailableError):
            client.call("Calculator.Multiply", 2, 3)
    finally:
        _kill(proc)
        for h in (client, detector, remote):
            if h is not None:
                h.close()
        seed.close()


def test_mesh_from_registry_over_two_gloo_ranks(tmp_path):
    from ptype_tpu.coord.remote import RemoteCoord as JRemoteCoord
    from ptype_tpu.parallel.mesh import mesh_from_registry as jmesh
    from ptype_tpu.registry import CoordRegistry as JCoordRegistry

    seed = join(seed_cfg())
    addr = seed._owned_server.address
    outs = [tmp_path / f"out{r}.json" for r in range(2)]
    procs = [_spawn("mesh", addr, str(tmp_path / "rdv"), str(r), "2",
                    str(outs[r])) for r in range(2)]
    jc = None
    try:
        deadline = time.monotonic() + 120
        while not all(o.exists() for o in outs):
            assert all(p.poll() is None for p in procs), [
                p.stdout.read() for p in procs if p.poll() is not None]
            assert time.monotonic() < deadline, "ranks did not build a mesh"
            time.sleep(0.05)
        got = [json.loads(o.read_text()) for o in outs]
        # The reference's rule over the same live registry entries, read
        # through its own client from the same coordinator.
        jc = JRemoteCoord(addr)
        jreg = JCoordRegistry(jc, lease_ttl=1.0)
        nodes = jreg.services()["ranks"]
        assert sorted(n.process_id for n in nodes) == [0, 1]
        want = [d.id for d in jmesh(jreg, "ranks", {"data": 2})
                .devices.flatten()]
        for o in outs:
            pathlib.Path(str(o) + ".go").touch()
        for p in procs:
            p.wait(timeout=max(1, deadline - time.monotonic()))
        assert [p.returncode for p in procs] == [0, 0], [
            p.stdout.read() for p in procs]
    finally:
        for p in procs:
            _kill(p)
        if jc is not None:
            jc.close()
        seed.close()
    for r, o in enumerate(got):
        assert o["rank"] == o["mesh_rank"] == r
        assert o["ordinals"] == [r]
        assert o["size"] == 2 and o["shape"] == {"data": 2}
        assert o["sum"] == 3.0  # 1 + 2, exact
    # Position i of the reference's mesh is device ordinal want[i]; the
    # port puts the rank whose ordinal that is at the same position.
    by_ordinal = {o["ordinals"][0]: o["mesh_rank"] for o in got}
    assert [by_ordinal[d] for d in want] == [0, 1]


def test_mesh_from_registry_checks():
    """No nodes, no ordinals and duplicate ordinals raise as in the
    reference, before any process group is needed."""
    from ptype_tpu_torch.parallel.mesh import mesh_from_registry
    from ptype_tpu_torch.registry import Node

    def reg(nodes):
        return type("R", (), {"services": lambda self: {"s": nodes}})()

    with pytest.raises(ClusterError, match="no nodes"):
        mesh_from_registry(reg([]), "s", {"data": 1})
    with pytest.raises(ClusterError, match="no device ordinals"):
        mesh_from_registry(reg([Node("a", 1)]), "s", {"data": 1})
    with pytest.raises(ClusterError, match="duplicate device ordinals"):
        mesh_from_registry(reg([Node("a", 1, 0, (0,)),
                                Node("b", 2, 1, (0,))]), "s", {"data": 2})
    with pytest.raises(ClusterError, match="no process group"):
        mesh_from_registry(reg([Node("a", 1, 0, (0,))]), "s", {"data": 1})
