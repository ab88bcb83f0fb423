"""Coordinator failover of the port: kill -9 the seed, the warm standby
takes over — ``tests/test_failover.py``'s drills on the port's classes.

The seed runs in a SUBPROCESS (``tests/torch_cluster_node.py seed``, the
port's ``CoordServer`` with no torch) and dies by SIGKILL mid-churn; the
port's :class:`~ptype_tpu_torch.coord.standby.Standby` detects the death
by probe, replays the shared or streamed WAL, and the SAME client objects
(endpoint-list ``RemoteCoord``) ride their reconnect loop onto it. Beside
the reference's drills: a port standby takes over from a reference seed
and a reference standby from a port seed (one wire, one WAL format), and
Store-DP training gives the same losses with and without the SIGKILL.
The witness and partition drills are in
``tests/test_torch_failover_quorum.py``.
"""

import json
import os
import signal
import subprocess
import sys
import time

import pytest

from ptype_tpu_torch.coord.remote import RemoteCoord
from ptype_tpu_torch.coord.standby import Standby
from ptype_tpu_torch.errors import CoordinationError
from ptype_tpu_torch.registry import CoordRegistry

HERE = os.path.dirname(os.path.abspath(__file__))
NODE = os.path.join(HERE, "torch_cluster_node.py")
REF_SEED = os.path.join(HERE, "coord_seed_worker.py")
TTL = 1.0


def _start_seed(addr: str, data_dir: str, cmd=None) -> subprocess.Popen:
    """A seed process on ``addr`` over ``data_dir``: the port's by
    default, or ``cmd`` (the reference's seed worker)."""
    p = subprocess.Popen(
        (cmd or [sys.executable, NODE, "seed"]) + [addr, data_dir],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    line = p.stdout.readline()
    assert line.startswith("{"), f"seed died: {p.stderr.read()[-2000:]}"
    assert json.loads(line)["ready"]
    return p


#: Each drill's own limit (s): a drill past it fails with the stack of
#: its wait instead of holding the whole run.
DRILL_TIMEOUT_S = 120


@pytest.fixture(autouse=True)
def _drill_timeout():
    def expire(signum, frame):
        raise TimeoutError(f"drill ran past {DRILL_TIMEOUT_S} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(DRILL_TIMEOUT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)



def test_standby_takes_over_after_seed_sigkill(tmp_path, free_port_pair):
    primary_addr, standby_addr = free_port_pair
    data_dir = str(tmp_path / "coord")
    seed = _start_seed(primary_addr, data_dir)
    standby = Standby(primary_addr, standby_addr, data_dir,
                      check_interval=0.2, failure_threshold=3,
                      probe_timeout=0.5)
    coord = RemoteCoord([primary_addr, standby_addr],
                        reconnect_timeout=30.0)
    registry = CoordRegistry(coord, lease_ttl=TTL)
    try:
        # Live registrations with keepalive + a watch + KV state.
        regs = [registry.register("svc", f"node{i}", "127.0.0.1",
                                  7000 + i) for i in range(3)]
        watch = registry.watch_service("svc")
        assert len(watch.get(timeout=5)) == 3  # snapshot
        coord.put("store/answer", "42")

        # Churn right up to (and across) the kill.
        churn = registry.register("svc", "churner", "127.0.0.1", 7999)

        assert not standby.promoted.is_set()
        os.kill(seed.pid, signal.SIGKILL)
        seed.wait(timeout=10)

        assert standby.promoted.wait(timeout=10), (
            "standby never promoted after seed SIGKILL")

        # Within ~one TTL the clients must be whole again: keepalives
        # reclaim replayed leases (or re-register on lease loss), so
        # ZERO registrations are lost.
        deadline = time.monotonic() + 10 * TTL
        want = {7000, 7001, 7002, 7999}
        ports: set = set()
        while time.monotonic() < deadline:
            try:
                # In-flight calls can race the client's reconnect and
                # surface CoordinationError — callers retry, exactly
                # like the registry keepalive does.
                ports = {n.port for n in
                         registry.services().get("svc", [])}
            except CoordinationError:
                ports = set()
            if ports == want:
                break
            time.sleep(0.1)
        assert ports == want, f"lost registrations after failover: " \
                              f"{want - ports}"

        # KV survived via the WAL replay.
        got = coord.range("store/answer")
        assert [it.value for it in got.items] == ["42"]

        # Watches re-armed: a post-failover registration is delivered
        # as a fresh node-set snapshot containing the new endpoint.
        registry.register("svc", "late", "127.0.0.1", 7100)
        deadline = time.monotonic() + 5
        seen_late = False
        while time.monotonic() < deadline and not seen_late:
            snap = watch.get(timeout=1)
            if snap and 7100 in {n.port for n in snap}:
                seen_late = True
        assert seen_late, "watch stream dead after failover"

        # And churn keeps working: deregistration propagates.
        churn.close(revoke=True)
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            if 7999 not in {n.port for n in
                            registry.services().get("svc", [])}:
                break
            time.sleep(0.1)
        else:
            pytest.fail("deregistration lost after failover")
        for r in regs:
            r.close()
    finally:
        coord.close()
        standby.close()
        if seed.poll() is None:
            seed.kill()
            seed.wait(timeout=10)


def test_standby_does_not_promote_while_primary_lives(tmp_path,
                                                      free_port_pair):
    primary_addr, standby_addr = free_port_pair
    data_dir = str(tmp_path / "coord")
    seed = _start_seed(primary_addr, data_dir)
    standby = Standby(primary_addr, standby_addr, data_dir,
                      check_interval=0.1, failure_threshold=3,
                      probe_timeout=0.5)
    try:
        time.sleep(1.5)  # many probe rounds
        assert not standby.promoted.is_set()
        assert standby.server is None
    finally:
        standby.close()
        seed.kill()
        seed.wait(timeout=10)


def test_operator_switchover(tmp_path, free_port_pair):
    """Graceful promote (the learner-PROMOTE analog): operator shuts
    the primary down, promotes the standby, clients fail over and the
    state is intact."""
    primary_addr, standby_addr = free_port_pair
    data_dir = str(tmp_path / "coord")
    seed = _start_seed(primary_addr, data_dir)
    standby = Standby(primary_addr, standby_addr, data_dir,
                      check_interval=5.0, failure_threshold=1000)
    coord = RemoteCoord([primary_addr, standby_addr],
                        reconnect_timeout=30.0)
    try:
        coord.put("store/k", "v1")
        seed.terminate()  # graceful shutdown releases the WAL fence
        seed.wait(timeout=10)
        server = standby.promote(timeout=10)
        assert server is standby.server and standby.promoted.is_set()
        deadline = time.monotonic() + 10
        val = None
        while time.monotonic() < deadline:
            try:
                res = coord.range("store/k")
                val = res.items[0].value if res.items else None
                break
            except CoordinationError:
                time.sleep(0.1)
        assert val == "v1"
    finally:
        coord.close()
        standby.close()
        if seed.poll() is None:
            seed.kill()
            seed.wait(timeout=10)


def test_wal_fence_refuses_second_coordinator(tmp_path):
    """Split-brain fence: while a coordinator holds the WAL-dir flock,
    a second CoordState on the same data_dir must refuse to start —
    promotion against a wedged-but-alive primary fails loudly instead
    of interleaving two writers into one WAL."""
    from ptype_tpu_torch.coord.core import CoordState

    first = CoordState(data_dir=str(tmp_path))
    try:
        with pytest.raises(RuntimeError, match="locked by a live"):
            CoordState(data_dir=str(tmp_path))
    finally:
        first.close()
    # Fence released on close: a successor starts cleanly.
    second = CoordState(data_dir=str(tmp_path))
    second.close()


def test_standby_retries_promotion_while_fence_held(tmp_path,
                                                    free_port_pair):
    """A wedged-but-alive primary: probes fail (no server on the
    address) but the WAL fence is still held — the standby must keep
    retrying, then promote once the fence drops."""
    from ptype_tpu_torch.coord.core import CoordState

    primary_addr, standby_addr = free_port_pair
    data_dir = str(tmp_path / "coord")
    wedged = CoordState(data_dir=data_dir)  # holds the fence, serves nothing
    standby = Standby(primary_addr, standby_addr, data_dir,
                      check_interval=0.1, failure_threshold=2,
                      probe_timeout=0.3)
    try:
        assert not standby.promoted.wait(timeout=1.5), (
            "standby promoted through a held WAL fence")
        wedged.close()  # primary truly dies; fence drops
        assert standby.promoted.wait(timeout=5), (
            "standby did not promote after the fence dropped")
    finally:
        standby.close()


def test_failed_operator_promote_rearms_monitor(tmp_path, free_port_pair):
    """promote() against a live primary raises — but the standby must
    KEEP guarding afterwards: a caller that catches the error expects
    automatic failover to still be armed (the monitor was stopped
    during the deliberate-promotion attempt)."""
    primary_addr, standby_addr = free_port_pair
    data_dir = str(tmp_path / "coord")
    seed = _start_seed(primary_addr, data_dir)
    standby = Standby(primary_addr, standby_addr, data_dir,
                      check_interval=0.1, failure_threshold=2,
                      probe_timeout=0.3)
    try:
        with pytest.raises(RuntimeError, match="WAL fence"):
            standby.promote(timeout=1.0)  # primary alive: fence held
        # The failed attempt must have re-armed automatic failover.
        os.kill(seed.pid, signal.SIGKILL)
        seed.wait(timeout=10)
        assert standby.promoted.wait(timeout=10), (
            "monitor not re-armed after failed operator promote")
    finally:
        standby.close()
        if seed.poll() is None:
            seed.kill()
            seed.wait(timeout=10)


def test_wal_stream_standby_cross_host(tmp_path, free_port_pair):
    """Cross-host failover: the standby's data_dir is its OWN (no
    shared filesystem); a WalFollower mirrors the primary's WAL over
    TCP. SIGKILL the primary → the standby promotes over the mirror
    with registrations, KV and lease state intact."""
    from ptype_tpu_torch.coord.standby import WalFollower  # noqa: F401

    primary_addr, standby_addr = free_port_pair
    primary_dir = str(tmp_path / "primary")   # "host A"
    standby_dir = str(tmp_path / "standby")   # "host B" — disjoint
    seed = _start_seed(primary_addr, primary_dir)
    standby = Standby(primary_addr, standby_addr, standby_dir,
                      check_interval=0.2, failure_threshold=3,
                      probe_timeout=0.5, replicate=True)
    coord = RemoteCoord([primary_addr, standby_addr],
                        reconnect_timeout=30.0)
    registry = CoordRegistry(coord, lease_ttl=TTL)
    try:
        assert standby.follower.synced.wait(timeout=10), (
            "follower never mirrored the initial snapshot")
        regs = [registry.register("svc", f"node{i}", "127.0.0.1",
                                  7000 + i) for i in range(3)]
        coord.put("store/answer", "42")
        # Let the mirror catch up (stream is ordered; the last put
        # landing implies everything before it landed).
        deadline = time.monotonic() + 10
        wal = os.path.join(standby_dir, "coord.wal")
        while time.monotonic() < deadline:
            if os.path.exists(wal) and "store/answer" in open(wal).read():
                break
            time.sleep(0.05)

        os.kill(seed.pid, signal.SIGKILL)
        seed.wait(timeout=10)
        assert standby.promoted.wait(timeout=10), (
            "standby never promoted after seed SIGKILL (wal-stream)")

        # Clients ride the endpoint list onto the standby; within ~one
        # TTL keepalives reclaim the replayed leases: zero lost
        # registrations, KV intact.
        deadline = time.monotonic() + TTL * 8
        nodes, val = [], None
        while time.monotonic() < deadline:
            try:
                nodes = registry.nodes("svc")
                res = coord.range("store/answer")
                val = res.items[0].value if res.items else None
                if len(nodes) == 3 and val == "42":
                    break
            except CoordinationError:
                pass
            time.sleep(0.1)
        assert len(nodes) == 3, f"lost registrations: {nodes}"
        assert val == "42", f"lost KV state: {val!r}"
        del regs
    finally:
        coord.close()
        standby.close()
        if seed.poll() is None:
            seed.kill()
            seed.wait(timeout=10)


def test_wal_stream_refuses_promotion_over_unsynced_mirror(
        tmp_path, free_port_pair):
    """A replicate-mode standby whose follower NEVER mirrored a
    snapshot (primary unreachable from the start) must refuse
    auto-promotion — serving an empty data_dir would silently wipe the
    control plane."""
    primary_addr, standby_addr = free_port_pair
    # No seed: the primary address never answers.
    standby = Standby(primary_addr, standby_addr,
                      str(tmp_path / "standby"),
                      check_interval=0.1, failure_threshold=2,
                      probe_timeout=0.2, replicate=True)
    try:
        assert not standby.promoted.wait(timeout=2.0), (
            "standby promoted over a never-synced (empty) mirror")
        assert standby.server is None
    finally:
        standby.close()


def test_wal_stream_operator_promote_refused_while_primary_lives(
        tmp_path, free_port_pair):
    """wal-stream mode has no flock fence: operator promote() while
    the primary still answers must refuse (split-brain guard) and
    leave automatic failover armed."""
    primary_addr, standby_addr = free_port_pair
    seed = _start_seed(primary_addr, str(tmp_path / "primary"))
    standby = Standby(primary_addr, standby_addr,
                      str(tmp_path / "standby"),
                      check_interval=0.1, failure_threshold=2,
                      probe_timeout=0.3, replicate=True)
    try:
        # Wait for the initial mirror: killing the seed before the
        # follower's first snapshot would (correctly) trip the
        # unsynced-mirror refusal instead of exercising the re-arm.
        assert standby.follower.synced.wait(timeout=10)
        with pytest.raises(RuntimeError, match="still alive"):
            standby.promote(timeout=1.0)
        os.kill(seed.pid, signal.SIGKILL)
        seed.wait(timeout=10)
        assert standby.promoted.wait(timeout=10), (
            "monitor not re-armed after refused wal-stream promote")
    finally:
        standby.close()
        if seed.poll() is None:
            seed.kill()
            seed.wait(timeout=10)


@pytest.fixture
def cpu_group():
    """A world-1 gloo process group for the Store's mesh (made here
    unless one exists; destroyed after when made here)."""
    import socket

    import torch.distributed as dist

    from ptype_tpu_torch.parallel.mesh import init_distributed

    made = not dist.is_initialized()
    if made:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        init_distributed(f"tcp://127.0.0.1:{port}", 0, 1, "cpu")
    yield
    if made:
        dist.destroy_process_group()


def _store_dp_run(coord, steps, on_first_step=None):
    """``steps`` step outputs of a tiny f32 StoreDPTrainer (seed-0 init
    and stream) publishing its manifests through ``coord``, and a
    callable that runs one more step; the callback runs after the
    first step."""
    import torch

    from ptype_tpu_torch.models import transformer as tfm
    from ptype_tpu_torch.parallel.mesh import build_mesh
    from ptype_tpu_torch.parallel.tensorstore import TensorStore
    from ptype_tpu_torch.store import KVStore
    from ptype_tpu_torch.train.data import synthetic_batches
    from ptype_tpu_torch.train.store_dp import StoreDPTrainer

    mesh = build_mesh({"data": 1}, device="cpu")
    cfg = tfm.preset("tiny", dtype=torch.float32)
    store = TensorStore(mesh, kv=KVStore(coord), device="cpu")
    trainer = StoreDPTrainer(cfg, store, device="cpu")
    stream = synthetic_batches(cfg.vocab_size, 8, 32, device="cpu")
    outs = []
    for i in range(steps):
        outs.append(trainer.step(next(stream)))
        if i == 0 and on_first_step is not None:
            on_first_step()
    return outs, lambda: trainer.step(next(stream))


def test_training_rides_through_coordinator_failover(tmp_path,
                                                     free_port_pair,
                                                     cpu_group):
    """The integration drill: Store-DP training publishes its tensor
    manifests through the coordination KV while the seed is SIGKILLed
    mid-run and a wal-stream standby takes over. The data plane (the
    process group's collectives) never depended on the coordinator; the
    control-plane writes must ride the reconnect onto the standby —
    training continues, manifests keep publishing, nothing deadlocks,
    and the losses equal those of the same run with no failover (the
    coordinator carries no data), exactly."""
    import math

    from ptype_tpu_torch.coord.core import CoordState
    from ptype_tpu_torch.coord.local import LocalCoord
    from ptype_tpu_torch.store import KVStore, with_prefix

    steps = 4
    calm_state = CoordState(sweep_interval=0.05)
    try:
        calm = [o["loss"] for o in _store_dp_run(LocalCoord(calm_state),
                                                 steps)[0]]
    finally:
        calm_state.close()

    primary_addr, standby_addr = free_port_pair
    seed = _start_seed(primary_addr, str(tmp_path / "primary"))
    standby = Standby(primary_addr, standby_addr,
                      str(tmp_path / "standby"),
                      check_interval=0.2, failure_threshold=3,
                      probe_timeout=0.5, replicate=True)
    coord = RemoteCoord([primary_addr, standby_addr],
                        reconnect_timeout=30.0)
    try:
        assert standby.follower.synced.wait(timeout=10)

        def kill():
            os.kill(seed.pid, signal.SIGKILL)
            seed.wait(timeout=10)
            assert standby.promoted.wait(timeout=10)

        # Training continues across the outage: steps complete, the
        # grad epoch advances, and manifests land on the NEW primary.
        outs, step = _store_dp_run(coord, steps, on_first_step=kill)
        losses = [o["loss"] for o in outs]
        assert all(math.isfinite(x) for x in losses)
        assert outs[-1]["grad_epoch"] > outs[0]["grad_epoch"]
        assert losses == calm, (losses, calm)
        # The steps inside the outage published nothing (best effort);
        # once the client has ridden onto the standby, the next step
        # publishes its manifests there, with the current epoch.
        kv = KVStore(coord)
        deadline = time.monotonic() + 15
        while True:
            try:
                kv.get("tensors/", with_prefix())
                break
            except CoordinationError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.1)
        last = step()
        manifests = [json.loads(v) for v in
                     kv.get("tensors/", with_prefix())]
        assert manifests, "no tensor manifests on the promoted standby"
        assert max(m["epoch"] for m in manifests) == last["grad_epoch"], (
            "the promoted standby holds no manifest of the last step")
    finally:
        coord.close()
        standby.close()
        if seed.poll() is None:
            seed.kill()
            seed.wait(timeout=10)


def test_wal_stream_failover_chain(tmp_path):
    """The documented operator lifecycle, twice over: primary → standby
    A takes over → a NEW standby B guards the promoted A → A dies → B
    takes over — registrations and KV survive BOTH failovers."""
    import socket as _socket

    def _port():
        with _socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    addrs = [f"127.0.0.1:{_port()}" for _ in range(3)]
    seed = _start_seed(addrs[0], str(tmp_path / "p0"))
    sb_a = Standby(addrs[0], addrs[1], str(tmp_path / "p1"),
                   check_interval=0.2, failure_threshold=3,
                   probe_timeout=0.5, replicate=True)
    coord = RemoteCoord(addrs, reconnect_timeout=30.0)
    registry = CoordRegistry(coord, lease_ttl=TTL)
    try:
        assert sb_a.follower.synced.wait(timeout=10)
        reg = registry.register("svc", "n0", "127.0.0.1", 7100)
        coord.put("store/gen", "1")
        time.sleep(0.5)  # let the mirror stream the records

        os.kill(seed.pid, signal.SIGKILL)
        seed.wait(timeout=10)
        assert sb_a.promoted.wait(timeout=10), "first failover failed"

        # Chain: B replicates from the PROMOTED A.
        sb_b = Standby(addrs[1], addrs[2], str(tmp_path / "p2"),
                       check_interval=0.2, failure_threshold=3,
                       probe_timeout=0.5, replicate=True)
        try:
            assert sb_b.follower.synced.wait(timeout=10), (
                "second standby never synced from the promoted server")
            # Mutation on the new primary (retry while the client's
            # reconnect loop rides over to it).
            deadline = time.monotonic() + 15
            while True:
                try:
                    coord.put("store/gen", "2")
                    break
                except CoordinationError:
                    if time.monotonic() > deadline:
                        raise
                    time.sleep(0.2)
            time.sleep(0.5)
            sb_a.server.close()  # second "death" (hard close)
            assert sb_b.promoted.wait(timeout=15), (
                "second failover failed")

            deadline = time.monotonic() + TTL * 8
            val, nodes = None, []
            while time.monotonic() < deadline:
                try:
                    res = coord.range("store/gen")
                    val = res.items[0].value if res.items else None
                    nodes = registry.nodes("svc")
                    if val == "2" and len(nodes) == 1:
                        break
                except CoordinationError:
                    pass
                time.sleep(0.1)
            assert val == "2", f"KV lost across the chain: {val!r}"
            assert len(nodes) == 1, f"registration lost: {nodes}"
            del reg
        finally:
            sb_b.close()
    finally:
        coord.close()
        sb_a.close()
        if seed.poll() is None:
            seed.kill()
            seed.wait(timeout=10)


def test_standby_cli_process(tmp_path, free_port_pair):
    """The operator path end to end: ``python -m ptype_tpu_torch
    standby`` as a real process (config/env parsing included) promotes
    after the seed is SIGKILLed, and clients reach the promoted
    address."""
    primary_addr, standby_addr = free_port_pair
    data_dir = tmp_path / "d"
    seed = _start_seed(primary_addr, str(data_dir / "coord"))

    (tmp_path / "platform.yaml").write_text(
        f"name: sb\ncoordinator_address: \"{primary_addr}\"\n"
        f"data_dir: {data_dir}\n")
    (tmp_path / "standby.yaml").write_text(
        "service_name: standby\nnode_name: sb1\nport: 0\n"
        "platform_config_file: platform.yaml\n")
    env = dict(os.environ)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env.update(CONFIG=str(tmp_path / "standby.yaml"),
               STANDBY_ADDR=standby_addr,
               PYTHONPATH=repo + os.pathsep + env.get("PYTHONPATH", ""),
               JAX_PLATFORMS="cpu")
    sb = subprocess.Popen(
        [sys.executable, "-m", "ptype_tpu_torch", "standby"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
    try:
        from conftest import wait_output

        wait_output(sb, "standby for", timeout=30)
        os.kill(seed.pid, signal.SIGKILL)
        seed.wait(timeout=10)

        # Promotion takes ~failure_threshold probe rounds; the client
        # constructor dials eagerly, so construction retries too.
        deadline = time.monotonic() + 30
        val, coord = None, None
        try:
            while time.monotonic() < deadline:
                try:
                    if coord is None:
                        coord = RemoteCoord([standby_addr],
                                            reconnect_timeout=10.0)
                    coord.put("store/cli", "up")
                    val = coord.range("store/cli").items[0].value
                    break
                except CoordinationError:
                    time.sleep(0.3)
            assert val == "up", "promoted standby CLI never served"
        finally:
            if coord is not None:
                coord.close()
    finally:
        sb.terminate()
        try:
            sb.wait(timeout=10)
        except subprocess.TimeoutExpired:
            sb.kill()
            sb.wait(timeout=10)
        if seed.poll() is None:
            seed.kill()
            seed.wait(timeout=10)


def test_term_fence_refuses_restarted_stale_primary(tmp_path,
                                                    free_port_pair):
    """The wal-stream fence. After a wal-stream
    takeover bumps the fencing term, the OLD primary restarted on its
    old address (stale WAL, stale term) must not be able to serve
    fenced clients — they get refused, refuse IT in turn, and stay on
    (or return to) the current primary. Raft's leader epoch did this
    for the reference (cluster.go:120-147); here the term rides the
    coord wire protocol."""
    import socket as _socket
    import threading as _threading

    from ptype_tpu_torch.coord import wire

    primary_addr, standby_addr = free_port_pair
    primary_dir = str(tmp_path / "primary")
    standby_dir = str(tmp_path / "standby")
    seed = _start_seed(primary_addr, primary_dir)
    standby = Standby(primary_addr, standby_addr, standby_dir,
                      check_interval=0.2, failure_threshold=3,
                      probe_timeout=0.5, replicate=True)
    coord = RemoteCoord([primary_addr, standby_addr],
                        reconnect_timeout=30.0, request_timeout=5.0)
    old_seed = None
    restarted = None
    try:
        assert standby.follower.synced.wait(timeout=10)
        coord.put("store/epoch", "before")
        time.sleep(0.5)  # let the mirror stream the record

        os.kill(seed.pid, signal.SIGKILL)
        seed.wait(timeout=10)
        assert standby.promoted.wait(timeout=10)

        # The client rides onto the promoted standby and ADOPTS the
        # bumped term through the reply envelope.
        deadline = time.monotonic() + 15
        while True:
            try:
                coord.put("store/epoch", "after-takeover")
                break
            except CoordinationError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.2)
        assert coord.term >= 1, (
            f"client never adopted the promoted term: {coord.term}")
        fenced_term = coord.term

        # Restart the old primary on its old address over its STALE
        # data_dir — the exact operator mistake the fence exists for.
        old_seed = _start_seed(primary_addr, primary_dir)

        # (a) A fenced request sent straight at the stale primary is
        # refused without execution.
        host, _, port = primary_addr.rpartition(":")
        s = _socket.create_connection((host, int(port)), timeout=5)
        try:
            wire.send_msg(s, _threading.Lock(),
                          {"op": "put", "id": 1, "key": "store/epoch",
                           "value": "stale-write",
                           "min_term": fenced_term})
            reply = wire.recv_msg(s)
        finally:
            s.close()
        assert reply.get("stale") and not reply.get("ok"), (
            f"stale primary served a fenced write: {reply}")

        # (b) With ONLY the stale primary reachable, the fenced client
        # refuses to write at all rather than split-braining: take the
        # new primary down and watch the put fail closed.
        standby.server.close()
        with pytest.raises(CoordinationError):
            coord.put("store/epoch", "must-not-land")

        # (c) The current primary returns (plain restart over the
        # promoted dir — term persists); the client lands back on it.
        from ptype_tpu_torch.coord.service import CoordServer

        restarted = CoordServer(standby_addr, data_dir=standby_dir)
        deadline = time.monotonic() + 20
        while True:
            try:
                coord.put("store/epoch", "after-restart")
                break
            except CoordinationError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.2)
        assert coord.address == standby_addr, (
            f"client settled on {coord.address}, not the current "
            f"primary {standby_addr}")
        assert restarted.state.term == fenced_term

        # The fenced writes never landed on the stale primary: its
        # keyspace still holds the pre-takeover value.
        stale_view = RemoteCoord([primary_addr])
        try:
            res = stale_view.range("store/epoch")
            assert [it.value for it in res.items] == ["before"], (
                "a fenced write leaked onto the stale primary")
        finally:
            stale_view.close()
    finally:
        coord.close()
        standby.close()
        if restarted is not None:
            restarted.close()
        for p in (seed, old_seed):
            if p is not None and p.poll() is None:
                p.kill()
                p.wait(timeout=10)


def test_dynamic_standby_attach_catchup_promote(tmp_path, free_port_pair):
    """The runtime standby lifecycle, mirroring the
    reference's learner dance (memberAdd as learner → catch up →
    promote, cluster.go:120-147, 183-195; dead-member join drill
    cluster_test.go:133-165). A NEW standby attaches to a LIVE primary
    mid-load: it appears in the membership as a learner, becomes
    promote-eligible once its mirror catches up, clients that never
    knew its address discover it, and when the primary is killed the
    takeover loses zero registrations."""
    primary_addr, standby_addr = free_port_pair
    seed = _start_seed(primary_addr, str(tmp_path / "primary"))
    # The client knows ONLY the primary: the standby doesn't exist yet.
    coord = RemoteCoord([primary_addr], reconnect_timeout=30.0,
                        request_timeout=5.0, discovery_interval=0.2)
    registry = CoordRegistry(coord, lease_ttl=TTL)
    standby = None
    try:
        regs = [registry.register("svc", f"n{i}", "127.0.0.1", 7200 + i)
                for i in range(3)]
        coord.put("store/phase", "pre-attach")

        # Attach the standby to the RUNNING primary (no restart, no
        # static config on the client side).
        standby = Standby(primary_addr, standby_addr,
                          str(tmp_path / "standby"),
                          check_interval=0.2, failure_threshold=3,
                          probe_timeout=0.5, replicate=True)

        # Learner → promote-eligible member, observable via membership.
        def eligible_members():
            return [m for m in coord.member_list()
                    if (m.metadata or {}).get("role") == "standby"
                    and (m.metadata or {}).get("learner") is False]

        deadline = time.monotonic() + 15
        while time.monotonic() < deadline and not eligible_members():
            time.sleep(0.1)
        members = eligible_members()
        assert members, "standby never became a promote-eligible member"
        assert members[0].peer_addr == standby_addr
        assert standby.member_id == members[0].id
        assert standby.promote_eligible

        # The client's endpoint discovery picked the standby up.
        deadline = time.monotonic() + 10
        while (time.monotonic() < deadline
               and standby_addr not in coord.endpoints):
            time.sleep(0.1)
        assert standby_addr in coord.endpoints, (
            "client never discovered the attached standby")

        # Load after attach, then kill the primary.
        coord.put("store/phase", "post-attach")
        time.sleep(0.5)  # let the mirror stream the record
        os.kill(seed.pid, signal.SIGKILL)
        seed.wait(timeout=10)
        assert standby.promoted.wait(timeout=10), (
            "dynamically attached standby never took over")

        # Zero lost registrations + KV intact on the new primary.
        deadline = time.monotonic() + TTL * 8
        want = {7200, 7201, 7202}
        ports, val = set(), None
        while time.monotonic() < deadline:
            try:
                ports = {n.port for n in
                         registry.services().get("svc", [])}
                res = coord.range("store/phase")
                val = res.items[0].value if res.items else None
                if ports == want and val == "post-attach":
                    break
            except CoordinationError:
                pass
            time.sleep(0.1)
        assert ports == want, f"lost registrations: {want - ports}"
        assert val == "post-attach", f"lost KV state: {val!r}"
        del regs
    finally:
        coord.close()
        if standby is not None:
            standby.close()
        if seed.poll() is None:
            seed.kill()
            seed.wait(timeout=10)


def test_operator_promote_refuses_unsynced_mirror_unless_forced(
        tmp_path, free_port_pair):
    """Operator promote() over a never-synced wal-stream mirror is the
    silent-wipe footgun; it must refuse by default and require an
    explicit force=True (bootstrap-an-empty-control-plane intent)."""
    primary_addr, standby_addr = free_port_pair
    # No seed: the mirror can never sync.
    standby = Standby(primary_addr, standby_addr,
                      str(tmp_path / "standby"),
                      check_interval=0.2, failure_threshold=99,
                      probe_timeout=0.2, replicate=True)
    try:
        assert not standby.promote_eligible
        with pytest.raises(RuntimeError, match="never synced"):
            standby.promote(timeout=2.0)
        server = standby.promote(timeout=10.0, force=True)
        assert server is standby.server
        c = RemoteCoord([standby_addr])
        try:
            c.put("boot", "1")
            assert c.range("boot").items[0].value == "1"
        finally:
            c.close()
    finally:
        standby.close()


def test_sync_put_survives_immediate_failover(tmp_path, free_port_pair):
    """put(sync=True) acks only after the WAL follower has mirrored
    the record (the raft-commit analog): an acked sync write followed
    IMMEDIATELY by primary SIGKILL must appear on the promoted standby
    — streaming lag can never lose it. (A plain async put has no such
    guarantee; that's the documented difference.)"""
    primary_addr, standby_addr = free_port_pair
    seed = _start_seed(primary_addr, str(tmp_path / "p"))
    standby = Standby(primary_addr, standby_addr, str(tmp_path / "s"),
                      check_interval=0.2, failure_threshold=3,
                      probe_timeout=0.5, replicate=True)
    coord = RemoteCoord([primary_addr, standby_addr],
                        reconnect_timeout=30.0, request_timeout=10.0)
    try:
        assert standby.follower.synced.wait(timeout=10)
        coord.put("store/acked", "must-survive", sync=True)
        # No settling sleep — the kill races the stream ON PURPOSE;
        # the sync ack is the only thing standing between this write
        # and the WAL-streaming lag.
        os.kill(seed.pid, signal.SIGKILL)
        seed.wait(timeout=10)
        assert standby.promoted.wait(timeout=10)

        deadline = time.monotonic() + 15
        val = None
        while time.monotonic() < deadline:
            try:
                res = coord.range("store/acked")
                val = res.items[0].value if res.items else None
                if val == "must-survive":
                    break
            except CoordinationError:
                pass
            time.sleep(0.1)
        assert val == "must-survive", (
            f"acked sync write lost across failover: {val!r}")
    finally:
        coord.close()
        standby.close()
        if seed.poll() is None:
            seed.kill()
            seed.wait(timeout=10)


def test_two_standbys_deterministic_succession(tmp_path):
    """Two wal-stream standbys guarding ONE primary (easy to reach now
    that standbys attach dynamically) must not both promote on its
    death: the senior (lowest member id) takes over, the junior defers,
    ADOPTS the winner as its new primary, and keeps guarding — so a
    second death fails over again with no operator action. State
    survives both hops; at no point do two primaries serve."""
    import socket as _socket

    def _port():
        with _socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    addrs = [f"127.0.0.1:{_port()}" for _ in range(3)]
    seed = _start_seed(addrs[0], str(tmp_path / "p"))
    sb_a = Standby(addrs[0], addrs[1], str(tmp_path / "a"),
                   check_interval=0.2, failure_threshold=3,
                   probe_timeout=0.5, replicate=True)
    sb_b = None
    coord = RemoteCoord(addrs, reconnect_timeout=30.0,
                        request_timeout=5.0)
    try:
        assert sb_a.follower.synced.wait(timeout=10)
        # A must be registered + eligible before B attaches, so the
        # seniority order (member id) is deterministic: A < B.
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline and sb_a.member_id is None:
            time.sleep(0.1)
        assert sb_a.member_id is not None
        sb_b = Standby(addrs[0], addrs[2], str(tmp_path / "b"),
                       check_interval=0.2, failure_threshold=3,
                       probe_timeout=0.5, replicate=True)
        assert sb_b.follower.synced.wait(timeout=10)
        coord.put("store/hop", "0")
        # Both must know about each other (succession lists cached from
        # the live primary) before the kill.
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline and not (
                sb_b._peer_standbys and sb_a._peer_standbys
                and sb_b.member_id is not None):
            time.sleep(0.1)
        assert any(a == addrs[2] for _, a in sb_a._peer_standbys), (
            f"senior never learned about the junior: "
            f"{sb_a._peer_standbys}")
        assert any(a == addrs[1] for _, a in sb_b._peer_standbys), (
            f"junior never learned about the senior: "
            f"{sb_b._peer_standbys}")
        time.sleep(0.5)  # let the mirrors stream the last put

        os.kill(seed.pid, signal.SIGKILL)
        seed.wait(timeout=10)

        assert sb_a.promoted.wait(timeout=15), "senior never promoted"
        # The junior must NOT promote; it re-points at the winner.
        deadline = time.monotonic() + 15
        while (time.monotonic() < deadline
               and sb_b.primary_address != addrs[1]):
            assert not sb_b.promoted.is_set(), (
                "junior promoted alongside the senior: split brain")
            time.sleep(0.1)
        assert sb_b.primary_address == addrs[1], (
            "junior never adopted the promoted senior")
        assert not sb_b.promoted.is_set()
        # The follower object is swapped during adoption (briefly
        # None); wait for a LIVE follower whose fresh mirror synced
        # from the new primary.
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline:
            f = sb_b.follower
            if f is not None and not f.closed and f.synced.is_set():
                break
            time.sleep(0.1)
        else:
            pytest.fail("junior's mirror never re-synced from the "
                        "new primary")

        # Write on the new primary, then kill it: the junior (now the
        # only standby) takes over — the chain re-formed itself.
        deadline = time.monotonic() + 15
        while True:
            try:
                coord.put("store/hop", "1")
                break
            except CoordinationError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.2)
        time.sleep(0.5)  # mirror the record
        sb_a.server.close()
        assert sb_b.promoted.wait(timeout=20), (
            "junior never promoted after the second death")

        deadline = time.monotonic() + 15
        val = None
        while time.monotonic() < deadline:
            try:
                res = coord.range("store/hop")
                val = res.items[0].value if res.items else None
                if val == "1":
                    break
            except CoordinationError:
                pass
            time.sleep(0.1)
        assert val == "1", f"state lost across the double hop: {val!r}"
        # Fence: the second takeover is at a strictly higher term.
        assert sb_b.server.state.term == 2, sb_b.server.state.term
    finally:
        coord.close()
        sb_a.close()
        if sb_b is not None:
            sb_b.close()
        if seed.poll() is None:
            seed.kill()
            seed.wait(timeout=10)



def test_watch_resumes_across_failover_without_relist(
        tmp_path, free_port_pair):
    """Round-5 composition: the wal-stream mirror replays the same
    revision lineage, so a client watch that rode the failover can
    RESUME from its last delivered revision on the promoted standby —
    events flow with NO epoch bump (pre-MVCC every reconnect forced a
    snapshot re-list)."""
    primary_addr, standby_addr = free_port_pair
    seed = _start_seed(primary_addr, str(tmp_path / "p"))
    standby = Standby(primary_addr, standby_addr, str(tmp_path / "s"),
                      check_interval=0.2, failure_threshold=3,
                      probe_timeout=0.5, replicate=True)
    coord = RemoteCoord([primary_addr, standby_addr],
                        reconnect_timeout=30.0)
    try:
        assert standby.follower.synced.wait(timeout=10)
        w = coord.watch("svc/")
        coord.put("svc/a", "1", sync=True)
        evs = w.get(timeout=5)
        assert [e.key for e in evs] == ["svc/a"]

        os.kill(seed.pid, signal.SIGKILL)
        seed.wait(timeout=10)
        assert standby.promoted.wait(timeout=15)

        # Write on the NEW primary; the resumed watch must deliver it.
        rev = standby.server.state.put("svc/b", "2")
        got = []
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline and not got:
            got = [e for e in w.get(timeout=1) if e.mod_rev == rev]
        assert got, "watch never delivered post-failover event"
        assert w.epoch == 0, (
            "epoch bumped: the failover resume forced a re-list even "
            "though the mirror's history covered the gap")
    finally:
        coord.close()
        standby.close()
        if seed.poll() is None:
            seed.kill()
            seed.wait(timeout=10)


@pytest.fixture
def free_port_pair():
    import socket

    socks = [socket.socket(), socket.socket()]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    addrs = [f"127.0.0.1:{s.getsockname()[1]}" for s in socks]
    for s in socks:
        s.close()
    return addrs


# ------------------------------------------------ across the two packages


def _cross_takeover(tmp_path, free_port_pair, seed_cmd, standby_cls,
                    coord_cls, registry_cls):
    """A wal-stream standby of one package mirrors a seed process of the
    other, takes over after its SIGKILL, and serves the registrations
    and KV a client of the standby's package wrote before the kill."""
    primary_addr, standby_addr = free_port_pair
    seed = _start_seed(primary_addr, str(tmp_path / "primary"), seed_cmd)
    standby = standby_cls(primary_addr, standby_addr,
                          str(tmp_path / "standby"),
                          check_interval=0.2, failure_threshold=3,
                          probe_timeout=0.5, replicate=True)
    coord = coord_cls([primary_addr, standby_addr], reconnect_timeout=30.0)
    registry = registry_cls(coord, lease_ttl=TTL)
    try:
        assert standby.follower.synced.wait(timeout=10), (
            "the standby never mirrored the other package's snapshot")
        regs = [registry.register("svc", f"n{i}", "127.0.0.1", 7300 + i)
                for i in range(2)]
        coord.put("store/cross", "kept", sync=True)
        os.kill(seed.pid, signal.SIGKILL)
        seed.wait(timeout=10)
        assert standby.promoted.wait(timeout=10), (
            "the standby never promoted over the other package's WAL")
        deadline = time.monotonic() + 10 * TTL
        ports, val = set(), None
        while time.monotonic() < deadline:
            try:
                ports = {n.port for n in registry.services().get("svc", [])}
                items = coord.range("store/cross").items
                val = items[0].value if items else None
                if ports == {7300, 7301} and val == "kept":
                    break
            except Exception:  # noqa: BLE001 — the reconnect surface
                pass
            time.sleep(0.1)
        assert ports == {7300, 7301}, f"lost registrations: {ports}"
        assert val == "kept", f"lost KV state: {val!r}"
        assert standby.server.state.term >= 1
        del regs
    finally:
        coord.close()
        standby.close()
        if seed.poll() is None:
            seed.kill()
            seed.wait(timeout=10)


def test_port_standby_takes_over_from_reference_seed(tmp_path,
                                                     free_port_pair):
    _cross_takeover(tmp_path, free_port_pair, [sys.executable, REF_SEED],
                    Standby, RemoteCoord, CoordRegistry)


def test_reference_standby_takes_over_from_port_seed(tmp_path,
                                                     free_port_pair):
    from ptype_tpu.coord.remote import RemoteCoord as JRemoteCoord
    from ptype_tpu.coord.standby import Standby as JStandby
    from ptype_tpu.registry import CoordRegistry as JCoordRegistry

    _cross_takeover(tmp_path, free_port_pair, None, JStandby, JRemoteCoord,
                    JCoordRegistry)

