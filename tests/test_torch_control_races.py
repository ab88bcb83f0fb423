"""Two races of the port's replica control plane, on the CPU with no
load needed:

- a ``Replica.Drain`` or ``Replica.Exit`` reply written after the order
  has ended the replica: the host's exit path quiesces its server
  (``ActorServer.quiesce``) before it shuts the connections, so the
  reply arrives; a request read once the quiesce began is refused with
  the typed ``ServerClosingError``;
- ``ReplicaHost.activate``'s window between the registration and the
  lifecycle flip: a registry that reads the actor's ``Info()`` the
  moment the registration is visible never reads ``warm``, and
  ``status()`` never pairs ``warm`` with ``registered``.

The calls dial real TCP sockets: ``actor.lookup_local`` is patched to
None, so an in-process dial does not short-circuit to the handler. A
worker's main loop (``reconciler/worker.py``: wait for the exit, then
``host.close()``) runs on a thread. Every wait has a deadline.
"""

import threading
import time
from unittest import mock

import numpy as np
import pytest

from ptype_tpu_torch import actor as tactor
from ptype_tpu_torch import errors
from ptype_tpu_torch import lockcheck as tlockcheck
from ptype_tpu_torch import rpc as rpc_mod
from ptype_tpu_torch.coord.core import CoordState
from ptype_tpu_torch.coord.local import LocalCoord
from ptype_tpu_torch.errors import CoordinationError, ShedError
from ptype_tpu_torch.reconciler import FakeGeneratorActor
from ptype_tpu_torch.reconciler.replica import ReplicaHost
from ptype_tpu_torch.registry import CoordRegistry, Node

#: How long a slowed handler holds its reply once the exit has begun.
SLOW_S = 0.3


@pytest.fixture(autouse=True)
def _wire_and_lock_order():
    """Calls go over TCP; the port's lock-order watchdog is armed (a
    cycle in the acquisition graph fails the test)."""
    was = tlockcheck.active()
    wd = tlockcheck.enable()
    with mock.patch.object(tactor, "lookup_local", lambda a, p: None):
        yield
    cycles = wd.cycles()
    tlockcheck._watchdog = was
    assert not cycles, f"lock-order cycles: {cycles}"


@pytest.fixture
def registry():
    state = CoordState(sweep_interval=0.05)
    yield CoordRegistry(LocalCoord(state), lease_ttl=2.0)
    state.close()


def _dial(host):
    return rpc_mod._dial(Node(address="127.0.0.1", port=host.port), 5.0,
                         device="cpu")


def _worker_loop(host):
    """``reconciler/worker.py``'s main loop on a thread: park until the
    host's exit, then close it."""
    t = threading.Thread(target=lambda: (host.wait_exit(), host.close()),
                         daemon=True)
    t.start()
    return t


@pytest.mark.parametrize("method,args", [("Replica.Drain", (30.0,)),
                                         ("Replica.Exit", ())])
def test_an_order_that_ends_the_replica_gets_its_reply(registry, method,
                                                       args):
    """The fake actor drains at once, so the drain thread asks for the
    exit while ``Replica.Drain`` still builds its reply (its
    ``status()`` slowed once the exit has begun); ``Replica.Exit``'s
    handler is slowed the same way after it asks. The worker's close
    runs meanwhile: the reply still arrives, then the host exits and
    leaves the registry."""
    host = ReplicaHost(registry, "llm", "r0", FakeGeneratorActor)
    status, request_exit = host.status, host.request_exit

    def slow_status():
        if host.lifecycle in ("draining", "drained"):
            host.wait_exit(5)
            time.sleep(SLOW_S)
        return status()

    def slow_exit():
        request_exit()
        time.sleep(SLOW_S)

    host.status, host.request_exit = slow_status, slow_exit
    assert len(registry.nodes("llm")) == 1
    worker = _worker_loop(host)
    conn = _dial(host)
    try:
        reply = conn.call_async(method, args).result(timeout=10)
    finally:
        conn.close()
        host.request_exit()
        worker.join(timeout=20)
    if method == "Replica.Drain":
        assert reply["lifecycle"] in ("draining", "drained")
        assert reply["drain_started"] is not None
    else:
        assert reply is True
    assert not worker.is_alive() and not host.server.serving
    assert registry.nodes("llm") == []


class _HeldActor(FakeGeneratorActor):
    """A fake whose Generate waits, once inside, until the test lets it
    return."""

    def __init__(self):
        super().__init__()
        self.entered, self.release = threading.Event(), threading.Event()

    def Generate(self, prompt, max_new_tokens: int = 8, *args):
        self.entered.set()
        self.release.wait(20)
        return super().Generate(prompt, max_new_tokens, *args)


def test_a_request_read_while_the_server_quiesces_is_refused_typed(
        registry):
    """A Generate is in flight when the worker's close begins: the
    server stops accepting, a request sent on an open connection
    meanwhile gets the typed refusal (a shed, not a dropped socket),
    and the in-flight Generate, let go after that, still gets its
    answer."""
    host = ReplicaHost(registry, "llm", "r0", _HeldActor)
    worker = None
    conn = _dial(host)
    try:
        slow = conn.call_async("Generator.Generate",
                               (np.zeros((1, 4), np.int32), 3))
        assert host.actor.entered.wait(10), "the Generate never ran"
        host.request_exit()
        worker = _worker_loop(host)
        deadline = time.monotonic() + 10
        while host.server.serving:
            assert time.monotonic() < deadline, "the close never began"
            time.sleep(0.005)
        with pytest.raises(ShedError) as refused:
            conn.call_async("Replica.Status", ()).result(timeout=10)
        assert isinstance(refused.value, errors.ServerClosingError)
        assert refused.value.retry_after_s == tactor.CLOSING_RETRY_S
        # No new connection: the listening socket is closed and the
        # server is gone from the in-process table (no dial, whose port
        # another process may have bound since).
        assert host.server._sock.fileno() == -1
        assert host.server not in tactor._local_servers.values()
        host.actor.release.set()
        out = slow.result(timeout=10)
        assert out.shape == (1, 3) and (out == 7).all()
    finally:
        host.actor.release.set()
        conn.close()
        host.request_exit()
        if worker is not None:
            worker.join(timeout=20)
    assert not worker.is_alive()


def test_a_listed_replica_never_reads_warm(registry):
    """A registry that reads the actor's ``Info()`` the moment each
    registration returns, and holds it a while: no read is ``warm``, and
    a ``status()`` poller never sees ``warm`` beside ``registered`` nor
    ``active`` without it. A registration that fails leaves the replica
    warm and unlisted; the next activation lists it active."""
    box, seen, pairs = {}, [], []
    fail = {"next": True}
    register = registry.register

    def peeking_register(*a, **k):
        if fail.pop("next", False):
            raise CoordinationError("the coordinator refused the lease")
        reg = register(*a, **k)
        seen.append(box["actor"].Info()["lifecycle"])
        time.sleep(0.05)
        return reg

    def make():
        box["actor"] = FakeGeneratorActor()
        return box["actor"]

    registry.register = peeking_register
    host = ReplicaHost(registry, "llm", "r0", make, warm_hold=True)
    stop = threading.Event()

    def poll():
        while not stop.is_set():
            st = host.status()
            pairs.append((st["lifecycle"], st["registered"]))

    poller = threading.Thread(target=poll, daemon=True)
    poller.start()
    try:
        with pytest.raises(CoordinationError):
            host.activate()
        assert host.status()["lifecycle"] == "warm"
        assert box["actor"].Info()["lifecycle"] == "warm"
        assert registry.nodes("llm") == []
        host.activate()
        time.sleep(0.05)
    finally:
        stop.set()
        poller.join(timeout=10)
        host.close()
    assert seen == ["active"]
    assert set(pairs) <= {("warm", False), ("active", True)}
    assert ("active", True) in pairs
