"""Quorum drills of the port's coordinator failover: the witness, the
partitioned-minority self-fence and the quorum window —
``tests/test_failover.py``'s partition drills on the port's
``CoordServer``, ``Standby`` and ``WitnessServer``.

Each network path a drill cuts runs through a ``_TcpProxy`` (a
point-to-point forwarder whose ``cut()`` severs that path alone), so a
partition is expressed in one process. The primary's quorum loop and
self-fence (``coord/service.py`` ``_quorum_round``, ``_fenced``) run
here as the port copied them.
"""

import signal
import time

import pytest

from ptype_tpu_torch.coord.remote import RemoteCoord
from ptype_tpu_torch.coord.standby import Standby
from ptype_tpu_torch.errors import CoordinationError


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



class _TcpProxy:
    """Point-to-point TCP forwarder standing in for ONE network path.
    ``cut()`` severs exactly that path (refuses new dials, kills live
    links) while every other path stays up — a real partition blocks
    by (src, dst) pair, which a single in-process server can't express
    any other way."""

    def __init__(self, target: str):
        import socket as _socket
        import threading as _threading

        self._target = target
        self._lis = _socket.socket()
        self._lis.setsockopt(_socket.SOL_SOCKET,
                             _socket.SO_REUSEADDR, 1)
        self._lis.bind(("127.0.0.1", 0))
        self._lis.listen(32)
        self.address = f"127.0.0.1:{self._lis.getsockname()[1]}"
        self._conns: set = set()
        self._lock = _threading.Lock()
        self._cut = _threading.Event()
        _threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self):
        import socket as _socket
        import threading as _threading

        host, _, port = self._target.rpartition(":")
        while not self._cut.is_set():
            try:
                c, _peer = self._lis.accept()
            except OSError:
                return
            try:
                u = _socket.create_connection((host, int(port)),
                                              timeout=2.0)
            except OSError:
                c.close()
                continue
            with self._lock:
                self._conns.update((c, u))
            for a, b in ((c, u), (u, c)):
                _threading.Thread(target=self._pump, args=(a, b),
                                  daemon=True).start()

    def _pump(self, a, b):
        import socket as _socket

        try:
            while True:
                data = a.recv(65536)
                if not data:
                    break
                b.sendall(data)
        except OSError:
            pass
        finally:
            for s in (a, b):
                try:
                    s.shutdown(_socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    s.close()
                except OSError:
                    pass

    def cut(self):
        import socket as _socket

        self._cut.set()
        try:
            self._lis.close()
        except OSError:
            pass
        with self._lock:
            conns, self._conns = list(self._conns), set()
        for s in conns:
            try:
                s.shutdown(_socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass


WITNESS_TTL = 1.0


def _witness_cluster(tmp_path, standby_addr, *,
                     proxy_witness: bool, proxy_primary: bool):
    """Primary (in-process, witness-fenced) + wal-stream standby +
    witness, with proxies on the paths a drill wants to cut."""
    from ptype_tpu_torch.coord.service import CoordServer
    from ptype_tpu_torch.coord.witness import WitnessServer

    witness = WitnessServer(ttl=WITNESS_TTL)
    wproxy = _TcpProxy(witness.address) if proxy_witness else None
    primary = CoordServer(
        "127.0.0.1:0", data_dir=str(tmp_path / "p"),
        witness_addr=(wproxy.address if wproxy else witness.address),
        witness_ttl=WITNESS_TTL)
    pproxy = _TcpProxy(primary.address) if proxy_primary else None
    standby = Standby(
        pproxy.address if pproxy else primary.address,
        standby_addr, str(tmp_path / "s"),
        check_interval=0.2, failure_threshold=3, probe_timeout=0.5,
        replicate=True, witness_addr=witness.address,
        witness_ttl=WITNESS_TTL)
    return witness, wproxy, primary, pproxy, standby


def test_partition_minority_primary_fences_and_standby_promotes(
        tmp_path, free_port_pair):
    """THE raft-parity drill (ref cluster_test.go:47-167): partition
    the primary onto the minority side (it can reach neither witness
    nor standby) while a client can reach ONLY it. The old term fence
    can't help — this client never sees the successor's term. The
    quorum self-fence must refuse it anyway, while the majority side
    (standby + witness) promotes and serves the intact state."""
    _, standby_addr = free_port_pair
    witness, wproxy, primary, pproxy, standby = _witness_cluster(
        tmp_path, standby_addr, proxy_witness=True, proxy_primary=True)
    client = RemoteCoord([primary.address], request_timeout=5.0,
                         reconnect_timeout=5.0)
    c2 = None
    try:
        assert standby.follower.synced.wait(timeout=10)
        # sync=True: the cut below DELIBERATELY races the repl stream;
        # only a replication-acked write is promised to survive.
        client.put("store/k", "v1", sync=True)

        # PARTITION: primary loses witness AND standby; the standby
        # keeps the witness; the client keeps the (old) primary.
        wproxy.cut()
        pproxy.cut()

        assert standby.promoted.wait(timeout=20), (
            "standby (majority side) never promoted")
        # The minority primary must refuse its clients — stalling or
        # erroring is acceptable, serving is not.
        with pytest.raises(CoordinationError):
            client.put("store/k", "v2-through-stale-primary")
        with pytest.raises(CoordinationError):
            client.range("store/k")
        # Majority side: data intact, term advanced. (Transient
        # connection errors right after promotion are the client's
        # normal retry surface — retry, but never accept a wrong
        # value.)
        c2 = RemoteCoord([standby.server.address],
                         reconnect_timeout=10.0)
        val = None
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline and val is None:
            try:
                items = c2.range("store/k").items
                val = items[0].value if items else None
            except CoordinationError:
                time.sleep(0.2)
        assert val == "v1", (
            f"majority side lost the replication-acked write: {val!r}")
        assert standby.server.state.term >= 1
    finally:
        if c2 is not None:
            c2.close()
        client.close()
        standby.close()
        primary.close()
        witness.close()


def test_partition_isolated_standby_does_not_promote(
        tmp_path, free_port_pair):
    """The inverse partition: only the standby⇄primary path drops;
    primary and standby both still reach the witness. The standby's
    probes all fail — but the witness refuses it the lease (the
    primary keeps renewing), so it must NOT promote, and the primary
    (majority side: self + witness) keeps serving."""
    _, standby_addr = free_port_pair
    witness, _, primary, pproxy, standby = _witness_cluster(
        tmp_path, standby_addr, proxy_witness=False,
        proxy_primary=True)
    client = RemoteCoord([primary.address])
    try:
        assert standby.follower.synced.wait(timeout=10)
        client.put("store/k", "v1")

        pproxy.cut()  # standby sees a "dead" primary

        # Give it several full detection + promotion-attempt cycles.
        time.sleep(3 * WITNESS_TTL + 2.0)
        assert not standby.promoted.is_set(), (
            "isolated standby promoted over a healthy primary — "
            "split brain")
        # The healthy majority primary serves on, same term.
        client.put("store/k", "v2")
        assert client.range("store/k").items[0].value == "v2"
        assert primary.state.term == 0
    finally:
        client.close()
        standby.close()
        primary.close()
        witness.close()


def test_witness_outage_majority_pair_keeps_serving(
        tmp_path, free_port_pair):
    """Witness down, primary+standby connected: the pair IS the
    majority (2 of 3). The follower heartbeat round-trip is the
    primary's second vote, so serving continues — the witness must
    never be a single point of failure for a healthy pair."""
    _, standby_addr = free_port_pair
    witness, wproxy, primary, _, standby = _witness_cluster(
        tmp_path, standby_addr, proxy_witness=True,
        proxy_primary=False)
    client = RemoteCoord([primary.address])
    try:
        assert standby.follower.synced.wait(timeout=10)
        client.put("store/k", "v1")

        wproxy.cut()  # witness unreachable from the primary

        time.sleep(3 * WITNESS_TTL)
        client.put("store/k", "v2")  # still served: follower vote
        assert client.range("store/k").items[0].value == "v2"
        assert not standby.promoted.is_set()
    finally:
        client.close()
        standby.close()
        primary.close()
        witness.close()


def test_witness_outage_survives_follower_blip(tmp_path, free_port_pair):
    """With the witness down, the follower
    heartbeat is the primary's ONLY second vote — so a follower
    connection blip must not fence the primary PERMANENTLY. The
    returning follower's repl_subscribe must pass the soft fence
    (refusing it would make the fence self-sustaining forever while
    primary+standby, 2 of the 3 voters, are healthy)."""
    import socket as _socket

    _, standby_addr = free_port_pair
    witness, wproxy, primary, _, standby = _witness_cluster(
        tmp_path, standby_addr, proxy_witness=True,
        proxy_primary=False)
    client = RemoteCoord([primary.address], reconnect_timeout=30.0)
    try:
        assert standby.follower.synced.wait(timeout=10)
        client.put("store/k", "v1")

        wproxy.cut()  # witness gone: follower vote is all that's left
        time.sleep(2 * WITNESS_TTL)
        # Blip the follower connection; its loop redials in ~0.5s.
        sock = standby.follower._sock
        if sock is not None:
            try:
                sock.shutdown(_socket.SHUT_RDWR)
            except OSError:
                pass
        # The primary may fence for ~a TTL; once the follower
        # re-subscribes and heartbeats, service must resume.
        deadline = time.monotonic() + 10 * WITNESS_TTL
        ok = False
        while time.monotonic() < deadline and not ok:
            try:
                client.put("store/k", "v2")
                ok = True
            except CoordinationError:
                time.sleep(0.2)
        assert ok, ("primary never recovered after a follower blip "
                    "with the witness down — permanent self-fence")
        assert not standby.promoted.is_set()
    finally:
        client.close()
        standby.close()
        primary.close()
        witness.close()


def test_two_standbys_with_witness_elect_single_successor(
        tmp_path, free_port_pair):
    """Succession × witness: with two standbys guarding one primary,
    the witness lease must not deadlock the succession protocol — and
    whatever races happen, AT MOST ONE standby can ever hold the
    lease and serve. (Senior-preference is best-effort timing and is
    asserted by test_two_standbys_deterministic_succession; here the
    invariants are single-winner + data intact + witness records
    exactly the winner.)"""
    from ptype_tpu_torch.coord.service import CoordServer
    from ptype_tpu_torch.coord.witness import WitnessServer, status

    witness = WitnessServer(ttl=1.0)
    primary = CoordServer("127.0.0.1:0", data_dir=str(tmp_path / "p"),
                          witness_addr=witness.address,
                          witness_ttl=1.0)
    addr_a, addr_b = free_port_pair
    kw = dict(check_interval=0.2, failure_threshold=3,
              probe_timeout=0.5, replicate=True,
              witness_addr=witness.address, witness_ttl=1.0,
              succession_grace=2.0)
    sb_a = Standby(primary.address, addr_a, str(tmp_path / "a"), **kw)
    assert sb_a.follower.synced.wait(timeout=10)
    sb_b = Standby(primary.address, addr_b, str(tmp_path / "b"), **kw)
    assert sb_b.follower.synced.wait(timeout=10)
    client = RemoteCoord([primary.address, addr_a, addr_b],
                         reconnect_timeout=30.0)
    try:
        client.put("store/k", "v1", sync=True)
        # Wait until each standby's PEER VIEW shows the other as
        # promote-eligible — _peer_standbys refreshes once per probe
        # round, and killing the primary inside that propagation
        # window would legitimately let the junior see zero seniors
        # (syncing on the LOCAL _member_promoted flag
        # raced exactly there).
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline and not (
                any(a == addr_b for _, a in sb_a._peer_standbys)
                and any(a == addr_a for _, a in sb_b._peer_standbys)):
            time.sleep(0.1)

        primary.close()  # the primary dies (in-process analog)

        deadline = time.monotonic() + 30
        winner = None
        while time.monotonic() < deadline and winner is None:
            if sb_a.promoted.is_set():
                winner = (sb_a, addr_a)
            elif sb_b.promoted.is_set():
                winner = (sb_b, addr_b)
            else:
                time.sleep(0.1)
        assert winner is not None, "no standby ever promoted"
        loser = sb_b if winner[0] is sb_a else sb_a
        # The OTHER standby must never also serve.
        time.sleep(2.0)
        assert not loser.promoted.is_set(), (
            "both standbys promoted — split brain despite witness")
        st = status(witness.address)
        assert st["holder"] == winner[1], st
        # Clients ride onto the winner; data intact.
        deadline = time.monotonic() + 15
        val = None
        while time.monotonic() < deadline and val != "v1":
            try:
                items = client.range("store/k").items
                val = items[0].value if items else None
            except CoordinationError:
                time.sleep(0.2)
        assert val == "v1"
    finally:
        client.close()
        sb_a.close()
        sb_b.close()
        primary.close()
        witness.close()


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


# ------------------------------------------------ quorum window anchoring


def test_follower_vote_anchors_quorum_to_last_round_trip():
    """The quorum self-fence window: the
    follower vote must extend the serving window from the follower's
    actual last round-trip, not from "now" — an almost-TTL-old
    heartbeat granting a fresh full TTL let a primary serve up to
    ~2×TTL past its last real contact, overlapping a successor that
    took the (vacant) witness lease."""
    import socket as _socket

    from ptype_tpu_torch.coord.core import CoordState
    from ptype_tpu_torch.coord.service import CoordServer

    # Witness configured but unreachable (immediately-refused port):
    # majority-pair mode — the follower round-trip is the only vote.
    with _socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dead_addr = f"127.0.0.1:{s.getsockname()[1]}"
    ttl = 3.0
    server = CoordServer("127.0.0.1:0", CoordState(sweep_interval=0.05),
                         witness_addr=dead_addr, witness_ttl=ttl)
    try:
        feed = server.state.repl_subscribe()
        stale = time.monotonic() - 0.8 * ttl
        feed.last_hb = stale
        server._quorum_until = 0.0  # white-box: decay the boot grace
        server._quorum_round()
        granted = server._quorum_until
        # Old behavior: t0 + ttl ≈ now + 3.0 s of window. Anchored:
        # stale + ttl ≈ now + 0.6 s.
        assert granted == pytest.approx(stale + ttl, abs=0.4), (
            f"follower vote granted "
            f"{granted - time.monotonic():.2f}s of serving window; "
            f"must anchor to the follower's last round-trip")
        assert granted - time.monotonic() < 1.5
    finally:
        server.close()


def test_same_term_witness_refusal_is_retriable_not_terminal():
    """A witness refusal whose reported
    term is NOT above ours proves a holder-string mismatch (restart
    under a different address, witness state loss), not a successor —
    it must deny the vote and retry, never terminally fence. A refusal
    carrying a strictly higher term still hard-fences."""
    from ptype_tpu_torch.coord import witness as witness_mod
    from ptype_tpu_torch.coord.core import CoordState
    from ptype_tpu_torch.coord.service import CoordServer
    from ptype_tpu_torch.coord.witness import WitnessServer

    w = WitnessServer(ttl=30.0)
    server = None
    try:
        # Another holder string at the SAME term the server runs at —
        # the shape an address change across a restart produces.
        assert witness_mod.acquire(w.address, candidate="old-name",
                                   term=0)["granted"]
        server = CoordServer("127.0.0.1:0",
                             CoordState(sweep_interval=0.05),
                             witness_addr=w.address, witness_ttl=30.0)
        server._quorum_round()
        assert server._superseded is None, (
            "same-term refusal must be retriable, not terminal")
        assert server._refusals >= 1
        # A strictly-higher recorded term — a promoted successor.
        with w._lock:
            w._term = server.state.term + 3
        server._quorum_round()
        assert server._superseded is not None
    finally:
        if server is not None:
            server.close()
        w.close()


def test_unsynced_standby_never_consumes_witness_lease(tmp_path,
                                                       free_port_pair):
    """Promotion ordering: the
    synced-mirror precondition must run BEFORE the witness acquire. An
    unsynced standby that grabbed the lease (bumped term) and then
    refused to promote left a later-returning primary permanently
    'superseded' by a successor that never serves."""
    from ptype_tpu_torch.coord import witness as witness_mod
    from ptype_tpu_torch.coord.witness import WitnessServer

    primary_addr, standby_addr = free_port_pair
    # Nothing ever listens on primary_addr: the mirror can never sync
    # and every probe fails — promotion attempts fire continuously.
    w = WitnessServer(ttl=WITNESS_TTL)
    standby = Standby(primary_addr, standby_addr, str(tmp_path / "s"),
                      check_interval=0.1, failure_threshold=2,
                      probe_timeout=0.3, replicate=True,
                      register=False, witness_addr=w.address,
                      witness_ttl=WITNESS_TTL)
    try:
        deadline = time.monotonic() + 3.0
        while time.monotonic() < deadline:
            assert not standby.promoted.is_set(), (
                "unsynced standby must never promote")
            time.sleep(0.1)
        st = witness_mod.status(w.address)
        assert st["holder"] is None, (
            f"unsynced standby consumed the witness lease: {st}")
    finally:
        standby.close()
        w.close()
