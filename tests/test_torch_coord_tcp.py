"""The port's TCP coordination tier (``ptype_tpu_torch.coord.service``
``CoordServer`` + ``coord.remote.RemoteCoord``) held to the contracts
of ``tests/test_coord.py``'s TCP section: KV, prefix and range options,
reads at a revision, leases and expiry, watch push, resume from a
revision after a reconnect, relist after compaction, members, barrier,
sync puts and replication feeds, a dial failure, garbage frames.

Across packages: one scripted sequence of operations, run with every
pairing of server and client package (ref/ref, port/port, ref server
with port client, port server with ref client), must give equal
values, revisions, lease ids, members and watch events. Everything is
exact; every server binds port 0."""

import socket
import threading
import time
from types import SimpleNamespace

import pytest

from ptype_tpu.coord import core as jcore
from ptype_tpu.coord import remote as jremote
from ptype_tpu.coord import service as jservice
from ptype_tpu.errors import CoordinationError as JCoordinationError
from ptype_tpu_torch.coord import api as tapi
from ptype_tpu_torch.coord import core as tcore
from ptype_tpu_torch.coord import remote as tremote
from ptype_tpu_torch.coord import service as tservice
from ptype_tpu_torch.coord import wire
from ptype_tpu_torch.errors import CoordinationError

PKG = {"ref": SimpleNamespace(core=jcore, service=jservice, remote=jremote),
       "port": SimpleNamespace(core=tcore, service=tservice,
                               remote=tremote)}
RangeOptions = tcore.RangeOptions
RemoteCoord = tremote.RemoteCoord


def wait_until(pred, timeout=3.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


@pytest.fixture
def server():
    s = tservice.CoordServer("127.0.0.1:0",
                             tcore.CoordState(sweep_interval=0.05))
    yield s
    s.close()


def _drop_client_socket(c):
    """Sever the client's TCP connection under it (a network blip)."""
    try:
        c._sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass


# ------------------------------------------------------------- contracts


def test_connect_dials_tcp(server):
    c = tapi.connect(server.address, dial_timeout=2.0)
    try:
        assert isinstance(c, RemoteCoord)
        assert c.put("a", "1") > 0
        assert c.range("a").items[0].value == "1"
    finally:
        c.close()


def test_kv_prefix_and_range_options(server):
    c = RemoteCoord(server.address)
    try:
        r1 = c.put("a/x", "1")
        assert c.put("a/x", "1b") > r1
        item = c.range("a/x").items[0]
        assert (item.value, item.version, item.create_rev) == ("1b", 2, r1)
        for i in range(5):
            c.put(f"k/{i}", str(9 - i))
        res = c.range("k/", RangeOptions(prefix=True, limit=2))
        assert len(res.items) == 2 and res.count == 5
        res = c.range("k/", RangeOptions(
            prefix=True, sort_order=tcore.SortOrder.DESCEND,
            sort_target=tcore.SortTarget.VALUE))
        assert [it.value for it in res.items] == ["9", "8", "7", "6", "5"]
        res = c.range("k/", RangeOptions(prefix=True, keys_only=True))
        assert all(it.value == "" for it in res.items)
        res = c.range("k/", RangeOptions(prefix=True, count_only=True))
        assert res.count == 5 and res.items == []
        res = c.range("k/3", RangeOptions(from_key=True))
        assert [it.key for it in res.items] == ["k/3", "k/4"]
        res = c.range("k/1", RangeOptions(range_end="k/3"))
        assert [it.key for it in res.items] == ["k/1", "k/2"]
        res = c.range("a/", RangeOptions(prefix=True, rev=r1))
        assert [(it.key, it.value) for it in res.items] == [("a/x", "1")]
        assert c.delete("a/x") == 1 and c.delete("a/x") == 0
    finally:
        c.close()


def test_watch_push_and_start_rev(server):
    c1, c2 = RemoteCoord(server.address), RemoteCoord(server.address)
    try:
        w = c1.watch("services/")
        r = c2.put("services/s/n1", "hello")
        batch = w.get(timeout=3.0)
        assert [(e.type, e.value, e.mod_rev) for e in batch] == [
            (tcore.EventType.PUT, "hello", r)]
        c2.delete("services/s/n1")
        assert [e.type for e in w.get(timeout=3.0)] == [
            tcore.EventType.DELETE]
        w.cancel()
        w2 = c1.watch("services/", start_rev=r)
        assert [e.mod_rev for e in w2.get(timeout=3.0)][0] == r
        w2.cancel()
    finally:
        c1.close()
        c2.close()


def test_lease_expiry_keepalive_and_members(server):
    c = RemoteCoord(server.address)
    try:
        lease = c.grant(0.2)
        c.put("k", "v", lease=lease)
        assert c.keepalive(lease) == 0.2
        m = c.member_add("n1", "addr", {"x": 1})
        assert c.member_list()[0].metadata == {"x": 1}
        learner = c.member_add("n2", "addr2", {"learner": True})
        assert c.member_promote(learner.id).metadata["learner"] is False
        assert c.member_remove(m.id)
        assert [x.name for x in c.member_list()] == ["n2"]
        assert wait_until(lambda: c.range("k").count == 0, timeout=2.0)
        with pytest.raises(CoordinationError):
            c.keepalive(lease)
        w = c.watch("svc/")
        lease = c.grant(0.2)
        c.put("svc/n", "v", lease=lease)
        evs = []
        assert wait_until(lambda: evs.extend(w.get(timeout=0.2)) or any(
            e.type is tcore.EventType.DELETE for e in evs), timeout=3.0)
    finally:
        c.close()


def test_barrier_across_clients(server):
    clients = [RemoteCoord(server.address) for _ in range(3)]
    results = []
    try:
        threads = [threading.Thread(target=lambda c=c: results.append(
            c.barrier("b", 3, timeout=5.0))) for c in clients]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=5.0)
        assert results == [True, True, True]
        assert clients[0].barrier("lonely", 2, timeout=0.2) is False
    finally:
        for c in clients:
            c.close()


def test_watch_resumes_from_revision_after_reconnect(server):
    """Events that land during a connection outage are replayed from
    the server's history on re-arm, in order, with no epoch bump."""
    c = RemoteCoord(server.address, reconnect_timeout=30.0)
    try:
        w = c.watch("svc/")
        r1 = server.state.put("svc/a", "1")
        assert [e.mod_rev for e in w.get(timeout=5)] == [r1]
        _drop_client_socket(c)
        r2 = server.state.put("svc/b", "2")
        r3 = server.state.put("svc/a", "1b")
        server.state.put("other/x", "ignored")
        got = []
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline and len(got) < 2:
            got.extend(w.get(timeout=1))
        assert [(e.key, e.mod_rev) for e in got] == [("svc/b", r2),
                                                     ("svc/a", r3)]
        assert w.epoch == 0
    finally:
        c.close()


def test_watch_relists_when_history_compacted():
    server = tservice.CoordServer(
        "127.0.0.1:0", tcore.CoordState(sweep_interval=0.05,
                                        history_window=3))
    c = RemoteCoord(server.address, reconnect_timeout=30.0)
    try:
        w = c.watch("svc/")
        _drop_client_socket(c)
        for i in range(8):
            server.state.put("svc/k", str(i))
        assert wait_until(lambda: w.epoch == 1, timeout=15)
        w.get(timeout=0.2)
        rl = server.state.put("svc/live", "x")
        got = []
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and not got:
            got = [e for e in w.get(timeout=1) if e.mod_rev == rl]
        assert got, "watch dead after the compacted-gap fallback"
    finally:
        c.close()
        server.close()


def _raw_subscriber(address):
    """A replication follower that mirrors nothing and never acks."""
    host, _, port = address.rpartition(":")
    sock = socket.create_connection((host, int(port)), timeout=2.0)
    wire.send_msg(sock, threading.Lock(), {"op": "repl_subscribe", "id": 1})
    assert wire.recv_msg(sock)["ok"]
    assert wire.recv_msg(sock)["items"][0]["kind"] == "snap"
    return sock


def test_sync_puts_and_replication_feeds(server):
    c = RemoteCoord(server.address)
    try:
        assert c.put("s", "1", sync=True) > 0  # no follower: immediate
        with pytest.raises(CoordinationError, match="live follower"):
            c.put("s", "v", sync=True, sync_timeout=0.5,
                  sync_min_followers=1)
        with pytest.raises(ValueError, match="requires sync=True"):
            c.put("s", "x", sync_min_followers=1)
        sock = _raw_subscriber(server.address)
        assert len(server.state._repl_feeds) == 1
        t0 = time.monotonic()
        with pytest.raises(CoordinationError,
                           match="replication not acknowledged"):
            c.put("s2", "v", sync=True, sync_timeout=0.5)
        assert time.monotonic() - t0 < 3.0
        assert server.state.range("s2").items[0].value == "v"
        sock.close()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and server.state._repl_feeds:
            server.state.put("store/poke", "x")
            time.sleep(0.1)
        assert not server.state._repl_feeds, "orphaned repl feed"
    finally:
        c.close()


def test_remote_error_and_dial_failure(server):
    c = RemoteCoord(server.address)
    try:
        with pytest.raises(CoordinationError, match="lease"):
            c.put("k", "v", lease=12345)
    finally:
        c.close()
    with pytest.raises(CoordinationError, match="failed to dial"):
        RemoteCoord("127.0.0.1:1", dial_timeout=0.3)
    with pytest.raises(CoordinationError, match="failed to dial"):
        tapi.connect("127.0.0.1:1", dial_timeout=0.3)


def test_server_survives_garbage_frames(server):
    import os
    import random
    import struct

    host, _, port = server.address.rpartition(":")
    rng = random.Random(0)
    payloads = [b"\x00\x00\x00\x04junk", b"\x00\x00\x00\x02[]",
                b"\xff\xff\xff\xff", struct.pack(">I", 10) + b"short",
                ] + [os.urandom(rng.randint(1, 64)) for _ in range(20)]
    for p in payloads:
        s = socket.create_connection((host, int(port)), timeout=2.0)
        try:
            s.sendall(p)
        finally:
            s.close()
    good = RemoteCoord(server.address)
    try:
        good.put("store/alive", "yes")
        assert good.range("store/alive").items[0].value == "yes"
    finally:
        good.close()
    a, b = socket.socketpair()
    try:
        a.sendall(b"\x00\x00\x00\x03{{{")
        with pytest.raises(wire.WireError, match="malformed"):
            wire.recv_msg(b)
    finally:
        a.close()
        b.close()


# --------------------------------------------------------- across packages


def _events(w, n, timeout=5.0):
    got = []
    deadline = time.monotonic() + timeout
    while len(got) < n and time.monotonic() < deadline:
        got.extend(w.get(timeout=0.2))
    return [(e.type.value, e.key, e.value, e.mod_rev) for e in got]


def _items(res):
    return ([(it.key, it.value, it.create_rev, it.mod_rev, it.version,
              it.lease) for it in res.items], res.count, res.revision)


def _script(server_pkg, client_pkg):
    """One fixed sequence of operations through a client of
    ``client_pkg`` against a server of ``server_pkg``; returns every
    observable result."""
    S, C = PKG[server_pkg], PKG[client_pkg]
    server = S.service.CoordServer("127.0.0.1:0",
                                   S.core.CoordState(sweep_interval=0.05))
    c1 = C.remote.RemoteCoord(server.address)
    c2 = C.remote.RemoteCoord(server.address)
    RO = C.core.RangeOptions
    out = {}
    try:
        w = c1.watch("svc/")
        revs = [c1.put("svc/a", "1"), c2.put("svc/b", "2"),
                c1.put("svc/a", "1b"), c2.put("other/x", "y")]
        out["revs"] = revs
        out["deleted"] = c1.delete("svc/b")
        lease = c2.grant(30.0)
        out["lease"] = lease
        out["lease_put"] = c2.put("svc/l", "leased", lease=lease)
        out["keepalive"] = c2.keepalive(lease)
        c2.revoke(lease)
        out["events"] = _events(w, 6)
        out["ranges"] = [
            _items(c1.range("svc/", RO(prefix=True))),
            _items(c1.range("svc/", RO(prefix=True, rev=revs[1]))),
            _items(c1.range("", RO(from_key=True, keys_only=True))),
            _items(c1.range("other/", RO(prefix=True, count_only=True))),
            _items(c1.range("svc/", RO(
                prefix=True, limit=1, sort_order=C.core.SortOrder.DESCEND,
                sort_target=C.core.SortTarget.MOD))),
        ]
        replay = c2.watch("svc/", start_rev=revs[2])
        out["replay"] = _events(replay, 4)
        m1 = c1.member_add("n1", "10.0.0.1:1", {"process_id": 0})
        m2 = c2.member_add("n2", "10.0.0.2:2", {"learner": True})
        c1.member_promote(m2.id)
        out["removed"] = c2.member_remove(m1.id)
        out["members"] = [(m.id, m.name, m.peer_addr, m.metadata)
                          for m in c1.member_list()]
        res = []
        ts = [threading.Thread(target=lambda c=c: res.append(
            c.barrier("b", 2, timeout=5.0))) for c in (c1, c2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=10)
        out["barrier"] = res
        with pytest.raises((CoordinationError, JCoordinationError),
                           match="lease 999 not found"):
            c1.put("k", "v", lease=999)
    finally:
        c1.close()
        c2.close()
        server.close()
    return out


@pytest.fixture(scope="module")
def reference_script():
    return _script("ref", "ref")


@pytest.mark.parametrize("server_pkg,client_pkg",
                         [("port", "port"), ("ref", "port"),
                          ("port", "ref")])
def test_scripted_sequence_equals_the_reference(reference_script,
                                                server_pkg, client_pkg):
    got = _script(server_pkg, client_pkg)
    assert got == reference_script
    assert len(got["events"]) == 6 and got["barrier"] == [True, True]
