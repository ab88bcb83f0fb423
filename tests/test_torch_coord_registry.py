"""The port's coordination tier, service registry and KV store against
the reference's: every case of ``tests/test_registry.py``,
``tests/test_store.py`` and the in-process cases of
``tests/test_coord.py``, each one test parametrised over the two
packages (``ref``: ``ptype_tpu``, ``port``: ``ptype_tpu_torch``), so the
same assertions hold for both. Plus the port's ``connect``, which
serves ``local:<name>`` in process and dials any other address over TCP
(``tests/test_torch_coord_tcp.py`` holds the TCP tier itself)."""

import importlib
import logging
import threading
import time
from types import SimpleNamespace

import pytest

PACKAGES = {"ref": "ptype_tpu", "port": "ptype_tpu_torch"}


def _load(root: str) -> SimpleNamespace:
    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    ns = SimpleNamespace()
    for m in ("coord.core", "coord.local", "registry", "store", "errors"):
        for k, v in vars(mod(m)).items():
            if not k.startswith("__"):
                setattr(ns, k, v)
    ns.connect = mod("coord.api").connect
    ns.local_module = mod("coord.local")
    return ns


@pytest.fixture(params=sorted(PACKAGES), ids=lambda k: k)
def pkg(request):
    ns = _load(PACKAGES[request.param])
    yield ns
    ns.local_module.reset_local_coords()


@pytest.fixture
def coord(pkg):
    """A fresh in-process backend of the package (fast lease sweep)."""
    state = pkg.CoordState(sweep_interval=0.05)
    yield pkg.LocalCoord(state)
    state.close()


def wait_until(pred, timeout=3.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


# ------------------------------------------------------------ registry


def test_register_and_services(pkg, coord):
    reg = pkg.CoordRegistry(coord, lease_ttl=5.0)
    r1 = reg.register("calc", "n1", "10.0.0.1", 9000,
                      device_ordinals=(0, 1), process_id=0)
    r2 = reg.register("calc", "n2", "10.0.0.2", 9000)
    r3 = reg.register("prime", "n1", "10.0.0.1", 9001)
    try:
        services = reg.services()
        assert set(services) == {"calc", "prime"}
        assert services["calc"] == [
            pkg.Node("10.0.0.1", 9000, process_id=0, device_ordinals=(0, 1)),
            pkg.Node("10.0.0.2", 9000),
        ]
        assert services["calc"][0].device_ordinals == (0, 1)
        assert reg.nodes("prime") == [pkg.Node("10.0.0.1", 9001)]
        assert reg.nodes("ghost") == []
    finally:
        for r in (r1, r2, r3):
            r.close()


def test_reregister_same_node_overwrites(pkg, coord):
    reg = pkg.CoordRegistry(coord, lease_ttl=5.0)
    r1 = reg.register("calc", "n1", "10.0.0.1", 9000)
    r2 = reg.register("calc", "n1", "10.0.0.1", 9999)
    try:
        assert reg.nodes("calc") == [pkg.Node("10.0.0.1", 9999)]
    finally:
        r1.close()
        r2.close()


def test_lease_expiry_liveness(pkg, coord):
    reg = pkg.CoordRegistry(coord, lease_ttl=0.2)
    r = reg.register("calc", "n1", "10.0.0.1", 9000)
    assert reg.nodes("calc")
    r.close(revoke=False)  # stop keepalive, don't revoke: crash semantics
    assert wait_until(lambda: reg.nodes("calc") == [], timeout=2.0)


def test_keepalive_keeps_registration_alive(pkg, coord):
    reg = pkg.CoordRegistry(coord, lease_ttl=0.3)
    r = reg.register("calc", "n1", "10.0.0.1", 9000)
    try:
        time.sleep(1.0)  # several TTLs: the keepalive loop refreshes
        assert reg.nodes("calc") == [pkg.Node("10.0.0.1", 9000)]
    finally:
        r.close()


def test_close_revoke_deregisters_promptly(pkg, coord):
    reg = pkg.CoordRegistry(coord, lease_ttl=30.0)
    r = reg.register("calc", "n1", "10.0.0.1", 9000)
    r.close(revoke=True)
    assert reg.nodes("calc") == []


def test_watch_snapshot_then_deltas(pkg, coord):
    reg = pkg.CoordRegistry(coord, lease_ttl=5.0)
    r1 = reg.register("calc", "n1", "10.0.0.1", 9000)
    w = reg.watch_service("calc")
    try:
        assert w.get(timeout=3.0) == [pkg.Node("10.0.0.1", 9000)]
        r2 = reg.register("calc", "n2", "10.0.0.2", 9000)
        snap = w.get(timeout=3.0)
        assert snap is not None and len(snap) == 2
        r2.close(revoke=True)
        assert w.get(timeout=3.0) == [pkg.Node("10.0.0.1", 9000)]
    finally:
        w.cancel()
        r1.close()


def test_watch_empty_service_initial_snapshot(pkg, coord):
    reg = pkg.CoordRegistry(coord, lease_ttl=5.0)
    w = reg.watch_service("ghost")
    try:
        assert w.get(timeout=3.0) == []
    finally:
        w.cancel()


def test_watch_does_not_cross_services(pkg, coord):
    reg = pkg.CoordRegistry(coord, lease_ttl=5.0)
    w = reg.watch_service("calc")
    try:
        assert w.get(timeout=3.0) == []
        r = reg.register("prime", "n1", "10.0.0.1", 9001)
        assert w.get(timeout=0.4) is None
        r.close()
    finally:
        w.cancel()


def test_node_json_roundtrip(pkg):
    n = pkg.Node("1.2.3.4", 5, process_id=2, device_ordinals=(4, 5),
                 metadata={"stage": 1})
    assert pkg.Node.from_json(n.to_json()) == n
    assert pkg.Node.from_json(n.to_json()).metadata == {"stage": 1}


def test_node_json_is_the_same_in_both_packages():
    ref, port = _load("ptype_tpu"), _load("ptype_tpu_torch")
    kw = dict(process_id=2, device_ordinals=(4, 5), metadata={"stage": 1})
    raw = ref.Node("1.2.3.4", 5, **kw).to_json()
    assert port.Node("1.2.3.4", 5, **kw).to_json() == raw
    assert port.Node.from_json(raw) == port.Node("1.2.3.4", 5, **kw)


def test_reregisters_after_lease_loss(pkg, coord):
    reg = pkg.CoordRegistry(coord, lease_ttl=0.4)
    handle = reg.register("svc", "n1", "h", 1)
    coord.revoke(handle.lease_id)  # server-side expiry behind its back
    assert wait_until(lambda: bool(reg.services().get("svc")), timeout=3.0)
    handle.close()


def test_leases_held_keeps_a_starved_registration_listed():
    """The port's ``registry.hold_leases`` (held by a profiler's
    capture, whose start and stop hold the GIL past a lease): with no
    keepalive reaching the coordinator, a registration on a 0.3 s lease
    stays listed through a 5 s hold, the lease it leaves revoked; after
    its release it is back on a 0.3 s lease, which then lapses
    unrefreshed."""
    ns = _load(PACKAGES["port"])
    state = ns.CoordState(sweep_interval=0.05)
    coord = ns.LocalCoord(state)
    reg = ns.CoordRegistry(coord, lease_ttl=0.3)
    r = reg.register("calc", "n1", "10.0.0.1", 9000)
    refresh = coord.keepalive
    try:
        first = r.lease_id
        coord.keepalive = lambda lease_id: 0.3   # starved: none refreshes
        release = ns.hold_leases(5.0)
        held = r.lease_id
        assert held != first and first not in state._leases
        assert state._leases[held].ttl == 5.0
        time.sleep(1.2)
        assert reg.nodes("calc") == [ns.Node("10.0.0.1", 9000)]
        release()
        assert r.lease_id != held and held not in state._leases
        assert state._leases[r.lease_id].ttl == 0.3
        assert wait_until(lambda: reg.nodes("calc") == [], timeout=2.0)
    finally:
        coord.keepalive = refresh
        r.close()
        state.close()
        ns.local_module.reset_local_coords()


class _Sink(logging.Handler):
    """The records of the port's registry logger."""

    def __init__(self):
        super().__init__()
        self.records = []

    def emit(self, record):
        self.records.append(record)

    def __enter__(self):
        logging.getLogger("ptype_tpu_torch.registry").addHandler(self)
        return self

    def __exit__(self, *exc):
        logging.getLogger("ptype_tpu_torch.registry").removeHandler(self)

    def named(self, msg):
        return [r for r in self.records if r.getMessage() == msg]


def test_a_lease_that_lapsed_before_a_hold_relets_it_is_a_lapse():
    """A registration whose keepalive stalled until its 0.3 s lease
    expired (its key gone from the listing) is put back by
    ``hold_leases``'s relet, and that relet logs and counts the lapse
    ("lease lapsed, relet", with the seconds since its last refresh).
    A registration beside it that did not lapse is relet the same way
    with no lapse logged or counted."""
    ns = _load(PACKAGES["port"])
    state = ns.CoordState(sweep_interval=0.05)
    coord = ns.LocalCoord(state)
    reg = ns.CoordRegistry(coord, lease_ttl=0.3)
    stalled = reg.register("calc", "n1", "10.0.0.1", 9000)
    live = reg.register("calc", "n2", "10.0.0.2", 9000)
    stalled._keepalive_once = lambda *a, **k: None
    try:
        assert wait_until(lambda: reg.nodes("calc") == [
            ns.Node("10.0.0.2", 9000)], timeout=3.0)
        with _Sink() as sink:
            release = ns.hold_leases(5.0)
            assert len(reg.nodes("calc")) == 2
            assert state._leases[stalled.lease_id].ttl == 5.0
            assert state._leases[live.lease_id].ttl == 5.0
            release()
        (rec,) = sink.named("lease lapsed, relet")
        assert rec.kv["node"] == "n1" and rec.kv["lapses"] == 1
        assert rec.kv["since_refresh_s"] >= 0.3
        assert rec.kv["lease_ttl"] == 0.3
        assert (stalled.lapses, live.lapses) == (1, 0)
        assert state._leases[live.lease_id].ttl == 0.3
    finally:
        stalled.close()
        live.close()
        state.close()
        ns.local_module.reset_local_coords()


def test_a_keepalive_beat_held_back_logs_its_lateness():
    """A keepalive beat of a 1 s lease whose wait is held back 0.6 s past
    its due time (half a TTL after the last refresh) logs its lateness,
    its wake and its call; the beats before and after it, on time, log
    none. The registration keeps its lease and counts no lapse (no
    sweep runs)."""
    ns = _load(PACKAGES["port"])
    state = ns.CoordState(sweep_interval=30.0)
    coord = ns.LocalCoord(state)
    with _Sink() as sink:
        r = ns.CoordRegistry(coord, lease_ttl=1.0).register(
            "calc", "n1", "10.0.0.1", 9000)
        lease = r.lease_id
        wait, waits = r._stop.wait, []

        def held_back(timeout=None):
            waits.append(timeout)
            extra = 0.6 if len(waits) == 2 else 0.0
            return wait(None if timeout is None else timeout + extra)

        r._stop.wait = held_back
        try:
            assert wait_until(lambda: len(waits) >= 4, timeout=5.0)
            late = sink.named("late lease keepalive")
            assert [rec.kv["late_beats"] for rec in late] == [1], [
                rec.kv for rec in late]
            kv = late[0].kv
            assert 0.6 <= kv["late_s"] < 0.9 and kv["lease_ttl"] == 1.0
            assert 0.6 <= kv["wake_s"] <= kv["late_s"]
            assert kv["call_s"] < 0.25
            assert r.late_beats == 1 and round(r.late_max_s, 4) == kv["late_s"]
            assert r.lease_id == lease and r.lapses == 0
            assert ns.CoordRegistry(coord).nodes("calc") == [
                ns.Node("10.0.0.1", 9000)]
        finally:
            r.close()
            state.close()
            ns.local_module.reset_local_coords()


# --------------------------------------------------------------- store


@pytest.fixture
def store(pkg, coord):
    return pkg.KVStore(coord)


def test_store_put_get(store):
    store.put("alpha", "1")
    assert store.get("alpha") == ["1"]
    assert store.get_one("alpha") == "1"
    store.put("alpha", "2")
    assert store.get("alpha") == ["2"]


def test_store_get_missing_raises_no_key(pkg, store):
    with pytest.raises(pkg.NoKeyError):
        store.get("ghost")


def test_store_delete(pkg, store):
    store.put("k", "v")
    store.delete("k")
    with pytest.raises(pkg.NoKeyError):
        store.get("k")
    with pytest.raises(pkg.NoKeyError):
        store.delete("k")


def test_store_prefix_queries(pkg, store):
    for i in range(4):
        store.put(f"params/layer{i}", f"v{i}")
    store.put("other", "x")
    assert store.get("params/", pkg.with_prefix()) == ["v0", "v1", "v2",
                                                        "v3"]
    assert store.get("params/", pkg.with_prefix(),
                     pkg.with_limit(2)) == ["v0", "v1"]
    assert store.count("params/", pkg.with_prefix()) == 4


def test_store_sort_descending(pkg, store):
    for i in range(3):
        store.put(f"k{i}", str(i))
    vals = store.get("k", pkg.with_prefix(),
                     pkg.with_sort(pkg.SortTarget.KEY, pkg.SortOrder.DESCEND))
    assert vals == ["2", "1", "0"]


def test_store_keys_only_and_items(pkg, store):
    store.put("a/1", "x")
    store.put("a/2", "y")
    items = store.get_items("a/", pkg.with_prefix(), pkg.with_keys_only())
    assert [it.key for it in items] == ["store/a/1", "store/a/2"]
    assert all(it.value == "" for it in items)


def test_store_count_only(pkg, store):
    store.put("a/1", "x")
    assert store.count("a/", pkg.with_prefix(), pkg.with_count_only()) == 1
    with pytest.raises(pkg.NoKeyError):
        store.get("zzz", pkg.with_count_only())


def test_store_from_key_and_range(pkg, store):
    for k in ["a", "b", "c", "d"]:
        store.put(k, k)
    assert store.get("c", pkg.with_from_key()) == ["c", "d"]
    assert store.get("a", pkg.with_range("store/c")) == ["a", "b"]


def test_store_serializable_accepted(pkg, store):
    store.put("k", "v")
    assert store.get("k", pkg.with_serializable()) == ["v"]


def test_store_with_rev_reads_history(pkg, store):
    store.put("cfg", "old")
    rev = store.get_items("cfg")[0].mod_rev
    store.put("cfg", "new")
    assert store.get_one("cfg") == "new"
    assert store.get_one("cfg", pkg.with_rev(rev)) == "old"


def test_store_prefix_range_end_reexport(pkg):
    assert pkg.get_prefix_range_end("store/a") == "store/b"


def test_store_namespace_isolated(pkg, store, coord):
    store.put("services", "not-a-service")
    assert coord.range("services/", pkg.RangeOptions(prefix=True)).count == 0


# ------------------------------------------------- coordination state


def test_read_at_revision(pkg, coord):
    r1 = coord.put("a/x", "1")
    r2 = coord.put("a/y", "2")
    r3 = coord.put("a/x", "1b")
    coord.delete("a/y")
    r5 = coord.put("a/z", "3")

    def at(rev):
        res = coord.range("a/", pkg.RangeOptions(prefix=True, rev=rev))
        return {it.key: it.value for it in res.items}

    assert at(r1) == {"a/x": "1"}
    assert at(r2) == {"a/x": "1", "a/y": "2"}
    assert at(r3) == {"a/x": "1b", "a/y": "2"}
    assert at(r3 + 1) == {"a/x": "1b"}
    assert at(r5) == {"a/x": "1b", "a/z": "3"}
    it = coord.range("a/x", pkg.RangeOptions(rev=r1)).items[0]
    assert (it.value, it.version, it.mod_rev) == ("1", 1, r1)


def test_read_at_revision_compacted_and_future(pkg):
    state = pkg.CoordState(sweep_interval=0.05, history_window=4)
    coord = pkg.LocalCoord(state)
    try:
        revs = [coord.put("k", str(i)) for i in range(10)]
        with pytest.raises(pkg.CoordinationError, match="compacted"):
            coord.range("k", pkg.RangeOptions(rev=revs[0]))
        assert coord.range(
            "k", pkg.RangeOptions(rev=revs[-2])).items[0].value == "8"
        with pytest.raises(pkg.CoordinationError, match="future"):
            coord.range("k", pkg.RangeOptions(rev=revs[-1] + 100))
    finally:
        state.close()


def test_read_at_revision_survives_restart_floor(pkg, tmp_path):
    d = str(tmp_path / "c")
    state = pkg.CoordState(data_dir=d)
    r1 = state.put("a/x", "1")
    r2 = state.put("a/x", "2")
    state.close()
    state = pkg.CoordState(data_dir=d)
    assert state.range(
        "a/x", pkg.RangeOptions(rev=r1)).items[0].value == "1"
    state.close()
    state = pkg.CoordState(data_dir=d)
    coord = pkg.LocalCoord(state)
    try:
        r3 = coord.put("a/x", "3")
        assert coord.range(
            "a/x", pkg.RangeOptions(rev=r2)).items[0].value == "2"
        assert coord.range(
            "a/x", pkg.RangeOptions(rev=r3)).items[0].value == "3"
        with pytest.raises(pkg.CoordinationError, match="compacted"):
            coord.range("a/x", pkg.RangeOptions(rev=r1))
    finally:
        state.close()


def test_wal_written_by_one_package_replays_in_the_other(tmp_path):
    """The coordinator's data dir (WAL + snapshot) is the same format in
    both packages."""
    ref, port = _load("ptype_tpu"), _load("ptype_tpu_torch")
    for a, b in ((ref, port), (port, ref)):
        d = str(tmp_path / f"{a is ref}")
        st = a.CoordState(data_dir=d)
        st.put("k1", "v1")
        lease = st.grant(5.0)
        st.put("leased", "v", lease=lease)
        st.close()
        st2 = b.CoordState(data_dir=d)
        try:
            assert st2.range("k1").items[0].value == "v1"
            assert st2.range("leased").items[0].lease == lease
        finally:
            st2.close()


def test_watch_start_rev_replays_history(coord):
    coord.put("a/x", "1")
    r2 = coord.put("a/y", "2")
    coord.put("b/other", "x")
    r4 = coord.put("a/x", "1b")
    w = coord.watch("a/", start_rev=r2)
    evs = w.get(timeout=2)
    assert [(e.key, e.value, e.mod_rev) for e in evs] == [
        ("a/y", "2", r2), ("a/x", "1b", r4)]
    r5 = coord.put("a/z", "3")
    evs = w.get(timeout=2)
    assert [(e.key, e.mod_rev) for e in evs] == [("a/z", r5)]
    w.cancel()


def test_put_get_delete(coord):
    rev1 = coord.put("a/x", "1")
    rev2 = coord.put("a/y", "2")
    assert rev2 > rev1
    res = coord.range("a/x")
    assert [it.value for it in res.items] == ["1"]
    assert res.items[0].version == 1
    coord.put("a/x", "1b")
    item = coord.range("a/x").items[0]
    assert item.value == "1b"
    assert item.version == 2
    assert item.create_rev == rev1
    assert coord.delete("a/x") == 1
    assert coord.range("a/x").count == 0
    assert coord.delete("a/x") == 0


def test_prefix_range(pkg, coord):
    for i in range(5):
        coord.put(f"svc/n{i}", str(i))
    coord.put("svd/other", "x")
    res = coord.range("svc/", pkg.RangeOptions(prefix=True))
    assert res.count == 5
    assert [it.key for it in res.items] == [f"svc/n{i}" for i in range(5)]


def test_range_options(pkg, coord):
    RO = pkg.RangeOptions
    for i in range(5):
        coord.put(f"k/{i}", str(9 - i))
    res = coord.range("k/", RO(prefix=True, limit=2))
    assert len(res.items) == 2 and res.count == 5
    res = coord.range("k/", RO(prefix=True, sort_order=pkg.SortOrder.DESCEND,
                               sort_target=pkg.SortTarget.VALUE))
    assert [it.value for it in res.items] == ["9", "8", "7", "6", "5"]
    res = coord.range("k/", RO(prefix=True, keys_only=True))
    assert all(it.value == "" for it in res.items)
    res = coord.range("k/", RO(prefix=True, count_only=True))
    assert res.count == 5 and res.items == []
    res = coord.range("k/3", RO(from_key=True))
    assert [it.key for it in res.items] == ["k/3", "k/4"]
    res = coord.range("k/1", RO(range_end="k/3"))
    assert [it.key for it in res.items] == ["k/1", "k/2"]


def test_prefix_range_end(pkg):
    assert pkg.prefix_range_end("abc") == "abd"
    assert pkg.prefix_range_end("a\xff") == "a" + chr(0x100)
    assert pkg.prefix_range_end("") == "\0"


def test_lease_expiry(coord):
    lease = coord.grant(0.2)
    coord.put("services/s/n1", "v", lease=lease)
    assert coord.range("services/s/n1").count == 1
    assert wait_until(lambda: coord.range("services/s/n1").count == 0,
                      timeout=2.0)


def test_lease_keepalive(pkg, coord):
    lease = coord.grant(0.3)
    coord.put("k", "v", lease=lease)
    for _ in range(5):
        time.sleep(0.1)
        coord.keepalive(lease)
    assert coord.range("k").count == 1
    coord.revoke(lease)
    assert coord.range("k").count == 0
    with pytest.raises(pkg.CoordinationError):
        coord.keepalive(lease)


def test_put_with_unknown_lease(pkg, coord):
    with pytest.raises(pkg.CoordinationError):
        coord.put("k", "v", lease=999)


def test_watch_events(pkg, coord):
    w = coord.watch("services/")
    coord.put("services/s/n1", "a")
    batch = w.get(timeout=2.0)
    assert len(batch) == 1
    assert batch[0].type is pkg.EventType.PUT
    assert batch[0].key == "services/s/n1"
    assert batch[0].value == "a"
    coord.put("other/key", "x")
    coord.delete("services/s/n1")
    batch = w.get(timeout=2.0)
    assert [ev.type for ev in batch] == [pkg.EventType.DELETE]
    w.cancel()
    assert w.get(timeout=0.1) == []


def test_watch_lease_expiry_generates_delete(pkg, coord):
    lease = coord.grant(0.2)
    coord.put("services/s/n1", "v", lease=lease)
    w = coord.watch("services/")
    batch = w.get(timeout=2.0)
    assert batch and batch[0].type is pkg.EventType.DELETE
    w.cancel()


def test_member_lifecycle(coord):
    m1 = coord.member_add("n1", "127.0.0.1:1", {"process_id": 0})
    m2 = coord.member_add("n2", "127.0.0.1:2")
    assert [m.name for m in coord.member_list()] == ["n1", "n2"]
    assert coord.member_remove(m1.id) is True
    assert coord.member_remove(m1.id) is False
    assert [m.name for m in coord.member_list()] == ["n2"]
    assert m2.metadata == {}


def test_member_promote_learner(pkg, coord):
    m = coord.member_add("sb", "127.0.0.1:9", {"role": "standby",
                                               "learner": True})
    assert coord.member_list()[0].metadata["learner"] is True
    promoted = coord.member_promote(m.id)
    assert promoted.id == m.id
    assert promoted.metadata["learner"] is False
    assert coord.member_list()[0].metadata["learner"] is False
    assert coord.member_promote(m.id).metadata["learner"] is False
    with pytest.raises(pkg.CoordinationError, match="not found"):
        coord.member_promote(9999)


def test_fsync_wal_roundtrip(pkg, tmp_path):
    d = str(tmp_path / "coord")
    st = pkg.CoordState(data_dir=d, fsync=True, compact_every=4)
    for i in range(10):
        st.put(f"k{i}", str(i))
    lease = st.grant(5.0)
    st.put("leased", "v", lease=lease)
    st.close()
    st2 = pkg.CoordState(data_dir=d, fsync=True)
    try:
        assert st2.range("k7").items[0].value == "7"
        assert st2.range("leased").items[0].lease == lease
    finally:
        st2.close()


def test_member_promote_survives_restart(pkg, tmp_path):
    d = str(tmp_path / "coord")
    st = pkg.CoordState(data_dir=d)
    m = st.member_add("sb", "127.0.0.1:9", {"role": "standby",
                                            "learner": True})
    st.member_promote(m.id)
    st.close()
    st2 = pkg.CoordState(data_dir=d)
    try:
        (member,) = st2.member_list()
        assert member.id == m.id
        assert member.metadata["learner"] is False
    finally:
        st2.close()


def test_barrier(coord):
    results = []

    def arrive():
        results.append(coord.barrier("step", 3, timeout=5.0))

    threads = [threading.Thread(target=arrive) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=5.0)
    assert results == [True, True, True]


def test_barrier_timeout(coord):
    assert coord.barrier("lonely", 2, timeout=0.2) is False


def test_connect_local_shares_a_named_state(pkg):
    a, b = pkg.connect("local:shared"), pkg.connect("shared",
                                                    in_process=True)
    a.put("k", "v")
    assert b.range("k").items[0].value == "v"


def test_port_connect_refuses_a_remote_address():
    """A non-local address is dialled over TCP: with no coordinator
    listening there, connect raises rather than hand back a backend."""
    port = _load("ptype_tpu_torch")
    for addr in ("127.0.0.1:1", ["127.0.0.1:1", "127.0.0.1:1"]):
        with pytest.raises(port.CoordinationError, match="failed to dial"):
            port.connect(addr, dial_timeout=0.3)


def test_chaos_seams_of_the_coordinator_fire_in_the_port(tmp_path):
    """``coord.keepalive`` (revoke a member's lease) and
    ``coord.wal_append`` (delay a WAL record) fire in the port's copy."""
    from ptype_tpu_torch import chaos

    port = _load("ptype_tpu_torch")
    st = port.CoordState(data_dir=str(tmp_path / "c"), sweep_interval=0.05)
    plan = chaos.FaultPlan([
        chaos.FaultSpec("coord.keepalive", "revoke", times=1),
        chaos.FaultSpec("coord.wal_append", "delay", match="p:slow",
                        delay_s=0.2, times=1)])
    try:
        with chaos.armed(plan):
            lease = st.grant(5.0)
            st.put("held", "v", lease=lease)
            with pytest.raises(port.CoordinationError):
                st.keepalive(lease)
            assert st.range("held").count == 0
            t0 = time.monotonic()
            st.put("slow", "x")
            assert time.monotonic() - t0 >= 0.2
        assert [e.site for e in plan.fired()] == ["coord.keepalive",
                                                  "coord.wal_append"]
    finally:
        st.close()
