"""The port's actor RPC (``ptype_tpu_torch.rpc`` ``Client`` over
``ptype_tpu_torch.actor`` ``ActorServer``) held to the contracts of
``tests/test_rpc.py``, through the same mock-registry seam (membership
injected by hand, no coordinator): round trip, tensor payloads,
``RemoteError``, the typed ``ShedError``, retry until healthy, retry
exhaustion, round robin, ``go``, debounce, rebalance reuse, mesh mode,
``max_connections``, ``fnv32a`` equal to the reference's, a timed-out
call forgetting its pending entry; lowercase methods are not remotely
callable; tensor arguments land on the server's device (and raise with
no card and none named).

Across packages, over TCP: the reference's ``Client`` calls the port's
``ActorServer`` and the port's ``Client`` calls the reference's, with
numpy, torch and jax tensors (f32, int32 — each client sends the arrays
its package encodes), bytes and nested dicts; every result must equal
its argument bit for bit. bf16 crosses one way in each direction: the
reference's codec cannot encode a bf16 array (NumPy's buffer protocol
refuses ml_dtypes' bfloat16), so a port bf16 tensor goes to a reference
handler that returns its bits as uint16, and a port handler returns a
bf16 tensor that the reference client decodes."""

import queue
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptype_tpu import actor as jactor
from ptype_tpu import registry as jregistry
from ptype_tpu import rpc as jrpc
from ptype_tpu_torch import actor as tactor
from ptype_tpu_torch import rpc
from ptype_tpu_torch.errors import (NoClientAvailableError, RemoteError,
                                    RPCError, ShedError)
from ptype_tpu_torch.registry import Node, NodeWatch, Registry


class MockRegistry(Registry):
    """Hand-fed node snapshots (ref: rpc_test.go:16-40)."""

    def __init__(self, watch_cls=NodeWatch):
        self.watches = []
        self.watch_cls = watch_cls

    def register(self, *a, **k):
        raise NotImplementedError

    def services(self):
        return {}

    def watch_service(self, service_name):
        w = self.watch_cls()
        self.watches.append(w)
        return w

    def push(self, nodes):
        for w in self.watches:
            w._push(nodes)


class Echo:
    def Echo(self, x):
        return x

    def Add(self, a, b):
        return a + b

    def Boom(self):
        raise ValueError("kaboom")

    def Shed(self):
        raise ShedError("busy", retry_after_s=0.25)

    def secret(self):
        return "lowercase is local only"


class FailNTimes:
    def __init__(self, n):
        self.n = n
        self.calls = 0
        self.lock = threading.Lock()

    def Flaky(self):
        with self.lock:
            self.calls += 1
            if self.calls <= self.n:
                raise RuntimeError(f"failure {self.calls}")
            return "ok"


def make_server(handler, name=None, device="cpu", mod=tactor):
    s = mod.ActorServer("127.0.0.1", 0, **(
        {"device": device} if mod is tactor else {}))
    s.register(handler, name or type(handler).__name__)
    s.serve()
    return s


def _cfg(mod=rpc, **kw):
    kw.setdefault("max_connections", 3)
    kw.setdefault("initial_node_timeout", 1.0)
    kw.setdefault("debounce_time", 0.15)
    kw.setdefault("retries", 0)
    kw.setdefault("call_timeout", 5.0)
    return mod.ConnConfig(**kw)


def start_client(reg, nodes, cfg=None, device="cpu"):
    threading.Timer(0.05, reg.push, args=(nodes,)).start()
    return rpc.Client("client-host", "echo", reg, cfg or _cfg(),
                      device=device)


@pytest.fixture
def echo_cluster():
    servers = [make_server(Echo()) for _ in range(3)]
    reg = MockRegistry()
    nodes = [Node("127.0.0.1", s.port) for s in servers]
    yield servers, reg, nodes
    for s in servers:
        s.close()


def test_call_roundtrip_and_tensor_payloads(echo_cluster):
    _, reg, nodes = echo_cluster
    client = start_client(reg, nodes)
    try:
        assert client.call("Echo.Add", 2, 3) == 5
        assert client.call("Echo.Echo", {"k": [1, "two", 3.0]}) == {
            "k": [1, "two", 3.0]}
        x = np.arange(12, dtype=np.float32).reshape(3, 4)
        out = client.call("Echo.Echo", x)
        np.testing.assert_array_equal(out, x)
        t = torch.arange(6, dtype=torch.int32)
        out = client.call("Echo.Echo", t)
        assert torch.equal(out, t) and out.device.type == "cpu"
    finally:
        client.close()


def test_remote_error_and_typed_shed(echo_cluster):
    _, reg, nodes = echo_cluster
    client = start_client(reg, nodes, _cfg(retries=2))
    try:
        with pytest.raises(RemoteError, match="kaboom") as ei:
            client.call("Echo.Boom")
        assert "ValueError" in str(ei.value)
        assert "Boom" in ei.value.remote_traceback
        with pytest.raises(ShedError) as es:
            client.call("Echo.Shed")
        assert es.value.retry_after_s == 0.25
        with pytest.raises(RemoteError, match="no such method"):
            client.call("Echo.secret")
    finally:
        client.close()


def test_typed_shed_and_lowercase_over_tcp(monkeypatch):
    """The same contracts with the socket transport forced."""
    srv = make_server(Echo())
    monkeypatch.setattr(tactor, "lookup_local", lambda a, p: None)
    try:
        conn = rpc._dial(Node("127.0.0.1", srv.port), 5.0, "cpu")
        assert isinstance(conn, rpc._Conn)
        with pytest.raises(ShedError) as es:
            conn.call_async("Echo.Shed", ()).result(timeout=5)
        assert es.value.retry_after_s == 0.25
        with pytest.raises(RemoteError, match="no such method"):
            conn.call_async("Echo.secret", ()).result(timeout=5)
        assert "Echo.secret" not in srv.methods
        assert "ptype.Telemetry" in srv.methods
        assert conn.call_async("Echo.Add", (1, 2)).result(timeout=5) == 3
        conn.close()
    finally:
        srv.close()


def test_tensor_arguments_land_on_the_server_device(monkeypatch):
    """With no device named and no card, a tensor argument raises (it
    never lands on the CPU unasked); a payload without tensors needs no
    device; device='cpu' serves tensors."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    monkeypatch.setattr(tactor, "lookup_local", lambda a, p: None)
    bare = make_server(Echo(), device=None)
    cpu = make_server(Echo(), device="cpu")
    try:
        c = rpc._dial(Node("127.0.0.1", bare.port), 5.0, "cpu")
        assert c.call_async("Echo.Add", (6, 7)).result(timeout=5) == 13
        with pytest.raises(RemoteError, match="no CUDA device"):
            c.call_async("Echo.Echo", (torch.ones(2),)).result(timeout=5)
        c.close()
        c = rpc._dial(Node("127.0.0.1", cpu.port), 5.0, None)
        arr = np.ones(3, np.float32)  # numpy stays numpy: no device
        np.testing.assert_array_equal(
            c.call_async("Echo.Echo", (arr,)).result(timeout=5), arr)
        fut = c.call_async("Echo.Echo", (torch.ones(2),))
        with pytest.raises(RPCError, match="no CUDA device"):
            fut.result(timeout=5)  # the reply tensor: client has none
        c.close()
    finally:
        bare.close()
        cpu.close()


def test_no_initial_nodes_times_out():
    reg = MockRegistry()
    t0 = time.monotonic()
    with pytest.raises(NoClientAvailableError):
        rpc.Client("client-host", "ghost", reg,
                   _cfg(initial_node_timeout=0.3))
    assert time.monotonic() - t0 >= 0.25


@pytest.mark.parametrize("fail,calls,outcome",
                         [(2, 3, "ok"), (10, 3, "failure 3")],
                         ids=["until_healthy", "exhaustion"])
def test_retries(fail, calls, outcome):
    handler = FailNTimes(fail)
    server = make_server(handler, "R")
    reg = MockRegistry()
    client = start_client(reg, [Node("127.0.0.1", server.port)],
                          _cfg(retries=2))
    try:
        if outcome == "ok":
            assert client.call("R.Flaky") == "ok"
        else:
            with pytest.raises(RemoteError, match=outcome):
                client.call("R.Flaky")
        assert handler.calls == calls
    finally:
        client.close()
        server.close()


def test_round_robin_spreads_attempts():
    hits = []

    class Who:
        def __init__(self, tag):
            self.tag = tag

        def Who(self):
            hits.append(self.tag)
            return self.tag

    servers = [make_server(Who(i), "W") for i in range(3)]
    reg = MockRegistry()
    client = start_client(reg, [Node("127.0.0.1", s.port) for s in servers],
                          _cfg(max_connections=0))
    try:
        assert {client.call("W.Who") for _ in range(9)} == {0, 1, 2}
    finally:
        client.close()
        for s in servers:
            s.close()


def test_async_go(echo_cluster):
    _, reg, nodes = echo_cluster
    client = start_client(reg, nodes)
    try:
        done = queue.Queue()
        fut = client.go("Echo.Add", 20, 22, done=done)
        assert fut.result(timeout=5.0) == 42
        assert done.get(timeout=5.0).result() == 42
        with pytest.raises(RemoteError, match="kaboom"):
            client.go("Echo.Boom").result(timeout=5.0)
    finally:
        client.close()


def test_debounce_coalesces_churn(echo_cluster):
    _, reg, nodes = echo_cluster
    client = start_client(reg, nodes[:1], _cfg(debounce_time=0.3))
    try:
        balancer = client._conns
        rebalances = []
        original = balancer._handle_new_nodes

        def counting(ns):
            rebalances.append(len(ns))
            original(ns)

        balancer._handle_new_nodes = counting
        for i in range(4):
            reg.push(nodes[: i % 3 + 1])
            time.sleep(0.02)
        time.sleep(0.8)
        assert rebalances == [1]
    finally:
        client.close()


def test_rebalance_reuses_healthy_connections(echo_cluster):
    _, reg, nodes = echo_cluster
    client = start_client(reg, nodes, _cfg(max_connections=0,
                                           debounce_time=0.1))
    try:
        with client._conns._lock:
            before = {(c.node.address, c.node.port): c
                      for c in client._conns._conns}
        reg.push(nodes[:2])
        time.sleep(0.5)
        with client._conns._lock:
            after = {(c.node.address, c.node.port): c
                     for c in client._conns._conns}
        assert len(after) == 2
        for key, conn in after.items():
            assert conn is before[key]
    finally:
        client.close()


@pytest.mark.parametrize("max_conn,want", [(0, 5), (2, 2)],
                         ids=["mesh_mode", "max_connections"])
def test_fanout(max_conn, want):
    servers = [make_server(Echo()) for _ in range(5)]
    reg = MockRegistry()
    client = start_client(reg, [Node("127.0.0.1", s.port) for s in servers],
                          _cfg(max_connections=max_conn))
    try:
        with client._conns._lock:
            assert len(client._conns._conns) == want
    finally:
        client.close()
        for s in servers:
            s.close()


def test_select_nodes_equals_the_reference():
    nodes = [Node("10.0.0.%d" % i, 1) for i in range(7)]
    jnodes = [jregistry.Node("10.0.0.%d" % i, 1) for i in range(7)]
    for k in (1, 3, 7):
        got = rpc._ConnectionBalancer._select_nodes(
            type("B", (), {"cfg": _cfg(max_connections=k),
                           "local_addr": "me"})(), nodes)
        want = jrpc._ConnectionBalancer._select_nodes(
            type("B", (), {"cfg": _cfg(jrpc, max_connections=k),
                           "local_addr": "me"})(), jnodes)
        assert [n.address for n in got] == [n.address for n in want]
        assert len({n.address for n in got}) == k


def test_fnv32a_equals_the_reference():
    rng = np.random.default_rng(0)
    words = ["", "a", "hello", "client-host0", "10.0.0.1:9000"] + [
        rng.bytes(12).hex() for _ in range(20)]
    for w in words:
        assert rpc.fnv32a(w) == jrpc.fnv32a(w)
    assert rpc.fnv32a("hello") == 0x4F9F2CAB


def test_round_robin_seq_wraps():
    reg = MockRegistry()
    server = make_server(Echo())
    client = start_client(reg, [Node("127.0.0.1", server.port)])
    try:
        client._conns._seq = 0xFFFFFFFFFFFFFFFF
        assert client.call("Echo.Add", 1, 1) == 2
        assert client.call("Echo.Add", 2, 2) == 4
        assert client._conns._seq == 1
    finally:
        client.close()
        server.close()


def test_connection_errs_stream():
    reg = MockRegistry()
    good = make_server(Echo())
    client = start_client(reg, [Node("127.0.0.1", good.port),
                                Node("127.0.0.1", 1)],
                          _cfg(max_connections=0))
    try:
        assert "dial" in str(client.connection_errs().get(timeout=3.0))
        assert client.call("Echo.Add", 1, 2) == 3
    finally:
        client.close()
        good.close()


def test_empty_initial_snapshot_then_nodes():
    srv = make_server(Echo())
    node = Node("127.0.0.1", srv.port)
    reg = MockRegistry()

    def feed():
        time.sleep(0.05)
        reg.push([])
        time.sleep(0.2)
        reg.push([node])

    threading.Thread(target=feed, daemon=True).start()
    client = rpc.Client("client-host", "echo", reg,
                        _cfg(initial_node_timeout=2.0))
    try:
        assert client.call("Echo.Echo", "hi") == "hi"
    finally:
        client.close()
        srv.close()


def test_call_timeout_forgets_pending():
    srv = make_server(Echo())
    node = Node("localhost", srv.port)  # not aliased: the socket path
    block = threading.Event()
    srv.register_function("Slow.Wait", lambda: block.wait(5))
    reg = MockRegistry()
    threading.Timer(0.05, reg.push, args=([node],)).start()
    client = rpc.Client("client-host", "echo", reg,
                        _cfg(call_timeout=0.2, retries=0))
    try:
        with pytest.raises(RPCError, match="timed out"):
            client.call("Slow.Wait")
        conn = client._conns.get()
        assert hasattr(conn, "_pending"), "expected the socket transport"
        assert not conn._pending
    finally:
        block.set()
        client.close()
        srv.close()


def test_local_conn_passes_tensors_by_reference(echo_cluster):
    _, reg, nodes = echo_cluster
    client = start_client(reg, nodes)
    try:
        t = torch.arange(4.0)
        assert client.call("Echo.Echo", t) is t
    finally:
        client.close()


# --------------------------------------------------------- across packages


def _bits(x):
    """(dtype name, shape, raw bytes) of an array of either package."""
    if isinstance(x, torch.Tensor):
        name = str(x.dtype).replace("torch.", "")
        raw = (x.view(torch.int16) if x.dtype == torch.bfloat16 else x)
        return name, tuple(x.shape), raw.contiguous().numpy().tobytes()
    arr = np.asarray(x)
    return str(arr.dtype), tuple(arr.shape), arr.tobytes()


def _payload(kind):
    rng = np.random.default_rng(7)
    f32 = rng.standard_normal((3, 4)).astype(np.float32)
    i32 = rng.integers(-1000, 1000, (5,)).astype(np.int32)
    if kind == "np":
        return [f32, i32]
    if kind == "torch":
        return [torch.from_numpy(f32), torch.from_numpy(i32)]
    return [jnp.asarray(f32), jnp.asarray(i32)]


def _bf16_bits():
    f32 = np.random.default_rng(8).standard_normal((4, 6)).astype(
        np.float32)
    return torch.from_numpy(f32).to(torch.bfloat16)


def _check_echo(call, arrays):
    for a in arrays:
        assert _bits(call("Echo.Echo", a)) == _bits(a)
    nested = {"arrays": list(arrays), "raw": b"\x00\xffbytes",
              "meta": {"n": 3, "f": 0.5, "s": "x", "none": None,
                       "t": (1, [2, {"deep": True}])}}
    out = call("Echo.Echo", nested)
    assert [_bits(a) for a in out["arrays"]] == [_bits(a) for a in arrays]
    assert out["raw"] == nested["raw"]
    assert out["meta"] == nested["meta"]
    assert call("Echo.Add", 40, 2) == 42


@pytest.mark.parametrize("kind", ["np", "jax"])
def test_reference_client_calls_the_port_server(kind):
    srv = make_server(Echo(), device="cpu")
    reg = MockRegistry(jregistry.NodeWatch)
    threading.Timer(0.05, reg.push,
                    args=([jregistry.Node("127.0.0.1", srv.port)],)).start()
    client = jrpc.Client("client-host", "echo", reg, _cfg(jrpc))
    try:
        _check_echo(client.call, _payload(kind))
        with pytest.raises(Exception, match="no such method"):
            client.call("Echo.secret")
    finally:
        client.close()
        srv.close()


@pytest.mark.parametrize("kind", ["np", "torch"])
def test_port_client_calls_the_reference_server(kind):
    srv = jactor.ActorServer("127.0.0.1", 0)
    srv.register(Echo(), "Echo")
    srv.serve()
    reg = MockRegistry()
    client = start_client(reg, [Node("127.0.0.1", srv.port)])
    try:
        _check_echo(client.call, _payload(kind))
        with pytest.raises(RemoteError, match="no such method"):
            client.call("Echo.secret")
    finally:
        client.close()
        srv.close()


def test_bf16_crosses_to_the_reference_server():
    srv = jactor.ActorServer("127.0.0.1", 0)
    srv.register_function("Bf16.Bits",
                          lambda x: np.asarray(x).view(np.uint16))
    srv.serve()
    reg = MockRegistry()
    client = start_client(reg, [Node("127.0.0.1", srv.port)])
    try:
        t = _bf16_bits()
        got = client.call("Bf16.Bits", t)
        assert got.tobytes() == t.view(torch.int16).numpy().tobytes()
    finally:
        client.close()
        srv.close()


def test_bf16_crosses_to_the_reference_client():
    srv = tactor.ActorServer("127.0.0.1", 0, device="cpu")
    srv.register_function("Bf16.FromBits", lambda bits: torch.from_numpy(
        np.ascontiguousarray(bits).view(np.int16)).view(torch.bfloat16))
    srv.serve()
    reg = MockRegistry(jregistry.NodeWatch)
    threading.Timer(0.05, reg.push,
                    args=([jregistry.Node("127.0.0.1", srv.port)],)).start()
    client = jrpc.Client("client-host", "echo", reg, _cfg(jrpc))
    try:
        t = _bf16_bits()
        bits = t.view(torch.int16).numpy().view(np.uint16)
        got = client.call("Bf16.FromBits", bits)
        assert str(got.dtype) == "bfloat16"
        assert got.tobytes() == bits.tobytes()
        np.testing.assert_array_equal(got.astype(np.float32),
                                      t.float().numpy())
    finally:
        client.close()
        srv.close()


def test_rpc_chaos_seams_fire_and_recover(monkeypatch):
    """The port's socket seams (as ``tests/test_chaos.py``): an
    ``rpc.send`` drop and truncate and an ``rpc.recv`` delay kill or
    slow calls, and the retry path completes every call with each
    fault paired with a recovery; an ``rpc.dial`` timeout against one
    node routes the calls to the other."""
    from ptype_tpu_torch import chaos
    from ptype_tpu_torch.chaos import FaultPlan, FaultSpec

    monkeypatch.setattr(tactor, "lookup_local", lambda a, p: None)
    servers = [make_server(Echo()) for _ in range(2)]
    nodes = [Node("127.0.0.1", s.port) for s in servers]
    client = None
    try:
        plan = chaos.arm(FaultPlan([
            FaultSpec("rpc.send", "drop", after=1, times=1),
            FaultSpec("rpc.send", "truncate", after=3, times=1),
            FaultSpec("rpc.recv", "delay", after=0, times=1, delay_s=0.05),
        ]))
        client = start_client(MockRegistry(), nodes, _cfg(
            max_connections=0, retries=3))
        for i in range(8):
            assert client.call("Echo.Echo", i) == i
        fired = [(e.site, e.action) for e in plan.fired()]
        assert {("rpc.send", "drop"), ("rpc.send", "truncate"),
                ("rpc.recv", "delay")} <= set(fired)
        assert plan.unrecovered() == {}, plan.unrecovered()
        client.close()
        victim = f"127.0.0.1:{servers[0].port}"
        plan = chaos.arm(FaultPlan([
            FaultSpec("rpc.dial", "timeout", match=victim, times=1)]))
        client = start_client(MockRegistry(), nodes, _cfg(
            max_connections=0, retries=1))
        for i in range(4):
            assert client.call("Echo.Echo", i) == i
        assert [(e.site, e.action, e.key) for e in plan.fired()] == [
            ("rpc.dial", "timeout", victim)]
        assert plan.unrecovered() == {}
    finally:
        chaos.disarm()
        if client is not None:
            client.close()
        for s in servers:
            s.close()


def test_short_lived_connections_never_read_each_others_frames(monkeypatch):
    """Dial, call, close, over and over from several threads: every
    call gets its own reply. A connection's reader reads its fd NUMBER
    without the GIL, so a close from another thread could free that
    number for the next dial while the old reader still reads it — it
    stole the new connection's frames ("connection closed", malformed
    or oversized frames). The reader now closes its own fd."""
    monkeypatch.setattr(tactor, "lookup_local", lambda a, p: None)
    server = make_server(Echo())
    errors, calls = [], [0]
    lock = threading.Lock()

    def churn(k):
        for i in range(60):
            c = rpc._dial(Node("127.0.0.1", server.port), 5.0, "cpu")
            try:
                got = c.call_async("Echo.Add", (k, i)).result(timeout=10)
                assert got == k + i, (k, i, got)
                with lock:
                    calls[0] += 1
            except Exception as e:  # noqa: BLE001 — collected below
                errors.append(repr(e))
            finally:
                c.close()

    threads = [threading.Thread(target=churn, args=(k,)) for k in range(8)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        server.close()
    assert errors == []
    assert calls[0] == 8 * 60
