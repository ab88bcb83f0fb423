"""Actor server: register handlers, serve calls — the port's copy of
``ptype_tpu/actor.py``.

The reference's servers were stdlib ``net/rpc``: ``rpc.Register(&Calculator{})``
+ ``rpc.HandleHTTP()`` + ``http.ListenAndServe`` (example/calculator/server.go:
16-20,38). Here the equivalent is :class:`ActorServer`: register an object
(its public methods become ``Type.Method`` endpoints, net/rpc naming) or a
bare function, then ``serve()``.

Device-native behaviors:
- payloads ride :mod:`ptype_tpu_torch.codec`, so tensor args arrive as
  tensors on the server's device rather than pickled host objects. The
  device is ``resolve_device(device)`` of the ``device`` the server was
  built with: ``cuda`` unless it names another, and with no CUDA device
  and none named a tensor argument raises — it never lands on the CPU
  unasked. The device is resolved at the first tensor, so a server
  whose payloads hold none (a calculator) never needs one;
- same-process calls short-circuit the socket entirely (see
  ``lookup_local``), which is how actor calls between services that share a
  host process stay zero-copy.
"""

from __future__ import annotations

import functools
import json
import socket
import struct
import threading
import traceback

from ptype_tpu_torch import codec, logs, threadpool, trace
from ptype_tpu_torch.coord import wire
from ptype_tpu_torch.device import resolve_device
from ptype_tpu_torch.errors import ShedError

log = logs.get_logger("actor")

#: The longest :meth:`ActorServer.quiesce` waits for the replies of
#: requests already running: long enough for a control reply, short
#: enough that a handler wedged in its actor cannot hold the process's
#: exit for ever.
QUIESCE_S = 5.0
#: The retry hint of the refusal a quiescing server answers with.
CLOSING_RETRY_S = 0.05

# Process-local server registry for zero-copy same-process dispatch.
_local_servers: dict[tuple[str, int], "ActorServer"] = {}
_local_lock = threading.Lock()


def _profile_endpoint(cmd: str, options=None):
    """The built-in ``ptype.Profile`` handler — a lazy shim so actor.py
    stays import-light (profiling pulls in the health plane; this
    module must import before it)."""
    from ptype_tpu_torch.health import profiling

    return profiling.endpoint(cmd, options)


def lookup_local(address: str, port: int) -> "ActorServer | None":
    with _local_lock:
        server = _local_servers.get((address, port))
    if server is not None and not server.serving:
        return None
    return server


class ActorServer:
    """Registers handlers and serves actor calls over TCP."""

    def __init__(self, host: str = "0.0.0.0", port: int = 0, device=None):
        # Default binds all interfaces, matching the reference's
        # http.ListenAndServe(":port") (server.go:38) — the registry
        # advertises the host's routable IP (cluster.go:198-213), so the
        # server must be reachable on it.
        self._handlers: dict[str, object] = {}
        # Built-in observability endpoints: every actor server answers
        # the cluster telemetry pull plane (metrics snapshot, series and
        # recent spans from the flight recorder) and the profiling
        # plane (torch.profiler capture + device-memory snapshots)
        # without registration — telemetry.cluster_snapshot /
        # cluster_profile walk the registry and call these per node.
        self._handlers["ptype.Telemetry"] = trace.telemetry
        self._handlers["ptype.Profile"] = _profile_endpoint
        #: Resolves the device tensor arguments decode onto (see the
        #: module doc); called only for a frame that holds a tensor.
        self._decode_device = functools.partial(resolve_device, device)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(128)
        self.host, self.port = self._sock.getsockname()[:2]
        self._closed = threading.Event()
        self._thread: threading.Thread | None = None
        #: Live accepted connections, so close() can shut them down —
        #: a reader parked in recv(2) is not woken by close() alone and
        #: would otherwise outlive the server as a wedged thread.
        self._conns: set[socket.socket] = set()
        self._conns_lock = threading.Lock()
        #: Requests read off a connection whose reply is not written yet
        #: (counted where the reader spawns the handler, uncounted once
        #: the reply is out), and whether new ones are refused
        #: (:meth:`quiesce`); both under ``_idle``.
        self._inflight = 0
        self._quiescing = False
        self._idle = threading.Condition()

    # ------------------------------------------------------------ handlers

    def register(self, obj: object, name: str = "") -> None:
        """Expose ``obj``'s EXPORTED methods — leading-uppercase names,
        Go's net/rpc rule (ref example/calculator/calculator.go:9-12
        exposes ``Calculator.Multiply``) — as ``Name.Method`` endpoints.
        Lowercase methods (``close``, ``params``…) are the actor's
        local/lifecycle surface and must not be remotely callable: a
        reflected ``Generator.close`` would let any client shut the
        server's generation down. ``register_function`` remains the
        explicit escape hatch for any name."""
        name = name or type(obj).__name__
        for attr in dir(obj):
            if not attr[:1].isupper():
                continue
            fn = getattr(obj, attr)
            if callable(fn):
                self._handlers[f"{name}.{attr}"] = fn

    def register_function(self, name: str, fn) -> None:
        self._handlers[name] = fn

    @property
    def methods(self) -> list[str]:
        return sorted(self._handlers)

    # ------------------------------------------------------------- serving

    @property
    def serving(self) -> bool:
        return (self._thread is not None and not self._closed.is_set()
                and not self._quiescing)

    def serve(self) -> "ActorServer":
        """Start serving in the background; returns self."""
        if self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._accept_loop, name=f"actor-{self.port}", daemon=True
        )
        self._thread.start()
        with _local_lock:
            _local_servers[(self.host, self.port)] = self
            # Alias every address a registry entry might advertise for this
            # server, so in-process clients short-circuit regardless of
            # which name they dial.
            _local_servers[("127.0.0.1", self.port)] = self
            from ptype_tpu_torch.cluster import get_ip

            _local_servers[(get_ip(), self.port)] = self
        log.info("actor server listening",
                 kv={"addr": f"{self.host}:{self.port}",
                     "methods": len(self._handlers)})
        return self

    def _accept_loop(self) -> None:
        while not self._closed.is_set():
            try:
                conn, peer = self._sock.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._conns_lock:
                self._conns.add(conn)
            threading.Thread(
                target=self._serve_conn, args=(conn,),
                name=f"actor-conn-{peer[1]}", daemon=True
            ).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        send_lock = threading.Lock()
        try:
            while not self._closed.is_set():
                try:
                    msg = wire.recv_msg(conn)
                except (wire.WireError, OSError):
                    return
                args_blob = None
                if msg.get("args_len"):
                    try:
                        args_blob = wire._recv_exact(conn, msg["args_len"])
                    except (wire.WireError, OSError):
                        return
                with self._idle:
                    refuse = self._quiescing
                    if not refuse:
                        self._inflight += 1
                if refuse:
                    # Typed, so the caller routes elsewhere; answered
                    # here, so it cannot outlive the quiesce's wait.
                    self._send_reply(conn, send_lock, {
                        "id": msg.get("id"), "ok": False, "shed": True,
                        "closing": True, "retry_after_s": CLOSING_RETRY_S,
                        "error": f"server {self.host}:{self.port} is "
                                 f"closing"}, [])
                    continue
                # net/rpc services requests concurrently; so do we.
                threadpool.spawn(self._handle_request, conn, send_lock,
                                 msg, args_blob)
        finally:
            with self._conns_lock:
                self._conns.discard(conn)
            # This reader closes the fd once it has stopped reading, and
            # under the send lock: a handler's reply (a GIL-free writev
            # on the fd number) must never land on a socket that reused
            # the number.
            with send_lock:
                try:
                    conn.close()
                except OSError:
                    pass

    def _handle_request(self, conn, send_lock, msg: dict, args_blob) -> None:
        try:
            self._run_request(conn, send_lock, msg, args_blob)
        finally:
            with self._idle:
                self._inflight -= 1
                if not self._inflight:
                    self._idle.notify_all()

    def _run_request(self, conn, send_lock, msg: dict, args_blob) -> None:
        req_id = msg.get("id")
        method = msg.get("method", "")
        try:
            args = (codec.decode(args_blob, self._decode_device)
                    if args_blob is not None else ())
            # Adopt the caller's trace context (the "tp" frame field)
            # so dispatch()'s handler span joins the caller's trace —
            # the cross-process stitch.
            with trace.attach(msg.get("tp")):
                result = self.dispatch(method, args)
            result_parts = codec.encode_parts(result)
            reply = {"id": req_id, "ok": True,
                     "result_len": sum(len(p) for p in result_parts)}
        except ShedError as e:
            # Typed admission refusal: marshal the shed flag + retry
            # hint so the client re-raises a ShedError (and skips its
            # retry loop) instead of a generic RemoteError.
            reply = {"id": req_id, "ok": False, "shed": True,
                     "retry_after_s": e.retry_after_s, "error": str(e)}
            result_parts = []
        except Exception as e:  # noqa: BLE001 — server must not die
            reply = {"id": req_id, "ok": False, "error": f"{type(e).__name__}: {e}",
                     "traceback": traceback.format_exc()}
            result_parts = []
            # An unhandled handler error is a post-mortem moment:
            # snapshot the flight recorder (no-op unless a dump dir is
            # configured; rate-limited inside).
            trace.maybe_dump(f"actor error in {method}: "
                             f"{type(e).__name__}")
        self._send_reply(conn, send_lock, reply, result_parts)

    @staticmethod
    def _send_reply(conn, send_lock, reply: dict, result_parts) -> None:
        try:
            payload = json.dumps(reply, separators=(",", ":")).encode()
            # One writev (native) / one sendall keeps the header frame and
            # result blobs adjacent without a concatenation copy.
            from ptype_tpu_torch import native

            with send_lock:
                if not native.send_frame(conn, payload, result_parts):
                    conn.sendall(struct.pack(">I", len(payload)) + payload
                                 + b"".join(result_parts))
        except OSError:
            pass

    def dispatch(self, method: str, args):
        """Invoke a handler directly (used by the zero-copy local path).

        The handler runs inside an ``actor/<method>`` span — for wire
        calls it parents under the traceparent `_handle_request`
        attached; for local calls the caller's context flows in via
        `_LocalConn`'s copied contextvars. Both paths stitch."""
        fn = self._handlers.get(method)
        if fn is None:
            raise AttributeError(f"no such method: {method!r}")
        with trace.span(f"actor/{method}", port=self.port):
            if isinstance(args, (list, tuple)):
                return fn(*args)
            return fn(args)

    def _stop_accepting(self) -> None:
        with _local_lock:
            for key in [k for k, v in _local_servers.items() if v is self]:
                del _local_servers[key]
        # shutdown() before close(): threads parked in accept(2)/recv(2)
        # are not woken by close() alone — without this, every conn
        # reader (and the accept loop) outlives the server as a wedged
        # daemon thread.
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass

    def quiesce(self) -> bool:
        """The first half of a graceful close: stop accepting
        connections, refuse every request read from now on with a
        typed :class:`~ptype_tpu_torch.errors.ServerClosingError`, and
        wait up to :data:`QUIESCE_S` seconds until each request read before
        has had its reply written. Returns whether all have. Call
        :meth:`close` next; a close without a quiesce drops the replies
        of handlers still running."""
        with self._idle:
            self._quiescing = True
        self._stop_accepting()
        with self._idle:
            done = self._idle.wait_for(lambda: not self._inflight,
                                       QUIESCE_S)
            pending = self._inflight
        if not done:
            log.warning("quiesce timed out",
                        kv={"addr": f"{self.host}:{self.port}",
                            "pending": pending, "timeout_s": QUIESCE_S})
        return done

    def close(self) -> None:
        if self._closed.is_set():
            return
        self._closed.set()
        self._stop_accepting()
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            # Wakes the conn's reader, which closes it (_serve_conn).
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
