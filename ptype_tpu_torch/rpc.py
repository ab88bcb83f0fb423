"""Load-balanced actor RPC client — the port's copy of
``ptype_tpu/rpc.py``, wire-compatible with it both ways.

Capability parity with the reference's L4 (cluster/rpc.go): sync ``call``,
async ``go``, a watch-driven connection balancer with debounced rebalancing,
deterministic hash-based node selection, atomic round-robin, bounded
retries, mesh mode (``max_connections=0``), and a connection-error stream.

Documented reference bugs are **fixed, not replicated** (SURVEY.md §2):
- ``withRetry`` looped forever / never retried (rpc.go:107-116) — here a
  call makes exactly ``retries + 1`` attempts, each on the next
  round-robin connection so retries land on different nodes when possible;
- ``Client.Go`` delivered the first completion without retrying
  (rpc.go:90-95) — here the async path shares the sync retry loop;
- membership changes re-dialed every node (rpc.go:226-244) — here healthy
  connections to surviving nodes are reused;
- ``selectNodes`` could pick duplicates (rpc.go:252-264) — here collisions
  linear-probe to distinct nodes.

Device rules of the port: reply tensors decode onto the client's
``device`` (``resolve_device``: ``cuda`` unless named, raising with no
card and none named; resolved only for a reply that holds a tensor).
The same-process path passes CUDA tensors by reference into the
server's dispatch thread: it makes that thread's stream wait for the
caller's current stream first, and resolves the call only once the
handler's stream has finished its work, so neither side reads a tensor
the other is still writing.
"""

from __future__ import annotations

import contextvars
import functools
import json
import queue
import struct
import sys
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FuturesTimeoutError
from dataclasses import dataclass

from ptype_tpu_torch import actor as actor_mod
from ptype_tpu_torch import chaos, codec, logs, retry, trace
from ptype_tpu_torch.coord import wire
from ptype_tpu_torch.device import resolve_device
from ptype_tpu_torch.errors import (NoClientAvailableError, RemoteError,
                                    RPCError, ShedError)
from ptype_tpu_torch.registry import Node, NodeWatch, Registry

log = logs.get_logger("rpc")

_LEN = struct.Struct(">I")


@dataclass
class ConnConfig:
    """Ref: rpc.go:19-38, defaults preserved."""

    #: Max connections to unique nodes; 0 = full mesh.
    max_connections: int = 3
    #: Timeout for the initial node set to appear.
    initial_node_timeout: float = 5.0
    #: Quiet window for batching membership churn.
    debounce_time: float = 3.0
    #: Extra attempts after the first (total attempts = retries + 1),
    #: possibly on different nodes.
    retries: int = 2
    #: Per-attempt call timeout (the reference relied on TCP semantics;
    #: an explicit bound is strictly safer). None = no timeout.
    call_timeout: float | None = 60.0
    #: TCP connect timeout per dial (was hard-coded in ``_Conn``).
    dial_timeout: float = 5.0
    #: Jittered exponential backoff between retry attempts: an
    #: immediate re-fire lands the whole retry budget inside the same
    #: dying node set before the balancer can notice. First retry
    #: waits ~``retry_backoff_base``, growing to ``retry_backoff_cap``.
    retry_backoff_base: float = 0.05
    retry_backoff_cap: float = 1.0
    #: Pluggable connection picker: ``picker(healthy_conns) -> conn``
    #: replaces blind round-robin in the balancer's ``get()`` — the
    #: seam the inference gateway uses to inject its load-aware choice
    #: (``gateway.least_loaded_picker``). Returning None (or anything
    #: not in the list, or raising) falls back to round-robin, so a
    #: picker can never strand a caller.
    picker: object = None


DEFAULT_CONN_CONFIG = ConnConfig()


def fnv32a(data: str) -> int:
    """FNV-1a 32-bit (ref: rpc.go:266-270 used hash/fnv New32a)."""
    h = 0x811C9DC5
    for byte in data.encode("utf-8"):
        h ^= byte
        h = (h * 0x01000193) & 0xFFFFFFFF
    return h


# ---------------------------------------------------------------- transport


class _Conn:
    """One multiplexed connection to an actor server."""

    def __init__(self, node: Node, dial_timeout: float = 5.0, device=None):
        self.node = node
        self._decode_device = functools.partial(resolve_device, device)
        import socket

        self._sock = socket.create_connection(
            (node.address, node.port), timeout=dial_timeout
        )
        self._sock.settimeout(None)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._send_lock = threading.Lock()
        self._pending: dict[int, Future] = {}
        self._pending_lock = threading.Lock()
        self._next_id = 1
        self._id_lock = threading.Lock()
        self._closed = threading.Event()
        threading.Thread(
            target=self._read_loop,
            name=f"rpc-conn-{node.address}:{node.port}",
            daemon=True,
        ).start()

    @property
    def healthy(self) -> bool:
        return not self._closed.is_set()

    def _read_loop(self) -> None:
        while not self._closed.is_set():
            try:
                msg = wire.recv_msg(self._sock)
                blob = b""
                if msg.get("result_len"):
                    blob = wire._recv_exact(self._sock, msg["result_len"])
            except (wire.WireError, OSError):
                break
            f = chaos.hit("rpc.recv")
            if f is not None and f.action == "delay":
                f.sleep()  # slow reply: the caller's timeout clock runs
            with self._pending_lock:
                fut = self._pending.pop(msg.get("id"), None)
            if fut is None:
                continue
            if msg.get("ok"):
                try:
                    fut.set_result(codec.decode(blob, self._decode_device))
                except Exception as e:  # noqa: BLE001
                    fut.set_exception(RPCError(f"decode failed: {e}"))
            elif msg.get("shed"):
                # Typed admission refusal (gateway overload): keep the
                # retry hint and the ShedError type across the wire —
                # callers back off, the retry loop must NOT re-fire.
                fut.set_exception(ShedError(
                    msg.get("error", "request shed"),
                    retry_after_s=msg.get("retry_after_s", 1.0)))
            else:
                fut.set_exception(
                    RemoteError(msg.get("error", "remote error"),
                                msg.get("traceback", ""))
                )
        self.close()

    def call_async(self, method: str, args) -> Future:
        if self._closed.is_set():
            fut: Future = Future()
            fut.set_exception(RPCError(f"connection to {self.node.address}:"
                                       f"{self.node.port} closed"))
            return fut
        f = chaos.hit("rpc.send", method)
        if f is not None:
            injected = self._inject_send_fault(f)
            if injected is not None:
                return injected
        parts = codec.encode_parts(args)
        args_len = sum(len(p) for p in parts)
        with self._id_lock:
            req_id = self._next_id
            self._next_id += 1
        fut = Future()
        fut.req_id = req_id  # lets the caller forget() a timed-out call
        with self._pending_lock:
            self._pending[req_id] = fut
        frame = {"id": req_id, "method": method, "args_len": args_len}
        tp = trace.traceparent()
        if tp is not None:
            # Trace context rides the request frame: the server attaches
            # it around dispatch so the handler's spans join this trace.
            frame["tp"] = tp
        header = json.dumps(frame, separators=(",", ":")).encode("utf-8")
        try:
            with self._send_lock:
                # One writev (native) / one sendall: the header frame and
                # every tensor blob go out without a concatenation copy.
                from ptype_tpu_torch import native

                if not native.send_frame(self._sock, header, parts):
                    self._sock.sendall(
                        _LEN.pack(len(header)) + header + b"".join(parts)
                    )
        except OSError as e:
            with self._pending_lock:
                self._pending.pop(req_id, None)
            self.close()
            fut.set_exception(RPCError(f"send failed: {e}"))
        return fut

    def _inject_send_fault(self, f) -> Future | None:
        """Apply an armed ``rpc.send`` fault. ``delay`` returns None
        (the real send proceeds afterwards); ``drop`` and ``truncate``
        kill the connection and return a failed Future — the retry
        path's next attempt lands on another node."""
        if f.action == "delay":
            f.sleep()
            return None
        if f.action == "truncate":
            # A length header promising more bytes than ever arrive:
            # the server reader blocks on the remainder until the close
            # lands, then surfaces the standard truncated-frame
            # WireError — the same failure a mid-send crash produces.
            try:
                with self._send_lock:
                    self._sock.sendall(_LEN.pack(1 << 20) + b"chaos")
            except OSError:
                pass
        self.close()
        fut: Future = Future()
        fut.set_exception(RPCError(
            f"chaos: {f.action} on send to "
            f"{self.node.address}:{self.node.port}"))
        return fut

    def forget(self, fut: Future) -> None:
        """Drop a timed-out call's pending entry so abandoned futures are
        not resolved by late replies and _pending cannot grow unboundedly."""
        req_id = getattr(fut, "req_id", None)
        if req_id is not None:
            with self._pending_lock:
                self._pending.pop(req_id, None)

    def close(self) -> None:
        if self._closed.is_set():
            return
        self._closed.set()
        import socket

        try:
            # shutdown() wakes the read loop parked in recv(2); close()
            # alone leaves it wedged until process exit.
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        with self._pending_lock:
            pending, self._pending = list(self._pending.values()), {}
        for fut in pending:
            if not fut.done():
                fut.set_exception(RPCError("connection closed"))


def _cuda_stream_mark():
    """(device, event recorded on this thread's current stream), or None
    when this process has not initialised CUDA — then no tensor of the
    call can lie on a card."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return None
    ev = torch.cuda.Event()
    ev.record()
    return torch.cuda.current_device(), ev


class _LocalConn:
    """Zero-copy same-process dispatch — no socket, no serialization.

    This is the device-native fast path: CUDA tensor args pass by
    reference, avoiding the device→host→device round-trip the north star
    calls out. The dispatch thread runs on the caller's card, its stream
    waiting for the caller's current stream (a tensor written on a side
    stream is complete before the handler reads it), and the call
    resolves only after the handler's stream has drained (the caller may
    read the result on any stream).
    """

    def __init__(self, node: Node, server: actor_mod.ActorServer):
        self.node = node
        self._server = server

    @property
    def healthy(self) -> bool:
        return self._server.serving

    def call_async(self, method: str, args) -> Future:
        fut: Future = Future()
        # Carry the caller's trace context into the dispatch thread —
        # contextvars do not flow into new threads on their own, and
        # the local fast path must stitch like the wire path does.
        ctx = contextvars.copy_context()
        mark = _cuda_stream_mark()

        def dispatch():
            if mark is None:
                return self._server.dispatch(method, args)
            import torch

            card, ev = mark
            with torch.cuda.device(card):
                torch.cuda.current_stream().wait_event(ev)
                result = self._server.dispatch(method, args)
                torch.cuda.current_stream().synchronize()
            return result

        def run():
            try:
                fut.set_result(ctx.run(dispatch))
            except ShedError as e:
                fut.set_exception(e)  # typed: parity with the wire path
            except Exception as e:  # noqa: BLE001
                import traceback

                fut.set_exception(RemoteError(f"{type(e).__name__}: {e}",
                                              traceback.format_exc()))

        threading.Thread(target=run, daemon=True).start()
        return fut

    def forget(self, fut: Future) -> None:
        pass

    def close(self) -> None:
        pass


def _dial(node: Node, dial_timeout: float = 5.0, device=None):
    f = chaos.hit("rpc.dial", f"{node.address}:{node.port}")
    if f is not None:
        if f.action == "delay":
            f.sleep()
        elif f.action in ("drop", "timeout"):
            raise OSError(
                f"chaos: dial {f.action} to {node.address}:{node.port}")
    local = actor_mod.lookup_local(node.address, node.port)
    if local is not None:
        return _LocalConn(node, local)
    return _Conn(node, dial_timeout, device)


# ---------------------------------------------------------------- balancer


class _ConnectionBalancer:
    """Watches the registry and maintains <= max_connections dialed peers
    (ref: rpc.go:126-297, with the §2 fixes)."""

    def __init__(self, local_addr: str, service_name: str, registry: Registry,
                 cfg: ConnConfig, device=None):
        self.cfg = cfg
        self.device = device
        self.local_addr = local_addr
        self.service_name = service_name
        self._seq = 0
        self._seq_lock = threading.Lock()
        self._lock = threading.RLock()
        self._conns: list = []
        #: Latest node snapshot, kept so ``get()`` can kick a redial of
        #: dead connections without waiting for membership churn (a
        #: single-node service whose one connection drops would
        #: otherwise stay dead until the next watch event).
        self._last_nodes: list[Node] = []
        self._redialing = threading.Event()
        self._closed = threading.Event()
        self.err_queue: "queue.Queue[Exception]" = queue.Queue(maxsize=1024)
        self.conns_updated = threading.Event()

        self._watch: NodeWatch = registry.watch_service(service_name)
        # The registry pushes an immediate initial snapshot which may be
        # empty (service not registered yet — a normal startup race); keep
        # absorbing snapshots until one has nodes or the timeout passes
        # (ref contract: InitialNodeTimeout, rpc.go:155-160).
        deadline = time.monotonic() + cfg.initial_node_timeout
        initial: list[Node] | None = None
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            got = self._watch.get(timeout=remaining)
            if got:
                initial = got
                break
        if not initial:
            self._watch.cancel()
            raise NoClientAvailableError(
                f"no nodes for service {service_name!r} within "
                f"{cfg.initial_node_timeout}s"
            )
        self._handle_new_nodes(initial)
        self._watch_thread = threading.Thread(
            target=self._watch_loop, name=f"balancer-{service_name}",
            daemon=True,
        )
        self._watch_thread.start()

    # -- selection ---------------------------------------------------------

    def _select_nodes(self, nodes: list[Node]) -> list[Node]:
        """Deterministic hash-based subset (ref: rpc.go:252-270), with
        linear probing instead of the reference's duplicate-prone rehash."""
        n = len(nodes)
        want = n if self.cfg.max_connections == 0 else min(
            self.cfg.max_connections, n
        )
        nodes = sorted(nodes, key=lambda nd: (nd.address, nd.port))
        chosen: list[Node] = []
        taken: set[int] = set()
        for i in range(want):
            idx = fnv32a(self.local_addr + str(i)) % n
            while idx in taken:
                idx = (idx + 1) % n
            taken.add(idx)
            chosen.append(nodes[idx])
        return chosen

    def _handle_new_nodes(self, nodes: list[Node]) -> None:
        selected = self._select_nodes(nodes) if nodes else []
        with self._lock:
            self._last_nodes = list(nodes)
            existing = {
                (c.node.address, c.node.port): c
                for c in self._conns
            }
        # Dial OUTSIDE the lock: a blackholed peer costs a full
        # dial_timeout, and holding the balancer lock across it would
        # stall every concurrent get() even though healthy connections
        # exist.
        new_conns = []
        dialed = []
        for node in selected:
            key = (node.address, node.port)
            cur = existing.get(key)
            if cur is not None and cur.healthy:
                new_conns.append(cur)  # reuse, don't re-dial (§2 fix)
                continue
            try:
                conn = _dial(node, self.cfg.dial_timeout, self.device)
            except OSError as e:
                self._report(RPCError(
                    f"dial {node.address}:{node.port} failed: {e}"
                ))
                continue
            dialed.append(conn)
            new_conns.append(conn)
        with self._lock:
            if self._closed.is_set():
                # close() raced the dials: never install into a closed
                # balancer (leaked sockets + reader threads).
                for c in dialed:
                    c.close()
                return
            keep = {id(c) for c in new_conns}
            for c in self._conns:
                if id(c) not in keep:
                    c.close()
            self._conns = new_conns
        self.conns_updated.set()
        log.debug("rebalanced connections",
                  kv={"service": self.service_name, "conns": len(selected)})

    def _watch_loop(self) -> None:
        """Debounce churn: after a change arrives, keep absorbing updates
        until the quiet window passes, then apply the latest snapshot
        (ref: rpc.go:197-224; coalescing contract rpc_test.go:371-387)."""
        while not self._closed.is_set():
            latest = self._watch.get(timeout=0.5)
            if latest is None:
                if self._watch.closed:
                    return
                continue
            deadline = time.monotonic() + self.cfg.debounce_time
            while True:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                more = self._watch.get(timeout=remaining)
                if more is not None:
                    latest = more
            if self._closed.is_set():
                return
            self._handle_new_nodes(latest)

    # -- access ------------------------------------------------------------

    def get(self):
        """Round-robin connection (ref: rpc.go:176-183); wraps at 2**64
        like the reference's uint64 counter (rpc_test.go:390-425). A
        configured ``picker`` sees the healthy set first and may
        override the choice (load-aware routing); any misbehavior —
        None, a stale conn, an exception — falls back to round-robin."""
        with self._seq_lock:
            seq = self._seq
            self._seq = (self._seq + 1) & 0xFFFFFFFFFFFFFFFF
        with self._lock:
            conns = [c for c in self._conns if c.healthy]
            if len(conns) < len(self._conns) or not conns:
                # Dead connections with no membership churn to evict
                # them: kick a background re-dial of the last snapshot
                # so the client heals instead of waiting for a watch
                # event that may never come.
                self._kick_redial()
            if not conns:
                return None
            if self.cfg.picker is not None:
                try:
                    chosen = self.cfg.picker(list(conns))
                except Exception:  # noqa: BLE001 — picker is advisory
                    chosen = None
                if chosen is not None and any(chosen is c for c in conns):
                    return chosen
            return conns[seq % len(conns)]

    def _kick_redial(self) -> None:
        # No extra cooldown: _redialing already serializes bursts (an
        # unreachable peer holds it for its whole dial_timeout), and a
        # fixed cooldown would race the retry backoff — a caller's last
        # attempt must not find the redial still embargoed.
        if self._closed.is_set() or self._redialing.is_set():
            return
        self._redialing.set()

        def run():
            try:
                with self._lock:
                    nodes = list(self._last_nodes)
                if nodes and not self._closed.is_set():
                    self._handle_new_nodes(nodes)
            finally:
                self._redialing.clear()

        threading.Thread(target=run, name=f"redial-{self.service_name}",
                         daemon=True).start()

    def _report(self, err: Exception) -> None:
        try:
            self.err_queue.put_nowait(err)
        except queue.Full:
            pass

    def close(self) -> None:
        if self._closed.is_set():
            return
        self._closed.set()
        self._watch.cancel()
        with self._lock:
            conns, self._conns = self._conns, []
        for c in conns:
            c.close()


# ------------------------------------------------------------------ client


class Client:
    """Sync/async actor calls with bounded retries (ref: rpc.go:40-124).
    Reply tensors decode onto ``device`` (see the module doc)."""

    def __init__(self, local_addr: str, service_name: str, registry: Registry,
                 cfg: ConnConfig | None = None, device=None):
        self.cfg = cfg or DEFAULT_CONN_CONFIG
        self._conns = _ConnectionBalancer(
            local_addr, service_name, registry, self.cfg, device
        )

    def call(self, method: str, *args):
        """Synchronous call; up to ``retries + 1`` attempts, each on the
        next round-robin connection (correct version of rpc.go:59-67)."""
        return self._with_retry(method, args)

    def go(self, method: str, *args, done=None) -> Future:
        """Asynchronous call returning a Future (ref Client.Go's done
        channel, rpc.go:69-105 — with retries that actually happen).

        ``done``: optional callable invoked with the Future on completion,
        or a ``queue.Queue`` the Future is put on (the done-channel shape).
        """
        fut: Future = Future()

        def run():
            try:
                fut.set_result(self._with_retry(method, args))
            except Exception as e:  # noqa: BLE001
                fut.set_exception(e)

        threading.Thread(target=run, daemon=True).start()
        if done is not None:
            if isinstance(done, queue.Queue):
                fut.add_done_callback(done.put)
            elif callable(done):
                fut.add_done_callback(done)
        return fut

    def _with_retry(self, method: str, args):
        attempts = self.cfg.retries + 1
        last_err: Exception | None = None
        bo = retry.Backoff(base=self.cfg.retry_backoff_base,
                           cap=self.cfg.retry_backoff_cap)
        for attempt in range(attempts):
            if attempt:
                # Jittered exponential backoff between attempts: give
                # the balancer (and the peer) a beat to recover instead
                # of re-firing immediately into the same dying node set.
                bo.sleep()
            conn = self._conns.get()
            if conn is None:
                last_err = NoClientAvailableError("no client nodes available")
                continue
            # One span per attempt: the traceparent injected by
            # call_async is THIS span, so the server-side handler span
            # parents under the attempt that actually carried it.
            with trace.span("rpc.call", method=method,
                            node=f"{conn.node.address}:{conn.node.port}",
                            attempt=attempt) as sp:
                fut = conn.call_async(method, args)
                try:
                    result = fut.result(timeout=self.cfg.call_timeout)
                    chaos.note_ok("rpc.call", method)
                    return result
                except FuturesTimeoutError:
                    conn.forget(fut)
                    last_err = RPCError(
                        f"call {method!r} timed out after "
                        f"{self.cfg.call_timeout}s"
                    )
                    # The failure is absorbed for retry, so the span
                    # exit never sees it — record it explicitly or the
                    # flight recorder shows a failed attempt as ok.
                    sp.set_status("error")
                    sp.add_event("exception", type="TimeoutError",
                                 message=str(last_err)[:200])
                    self._conns._report(last_err)
                    continue
                except ShedError:
                    # Typed overload refusal: terminal by contract —
                    # every retry would land back in the same
                    # overloaded admission queue and amplify the
                    # overload the shed exists to relieve. The caller
                    # owns the backoff (retry_after_s rides the
                    # exception).
                    raise
                except Exception as e:  # noqa: BLE001
                    # Both transport errors and remote handler errors
                    # retry — "retries are possibly done on different
                    # nodes" (rpc.go:28-30; retry-until-healthy-handler
                    # contract rpc_test.go:55-77).
                    last_err = e
                    sp.set_status("error")
                    sp.add_event("exception", type=type(e).__name__,
                                 message=str(e)[:200])
                    if not isinstance(e, RemoteError):
                        self._conns._report(e if isinstance(e, RPCError)
                                            else RPCError(str(e)))
        raise last_err if last_err is not None else NoClientAvailableError(
            "no client nodes available"
        )

    def connection_errs(self) -> "queue.Queue[Exception]":
        """Stream of balancer/transport errors (ref: rpc.go:122-124)."""
        return self._conns.err_queue

    def close(self) -> None:
        self._conns.close()
