"""Length-prefixed JSON framing for the coordination protocol — the
port's copy of ``ptype_tpu/coord/wire.py``, so either package's
coordinator and clients speak to the other's.

The control plane is low-volume metadata (service records, small KV state,
lease heartbeats) — JSON over TCP is the honest choice; tensors NEVER travel
through here (they ride the actor RPC tensor codec or the
``torch.distributed`` collectives).

Frame: 4-byte big-endian length, then UTF-8 JSON payload.
"""

from __future__ import annotations

import json
import socket
import struct
import threading

from ptype_tpu_torch import chaos, trace

MAX_FRAME = 64 * 1024 * 1024

_LEN = struct.Struct(">I")


class WireError(ConnectionError):
    pass


def _chaos_kill(sock: socket.socket) -> None:
    """Sever a connection the chaos way: shutdown() first so a reader
    parked in recv(2) on the same socket wakes immediately (close()
    alone does not — same reason as RemoteCoord._bounce_endpoint)."""
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


def send_msg(sock: socket.socket, lock: threading.Lock, msg: dict) -> None:
    tp = trace.traceparent()
    if tp is not None and "_tp" not in msg:
        # Trace context rides the frame (the coord-plane analog of the
        # actor frame's "tp"): CoordServer attaches it around op
        # dispatch so coordinator work joins the caller's trace.
        # Replies/pushes sent from untraced threads carry nothing.
        msg = {**msg, "_tp": tp}
    payload = json.dumps(msg, separators=(",", ":")).encode("utf-8")
    if len(payload) > MAX_FRAME:
        raise WireError(f"frame too large: {len(payload)} bytes")
    f = chaos.hit("coord.wire_send", str(msg.get("op", "")))
    if f is not None:
        if f.action == "delay":
            f.sleep()
        elif f.action == "drop":
            _chaos_kill(sock)
            raise WireError("chaos: connection dropped before send")
        elif f.action == "truncate":
            with lock:
                try:
                    sock.sendall(_LEN.pack(len(payload))
                                 + payload[: len(payload) // 2])
                except OSError:
                    pass
            _chaos_kill(sock)
            raise WireError("chaos: frame truncated mid-send")
    with lock:
        sock.sendall(_LEN.pack(len(payload)) + payload)


def recv_msg(sock: socket.socket) -> dict:
    f = chaos.hit("coord.wire_recv")
    if f is not None:
        if f.action == "delay":
            f.sleep()
        elif f.action == "drop":
            _chaos_kill(sock)
            raise WireError("chaos: connection dropped before recv")
    header = _recv_exact(sock, _LEN.size)
    (length,) = _LEN.unpack(header)
    if length > MAX_FRAME:
        raise WireError(f"frame too large: {length} bytes")
    payload = _recv_exact(sock, length)
    try:
        msg = json.loads(bytes(payload).decode("utf-8"))
    except (ValueError, UnicodeDecodeError, RecursionError) as e:
        # RecursionError: ~2000 nested brackets blows json's recursive
        # parser well under MAX_FRAME — same peer-garbage class.
        # Garbage from a confused/malicious peer must surface as the
        # connection-level error every reader already handles — a raw
        # JSONDecodeError would escape the (WireError, OSError) nets.
        raise WireError(f"malformed frame: {e}") from e
    if not isinstance(msg, dict):
        raise WireError(f"malformed frame: expected object, "
                        f"got {type(msg).__name__}")
    return msg


def _recv_exact(sock: socket.socket, n: int) -> memoryview:
    """Read exactly n bytes into one preallocated buffer (no chunk list
    + join). Uses the native GIL-free reader when built (ptype_tpu_torch.native,
    the compiled-runtime tier); recv_into otherwise.

    The native path requires a BLOCKING socket: ``settimeout()`` flips
    the fd to non-blocking and raw ``recv(2)`` then returns EAGAIN
    immediately (observed as spurious probe failures in the standby) —
    Python's own recv hides this behind a selector wait, so timed
    sockets take the Python path."""
    buf = bytearray(n)
    view = memoryview(buf)
    try:
        from ptype_tpu_torch import native

        if native.available() and sock.gettimeout() is None:
            got = native.recv_exact_into(sock, view)
            if got < n:
                raise WireError("connection closed")
            return view
    except NotImplementedError:
        pass
    except ImportError:
        pass
    got = 0
    while got < n:
        r = sock.recv_into(view[got:])
        if r == 0:
            raise WireError("connection closed")
        got += r
    return view
