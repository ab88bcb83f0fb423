"""ctypes loader for the native wire library — the port's copy of
``ptype_tpu/native.py`` over its own copy of the source,
``ptype_tpu_torch/csrc/ptype_wire.cpp``.

The reference's whole runtime was compiled (Go); here the Python host
runtime gets a native transport tier: writev frame sends (no
concatenation copy) and GIL-free exact reads. It is a host library, not
a kernel. Loading is best-effort — ``available()`` is False and callers
fall back to pure Python when the library cannot be built (no
compiler).

``load()`` builds it with ``g++`` at first use, never at import, into
``build/native/`` at the repo root (listed in ``.gitignore``; the
reference builds into its package directory), named by a hash of the
source so an edit rebuilds. Each build writes a temporary file and
renames it into place, so processes that build at once never load a
half-written library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

from ptype_tpu_torch import logs

log = logs.get_logger("native")

_SRC = Path(__file__).resolve().parent / "csrc" / "ptype_wire.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "native"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def _target() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"ptype_wire-{digest}.so"


def _build(so: Path) -> bool:
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run(
                ["g++", "-O3", "-fPIC", "-shared", "-o", tmp, str(_SRC)],
                check=True, capture_output=True, timeout=120,
            )
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return True
    except (OSError, subprocess.SubprocessError) as e:
        log.debug("native build failed", kv={"err": str(e)})
        return False


def load() -> ctypes.CDLL | None:
    """The native library, building it on first use if possible.

    Lock-free fast path after the first call: every wire send/recv goes
    through here, so the steady state must not serialize all connection
    threads on a module lock (the one-time build inside the lock is
    acceptable: callers fall back to Python until it finishes)."""
    global _lib, _tried
    if _tried:
        return _lib
    with _lock:
        if _tried:
            return _lib
        _tried = True
        so = _target()
        if not so.exists() and not _build(so):
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError as e:
            log.debug("native load failed", kv={"err": str(e)})
            return None
        lib.ptype_send_frame.restype = ctypes.c_int
        lib.ptype_send_frame.argtypes = [
            ctypes.c_int, ctypes.c_char_p, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint64,
        ]
        lib.ptype_recv_exact.restype = ctypes.c_int64
        lib.ptype_recv_exact.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_uint64,
        ]
        lib.ptype_crc32c.restype = ctypes.c_uint32
        lib.ptype_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        _lib = lib
        log.debug("native wire library loaded", kv={"path": str(so)})
        return _lib


def available() -> bool:
    return load() is not None


def send_frame(sock, header: bytes, blobs: list[bytes]) -> bool:
    """writev the frame [len][header][blobs...]; False → caller falls
    back to Python sends. Socket must be blocking."""
    lib = load()
    if lib is None:
        return False
    n = len(blobs)
    if n > 1000:
        # The C side caps its iovec array; very-many-leaf payloads take
        # the Python sendall fallback rather than erroring.
        return False
    blob_arr = (ctypes.c_char_p * n)(*blobs) if n else None
    len_arr = (ctypes.c_uint64 * n)(*[len(b) for b in blobs]) if n else None
    rc = lib.ptype_send_frame(
        sock.fileno(), header, len(header),
        ctypes.cast(blob_arr, ctypes.POINTER(ctypes.c_char_p)),
        ctypes.cast(len_arr, ctypes.POINTER(ctypes.c_uint64)),
        n,
    )
    if rc != 0:
        raise OSError(-rc, os.strerror(-rc))
    return True


def recv_exact_into(sock, buf: memoryview) -> int:
    """Read exactly len(buf) bytes into a writable buffer without the
    GIL. Returns bytes read (== len(buf)), 0 on clean EOF; raises
    ConnectionError on mid-frame EOF, OSError on socket error. Falls
    back by raising NotImplementedError when the library is absent."""
    lib = load()
    if lib is None:
        raise NotImplementedError("native wire library unavailable")
    addr = ctypes.addressof(ctypes.c_char.from_buffer(buf))
    rc = lib.ptype_recv_exact(sock.fileno(), addr, len(buf))
    if rc == -1000000:
        raise ConnectionError("EOF mid-frame")
    if rc < 0:
        raise OSError(int(-rc), os.strerror(int(-rc)))
    return int(rc)


def crc32c(data: bytes) -> int:
    lib = load()
    if lib is None:
        raise NotImplementedError("native wire library unavailable")
    return int(lib.ptype_crc32c(data, len(data)))
