"""The port's native wire library (``ptype_tpu_torch.native`` over its
copy ``ptype_tpu_torch/csrc/ptype_wire.cpp``, built by g++ into
``build/native/``) against the reference's: ``crc32c`` equal on seeded
random bytes, ``send_frame`` / ``recv_exact_into`` round trips (EOF
mid-frame included), a frame the port's native path sends decodes with
the reference's codec, and the pure-Python socket path when the library
is absent. Bytes are compared exactly."""

import socket
import threading

import numpy as np
import pytest
import torch

from ptype_tpu import codec as jcodec
from ptype_tpu import native as jnative
from ptype_tpu_torch import codec as tcodec
from ptype_tpu_torch import native
from ptype_tpu_torch.coord import wire


@pytest.fixture(scope="module")
def lib():
    lib = native.load()
    if lib is None:
        pytest.skip("native library unavailable (no g++)")
    return lib


def test_builds_into_the_build_directory(lib):
    assert native.available()
    so = native._target()
    assert so.exists() and so.parent == native.BUILD_DIR
    assert so.parent.parts[-2:] == ("build", "native")


def test_crc32c_equals_the_reference(lib):
    if jnative.load() is None:
        pytest.skip("reference native library unavailable")
    rng = np.random.default_rng(0)
    for n in (0, 1, 7, 32, 4096, 100_003):
        data = rng.bytes(n)
        assert native.crc32c(data) == jnative.crc32c(data), n
    assert native.crc32c(b"123456789") == 0xE3069283


def test_send_frame_roundtrip(lib):
    a, b = socket.socketpair()
    try:
        header = b'{"id":1}'
        blobs = [b"alpha", b"",
                 np.random.default_rng(1).bytes(1 << 16)]
        assert native.send_frame(a, header, blobs)
        want = len(header).to_bytes(4, "big") + header + b"".join(blobs)
        buf = memoryview(bytearray(len(want)))
        assert native.recv_exact_into(b, buf) == len(want)
        assert bytes(buf) == want
    finally:
        a.close()
        b.close()


def test_recv_exact_into_large_and_eof_midframe(lib):
    a, b = socket.socketpair()
    try:
        payload = np.random.default_rng(2).bytes(1 << 20)
        t = threading.Thread(target=lambda: a.sendall(payload))
        t.start()
        buf = memoryview(bytearray(len(payload)))
        assert native.recv_exact_into(b, buf) == len(payload)
        t.join(timeout=10)
        assert bytes(buf) == payload
        a.sendall(b"abc")
        a.close()
        with pytest.raises(ConnectionError, match="EOF mid-frame"):
            native.recv_exact_into(b, memoryview(bytearray(10)))
    finally:
        b.close()


def test_clean_eof_reads_zero(lib):
    a, b = socket.socketpair()
    a.close()
    try:
        assert native.recv_exact_into(b, memoryview(bytearray(4))) == 0
    finally:
        b.close()


def test_port_native_frame_decodes_with_the_reference_codec(lib):
    """A port payload (torch f32/int32/bf16, numpy, bytes, nesting) sent
    as [header][blobs] by the port's writev decodes in the reference
    codec to the same bytes."""
    rng = np.random.default_rng(3)
    f32 = torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32))
    i32 = torch.from_numpy(rng.integers(-9, 9, (7,)).astype(np.int32))
    bf = torch.from_numpy(rng.standard_normal((4, 2)).astype(np.float32)
                          ).to(torch.bfloat16)
    payload = {"f32": f32, "i32": i32, "bf16": bf,
               "np": np.arange(6, dtype=np.int64), "raw": b"\x00\x01",
               "nested": [1, ("a", 2.5)]}
    parts = tcodec.encode_parts(payload)
    a, b = socket.socketpair()
    try:
        # parts[0] is the codec's own length prefix: send_frame adds the
        # frame's, as the actor wire does for its header.
        assert native.send_frame(a, parts[0] + parts[1], parts[2:])
        n = int.from_bytes(bytes(wire._recv_exact(b, 4)), "big")
        frame = bytes(wire._recv_exact(b, n))
        frame += bytes(wire._recv_exact(b, sum(map(len, parts[2:]))))
    finally:
        a.close()
        b.close()
    got = jcodec.decode(frame)
    assert got["f32"].tobytes() == f32.numpy().tobytes()
    assert got["i32"].tobytes() == i32.numpy().tobytes()
    assert got["bf16"].tobytes() == bf.view(torch.int16).numpy().tobytes()
    assert str(got["bf16"].dtype) == "bfloat16"
    assert got["np"].tolist() == list(range(6))
    assert got["raw"] == b"\x00\x01"
    assert got["nested"] == [1, ("a", 2.5)]


def test_python_socket_path_without_the_library(monkeypatch):
    """With no library, send_frame declines (callers sendall) and the
    coordination wire reads through recv_into: the same bytes."""
    monkeypatch.setattr(native, "_tried", True)
    monkeypatch.setattr(native, "_lib", None)
    a, b = socket.socketpair()
    try:
        assert native.send_frame(a, b"{}", [b"x"]) is False
        with pytest.raises(NotImplementedError):
            native.recv_exact_into(b, memoryview(bytearray(1)))
        wire.send_msg(a, threading.Lock(), {"op": "ping", "id": 7})
        assert wire.recv_msg(b) == {"op": "ping", "id": 7}
    finally:
        a.close()
        b.close()
