"""Actor RPC payload codec: JSON structure + raw tensor blobs — the
port's copy of ``ptype_tpu/codec.py``, with the same frame format, so
a frame written by either package decodes in the other.

Every payload splits into (a) a JSON-safe structure and (b) a list of
contiguous binary blobs for arrays, written directly after the header
— no base64, no copy through a JSON string. NumPy arrays come back as
NumPy arrays; tensors (``kind`` "torch", or the reference's "jax")
come back as torch tensors on the ``device`` :func:`decode` is given.

Frame layout::

    [4B header_len][header JSON][blob 0][blob 1]...

Header: ``{"tree": <structure>, "blobs": [len0, len1, ...]}`` where arrays
appear in the structure as ``{"__tensor__": i, "dtype": ..., "shape": ...,
"kind": "torch"|"jax"|"np"}`` and raw bytes as ``{"__bytes__": i}``.

NumPy has no bfloat16: a bf16 tensor's blob is its raw bits and its
``dtype`` the name "bfloat16", which decodes through torch (the port
never imports ``ml_dtypes``).
"""

from __future__ import annotations

import json
import struct
from typing import Any

import numpy as np

_LEN = struct.Struct(">I")


class CodecError(ValueError):
    pass


def _is_tensor(x: Any) -> bool:
    # Avoid importing torch eagerly for pure-control-plane processes.
    if not type(x).__module__.startswith("torch"):
        return False
    import torch

    return isinstance(x, torch.Tensor)


def _tensor_blob(t) -> tuple[np.ndarray, str]:
    """A tensor's host bytes and dtype name (the device-to-host copy
    happens here)."""
    import torch

    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint8).numpy(), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _to_tensor(buf, dtype: str, shape, device):
    import torch

    if dtype == "bfloat16":
        t = torch.frombuffer(bytearray(buf), dtype=torch.bfloat16)
    else:
        t = torch.from_numpy(np.frombuffer(buf, dtype=np.dtype(dtype))
                             .copy())
    t = t.reshape(shape)
    return t if device is None else t.to(device)


def _encode_impl(payload: Any) -> tuple[bytes, list]:
    """(header JSON bytes, blob list) — the frame minus assembly."""
    blobs: list[bytes | memoryview] = []

    def enc(x: Any):
        if x is None or isinstance(x, (bool, int, float, str)):
            return x
        if isinstance(x, (bytes, bytearray, memoryview)):
            blobs.append(bytes(x))
            return {"__bytes__": len(blobs) - 1}
        if isinstance(x, np.ndarray):
            arr = np.ascontiguousarray(x)
            blobs.append(memoryview(arr).cast("B"))
            return {"__tensor__": len(blobs) - 1, "dtype": str(arr.dtype),
                    "shape": list(arr.shape), "kind": "np"}
        if _is_tensor(x):
            arr, dtype = _tensor_blob(x)
            blobs.append(memoryview(np.ascontiguousarray(arr)).cast("B"))
            return {"__tensor__": len(blobs) - 1, "dtype": dtype,
                    "shape": list(x.shape), "kind": "torch"}
        if isinstance(x, np.generic):
            return enc(np.asarray(x))
        if isinstance(x, (list, tuple)):
            tag = "__list__" if isinstance(x, list) else "__tuple__"
            return {tag: [enc(v) for v in x]}
        if isinstance(x, dict):
            for k in x:
                if not isinstance(k, str):
                    raise CodecError(f"dict keys must be str, got {type(k)}")
                if k.startswith("__") and k.endswith("__"):
                    raise CodecError(f"reserved key name: {k!r}")
            return {k: enc(v) for k, v in x.items()}
        raise CodecError(f"cannot encode {type(x).__name__}")

    tree = enc(payload)
    header = json.dumps(
        {"tree": tree, "blobs": [len(b) for b in blobs]},
        separators=(",", ":"),
    ).encode("utf-8")
    return header, blobs


def encode(payload: Any) -> bytes:
    """Serialize an arbitrary pytree-ish payload into one frame."""
    return b"".join(encode_parts(payload))


def encode_parts(payload: Any) -> list[bytes]:
    """Like :func:`encode` but WITHOUT the final join: the frame as
    ``[4B header-len, header, blob0, ...]`` pieces. The native wire tier
    hands these to one writev(), so a multi-hundred-MB parameter payload
    is never copied into a second contiguous bytes object.
    ``b"".join(encode_parts(x)) == encode(x)``.
    """
    header, blobs = _encode_impl(payload)
    return [_LEN.pack(len(header)), header, *(bytes(b) for b in blobs)]


def decode(frame: bytes | memoryview, device: Any = None) -> Any:
    """Deserialize a frame.

    ``device``: the torch device that tensors (``kind`` "torch" or
    "jax") are placed on; None leaves them on the CPU. A callable is
    called once, at the first tensor, for the device (so a frame with
    no tensors never resolves one). NumPy arrays stay on the host
    either way.
    """
    frame = memoryview(frame)
    (header_len,) = _LEN.unpack(frame[: _LEN.size])
    header = json.loads(bytes(frame[_LEN.size : _LEN.size + header_len]))
    blob_lens = header["blobs"]
    blobs: list[memoryview] = []
    offset = _LEN.size + header_len
    for blen in blob_lens:
        blobs.append(frame[offset : offset + blen])
        offset += blen
    placed: list = []

    def place():
        if not placed:
            placed.append(device() if callable(device) else device)
        return placed[0]

    def dec(x: Any):
        if isinstance(x, dict):
            if "__bytes__" in x:
                return bytes(blobs[x["__bytes__"]])
            if "__tensor__" in x:
                buf = blobs[x["__tensor__"]]
                if (x.get("kind") in ("torch", "jax")
                        or x["dtype"] == "bfloat16"):
                    return _to_tensor(buf, x["dtype"], x["shape"], place())
                return np.frombuffer(
                    buf, dtype=np.dtype(x["dtype"])).reshape(x["shape"])
            if "__list__" in x:
                return [dec(v) for v in x["__list__"]]
            if "__tuple__" in x:
                return tuple(dec(v) for v in x["__tuple__"])
            return {k: dec(v) for k, v in x.items()}
        return x

    return dec(header["tree"])
