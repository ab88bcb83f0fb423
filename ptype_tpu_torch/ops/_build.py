"""Build and bind the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into its own shared library with a plain C interface,
loaded with :mod:`ctypes`. The build happens at first use, never at
import, into ``build/kernels/`` at the repo root (listed in
``.gitignore``), cached by a hash of the source and the flags: a
checkout with nothing built builds on its first kernel call.
:func:`build_all` starts one ``nvcc`` per source, all at once.

The sources include no PyTorch header, so a build takes seconds. Every
C entry point enqueues on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a non-zero code into an
exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-lineinfo", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: ptxas's report (registers, shared memory, spills) of each build.
build_logs: dict[str, str] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed "
                           "to build the port's kernels")
    return path


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src + " ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _nvcc_cmd(name: str, out: Path) -> list[str]:
    return [nvcc(), *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(out),
            str(CSRC / f"{name}.cu")]


def build_all(names=None) -> dict[str, float]:
    """Compile every kernel source not yet built, one ``nvcc`` each,
    all started together. Returns {name: seconds} of what was built."""
    import time

    names = sorted(p.stem for p in CSRC.glob("*.cu")) if names is None \
        else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.monotonic()
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            _nvcc_cmd(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, out)
    took = {}
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, out)
        took[name] = time.monotonic() - t0
    return took


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            out = _target(name)
            if not out.exists():
                build_all([name])
            lib = ctypes.CDLL(str(out))
            _libs[name] = lib
        return lib


def check(code: int, what: str, lib: ctypes.CDLL) -> None:
    """Raise for a non-zero ``cudaError_t`` a kernel's C entry point
    returned (a refused launch never runs, and no later synchronize
    reports it). Every source exports ``error_string`` for the name."""
    if code != 0:
        lib.error_string.restype = ctypes.c_char_p
        lib.error_string.argtypes = [ctypes.c_int]
        msg = lib.error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA launch failed: cudaError "
                           f"{code} ({msg})")
