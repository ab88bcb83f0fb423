"""Build and bind the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into its own shared library with a plain C interface,
loaded with :mod:`ctypes`. The build happens at first use, never at
import, into ``build/kernels/`` at the repo root (listed in
``.gitignore``), cached by a hash of the source, of every shared header
``csrc/*.cuh`` and of the flags: a checkout with nothing built builds on
its first kernel call, and an edit to a header rebuilds every source.
:func:`build_all` starts one ``nvcc`` per source, all at once.
:func:`sass_counts` reads back what a build compiled to.

The sources include no PyTorch header, so a build takes seconds. Every
C entry point enqueues on the stream it is given and returns
``cudaGetLastError()``; :func:`bind` gives an entry point with its ctypes
signature set (once per process), and :func:`check` turns a non-zero
code into an exception.

This cache is the port's program cache, and so the compile seam of
:mod:`ptype_tpu_torch.jitwatch`: armed, :func:`load` books each library
built or opened in this process (``csrc/<name>`` at the target's file
name) and :func:`bind` each first bind of an entry point; a second load
of one target is a recompile.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

from ptype_tpu_torch import jitwatch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-lineinfo", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], object] = {}
#: ptxas's report (registers, shared memory, spills) of each build.
build_logs: dict[str, str] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed "
                           "to build the port's kernels")
    return path


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
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
            if jitwatch._watch is not None:
                jitwatch._watch.on_compile(f"csrc/{name}", out.name)
        return lib


def bind(name: str, fn: str, argtypes, restype=ctypes.c_int):
    """The C function ``fn`` of ``csrc/<name>.cu``, its ``argtypes`` and
    ``restype`` set on the first call and kept: a launch pays one dict
    lookup for it."""
    f = _fns.get((name, fn))
    if f is None:
        f = getattr(load(name), fn)
        f.restype = restype
        f.argtypes = argtypes
        _fns[(name, fn)] = f
        if jitwatch._watch is not None:
            jitwatch._watch.on_compile(f"csrc/{name}:{fn}",
                                       _target(name).name)
    return f


def kernel_label(symbol: str) -> str:
    """A kernel's mangled symbol as ``name<args>``, e.g.
    ``flash_fwd_kernel_bf16<128>`` or
    ``paged_decode_split_kernel<bf16,128,1>``."""
    m = re.search(r"\d([a-z][a-z_]*_kernel(?:_[a-z0-9]+)?)I"
                  r"((?:f|13__nv_bfloat16|Li\d+E)+)E", symbol)
    if not m:
        return symbol[:60]
    args = [{"f": "f32", "13__nv_bfloat16": "bf16"}.get(a.group(0), a.group(1))
            for a in re.finditer(r"f|13__nv_bfloat16|Li(\d+)E", m.group(2))]
    return f"{m.group(1)}<{','.join(args)}>"


#: Tensor-core and TMA instructions counted by :func:`sass_counts`:
#: ``wgmma``, TMA loads, and the ``mma.sync`` path WMMA compiles to.
SASS_OPS = ("HGMMA", "UTMALDG", "HMMA")


def sass_counts(name: str) -> dict[str, dict[str, int]]:
    """{kernel label: {instruction: count}} of :data:`SASS_OPS` in the
    built library of ``csrc/<name>.cu``, from ``cuobjdump -sass``."""
    tool = shutil.which("cuobjdump") or str(Path(nvcc()).parent / "cuobjdump")
    return count_sass(subprocess.run(
        [tool, "-sass", str(_target(name))], capture_output=True, text=True,
        check=True, timeout=300).stdout)


def count_sass(sass: str) -> dict[str, dict[str, int]]:
    """:func:`sass_counts` of a ``cuobjdump -sass`` listing."""
    counts: dict[str, dict[str, int]] = {}
    current = None
    for line in sass.splitlines():
        m = re.search(r"Function\s*:\s*(\S+)", line)
        if m:
            current = counts.setdefault(kernel_label(m.group(1)),
                                        dict.fromkeys(SASS_OPS, 0))
        elif current is not None:
            for op in SASS_OPS:
                if re.search(rf"\b{op}\b", line):
                    current[op] += 1
    return counts


def check(code: int, what: str, name: str) -> None:
    """Raise for a non-zero ``cudaError_t`` that a C entry point of
    ``csrc/<name>.cu`` returned (a refused launch never runs, and no later
    synchronize reports it). Every source exports ``error_string`` for
    the code's name."""
    if code != 0:
        msg = bind(name, "error_string", [ctypes.c_int],
                   ctypes.c_char_p)(code).decode()
        raise RuntimeError(f"{what}: CUDA launch failed: cudaError "
                           f"{code} ({msg})")
