"""Runtime recompile watchdog + host-synchronisation discipline — the
port of ``ptype_tpu/jitwatch.py``: the dynamic half of the
dispatch-discipline plane (:mod:`ptype_tpu_torch.progaudit` is the
program contract).

Eager PyTorch has no trace cache and no compile log. The port's
programs are its hand-written kernels, so its compile seam is the
kernel build cache (``ops/_build.py``): :func:`JitWatch.on_compile`
books every kernel library built or opened in this process (function
``csrc/<name>``, signature the build target's file name — source,
headers and flags hashed) and every first bind of a C entry point
(``csrc/<name>:<fn>``). A second build or load of the same target in
one process is a **recompile**: the cache should have served it, and a
steady-state process makes none. ``on_compile(fn, signature)`` stays
public for other program caches to book through: the paged engine books
each CUDA graph it captures (``serve.decode``, ``serve.spec_window``;
``serve_engine/programs.py``).

- **disarmed** (default): each seam reads one module global and does
  nothing else;
- **armed** (:func:`enable`, or ``PTYPE_JITWATCH=1`` at import): the
  books are kept per ``(function, signature)``; a recompile bumps the
  ``jit.recompiles`` counter and a per-function ``jit.fn.<name>``
  gauge, which the health sampler turns into the series the
  ``recompile-storm`` rule pages on; a storm (one signature compiled
  ``storm_threshold`` times) dumps through the flight recorder.

Host-synchronisation discipline rides along. The reference's
:func:`hot_region` arms ``jax.transfer_guard`` against implicit
transfers. In eager PyTorch the hazard that guard exists for is a host
synchronisation inside a hot region: an ``.item()``/``int()``/
``bool()``/``.tolist()`` of a device tensor, a data-dependent shape
(``nonzero``, ``masked_select``, boolean indexing, ``unique``,
``repeat_interleave`` without ``output_size``), a device-to-host copy,
or a pageable host-to-device copy (which blocks the host on CUDA).
Armed, a hot region raises at such a call (level ``disallow``, the
default; ``log`` logs it; ``off`` keeps only the compile books), the
message naming the region and the op. :func:`sanctioned_transfer` is
the typed exemption, counted per reason (``jit.sanctioned_transfers``).
The port is stricter than the reference, which lets explicit
transfers through: an explicit ``.cpu()`` blocks the host just as an
implicit read does, so it too must be sanctioned.

Two detectors stand behind the one guard:

- **on CUDA**, the card's own check: while armed the process runs
  ``torch.cuda.set_sync_debug_mode("warn")`` and a warnings hook turns
  each synchronisation warning into a raise or a log — only for the
  thread that is inside a hot region and not inside a sanctioned one
  (the mode is process-global; ``"error"`` would make every other
  thread's legitimate read raise). The hook's filter is ``"always"``,
  so the warnings registry's once-per-location rule cannot swallow a
  repeat. A synchronisation made by a Python backward on autograd's
  device thread reports on that thread and is not attributed to the
  region (the audit's detector sees it).
- **on the CPU**, where nothing synchronises, a recording
  ``TorchDispatchMode`` (:class:`SyncRecorder`) is pushed in each
  armed region and flags the aten ops that would synchronise on the
  card. The region's state lives on the mode object, and autograd
  carries the dispatch-mode stack to the threads that run the
  backward, so a synchronisation in a backward is flagged too.

Stdlib-only at import; torch is touched by :func:`enable` and the armed
guards.
"""

from __future__ import annotations

import contextlib
import linecache
import logging
import os
import threading
import time

__all__ = [
    "enable", "disable", "active", "JitWatch", "hot_region",
    "sanctioned_transfer", "HostSyncError", "SyncRecorder", "recording",
    "sync_op",
    "ENV_VAR", "TRANSFER_ENV_VAR", "STORM_ENV_VAR",
]

ENV_VAR = "PTYPE_JITWATCH"
#: Guard level for hot regions: "disallow" (default — an unsanctioned
#: host synchronisation raises), "log", or "off" (compile books only).
TRANSFER_ENV_VAR = "PTYPE_JITWATCH_TRANSFERS"
STORM_ENV_VAR = "PTYPE_JITWATCH_STORM"
DEFAULT_STORM_THRESHOLD = 3
LEVELS = ("disallow", "log", "off")

#: The warning torch gives, in sync debug mode "warn", for each
#: synchronizing CUDA call.
SYNC_WARNING = "called a synchronizing CUDA operation"

log = logging.getLogger("ptype_tpu_torch.jitwatch")


class HostSyncError(RuntimeError):
    """An unsanctioned host synchronisation inside an armed hot region."""


class JitWatch:
    """Per-process compile books + steady-state marking."""

    def __init__(self, storm_threshold: int | None = None,
                 transfer_level: str | None = None):
        if storm_threshold is None:
            storm_threshold = int(os.environ.get(
                STORM_ENV_VAR, DEFAULT_STORM_THRESHOLD))
        self.storm_threshold = int(storm_threshold)
        self.transfer_level = (transfer_level
                               or os.environ.get(TRANSFER_ENV_VAR,
                                                 "disallow"))
        if self.transfer_level not in LEVELS:
            raise ValueError(f"jitwatch: transfer level must be one of "
                             f"{LEVELS}, got {self.transfer_level!r}")
        self._mu = threading.Lock()
        #: (fn, signature) -> compile count. Distinct signatures are
        #: distinct programs; the SAME signature twice means the cache
        #: was bypassed.
        self._sigs: dict[tuple[str, str], int] = {}
        self._fn_compiles: dict[str, int] = {}
        self._fn_recompiles: dict[str, int] = {}
        self._storms: list[dict] = []
        self._steady_at: float | None = None
        self._steady_since: dict[str, int] = {}
        self._sanctioned: dict[str, int] = {}
        self._hot_regions = 0

    # -------------------------------------------------------- tracking

    def on_compile(self, fn_name: str, signature: str) -> None:
        """Book one build of program ``fn_name`` at ``signature``."""
        storm = None
        internal = fn_name.startswith("_")
        with self._mu:
            key = (fn_name, signature)
            n = self._sigs.get(key, 0) + 1
            self._sigs[key] = n
            self._fn_compiles[fn_name] = \
                self._fn_compiles.get(fn_name, 0) + 1
            if self._steady_at is not None:
                self._steady_since[fn_name] = \
                    self._steady_since.get(fn_name, 0) + 1
            recompile = n > 1 and not internal
            if recompile:
                self._fn_recompiles[fn_name] = \
                    self._fn_recompiles.get(fn_name, 0) + 1
                count = self._fn_recompiles[fn_name]
            if n == self.storm_threshold and not internal:
                storm = {
                    "kind": "recompile-storm", "fn": fn_name,
                    "signature": signature[:256], "compiles": n,
                    "thread": threading.current_thread().name,
                    "t": time.time(),
                }
                self._storms.append(storm)
        self._publish(fn_name, count if recompile else None)
        if storm is not None:
            self._emit(storm)

    @staticmethod
    def _publish(fn_name: str, recompiles: int | None) -> None:
        """The metric families the sampler serializes and the
        recompile-storm rule and ``obs jit`` read."""
        from ptype_tpu_torch.metrics import metrics

        metrics.counter("jit.compiles").add(1)
        if recompiles is not None:
            metrics.counter("jit.recompiles").add(1)
            metrics.gauge(f"jit.fn.{fn_name}").set(float(recompiles))

    @staticmethod
    def _emit(finding: dict) -> None:
        """Flight-recorder seam (the lockcheck pattern): an event on the
        active span plus a rate-limited ring dump naming the function."""
        from ptype_tpu_torch import trace

        trace.add_event("jitwatch.storm",
                        **{k: str(v) for k, v in finding.items()
                           if k not in ("kind", "t")})
        trace.maybe_dump(
            f"recompile-storm: {finding['fn']} compiled "
            f"{finding['compiles']}x with one signature")

    def note_sanctioned(self, reason: str) -> None:
        with self._mu:
            self._sanctioned[reason] = self._sanctioned.get(reason, 0) + 1
        from ptype_tpu_torch.metrics import metrics

        metrics.counter("jit.sanctioned_transfers").add(1)

    def note_hot_region(self) -> None:
        with self._mu:
            self._hot_regions += 1

    def on_sync(self, region: str, op: str) -> None:
        """An unsanctioned host synchronisation in ``region``: raise
        under ``disallow``, log under ``log``."""
        msg = (f"jitwatch[{region}]: host synchronisation {op} inside a "
               f"hot region, outside sanctioned_transfer")
        if self.transfer_level == "disallow":
            raise HostSyncError(msg)
        log.warning(msg)

    # ------------------------------------------------------ steady state

    def mark_steady(self) -> None:
        """Warmup is over: every compile from now on is a steady-state
        discipline violation (``recompiles_since_steady``)."""
        with self._mu:
            self._steady_at = time.time()
            self._steady_since = {}

    def recompiles_since_steady(self) -> dict[str, int]:
        """fn -> compiles (of any signature) since ``mark_steady``: a
        steady-state hot loop builds nothing, new shape or not."""
        with self._mu:
            return dict(self._steady_since)

    # ------------------------------------------------------ inspection

    def compiles(self) -> dict[str, int]:
        with self._mu:
            return dict(self._fn_compiles)

    def recompiles(self) -> dict[str, int]:
        """fn -> same-signature recompile count."""
        with self._mu:
            return dict(self._fn_recompiles)

    def storms(self) -> list[dict]:
        with self._mu:
            return list(self._storms)

    def sanctioned(self) -> dict[str, int]:
        with self._mu:
            return dict(self._sanctioned)

    def report(self) -> dict:
        with self._mu:
            return {
                "compiles": dict(self._fn_compiles),
                "recompiles": dict(self._fn_recompiles),
                "signatures": len(self._sigs),
                "storms": list(self._storms),
                "storm_threshold": self.storm_threshold,
                "steady_since": dict(self._steady_since),
                "steady_marked": self._steady_at is not None,
                "sanctioned_transfers": dict(self._sanctioned),
                "hot_regions": self._hot_regions,
                "transfer_level": self.transfer_level,
            }


# ------------------------------------------------- the CPU detector

#: aten ops whose every call synchronises the host with the card: a
#: scalar read, or an output shape that depends on the data.
_SYNC_OPS = frozenset({
    "aten::_local_scalar_dense", "aten::nonzero", "aten::masked_select",
    "aten::_unique", "aten::_unique2", "aten::unique_dim",
    "aten::unique_consecutive", "aten::unique_dim_consecutive",
    "aten::is_nonzero", "aten::equal",
})


def _device_of(x):
    return getattr(x, "device", None)


def sync_op(func, args, kwargs) -> str | None:
    """The name of ``func`` when this call would synchronise the host on
    CUDA, else None: a scalar read or data-dependent shape
    (:data:`_SYNC_OPS`), ``repeat_interleave`` of a repeats tensor with
    no ``output_size``, indexing with a boolean mask, or a copy that
    crosses devices (except a non-blocking upload from pinned
    memory)."""
    import torch

    name = func._schema.name
    if name in _SYNC_OPS:
        return name
    if name == "aten::repeat_interleave":
        if (len(args) and torch.is_tensor(args[0])
                and kwargs.get("output_size") is None
                and (len(args) < 4 or args[3] is None)
                and func._overloadname != "self_int"):
            return name
        return None
    if name in ("aten::index", "aten::index_put", "aten::index_put_"):
        idx = args[1] if len(args) > 1 else kwargs.get("indices", ())
        if any(t is not None and t.dtype in (torch.bool, torch.uint8)
               for t in idx):
            return f"{name} (boolean mask)"
        return None
    if name == "aten::_to_copy":
        dst = kwargs.get("device")
        src = _device_of(args[0])
        if dst is not None and src is not None and \
                torch.device(dst) != src:
            if (src.type == "cpu" and kwargs.get("non_blocking")
                    and args[0].is_pinned()):
                return None
            return f"{name} {src.type}->{torch.device(dst).type}"
        return None
    if name == "aten::copy_":
        dst, src = _device_of(args[0]), _device_of(args[1])
        if dst is not None and src is not None and dst != src:
            nb = args[2] if len(args) > 2 else kwargs.get("non_blocking")
            if src.type == "cpu" and nb and args[1].is_pinned():
                return None
            return f"{name} {src.type}->{dst.type}"
    return None


class _Frame:
    """One open hot region (or audit) of one thread: its name and how
    deep the thread sits in sanctioned transfers now, and the reasons
    of the sanctioned passes it saw."""

    __slots__ = ("name", "cuda", "sanctioned", "reasons")

    def __init__(self, name: str, cuda: bool = False):
        self.name = name
        #: Whether the card's own check (not the dispatch mode) watches.
        self.cuda = cuda
        self.sanctioned = 0
        self.reasons: list[str] = []


_recorder_cls = None


def SyncRecorder(frame: _Frame, on_op):
    """A ``TorchDispatchMode`` that calls ``on_op(frame, func, args,
    kwargs, out)`` after each aten op it sees (the class is built on
    first use: torch is not imported with this module)."""
    global _recorder_cls
    if _recorder_cls is None:
        from torch.utils._python_dispatch import TorchDispatchMode

        class _SyncRecorder(TorchDispatchMode):
            def __init__(self, frame, on_op):
                super().__init__()
                self.frame = frame
                self.on_op = on_op

            def __torch_dispatch__(self, func, types, args=(),
                                   kwargs=None):
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                self.on_op(self.frame, func, args, kwargs, out)
                return out

        _recorder_cls = _SyncRecorder
    return _recorder_cls(frame, on_op)


def _guard_op(watch: JitWatch):
    def on_op(frame, func, args, kwargs, out):
        if frame.sanctioned:
            return
        op = sync_op(func, args, kwargs)
        if op is not None:
            watch.on_sync(frame.name, op)
    return on_op


# ------------------------------------------------ the CUDA detector

_tls = threading.local()


def _frames() -> list:
    fr = getattr(_tls, "frames", None)
    if fr is None:
        fr = _tls.frames = []
    return fr


class _SyncHook:
    """The armed process's ``warnings.showwarning``: a CUDA
    synchronisation warning from a thread inside an unsanctioned hot
    region goes to :meth:`JitWatch.on_sync`; one from anywhere else is
    dropped (the process-global mode reports every thread's);
    everything else goes to the hook it replaced."""

    def __init__(self, watch: JitWatch, prior):
        self.watch = watch
        self.prior = prior

    def __call__(self, message, category, filename, lineno, file=None,
                 line=None):
        if SYNC_WARNING not in str(message):
            return self.prior(message, category, filename, lineno, file,
                              line)
        frames = getattr(_tls, "frames", None)
        if not frames or frames[-1].sanctioned or not frames[-1].cuda:
            return None
        src = (line or linecache.getline(filename, lineno)).strip()
        self.watch.on_sync(frames[-1].name,
                           f"at {os.path.basename(filename)}:{lineno} "
                           f"({src})")
        return None


# ------------------------------------------------------------ module API

_watch: JitWatch | None = None
#: > 0 while the watchdog is armed or a recording runs: the one global
#: the :func:`sanctioned_transfer` seam reads (updated under ``_live_mu``:
#: recordings open on several threads).
_live = 0
_live_mu = threading.Lock()
#: What :func:`enable` changed and :func:`disable` restores: the prior
#: sync debug mode, ``warnings.showwarning``, and the filter added.
_saved: dict = {}


def enable(storm_threshold: int | None = None,
           transfer_level: str | None = None) -> JitWatch:
    """Arm the watchdog process-wide. Re-enabling replaces the books.
    On a machine with CUDA this sets the sync debug mode to ``"warn"``
    and installs the warnings hook. Returns the fresh watchdog."""
    global _watch, _live
    import warnings

    import torch

    disable()
    w = JitWatch(storm_threshold, transfer_level)
    if torch.cuda.is_available():
        _saved["mode"] = torch.cuda.get_sync_debug_mode()
        _saved["show"] = warnings.showwarning
        warnings.filterwarnings("always", message=f".*{SYNC_WARNING}")
        _saved["filter"] = warnings.filters[0]
        warnings.showwarning = _SyncHook(w, warnings.showwarning)
        torch.cuda.set_sync_debug_mode("warn")
    _watch = w
    with _live_mu:
        _live += 1
    return w


def disable() -> None:
    """Disarm: restore the sync debug mode, the warnings hook and the
    filter that :func:`enable` changed."""
    global _watch, _live
    import warnings

    if _watch is None:
        return
    if "mode" in _saved:
        import torch

        torch.cuda.set_sync_debug_mode(_saved.pop("mode"))
        if isinstance(warnings.showwarning, _SyncHook):
            warnings.showwarning = _saved["show"]
        _saved.pop("show")
        filt = _saved.pop("filter")
        if filt in warnings.filters:
            warnings.filters.remove(filt)
            warnings._filters_mutated()
    _watch = None
    with _live_mu:
        _live -= 1


def active() -> JitWatch | None:
    return _watch


@contextlib.contextmanager
def hot_region(name: str, device=None):
    """Host-synchronisation guard around a hot dispatch region. Disarmed:
    free. Armed at level ``disallow`` (``log``), an unsanctioned host
    synchronisation inside raises :class:`HostSyncError` (logs), naming
    ``name`` and the op. ``device``: the device the region dispatches
    to; CPU work (or None on a machine without CUDA) gets the dispatch
    detector, CUDA work the card's own."""
    w = _watch
    if w is None or w.transfer_level == "off":
        yield
        return
    w.note_hot_region()
    dev = getattr(device, "type", device)
    if (dev == "cuda") if dev is not None else "mode" in _saved:
        frame = _Frame(name, cuda=True)
        frames = _frames()
        frames.append(frame)
        try:
            yield
        finally:
            frames.pop()
    else:
        with recording(name, _guard_op(w)):
            yield


@contextlib.contextmanager
def recording(name: str, on_op):
    """Run the body under a :class:`SyncRecorder` calling ``on_op(frame,
    func, args, kwargs, out)`` for each aten op, with a frame named
    ``name`` open in this thread (so :func:`sanctioned_transfer` marks
    it; ``frame.sanctioned`` is nonzero inside one): the CPU detector of
    :func:`hot_region`, and the recorder ``progaudit.audit`` runs a
    program under. Yields the frame."""
    global _live
    frame = _Frame(name)
    frames = _frames()
    frames.append(frame)
    with _live_mu:
        _live += 1
    try:
        with SyncRecorder(frame, on_op):
            yield frame
    finally:
        with _live_mu:
            _live -= 1
        frames.pop()


@contextlib.contextmanager
def sanctioned_transfer(reason: str):
    """The typed exemption seam: a region where a host synchronisation
    IS the contract (the train data leg, the engine's one read a step).
    Counted per pass (``jit.sanctioned_transfers`` + per-reason books)
    so the exemptions stay auditable; every hot region and audit open
    in this thread sees the pass."""
    if not _live:
        yield
        return
    w = _watch
    if w is not None:
        w.note_sanctioned(reason)
    frames = list(_frames())
    for f in frames:
        f.sanctioned += 1
        f.reasons.append(reason)
    try:
        yield
    finally:
        for f in frames:
            f.sanctioned -= 1


def _maybe_enable_from_env() -> None:
    if os.environ.get(ENV_VAR, "").lower() in ("1", "true", "on"):
        enable()


_maybe_enable_from_env()
