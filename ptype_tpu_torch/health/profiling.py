"""Profiling plane: on-demand device profiling + counted-cost MFU — the
port's copy of ``ptype_tpu/health/profiling.py``, on ``torch.profiler``.

Four seams, as in the reference:

- **Capture sessions** (:func:`start` / :func:`stop` /
  :func:`capture`): a managed ``torch.profiler.profile`` into an
  artifact directory (``$PTYPE_PROFILE_DIR`` or a tempdir), returning a
  file manifest — and, on request, the artifact BYTES, so a capture can
  ship over the actor wire. :func:`stop` writes the session's Chrome
  trace gzipped as ``<host>_<pid>.pt.trace.json.gz``, which
  :func:`summarize` reads as the reference's reads its profiler's
  ``*.trace.json.gz``; a capture longer than :data:`CHUNK_S` writes
  one such file a recording (``<host>_<pid>.<i>.pt.trace.json.gz``).
  Activities: the CPU, plus CUDA when the process computes on a card
  (it has initialised CUDA). There is no quiet fallback: a CUDA process whose profiler
  cannot trace CUDA raises :class:`ProfileError` at :func:`start`, and
  a capture with a trace that holds no kernel record (each recording
  launches a marker fill kernel at each end and one half-way to prove
  it) raises at :func:`stop`. CUPTI is torn down after each trace
  (:data:`CUPTI_TEARDOWN_ENV`).
  One session per process: a second :func:`start` raises
  :class:`ProfileError`. Device-memory snapshots
  (:func:`memory_snapshot` — the caching allocator's counters under
  the reference's key names, plus ``torch.cuda.memory._snapshot()``)
  ride along with every capture.
- **The ``ptype.Profile`` actor endpoint** (:func:`endpoint`): every
  :class:`~ptype_tpu_torch.actor.ActorServer` serves it built-in
  (sibling of ``ptype.Telemetry``), so any node's device timeline is
  one RPC away — :func:`ptype_tpu_torch.telemetry.cluster_profile` fans
  a simultaneous capture across the whole registry.
- **Alert-triggered capture** (:class:`AlertCapture`): an
  :class:`~ptype_tpu_torch.health.rules.AlertEngine` hook that captures
  a short profile on the node an alert NAMES, rate-limited per (rule,
  node).
- **Counted-cost accounting** (:func:`compiled_cost` /
  :func:`transformer_grads_cost` / :func:`measure_compiled_cost`): XLA's
  ``cost_analysis`` has no PyTorch counterpart, so the port counts the
  ops one call runs — FLOPs with ``torch.utils.flop_counter.
  FlopCounterMode``, bytes with a dispatch mode that sums each op's
  tensor bytes in and out — and feeds the goodput ledger an
  ``mfu_compiled`` beside the analytic MFU.

**Threads.** Kineto's session must start and stop on one thread (a
stop on another thread crashes the process), while ``start`` and
``stop`` arrive on different RPC handler threads. So a session runs on
a thread of its own (``profile-session``): :func:`start` hands it the
profiler and waits until it records, :func:`stop` signals it and joins.
CUDA activity (CUPTI) is process-wide, so the device timeline holds
every thread's kernels. CPU-side ops are recorded per thread: with
``profile_all_threads`` (``torch._C._profiler._ExperimentalConfig``,
where this torch has it) the trace holds every thread's ops; without
it, only the session thread's. The manifest says which
(``cpu_threads``: ``"all"`` or ``"session"``).

**Leases.** A session's stop holds the GIL for seconds when the session
recorded a busy process: Kineto's ``_disable_profiler()`` (it switches
CUPTI off and collects the records in one C++ call) and the Chrome trace
export, and no keepalive runs meanwhile; its start can hold it for up
to a second under load, and a loaded process's keepalive was starved
past a second of lease after a stop. On a lease of a second or two the
process's registrations would lapse and its node drop out of the
registry. So a capture holds them on leases of :data:`STOP_LEASE_S`
from its start until its stop returns (``registry.hold_leases``; the
keepalive goes on refreshing them): a node being profiled stays listed,
and a process that dies during a capture stays listed for up to that
long. The
hold grows with what the session recorded, so a session records at most
:data:`CHUNK_S` seconds: a longer capture is consecutive recordings,
each its own trace file. On a loaded optimus-125m replica under one to
eight loaders no hold outgrew half the lease (the comment of
:data:`STOP_LEASE_S`); a heavier process is not measured.
The stop counts the trace's device records on the bytes it gzips, where
a parse of the whole trace would hold the GIL again.

**Quiet switches.** CUPTI switches its kernel recording on at a
session's start and off at its stop. Switched while another thread
launches kernels (a serving replica under load), it could stop
recording kernels altogether: the session — and, as a rule, every later
one in the process — came back with a handful of kernel records where
tens of thousands ran, its CPU ops and copies all there (seen after the
1st to the 14th session under load; never in 40 sessions switched with
nothing in flight). So a session's start and stop pass through
``device.DEVICE_GATE``: they wait for every entry point inside
``device.device_work`` to leave, drain the card, and switch with no
launch in flight; device work waits the while, the stop's record
processing included.

Only this module imports torch, and only inside the functions that use
it: ``import ptype_tpu_torch.health`` stays torch-free.
"""

from __future__ import annotations

import collections
import gc
import gzip
import json
import os
import re
import socket
import threading
import time

from ptype_tpu_torch import logs
from ptype_tpu_torch.device import DEVICE_GATE

log = logs.get_logger("profiling")

#: Env var: base directory for capture artifacts (default: a
#: process-qualified tempdir subdirectory).
PROFILE_DIR_ENV = "PTYPE_PROFILE_DIR"
#: Default on-demand capture length.
DEFAULT_CAPTURE_S = 0.5
#: Hard cap on a single capture's duration — a fat-fingered
#: ``duration=300`` from an operator (or a buggy alert hook) must not
#: pin the process's profiler for minutes.
MAX_CAPTURE_S = 30.0
#: Byte budget for shipping artifact data over the wire in one reply.
MAX_SHIP_BYTES = 32 * 2**20
#: Minimum seconds between alert-triggered captures per (rule, node) —
#: the ``trace.maybe_dump`` contract, applied to device profiles.
CAPTURE_MIN_INTERVAL_S = 60.0
#: Chrome-trace categories of device-side records (CUPTI activity).
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
#: A record as Kineto's Chrome trace spells it: ``"ph": "X"``, its
#: ``"cat"`` and the head of its ``"name"``, on one line or several (by
#: Kineto's version).
_RECORD = re.compile(
    rb'"ph":\s*"X",\s*"cat":\s*"(\w+)"(?:,\s*"name":\s*"([^"]{0,120}))?')
#: Bytes of the trace read, gzipped and scanned at a time, and the tail
#: of one chunk kept for the next scan (longer than any record's match,
#: so a record that the boundary splits is counted once, whole).
_CHUNK = 1 << 20
_CARRY = 256
#: gzip level of the shipped trace: zlib's default. gzip's own 9 took 3.4
#: times as long (2.52 s against 0.75 s) for a file 5.7% smaller, on the
#: 62 MB trace of a 1 s window of a loaded optimus-125m replica on an
#: H100 at 700 W (``chip_smoke.py`` failover (d), ``gzip_levels``).
TRACE_GZIP_LEVEL = 6
#: The measured worst of a process's first session start (CUPTI's
#: start-up, 8.62-13.89 s in four runs), and of one recording's stop,
#: which may wait for the last recording's gzip first: 16.83 s, the sum
#: of each part's largest, 3.08 (that gzip) + 0.28 (the gate's wait) +
#: 8.69 (Kineto's disable) + 1.70 (the export) + 3.08 (the gzip), on a
#: loaded optimus-125m replica under one to eight loaders: an H100 80GB
#: HBM3 at 700 W (``chip_smoke.py --profile-sweep`` and ``failover``
#: (d)).
FIRST_START_S = 13.89
RECORDING_STOP_S = 16.83
#: Seconds a session thread may take to start or to stop: 3.6 times the
#: longer of the two above. A start or a stop that gives up leaves
#: :func:`start` refusing until the thread has ended.
SESSION_TIMEOUT_S = 60.0
#: Longest stretch (s) that one ``torch.profiler`` session records. A
#: stop's GIL hold grows with what its session recorded: Kineto's
#: disable plus the export held a loaded optimus-125m replica 1.26-1.93
#: s after 0.25 s and up to 10.09 s after 1 s, and one 10 s and one 30 s
#: recording held it so long that its registration, on a 20 s lease,
#: went unlisted for 26.3 s and 112.2 s (two loaders; H100 80GB HBM3 at
#: 700 W, ``chip_smoke.py --profile-sweep``).
#: So a longer capture records consecutive sessions of at most this
#: many seconds; the stop of each, between them, goes unrecorded.
CHUNK_S = 1.0
#: Seconds of lease the process's registrations hold through a capture,
#: from its start until its stop returns (``registry.hold_leases``): a
#: keepalive that no beat reaches for this long lets them lapse. Kineto's
#: ``_disable_profiler()`` holds the GIL, so no keepalive runs, while it
#: collects the records, and the export holds it again right after:
#: after a recording of about :data:`CHUNK_S` the longest pair measured
#: was 10.09 s (8.69 + 1.40), a loaded optimus-125m replica under four
#: loaders of the one to eight measured (H100 80GB HBM3 at 700 W,
#: ``chip_smoke.py --profile-sweep``), and 25 s is 2.48 times that. The
#: hold followed the host more than the load: recordings of 31,000 to
#: 33,000 kernels took 0.98-8.69 s to disable. A process that dies
#: during a capture stays listed for up to this long.
STOP_LEASE_S = 25.0
#: Kineto's switch (read at each trace): "1" tears CUPTI down after each
#: trace, and the next session sets it up anew. Without it, a process
#: that had run other sessions recorded idle sessions whose kernel
#: records Kineto dropped as outside the session's window, their device
#: times having drifted from the host's (its log's "Out-of-range = 3",
#: every marker): 7 of 7 idle captures in each of two runs of the card
#: tests' process on an H100 80GB HBM3 at 700 W; with it, 0 of 10.
#: A CUDA capture sets it where the environment has not.
CUPTI_TEARDOWN_ENV = "TEARDOWN_CUPTI"
#: Kineto tears CUPTI down on a thread of its own: at the first CUDA
#: runtime call after a trace it finalizes CUPTI, then re-arms its own
#: callbacks. A session started before that thread is done recorded no
#: launch and no kernel (1 recording in 27 of an idle chunked capture,
#: on the H100 above). So with the teardown on, a CUDA session's start
#: first makes this many runtime calls, :data:`TEARDOWN_SETTLE_S` apart.
TEARDOWN_SETTLE_CALLS = 5
TEARDOWN_SETTLE_S = 0.01


def reply_timeout_s(duration_s: float) -> float:
    """Seconds a remote capture of ``duration_s`` may take to answer:
    its window (capped at :data:`MAX_CAPTURE_S`) plus twice the measured
    worst of a first start and of one recording's stop. A capture
    longer than :data:`CHUNK_S` stops only its last recording after its
    window, so no window adds stop cost past one recording's."""
    return (min(max(float(duration_s), 0.0), MAX_CAPTURE_S)
            + 2.0 * (FIRST_START_S + RECORDING_STOP_S))


class ProfileError(RuntimeError):
    """Typed misuse of the process's profiler (double start, stop
    without start, capture path escape) or a capture that could not
    trace what this process runs on."""


# -------------------------------------------------------- capture session

_lock = threading.Lock()
#: The active session: {"dir", "label", "t0", "thread", ...} — one
#: profiler per process, so there is at most one.
_active: dict | None = None
#: The thread of the last session: a stop that gave up leaves it
#: running, and no session starts until it ends.
_thread: threading.Thread | None = None


def base_dir() -> str:
    """Artifact root: ``$PTYPE_PROFILE_DIR`` or a tempdir subdir."""
    d = os.environ.get(PROFILE_DIR_ENV)
    if d:
        return d
    import tempfile

    return os.path.join(tempfile.gettempdir(),
                        f"ptype-profile-{os.getpid()}")


def active() -> bool:
    with _lock:
        return _active is not None


def _on_cuda(torch) -> bool:
    """Whether this process computes on a card: it has initialised CUDA.
    A process that never touched one (a control plane beside a card)
    is profiled, and reported, as a CPU process — and no verb here
    makes it create a CUDA context."""
    return torch.cuda.is_available() and torch.cuda.is_initialized()


def _profiler_kwargs(torch) -> tuple[dict, bool, str]:
    """(``torch.profiler.profile`` kwargs, traces CUDA, cpu_threads).
    Raises :class:`ProfileError` for a CUDA process whose profiler
    cannot trace CUDA activity — never a CPU-only capture instead."""
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    cuda = _on_cuda(torch)
    if cuda:
        if ProfilerActivity.CUDA not in torch.profiler.supported_activities():
            raise ProfileError(
                "this process runs on CUDA but torch.profiler cannot trace "
                "CUDA activity here (no CUPTI); refusing a CPU-only capture")
        acts.append(ProfilerActivity.CUDA)
    kw = {"activities": acts}
    threads = "session"
    try:
        kw["experimental_config"] = torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
        threads = "all"
    except (AttributeError, TypeError):
        pass  # an older torch: the session thread's CPU ops only
    return kw, cuda, threads


def _marker(torch) -> None:
    """One tiny fill kernel on the current card: proof, in the trace,
    that device activity was captured."""
    torch.empty(1, device="cuda").fill_(0.0)


def count_records(read) -> collections.Counter:
    """The records (``"ph": "X"``) of a Chrome trace whose bytes
    ``read(n)`` returns in turn, counted on the bytes as they pass: no
    parse of the whole trace. Keys: each category, and ``launch``: the
    CUDA runtime and driver calls that launch a kernel
    (``cudaLaunchKernel``, ``cuLaunchKernelEx``, ...)."""
    n, buf = collections.Counter(), b""
    while True:
        chunk = read(_CHUNK)
        buf += chunk
        # A match that starts in the kept tail is counted next time,
        # whole; at the end every match is.
        limit = max(0, len(buf) - _CARRY) if chunk else len(buf)
        for m in _RECORD.finditer(buf):
            if m.start() >= limit:
                break
            cat, name = m.group(1), m.group(2) or b""
            n[cat.decode()] += 1
            if (cat in (b"cuda_runtime", b"cuda_driver") and name.startswith(
                    (b"cudaLaunchKernel", b"cuLaunchKernel"))):
                n["launch"] += 1
        if not chunk:
            return n
        buf = buf[limit:]


def _gzip_counting(raw: str, dst: str, counts=None) -> int:
    """Gzip the Chrome trace ``raw`` into ``dst`` and return its
    device-side records (:func:`count_records` on the bytes as they
    pass, into ``counts`` where given): no parse of the whole trace,
    which would hold the GIL for seconds (zlib lets it go while it
    compresses)."""
    counts = collections.Counter() if counts is None else counts
    with open(raw, "rb") as src, gzip.open(
            dst, "wb", compresslevel=TRACE_GZIP_LEVEL) as out:
        def read(size):
            chunk = src.read(size)
            out.write(chunk)
            return chunk

        counts.update(count_records(read))
    return sum(counts[c] for c in DEVICE_CATEGORIES)


def _runtime_call(torch) -> None:
    """One CUDA runtime call that waits for nothing (a stream query)."""
    torch.cuda.current_stream().query()


def _switch_on(torch, sess: dict):
    """A new ``torch.profiler`` session, started through the device
    gate (once the last trace's CUPTI teardown has had its runtime calls
    and its time: :data:`TEARDOWN_SETTLE_CALLS`). Returns it and its
    recording's record: ``on_at``, when it began to record, and
    ``held_s``, the seconds of its start's parts: the wait for the gate
    (``start_wait``) and the switch inside it (``start_switch``)."""
    prof = torch.profiler.profile(**sess["kwargs"])
    if sess["cuda"] and os.environ.get(CUPTI_TEARDOWN_ENV) == "1":
        for _ in range(TEARDOWN_SETTLE_CALLS):
            _runtime_call(torch)
            time.sleep(TEARDOWN_SETTLE_S)
    t0 = time.perf_counter()
    with DEVICE_GATE.switch():
        t1 = time.perf_counter()
        if sess["cuda"]:
            torch.cuda.synchronize()
        prof.start()
        on_at = time.perf_counter()
        if sess["cuda"]:
            _marker(torch)
    return prof, {"on_at": on_at, "held_s": {
        "start_wait": t1 - t0, "start_switch": time.perf_counter() - t1}}


def _record(torch, sess: dict, rec: dict, end: float) -> None:
    """Record until the stop or until ``end``; on a card, launch one
    more marker half-way. A session can lose the kernel records of its
    first milliseconds, and at times of its last, though their launches
    are traced: Kineto drops a kernel record whose device time falls
    outside the session's window (its log's "Out-of-range" count), the
    edge markers' among them (the manifest's ``kernels_lost``)."""
    if sess["cuda"]:
        half = (rec["on_at"] + end) / 2 - time.perf_counter()
        if sess["stop"].wait(max(0.0, half)):
            return
        with DEVICE_GATE.work():
            _marker(torch)
    sess["stop"].wait(max(0.0, end - time.perf_counter()))


def _switch_off(torch, sess: dict, prof, rec: dict, raw: str) -> None:
    """Stop ``prof`` through the device gate and export its Chrome trace
    to ``raw``. ``rec`` gets ``recorded_s``, the seconds it recorded,
    and in ``held_s`` the seconds of each part: the wait for the gate
    (``stop_wait``), the marker and the card's drain (``stop_sync``),
    the switch (``stop_switch``) and, inside it, Kineto's
    ``_disable_profiler()`` (``stop_disable``), and the export. The
    disable and the export hold the GIL."""
    t0 = time.perf_counter()
    with DEVICE_GATE.switch():
        t1 = time.perf_counter()
        if sess["cuda"]:
            _marker(torch)
            torch.cuda.synchronize()
        t2 = time.perf_counter()
        prof.stop()
    t3 = time.perf_counter()
    prof.export_chrome_trace(raw)
    t4 = time.perf_counter()
    stats = getattr(prof.profiler, "_stats", None)
    disable_us = getattr(stats, "profiler_disable_call_duration_us", None)
    rec["recorded_s"] = t2 - rec["on_at"]
    rec["held_s"].update(
        stop_wait=t1 - t0, stop_sync=t2 - t1, stop_switch=t3 - t1,
        stop_disable=None if disable_us is None else disable_us / 1e6,
        export=t4 - t3)


def _gzip(raw: str, rec: dict) -> None:
    """Gzip the trace ``raw`` beside it and delete it. ``rec`` gets the
    trace's device records (``device_events``), its kernel launches
    (``launches``) and kernel records (``kernels``), the launches that
    left no kernel record (``kernels_lost``) and the seconds
    (``held_s["gzip"]``)."""
    t0 = time.perf_counter()
    counts = collections.Counter()
    rec["device_events"] = _gzip_counting(raw, raw + ".gz", counts)
    rec["launches"], rec["kernels"] = counts["launch"], counts["kernel"]
    rec["kernels_lost"] = max(0, counts["launch"] - counts["kernel"])
    os.remove(raw)
    rec["held_s"]["gzip"] = time.perf_counter() - t0


def _session(sess: dict) -> None:
    """The body of a session's own thread. It records in consecutive
    ``torch.profiler`` sessions of at most :data:`CHUNK_S` seconds
    each, every one started and stopped through the device gate and
    written to a trace file of its own, so that no stop's GIL hold grows
    with the window. The next recording starts before the last one's
    trace is gzipped (zlib lets the GIL go), so the gzip leaves no gap.
    A capture of a known length (``sess["window_s"]``) starts no
    recording past its end. Each recording appends its record
    (:func:`_switch_on`, :func:`_switch_off`, :func:`_gzip`) to
    ``sess["chunks"]``."""
    import torch

    try:
        _record_session(torch, sess)
    finally:
        _let_go(sess)


def _record_session(torch, sess: dict) -> None:
    """:func:`_session`'s recordings; a failure goes to ``sess["error"]``
    (before ``ready``, for :func:`start`; after it, for :func:`stop`)."""
    host = f"{socket.gethostname()}_{os.getpid()}"
    try:
        prof, rec = _switch_on(torch, sess)
    except Exception as e:  # noqa: BLE001 — handed to start()
        sess["error"] = e
        sess["ready"].set()
        return
    sess["first_on"] = rec["on_at"]
    until = (None if sess["window_s"] is None
             else rec["on_at"] + sess["window_s"])
    sess["ready"].set()

    def over() -> bool:
        return sess["stop"].is_set() or (
            until is not None and time.perf_counter() >= until)

    try:
        while True:
            end = rec["on_at"] + CHUNK_S
            _record(torch, sess, rec, end if until is None
                    else min(end, until))
            i = len(sess["chunks"])
            # One recording keeps the file name of an unchunked capture.
            name = (f"{host}.pt.trace.json" if i == 0 and over()
                    else f"{host}.{i:03d}.pt.trace.json")
            raw = os.path.join(sess["dir"], name)
            _switch_off(torch, sess, prof, rec, raw)
            sess["chunks"].append(rec)
            done = over()
            if not done:
                prof, nxt = _switch_on(torch, sess)
            try:
                _gzip(raw, rec)
            except Exception:
                if not done:  # no recording left running
                    with DEVICE_GATE.switch():
                        prof.stop()
                raise
            if done:
                break
            rec = nxt
    except Exception as e:  # noqa: BLE001 — handed to stop()
        sess["error"] = e


def _let_go(sess: dict) -> None:
    """One of a capture's two holders of the process's long leases (its
    session thread, and the :func:`start` or :func:`stop` that waits on
    it) is done; the last one runs a garbage collection, then puts the
    registrations back on leases of their own TTL. What a loaded
    recording leaves is freed only by the collector, and a collection
    that met it after a capture held a replica's GIL 0.60-1.23 s, past
    its 1 s lease."""
    with sess["hold_lock"]:
        sess["holders"] -= 1
        last = not sess["holders"]
    if last:
        gc.collect()
        sess["release"]()


def _held(chunks: list[dict]) -> dict:
    """A session's ``held_s``: its one recording's parts, or, over
    several, each part's largest value and ``chunks``, the parts of
    every recording in turn."""
    parts = [c["held_s"] for c in chunks]
    if len(parts) == 1:
        return dict(parts[0])
    out = {k: max((p[k] for p in parts if p.get(k) is not None),
                  default=None) for k in parts[0]}
    out["chunks"] = [dict(p) for p in parts]
    return out


def start(label: str = "", base: str | None = None, *,
          window_s: float | None = None) -> dict:
    """Begin a capture into a fresh artifact directory. ``window_s``,
    where the capture's length is known (:func:`capture`), ends its
    last recording at that many seconds after it started recording.

    Returns ``{"dir", "label", "ts"}``. Raises :class:`ProfileError`
    if a capture is already running (one profiler per process), while
    the last capture's session thread still runs (its :func:`stop` is
    under way, or a start or a stop gave up), or if this process runs
    on CUDA and the profiler cannot trace it. A start that gives up
    after :data:`SESSION_TIMEOUT_S` tells the thread to stop as soon as
    it records. The process's registrations are on leases of
    :data:`STOP_LEASE_S` from here until the capture's :func:`stop`
    returns, or its session thread ends if later.
    """
    global _active, _thread
    import torch

    from ptype_tpu_torch import registry

    if DEVICE_GATE.held():
        raise ProfileError("profile start inside device_work(): the "
                           "switch would wait for this thread")
    d = os.path.join(base or base_dir(),
                     f"{label or 'capture'}-{time.monotonic_ns()}")
    with _lock:
        if _active is not None:
            raise ProfileError(
                f"profile capture already active in {_active['dir']!r}")
        if _thread is not None and _thread.is_alive():
            raise ProfileError(
                "the last capture's session thread still runs (a stop "
                "under way, or a start or a stop that gave up): no second "
                "profiler session until it ends")
        kwargs, cuda, threads = _profiler_kwargs(torch)
        if cuda:
            os.environ.setdefault(CUPTI_TEARDOWN_ENV, "1")
        os.makedirs(d, exist_ok=True)
        sess = {"dir": d, "label": label, "t0": time.perf_counter(),
                "kwargs": kwargs, "cuda": cuda, "cpu_threads": threads,
                "window_s": window_s,
                "ready": threading.Event(), "stop": threading.Event(),
                "error": None, "chunks": [],
                "release": registry.hold_leases(STOP_LEASE_S),
                "hold_lock": threading.Lock(), "holders": 2}
        _thread = sess["thread"] = threading.Thread(
            target=_session, args=(sess,), name="profile-session",
            daemon=True)
        sess["thread"].start()
        if not sess["ready"].wait(SESSION_TIMEOUT_S):
            # The thread stops once its start ends: no recording runs
            # on that nothing could stop, and start() refuses till then.
            sess["stop"].set()
            _let_go(sess)
            raise ProfileError("profiler did not start within "
                               f"{SESSION_TIMEOUT_S:.0f} s")
        if sess["error"] is not None:
            sess["thread"].join()
            _let_go(sess)
            raise ProfileError(
                f"profiler failed to start: {sess['error']!r}")
        _active = sess
    log.info("profile capture started", kv={"dir": d, "label": label})
    return {"dir": d, "label": label, "ts": round(time.time(), 3)}


def stop(include_data: bool = False,
         max_bytes: int = MAX_SHIP_BYTES) -> dict:
    """End the active capture. Returns the artifact manifest::

        {"dir", "label", "duration_s", "files": [{"path", "size"}],
         "activities", "cpu_threads", "device_events", "chunks",
         "recorded_s", "unrecorded_s", "kernels_lost", "held_s",
         "memory": <memory_snapshot()>, "data": {relpath: bytes}?}

    A capture longer than :data:`CHUNK_S` is recorded in ``chunks``
    consecutive sessions, each its own trace file; ``recorded_s`` sums
    the seconds they recorded, ``unrecorded_s`` is the rest of the
    window (between them, and after the last), and ``device_events``
    sums their device records. ``kernels_lost`` is, for each trace, its
    kernel launches less its kernel records: the card is drained before
    a recording starts and before it stops, so each launch it records
    ran inside it. ``held_s`` is the seconds of each part of the
    session's start and stop (``_switch_on``, ``_switch_off``,
    ``_gzip``), over several sessions each part's largest and every
    session's under ``chunks``: what a profile cost the process it
    profiled.

    ``data`` (with ``include_data``) carries artifact bytes up to
    ``max_bytes`` total — the wire-shipping path; oversize files are
    listed in the manifest but skipped from ``data`` (``truncated``
    names them). Raises :class:`ProfileError` without an active
    capture, and when a trace of a CUDA session holds no kernel record.
    If the session's thread has not ended after
    :data:`SESSION_TIMEOUT_S`, raises, and :func:`start` refuses until
    it ends.
    """
    global _active

    if DEVICE_GATE.held():
        raise ProfileError("profile stop inside device_work(): the "
                           "switch would wait for this thread")
    with _lock:
        if _active is None:
            raise ProfileError("no profile capture active")
        sess, _active = _active, None
    try:
        return _stop_session(sess, include_data, max_bytes)
    finally:
        _let_go(sess)


def _stop_session(sess: dict, include_data: bool, max_bytes: int) -> dict:
    """:func:`stop` of the capture ``sess``."""
    t_stop = time.perf_counter()
    sess["stop"].set()
    sess["thread"].join(SESSION_TIMEOUT_S)
    dur = time.perf_counter() - sess["t0"]
    if sess["thread"].is_alive():
        raise ProfileError("profiler did not stop within "
                           f"{SESSION_TIMEOUT_S:.0f} s")
    if sess["error"] is not None:
        raise ProfileError(f"profiler failed to stop: {sess['error']!r}")
    chunks = sess["chunks"]
    recorded = sum(c["recorded_s"] for c in chunks)
    end = (t_stop if sess["window_s"] is None
           else min(t_stop, sess["first_on"] + sess["window_s"]))
    if sess["cuda"] and not all(c["kernels"] for c in chunks):
        raise ProfileError(
            "a trace of the capture holds no CUDA kernel (not even its "
            "own markers): device activity was not traced "
            f"({[c['kernels'] for c in chunks]} kernel records of "
            f"{[c['launches'] for c in chunks]} launches)")
    out = {"dir": sess["dir"], "label": sess["label"],
           "duration_s": round(dur, 4),
           "files": artifact_files(sess["dir"]),
           "activities": ["cpu", "cuda"] if sess["cuda"] else ["cpu"],
           "cpu_threads": sess["cpu_threads"],
           "device_events": sum(c["device_events"] for c in chunks),
           "chunks": len(chunks),
           "recorded_s": round(recorded, 4),
           "unrecorded_s": round(max(0.0, end - sess["first_on"]
                                     - recorded), 4),
           "kernels_lost": [c["kernels_lost"] for c in chunks],
           "held_s": _held(chunks),
           "memory": memory_snapshot()}
    if include_data:
        data: dict[str, bytes] = {}
        truncated: list[str] = []
        budget = int(max_bytes)
        for f in out["files"]:
            if f["size"] > budget:
                truncated.append(f["path"])
                continue
            try:
                with open(os.path.join(sess["dir"], f["path"]),
                          "rb") as fp:
                    data[f["path"]] = fp.read()
            except OSError:
                truncated.append(f["path"])
                continue
            budget -= f["size"]
        out["data"] = data
        if truncated:
            out["truncated"] = truncated
    log.info("profile capture stopped",
             kv={"dir": sess["dir"], "files": len(out["files"]),
                 "chunks": out["chunks"], "duration_s": out["duration_s"]})
    return out


def capture(duration_s: float = DEFAULT_CAPTURE_S, label: str = "",
            include_data: bool = False,
            max_bytes: int = MAX_SHIP_BYTES,
            base: str | None = None) -> dict:
    """One-shot: start, run for ``duration_s`` (capped at
    :data:`MAX_CAPTURE_S`), stop. The remote-capture verb behind the
    ``ptype.Profile`` endpoint and every alert-triggered capture."""
    duration_s = min(max(float(duration_s), 0.0), MAX_CAPTURE_S)
    start(label=label, base=base, window_s=duration_s)
    try:
        threading.Event().wait(duration_s)
    finally:
        result = stop(include_data=include_data, max_bytes=max_bytes)
    return result


def artifact_files(d: str) -> list[dict]:
    """Relative-path manifest of every file under ``d`` (sorted)."""
    out: list[dict] = []
    for dirpath, dirnames, filenames in os.walk(d):
        dirnames.sort()
        for f in sorted(filenames):
            p = os.path.join(dirpath, f)
            out.append({"path": os.path.relpath(p, d),
                        "size": os.path.getsize(p)})
    return out


def fetch(dir_path: str, relpath: str) -> bytes:
    """One artifact file's bytes — the follow-up verb for files the
    capture reply truncated. The resolved path must stay under
    ``dir_path`` (no traversal from the wire)."""
    root = os.path.realpath(dir_path)
    p = os.path.realpath(os.path.join(root, relpath))
    if not p.startswith(root + os.sep):
        raise ProfileError(f"artifact path escapes capture dir: "
                           f"{relpath!r}")
    with open(p, "rb") as fp:
        return fp.read()


def _host_watermarks() -> dict:
    """The metrics module's device watermarks plus the process's peak
    RSS (``ru_maxrss``, KiB on Linux) — the host row every snapshot
    carries, CPU processes included."""
    from ptype_tpu_torch import metrics as metrics_mod

    out = dict(metrics_mod.memory_watermarks())
    try:
        import resource

        out["rss_bytes"] = int(
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss) * 1024
    except (ImportError, OSError):
        pass
    return out


def memory_snapshot(include_profile: bool = False) -> dict:
    """Per-device memory snapshot + host watermarks.

    ``devices``: one row per local CUDA device with the caching
    allocator's counters under the reference's key names —
    ``bytes_in_use`` / ``peak_bytes_in_use`` (``allocated_bytes.all``
    current / peak), ``bytes_reserved`` (``reserved_bytes.all.current``),
    ``num_allocs`` — and ``bytes_limit``, the card's total from
    ``torch.cuda.mem_get_info``; a process that computes on no card
    (CUDA never initialised) reports one ``cpu`` row with ``{}`` stats,
    as the reference does on its CPU backend.
    ``host`` is :func:`ptype_tpu_torch.metrics.memory_watermarks` plus
    the peak RSS. The memory profile is ``torch.cuda.memory._snapshot()``
    pickled (the format PyTorch's memory viewer reads): its size is
    always reported, its bytes ride along with ``include_profile``.
    """
    import pickle

    import torch

    devices = []
    if _on_cuda(torch):
        for i in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(i)
            devices.append({
                "id": i, "platform": "cuda",
                "kind": torch.cuda.get_device_name(i),
                "stats": {
                    "bytes_in_use": int(
                        stats.get("allocated_bytes.all.current", 0)),
                    "peak_bytes_in_use": int(
                        stats.get("allocated_bytes.all.peak", 0)),
                    "bytes_reserved": int(
                        stats.get("reserved_bytes.all.current", 0)),
                    "num_allocs": int(stats.get("allocation.all.allocated",
                                                0)),
                    "bytes_limit": int(torch.cuda.mem_get_info(i)[1]),
                }})
    else:
        devices.append({"id": 0, "platform": "cpu", "kind": "cpu",
                        "stats": {}})
    out = {"devices": devices, "host": _host_watermarks()}
    if _on_cuda(torch):
        prof = pickle.dumps(torch.cuda.memory._snapshot())
        out["memory_profile_size"] = len(prof)
        if include_profile:
            out["memory_profile"] = prof
    else:
        out["memory_profile_note"] = "no CUDA device: no allocator snapshot"
    return out


# ----------------------------------------------------- the actor endpoint


def endpoint(cmd: str, options: dict | None = None):
    """The built-in ``ptype.Profile`` actor endpoint (registered by
    every :class:`~ptype_tpu_torch.actor.ActorServer`, sibling of
    ``ptype.Telemetry``). Verbs::

        ("status",)                       -> platform + session state
        ("start",   {"label"})            -> begin a capture
        ("stop",    {"include_data", "max_bytes"})
        ("capture", {"duration_s", "label", "include_data", ...})
        ("memory",  {"include_profile"})  -> device-memory snapshot
        ("fetch",   {"dir", "path"})      -> one artifact's bytes

    Errors (double start, unknown verb) surface as typed exceptions —
    the actor layer marshals them to the caller as ``RemoteError``.
    """
    opts = dict(options or {})
    if cmd == "status":
        import torch

        with _lock:
            sess = dict(_active) if _active is not None else None
            stopping = (sess is None and _thread is not None
                        and _thread.is_alive())
        cuda = _on_cuda(torch)
        return {"pid": os.getpid(), "platform": "cuda" if cuda else "cpu",
                "device_kind": (torch.cuda.get_device_name(0) if cuda
                                else "cpu"),
                "devices": torch.cuda.device_count() if cuda else 1,
                "active": sess is not None,
                # A session's thread still running with no capture
                # active (a stop in progress, or a start or a stop that
                # gave up): no start until it ends.
                "stopping": stopping,
                "dir": sess["dir"] if sess else None}
    if cmd == "start":
        return start(label=opts.get("label", ""))
    if cmd == "stop":
        return stop(include_data=opts.get("include_data", False),
                    max_bytes=opts.get("max_bytes", MAX_SHIP_BYTES))
    if cmd == "capture":
        return capture(
            duration_s=opts.get("duration_s", DEFAULT_CAPTURE_S),
            label=opts.get("label", ""),
            include_data=opts.get("include_data", True),
            max_bytes=opts.get("max_bytes", MAX_SHIP_BYTES))
    if cmd == "memory":
        return memory_snapshot(
            include_profile=opts.get("include_profile", False))
    if cmd == "fetch":
        return fetch(opts["dir"], opts["path"])
    raise ProfileError(f"ptype.Profile: unknown command {cmd!r}")


def write_artifacts(out_dir: str, result: dict) -> list[str]:
    """Persist a shipped capture reply (the ``data`` bytes from
    :func:`stop`/:func:`capture` over the wire) under ``out_dir``;
    returns the written paths. Relative paths are sanitized the same
    way :func:`fetch` guards reads."""
    root = os.path.realpath(out_dir)
    os.makedirs(root, exist_ok=True)
    written: list[str] = []
    for rel, blob in (result.get("data") or {}).items():
        p = os.path.realpath(os.path.join(root, rel))
        if not p.startswith(root + os.sep):
            continue
        os.makedirs(os.path.dirname(p), exist_ok=True)
        with open(p, "wb") as fp:
            fp.write(blob)
        written.append(p)
    return written


# --------------------------------------------------- alert-driven capture

#: Alerts whose firing auto-captures a profile on the named node: the
#: rules whose runbook first question is "what is that node's device
#: timeline doing". The serving rules ride the same hook — a TTFT
#: blowup or a thrashing KV pool is diagnosed from the afflicted
#: REPLICA's engine timeline, and the replica is what the alert names.
PROFILE_ALERT_RULES = ("straggler", "train-stall", "slo-p99",
                       "ttft-p99", "kv-pressure", "serve-stall")


class AlertCapture:
    """``AlertEngine`` hook: alert → short profile on the NAMED node.

    Install as ``AlertEngine(rules, capture=AlertCapture(...))``. On a
    matching firing it dials the node from the alert's node key
    (``service/addr:port`` — the cluster-snapshot key shape), runs the
    ``ptype.Profile`` ``capture`` verb with artifact shipping on, and
    writes the artifacts next to the flight-recorder dump
    (``out_dir``, defaulting to the trace plane's dump dir) — the page
    and its device evidence land side by side. Rate-limited per
    (rule, node) to one capture per ``min_interval_s``, mirroring
    ``trace.maybe_dump``; unresolvable node keys (the aggregator's own
    ``local`` row) degrade to a local capture. Capture runs on a
    background thread by default so ``evaluate()`` never blocks on a
    slow node; ``background=False`` is the deterministic test mode.
    """

    def __init__(self, out_dir: str | None = None,
                 duration_s: float = 0.25,
                 rules: tuple = PROFILE_ALERT_RULES,
                 min_interval_s: float = CAPTURE_MIN_INTERVAL_S,
                 timeout_s: float | None = None,
                 background: bool = True):
        from ptype_tpu_torch import trace as trace_mod

        self.out_dir = (out_dir or trace_mod.dump_dir()
                        or os.path.join(base_dir(), "alerts"))
        self.duration_s = float(duration_s)
        self.rules = tuple(rules)
        self.min_interval_s = float(min_interval_s)
        #: The reply timeout of a remote capture; None: the window's
        #: :func:`reply_timeout_s`.
        self.timeout_s = None if timeout_s is None else float(timeout_s)
        self.background = background
        #: Completed captures: {"rule", "node", "dir", "files"} — the
        #: post-mortem inventory (and the test surface).
        self.captures: list[dict] = []
        self.errors: list[dict] = []
        self._last: dict[tuple, float] = {}
        self._lock = threading.Lock()

    def __call__(self, alert) -> None:
        if alert.rule not in self.rules:
            return
        key = (alert.rule, alert.node)
        now = time.monotonic()
        with self._lock:
            last = self._last.get(key)
            if last is not None and now - last < self.min_interval_s:
                return
            self._last[key] = now
        if self.background:
            threading.Thread(target=self._capture, args=(alert,),
                             name="alert-profile", daemon=True).start()
        else:
            self._capture(alert)

    @staticmethod
    def _parse_node(node_key: str) -> tuple[str, int] | None:
        """``service/addr:port`` → (addr, port); None when the key has
        no dialable endpoint (the aggregator's ``local`` row)."""
        tail = node_key.rsplit("/", 1)[-1]
        addr, sep, port = tail.rpartition(":")
        if not sep or not addr:
            return None
        try:
            return addr, int(port)
        except ValueError:
            return None

    def _capture(self, alert) -> None:
        dest = os.path.join(
            self.out_dir,
            f"profile-{alert.rule}-"
            f"{alert.node.replace('/', '_').replace(':', '_')}-"
            f"{time.monotonic_ns()}")
        try:
            target = self._parse_node(alert.node)
            if target is None:
                result = capture(duration_s=self.duration_s,
                                 label=f"alert-{alert.rule}",
                                 include_data=True)
            else:
                result = self._remote_capture(*target)
            files = write_artifacts(dest, result)
            meta = {"rule": alert.rule, "node": alert.node,
                    "message": alert.message,
                    "ts": round(time.time(), 3),
                    "duration_s": result.get("duration_s"),
                    "remote_dir": result.get("dir"),
                    "memory": result.get("memory"),
                    "files": [os.path.relpath(p, dest) for p in files]}
            os.makedirs(dest, exist_ok=True)
            with open(os.path.join(dest, "capture.json"), "w",
                      encoding="utf-8") as fp:
                json.dump(meta, fp, indent=1, default=str)
            rec = {"rule": alert.rule, "node": alert.node,
                   "dir": dest, "files": len(files)}
            with self._lock:
                self.captures.append(rec)
            log.warning("alert-triggered profile captured", kv=rec)
        except Exception as e:  # noqa: BLE001 — the watchdog hosting
            # this hook must survive any capture failure (dead node,
            # disk full, profiler already busy on the target).
            with self._lock:
                self.errors.append({"rule": alert.rule,
                                    "node": alert.node,
                                    "error": f"{type(e).__name__}: {e}"})
            log.warning("alert-triggered profile capture failed",
                        kv={"rule": alert.rule, "node": alert.node,
                            "err": repr(e)})

    def _remote_capture(self, addr: str, port: int) -> dict:
        from ptype_tpu_torch import telemetry
        from ptype_tpu_torch.registry import Node

        return telemetry.node_profile(
            Node(addr, port), duration_s=self.duration_s,
            timeout=self.timeout_s, label="alert", dial_timeout=5.0)


# -------------------------------------------------- counted-cost analysis


def tree_avals(tree):
    """Shape/dtype skeleton of a tree of tensors — what
    :func:`compiled_cost` counts against: each tensor as an empty
    ``meta`` tensor of its shape and dtype (no data, no transfer), the
    dicts, lists, tuples and dataclasses around them rebuilt; anything
    else kept as it is. In-place updates on the skeleton leave the
    original untouched."""
    import dataclasses

    import torch

    if isinstance(tree, torch.Tensor):
        return torch.empty_like(tree, device="meta")
    if isinstance(tree, dict):
        return {k: tree_avals(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_avals(v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_avals(getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    return tree



def _byte_counter():
    """A ``TorchDispatchMode`` summing each op's tensor bytes, inputs
    and outputs, over the ops it sees (views move no bytes and are
    skipped)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class ByteCounter(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = 0
            self.bytes = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            self.ops += 1
            if not func.is_view:
                self.bytes += sum(
                    t.numel() * t.element_size()
                    for t in tree_leaves((args, kwargs, out))
                    if isinstance(t, torch.Tensor))
            return out

    return ByteCounter()


def compiled_cost(fn, *args, **kwargs) -> dict:
    """FLOPs/bytes of one call ``fn(*args, **kwargs)``, counted op by
    op — the port's stand-in for the reference's XLA ``cost_analysis``
    (which has no PyTorch counterpart; nothing is compiled here, the
    name is the reference's).

    - ``flops``: ``torch.utils.flop_counter.FlopCounterMode``, which
      prices the matmul-class ops (mm, bmm, addmm, baddbmm, einsum's
      products, convolutions, SDPA) — the work MFU prices; elementwise
      arithmetic (norms, softmax, an optimizer apply) counts 0 and shows
      in the bytes instead.
    - ``bytes_accessed``: each op's tensor inputs and outputs, summed
      (a view moves none). Unlike XLA's count no op is fused, so this
      is the eager program's traffic.

    A launch made through ``ctypes`` (the port's kernels) runs no torch
    op and is invisible to both counters: count a program built from
    torch ops (see :func:`transformer_grads_cost`). Run ``fn`` on
    ``meta`` tensors to count without computing. Raises
    :class:`ProfileError` when ``fn`` ran no torch op at all.
    """
    from torch.utils.flop_counter import FlopCounterMode

    counter = _byte_counter()
    with FlopCounterMode(display=False) as flops, counter:
        fn(*args, **kwargs)
    if not counter.ops:
        raise ProfileError("compiled_cost: the call ran no torch op — "
                           "nothing to count")
    return {"flops": float(flops.get_total_flops()),
            "bytes_accessed": float(counter.bytes)}


def _meta_params(cfg, device) -> dict:
    """A parameter tree of ``cfg``'s shapes on ``device`` (zeros off
    ``meta``), requiring grad."""
    import torch

    from ptype_tpu_torch.models.weights import param_shapes

    def leaf(shape):
        return torch.zeros(shape, dtype=cfg.param_dtype, device=device,
                           requires_grad=True)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else leaf(v)
                for k, v in tree.items()}

    return walk(param_shapes(cfg))


def _grads_cost_on(cfg, batch: int, seq: int, device) -> dict:
    import torch

    from ptype_tpu_torch.models import transformer as tfm
    from ptype_tpu_torch.parallel.collectives import tree_flatten

    params = _meta_params(cfg, device)
    leaves = [leaf for _, leaf in tree_flatten(params)]
    rows = {"tokens": torch.zeros(batch, seq, dtype=torch.int64,
                                  device=device),
            "targets": torch.zeros(batch, seq, dtype=torch.int64,
                                   device=device)}

    def local_grads():
        loss = tfm.loss_fn(params, rows, cfg, tfm._attention)
        return torch.autograd.grad(loss, leaves)

    return compiled_cost(local_grads)


def transformer_grads_cost(cfg, batch: int, seq: int,
                           stacked: int | None = None) -> dict:
    """Counted cost of one fwd+bwd over a ``(batch, seq)`` token block
    for ``cfg`` — the dominant term of every trainer's step: the port's
    ``loss_fn`` and ``torch.autograd.grad`` over every parameter, under
    :func:`compiled_cost`.

    The model's math runs with the PLAIN attention (the dense
    ``_attention``), because FlopCounterMode cannot see a kernel
    launched through ``ctypes``; the flash kernels do the same matmuls
    (the causal mask halves neither count). It runs on the ``meta``
    device — shapes only, no memory, no arithmetic — and, where an op
    has no meta implementation (a data-dependent MoE dispatch), on the
    CPU with zero weights instead; ``cost["device"]`` says which. With
    ``stacked`` the cost is that of ``stacked`` worker shards of
    ``batch`` rows each (the store-DP layout: each rank runs the same
    program on its rows). Returns flops/bytes plus ``flops_per_token``
    / ``tokens_per_step``.
    """
    try:
        cost = _grads_cost_on(cfg, batch, seq, "meta")
        cost["device"] = "meta"
    except (NotImplementedError, RuntimeError):
        cost = _grads_cost_on(cfg, batch, seq, "cpu")
        cost["device"] = "cpu"
    n = stacked or 1
    cost["flops"] *= n
    cost["bytes_accessed"] *= n
    tokens = batch * seq * n
    cost["tokens_per_step"] = tokens
    cost["flops_per_token"] = cost["flops"] / tokens
    return cost


def measure_compiled_cost(preset: str = "optimus-125m", batch: int = 8,
                          seq: int = 128) -> dict:
    """Counted-vs-analytic FLOPs on one config — the check behind
    ``compiled_flops_per_token`` (``mfu_compiled`` within 10% of the
    analytic MFU, gap REPORTED either way). MFU shares the wall-clock
    and peak factors, so the MFU gap IS the FLOPs gap."""
    from ptype_tpu_torch.models import transformer as tfm

    cfg = tfm.preset(preset)
    t0 = time.perf_counter()
    cost = transformer_grads_cost(cfg, batch, seq)
    analytic = tfm.flops_per_token(cfg, seq)
    compiled = cost["flops_per_token"]
    return {
        "preset": preset, "batch": batch, "seq": seq,
        "compiled_flops_per_token": round(compiled, 1),
        "analytic_flops_per_token": round(analytic, 1),
        "mfu_gap_pct": round(100.0 * (compiled - analytic) / analytic,
                             2),
        "bytes_per_token": round(
            cost["bytes_accessed"] / cost["tokens_per_step"], 1),
        "count_device": cost["device"],
        "count_s": round(time.perf_counter() - t0, 2),
    }


# --------------------------------------------------- host-side summaries


def summarize(profile_dir: str, top: int = 12) -> dict:
    """Host-side artifact summary — stdlib-only (gzip+json over the
    ``*.trace.json.gz`` Chrome traces a session writes), so it works
    with no viewer installed.

    Returns ``{"dir", "files", "events", "top_ops":
    [{"name", "total_us", "count"}, ...]}`` — top ops by total
    duration."""
    files = artifact_files(profile_dir)
    totals: dict[str, list] = {}
    n_events = 0
    for f in files:
        if not f["path"].endswith(".trace.json.gz"):
            continue
        try:
            with gzip.open(os.path.join(profile_dir, f["path"]),
                           "rt", encoding="utf-8") as fp:
                doc = json.load(fp)
        except (OSError, ValueError):
            continue
        for ev in doc.get("traceEvents", ()):
            if ev.get("ph") != "X":
                continue
            n_events += 1
            name = str(ev.get("name", "?"))
            acc = totals.setdefault(name, [0.0, 0])
            acc[0] += float(ev.get("dur", 0.0))
            acc[1] += 1
    top_ops = [{"name": name, "total_us": round(us, 1), "count": n}
               for name, (us, n) in sorted(
                   totals.items(), key=lambda kv: -kv[1][0])[:top]]
    return {"dir": profile_dir, "files": files, "events": n_events,
            "top_ops": top_ops}


def render_hbm_table(memory: dict) -> str:
    """One-line-per-device memory table from a :func:`memory_snapshot`
    dict (the ``obs profile`` printer feeds this to stdout)."""
    lines = []
    for dev in memory.get("devices", ()):
        stats = dev.get("stats", {})
        if stats:
            used = stats.get("bytes_in_use", 0) / 2**20
            peak = stats.get("peak_bytes_in_use", 0) / 2**20
            limit = stats.get("bytes_limit", 0) / 2**20
            lines.append(
                f"  dev{dev['id']} {dev.get('kind') or dev['platform']}:"
                f" {used:.1f} MiB in use (peak {peak:.1f}"
                + (f" / limit {limit:.0f})" if limit else ")"))
        else:
            lines.append(
                f"  dev{dev['id']} {dev.get('kind') or dev['platform']}:"
                f" no allocator stats (host RSS below)")
    host = memory.get("host", {})
    if host.get("rss_bytes"):
        lines.append(f"  host rss: {host['rss_bytes'] / 2**20:.1f} MiB")
    return "\n".join(lines)


# ----------------------------------------------------------- bench probe


def measure_profile_overhead(steps: int = 12, preset: str = "tiny",
                             batch: int = 8, seq: int = 32,
                             device=None) -> dict:
    """Capture-disabled cost of the profiling plane on the world-1
    store-DP loop (``device``: ``cuda`` unless named) — the
    ``profile_overhead_pct`` probe (bar: <1%).

    What "armed but not capturing" adds to a step: nothing in the step
    path checks the profiler (the endpoint is pull-only), so the whole
    idle cost is the goodput ledger's ``mfu_compiled`` arithmetic in
    its step-close — costed DIRECTLY (observe("train.step") with
    compiled flops set, microseconds against a step of milliseconds;
    same method as ``telemetry.measure_trace_overhead``). The
    interleaved armed/bare wall clocks ride along for transparency, and
    one short LIVE capture is costed separately (``capture_step_ms`` —
    the price of actually profiling, which is allowed to be visible)."""
    from ptype_tpu_torch import metrics as metrics_mod
    from ptype_tpu_torch import telemetry
    from ptype_tpu_torch.health import goodput as goodput_mod
    from ptype_tpu_torch.models import transformer as tfm

    cfg = tfm.preset(preset)
    with telemetry.probe_trainer(preset, device) as (trainer, batches):
        def step():
            trainer.step(batches(batch, seq))

        step()  # warm-up outside every measurement
        cost = trainer.compiled_cost()
        # A unit peak where the card table has none (the CPU): the
        # probe prices the MFU arithmetic and the gap, not an MFU.
        peak = metrics_mod.device_peak_tflops(trainer.device) or 1.0

        def ledger():
            return goodput_mod.GoodputLedger(
                registry=metrics_mod.MetricsRegistry(),
                tokens_per_step=batch * seq,
                flops_per_token=tfm.flops_per_token(cfg, seq),
                peak_tflops=peak).set_compiled_flops(cost["flops"])

        armed_ledger = ledger()
        # Interleaved armed/bare arms, per-arm MIN (robust to load
        # spikes).
        t_on: list[float] = []
        t_off: list[float] = []
        for i in range(2 * steps):
            armed = bool(i % 2)
            if armed:
                armed_ledger.install()
            else:
                armed_ledger.uninstall()
            t0 = time.perf_counter()
            step()
            (t_on if armed else t_off).append(time.perf_counter() - t0)
        armed_ledger.uninstall()
        step_s = min(t_off)

        # The idle cost, costed directly: one ledger step-close (with
        # the mfu_compiled arithmetic live) per step.
        probe = ledger()
        n = 5_000
        t0 = time.perf_counter()
        for _ in range(n):
            probe.observe("train.step", step_s)
        close_s = (time.perf_counter() - t0) / n

        # The price of actually capturing (informational, not the bar).
        start(label="bench-profile-overhead")
        t0 = time.perf_counter()
        for _ in range(2):
            step()
        capture_step_s = (time.perf_counter() - t0) / 2
        captured = stop()

    mfu_gap = None
    rec = probe.records()
    if rec and "mfu_gap_pct" in rec[-1]:
        mfu_gap = rec[-1]["mfu_gap_pct"]
    return {
        "bare_step_ms": round(step_s * 1e3, 2),
        "armed_step_ms": round(min(t_on) * 1e3, 2),
        "capture_step_ms": round(capture_step_s * 1e3, 2),
        "ledger_close_us": round(close_s * 1e6, 2),
        "profile_overhead_pct": round(100.0 * close_s / step_s, 4),
        "capture_artifact_files": len(captured["files"]),
        # One trace a recording: a capture longer than CHUNK_S has more.
        "capture_recordings": captured["chunks"],
        "compiled_flops_per_token": round(
            cost["flops"] / cost["tokens_per_step"], 1),
        "mfu_gap_pct": mfu_gap,
        "steps": steps,
    }
