"""Metrics — the port's copy of ``ptype_tpu/metrics.py``.

- Throughput and MFU for training loops (:class:`StepStats`,
  :func:`mfu`). The peak comes from :func:`device_peak_tflops`: a
  process pin (:func:`set_peak_tflops`), then the
  :data:`PEAK_TFLOPS_ENV` override, then the table, which names the
  card. A device none of them knows has no peak, and then :func:`mfu`
  is ``None``: the port never credits a run against another chip's
  rate (the reference falls back to the TPU v5e peak).
- The registry: :class:`Counter`, :class:`Timing`, :class:`Gauge`,
  :class:`Histogram` (exact windowed percentiles, with trace-id
  exemplars), :class:`MetricsRegistry`, the process-global
  :data:`metrics`, :func:`flatten_snapshot` and the JSONL
  :class:`MetricsWriter`.
- Device memory watermarks (:func:`memory_watermarks`,
  :func:`record_memory_gauges`) from the CUDA caching allocator.
- Profiler regions: :func:`annotate` and :func:`step_annotation` open
  a ``torch.profiler.record_function`` range (plus a trace span and
  the region observer when armed). None of them synchronizes.

torch is imported by the functions that use it, not with the module,
so a control-plane process (a fake replica worker) keeps the registry
without loading torch.
"""

from __future__ import annotations

import collections
import json
import threading
import time
from dataclasses import dataclass, field

from ptype_tpu_torch import lockcheck
from ptype_tpu_torch import trace as trace_mod

#: Dense bf16 tensor-core peak, TFLOP/s, by a substring of the device
#: name (matched case-blind). H100 SXM: 989 TFLOP/s (NVIDIA's H100 data
#: sheet), at its full 700 W power limit.
PEAK_TFLOPS = {"H100": 989.0}

#: Env override for the peak: either one bare float (the peak of
#: whatever device this process computes on — the operator knows better
#: than the substring table) or ``kind=tflops`` pairs matched before the
#: table (``"h200=989,b200=2250"``). A new card must be one env var
#: away from a correct MFU, not a code change.
PEAK_TFLOPS_ENV = "PTYPE_PEAK_TFLOPS"

#: Process-level pin (:func:`set_peak_tflops`): wins over env and table.
_peak_override: float | None = None
#: Device kinds already warned about: an unknown card logs ONCE per
#: kind, not once per MFU computation.
_peak_warned: set = set()


def set_peak_tflops(value: float | None) -> None:
    """Pin (or clear, with ``None``) the per-device peak every MFU
    computation of this process uses — the config-file seam; the env
    seam is :data:`PEAK_TFLOPS_ENV`."""
    global _peak_override
    _peak_override = None if value is None else float(value)


def _peak_env() -> tuple[float | None, dict]:
    """(flat override, ``kind=value`` additions) parsed from the env
    var; malformed entries are ignored (a typo must not break MFU)."""
    import os

    raw = os.environ.get(PEAK_TFLOPS_ENV, "").strip()
    if not raw:
        return None, {}
    extra: dict = {}
    flat = None
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" in part:
            key, _, val = part.partition("=")
            try:
                extra[key.strip().lower()] = float(val)
            except ValueError:
                pass
        else:
            try:
                flat = float(part)
            except ValueError:
                pass
    return flat, extra


def device_peak_tflops(device=None) -> float | None:
    """The bf16 peak of ``device`` (default: the current card, or the
    CPU on a host without one). Resolution order: the
    :func:`set_peak_tflops` pin, a bare-float :data:`PEAK_TFLOPS_ENV`,
    the env's ``kind=value`` pairs, then :data:`PEAK_TFLOPS`; a kind is
    the card's name (``torch.cuda.get_device_name``) or ``cpu``,
    matched by substring, case-blind. None for a device none of them
    names — the CPU included — and an unknown card logs one warning
    per kind naming the env var. Unlike the reference, there is no
    fallback to another chip's peak."""
    if _peak_override is not None:
        return _peak_override
    flat, extra = _peak_env()
    if flat is not None:
        return flat
    import torch

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda" and torch.cuda.is_available():
        kind = torch.cuda.get_device_name(device).lower()
    else:
        kind = device.type
    for key, tf in extra.items():
        if key in kind:
            return tf
    for key, tf in PEAK_TFLOPS.items():
        if key.lower() in kind:
            return tf
    if device.type != "cpu" and kind not in _peak_warned:
        _peak_warned.add(kind)
        from ptype_tpu_torch import logs

        logs.get_logger("metrics").warning(
            f"unknown accelerator kind; no MFU without its peak — set "
            f"it with {PEAK_TFLOPS_ENV}", kv={"device_kind": kind})
    return None


def mfu(tokens_per_sec: float, flops_per_token: float, n_chips: int,
        peak_tflops: float | None) -> float | None:
    """Model FLOPs utilization, achieved over peak; None without a
    peak."""
    if not peak_tflops:
        return None
    return tokens_per_sec * flops_per_token / (peak_tflops * 1e12 * n_chips)


#: Samples a Counter keeps for its windowed rate() — filled by the
#: health sampler's cadence (one sample per tick), sized so a minute
#: of 1 Hz sampling fits.
COUNTER_RATE_WINDOW = 64


@dataclass
class Counter:
    name: str
    value: float = 0.0
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)
    #: (t, cumulative value) samples behind the windowed rate() — the
    #: hot-path add() never touches this; the health Sampler (or an
    #: explicit sample() call) stamps it at its cadence.
    _samples: collections.deque = field(
        default_factory=lambda: collections.deque(
            maxlen=COUNTER_RATE_WINDOW),
        repr=False, compare=False)

    def add(self, delta: float = 1.0) -> None:
        with self._lock:
            self.value += delta

    def sample(self, now: float | None = None) -> None:
        """Stamp (t, value) into the rate window — called by the health
        sampler at its cadence (time.monotonic clock)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            self._samples.append((now, self.value))

    def rate(self, window_s: float | None = None,
             now: float | None = None) -> float:
        """Events/sec over the sampled window (the sampler cadence).

        Computed from the stamped samples only — deterministic under
        explicit sample(now=...) calls. With a single sample the live
        value at ``now`` closes the interval; with none, 0.0."""
        now = time.monotonic() if now is None else now
        with self._lock:
            pts = list(self._samples)
            cur = self.value
        if window_s is not None:
            pts = [p for p in pts if p[0] >= now - window_s]
        if not pts:
            return 0.0
        t0, v0 = pts[0]
        t1, v1 = pts[-1] if len(pts) > 1 else (now, cur)
        if t1 <= t0:
            return 0.0
        return max(0.0, (v1 - v0) / (t1 - t0))


#: Recent observations a Timing keeps for its percentile window —
#: enough to be distribution-aware on hot paths, small enough that the
#: per-observe cost stays one deque append.
TIMING_WINDOW = 256


@dataclass
class Timing:
    name: str
    total: float = 0.0
    count: int = 0
    #: Most recent observation — what a bench tail or debugger wants
    #: from a warm path (the mean is polluted by the compile-pass
    #: first observation).
    last: float = 0.0
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)
    #: Ring of the most recent observations, powering percentile() —
    #: hot-path timings (rpc calls, store pushes) are long-tailed, and
    #: a mean hides exactly the tail an SLO check needs.
    _recent: collections.deque = field(
        default_factory=lambda: collections.deque(maxlen=TIMING_WINDOW),
        repr=False, compare=False)

    def observe(self, seconds: float) -> None:
        with self._lock:
            self.total += seconds
            self.count += 1
            self.last = seconds
            self._recent.append(seconds)

    @property
    def mean(self) -> float:
        with self._lock:
            return self.total / self.count if self.count else 0.0

    @staticmethod
    def _rank(data: list, p: float) -> float:
        if not data:
            return 0.0
        rank = max(0, min(len(data) - 1,
                          int(round(p / 100.0 * (len(data) - 1)))))
        return data[rank]

    def percentile(self, p: float) -> float:
        """Nearest-rank percentile over the recent window (seconds);
        0.0 before any observation."""
        with self._lock:
            data = sorted(self._recent)
        return self._rank(data, p)

    def summary(self) -> dict:
        # One lock round-trip + one sort for all three percentiles:
        # snapshot() calls this per timing on every ptype.Telemetry
        # pull, and observe() contends the same lock on hot paths.
        with self._lock:
            data = sorted(self._recent)
            total, count, last = self.total, self.count, self.last
        return {"mean_s": total / count if count else 0.0,
                "count": count, "last_s": last,
                "p50_s": self._rank(data, 50.0),
                "p95_s": self._rank(data, 95.0),
                "p99_s": self._rank(data, 99.0)}


@dataclass
class Gauge:
    """A last-write-wins level (queue depth, live replicas, scale
    hint) — the counter/timing pair can't express 'current value'."""

    name: str
    value: float = 0.0
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)

    def add(self, delta: float = 1.0) -> None:
        with self._lock:
            self.value += delta


#: Exemplar slots kept per histogram: the K worst observations that
#: arrived with a trace id attached. Small and fixed — the point is a
#: handful of replayable links off the p99, not a second reservoir.
EXEMPLAR_SLOTS = 8


class Histogram:
    """Windowed reservoir with exact percentiles over the last
    ``window`` observations — the tail-latency surface (p50/p95/p99)
    the gateway's SLO accounting and autoscale signals read. A ring
    buffer, not a sketch: serving windows are small (thousands), and
    exact tails are what an SLO check needs.

    **Exemplars**: when an observation happens inside an
    active trace (or the caller passes ``trace_id``), the value keeps
    its trace id in one of :data:`EXEMPLAR_SLOTS` worst-value slots —
    so the p99 a dashboard shows links to a real replayable trace in
    the flight recorder, not an anonymous number. Free when tracing
    is disabled (one global load in :func:`trace.current_trace_id`)."""

    __slots__ = ("name", "window", "_ring", "_idx", "_count", "_lock",
                 "_exemplars")

    def __init__(self, name: str, window: int = 2048):
        self.name = name
        self.window = int(window)
        self._ring: list[float] = []
        self._idx = 0
        self._count = 0
        self._exemplars: list[tuple[float, str, float]] = []
        self._lock = lockcheck.lock("metrics.histogram")

    def observe(self, value: float, trace_id: str | None = None) -> None:
        v = float(value)
        if trace_id is None:
            trace_id = trace_mod.current_trace_id()
        with self._lock:
            if len(self._ring) < self.window:
                self._ring.append(v)
            else:
                self._ring[self._idx] = v
                self._idx = (self._idx + 1) % self.window
            self._count += 1
            if trace_id:
                ex = self._exemplars
                if len(ex) < EXEMPLAR_SLOTS:
                    ex.append((v, trace_id, time.time()))
                else:
                    i = min(range(len(ex)), key=lambda j: ex[j][0])
                    if v > ex[i][0]:
                        ex[i] = (v, trace_id, time.time())

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def percentile(self, p: float) -> float:
        """Nearest-rank percentile over the window; 0.0 when empty."""
        with self._lock:
            data = sorted(self._ring)
        if not data:
            return 0.0
        rank = max(0, min(len(data) - 1,
                          int(round(p / 100.0 * (len(data) - 1)))))
        return data[rank]

    def exemplars(self) -> list[dict]:
        """Worst-first ``{value, trace_id, ts}`` exemplar slots —
        what ``obs tail`` and the OpenMetrics exporter surface."""
        with self._lock:
            ex = list(self._exemplars)
        ex.sort(key=lambda e: -e[0])
        return [{"value": round(v, 3), "trace_id": tid,
                 "ts": round(ts, 3)} for v, tid, ts in ex]

    def summary(self) -> dict:
        out = {"count": self.count,
               "p50": self.percentile(50.0),
               "p95": self.percentile(95.0),
               "p99": self.percentile(99.0)}
        ex = self.exemplars()
        if ex:  # key present only when real links exist — snapshot
            out["exemplars"] = ex  # shape is pinned by older tests
        return out


class MetricsRegistry:
    """Process-local named counters/timings/gauges/histograms with a
    JSON dump."""

    def __init__(self):
        self._counters: dict[str, Counter] = {}
        self._timings: dict[str, Timing] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}
        self._lock = lockcheck.lock("metrics.registry")
        self._version = 0

    def _family(self, fam: dict, name: str, make):
        with self._lock:
            obj = fam.get(name)
            if obj is None:
                obj = fam[name] = make()
                # Version bumps let the health Sampler cache its walk
                # list and stay allocation-free between new families.
                self._version += 1
            return obj

    def counter(self, name: str) -> Counter:
        return self._family(self._counters, name, lambda: Counter(name))

    def timing(self, name: str) -> Timing:
        return self._family(self._timings, name, lambda: Timing(name))

    def gauge(self, name: str) -> Gauge:
        return self._family(self._gauges, name, lambda: Gauge(name))

    def histogram(self, name: str, window: int = 2048) -> Histogram:
        return self._family(self._histograms, name,
                            lambda: Histogram(name, window))

    @property
    def version(self) -> int:
        """Bumped once per family creation — the sampler's cheap
        'did the registry grow since my cached walk list' check."""
        with self._lock:
            return self._version

    def families(self) -> tuple:
        """(version, counters, timings, gauges, histograms) — shallow
        copies of the live family maps, for consumers (the health
        sampler) that need values-and-counts without the full summary
        construction :meth:`snapshot` pays."""
        with self._lock:
            return (self._version, dict(self._counters),
                    dict(self._timings), dict(self._gauges),
                    dict(self._histograms))

    def timed(self, name: str):
        """Context manager recording wall time into a Timing."""
        registry = self

        class _Ctx:
            def __enter__(self):
                self._t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                registry.timing(name).observe(time.perf_counter() - self._t0)
                return False

        return _Ctx()

    def snapshot(self) -> dict:
        with self._lock:
            counters = dict(self._counters)
            timings = dict(self._timings)
            gauges = dict(self._gauges)
            histograms = dict(self._histograms)
        # Every family dumps uniformly: counters/gauges as values,
        # timings and histograms as distribution summaries (count +
        # p50/p95/p99) — the gateway's SLO tail and a hot path's
        # Timing read the same way in one dump.
        return {
            "counters": {n: c.value for n, c in counters.items()},
            "timings": {n: t.summary() for n, t in timings.items()},
            "gauges": {n: g.value for n, g in gauges.items()},
            "histograms": {n: h.summary() for n, h in histograms.items()},
        }

    def dump_json(self) -> str:
        return json.dumps(self.snapshot(), separators=(",", ":"))


#: Default process-global registry.
metrics = MetricsRegistry()


def flatten_snapshot(snap: dict) -> dict:
    """One flat ``{name: scalar}`` view of a registry snapshot — what
    :meth:`MetricsWriter.emit` merges so the training scalar log and
    the health-plane series read the same values: counters and gauges
    as-is, timings as ``<name>.last_s`` (what the sampler stamps into
    its series) plus ``<name>.mean_s``, histograms as ``<name>.p99``.
    """
    flat: dict = {}
    flat.update(snap.get("counters", {}))
    flat.update(snap.get("gauges", {}))
    for name, s in snap.get("timings", {}).items():
        flat[f"{name}.last_s"] = s.get("last_s", 0.0)
        flat[f"{name}.mean_s"] = s.get("mean_s", 0.0)
    for name, s in snap.get("histograms", {}).items():
        flat[f"{name}.p99"] = s.get("p99", 0.0)
    return flat


# --------------------------------------------------------- memory gauges


def memory_watermarks(device=None) -> dict:
    """Device memory watermarks of a CUDA device (the current one when
    None) from the caching allocator: bytes in use, the peak, and the
    card's total. ``{}`` on the CPU. Host reads only: no
    synchronization."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            return {}
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    return {"device_bytes_in_use": int(
                stats.get("allocated_bytes.all.current", 0)),
            "device_peak_bytes": int(torch.cuda.max_memory_allocated(device)),
            "device_bytes_limit": int(
                torch.cuda.get_device_properties(device).total_memory)}


def record_memory_gauges(registry: MetricsRegistry | None = None,
                         device=None) -> dict:
    """Refresh the ``mem.*`` gauges from :func:`memory_watermarks` in
    ``registry`` (default: the process-global one) and return the raw
    dict — the seam ``serve.Info()`` and the telemetry snapshot share."""
    reg = registry if registry is not None else metrics
    wm = memory_watermarks(device)
    for key, value in wm.items():
        reg.gauge(f"mem.{key}").set(value)
    return wm


class MetricsWriter:
    """Append-only JSONL metrics sink for training runs.

    One ``{"ts": ..., "step": ..., **scalars}`` line per emit —
    tail-able during a run, trivially loadable after (pandas/jq); the
    file-based observability tier beneath profiler traces. Flushed per
    line so a SIGKILLed run keeps everything emitted before the kill.
    """

    def __init__(self, path: str):
        import os

        os.makedirs(os.path.dirname(os.path.abspath(path)),
                    exist_ok=True)
        self._f = open(path, "a", encoding="utf-8")
        self._lock = lockcheck.lock("metrics.kvlogger")

    def emit(self, step: int, snapshot: dict | None = None,
             **scalars) -> None:
        """Emit one line. ``snapshot`` (a :meth:`MetricsRegistry
        .snapshot` dict, or a registry to snapshot) merges flattened
        via :func:`flatten_snapshot` UNDER the explicit scalars — the
        training log and the health series then agree on one source of
        truth instead of call sites recomputing rates by hand."""
        import math

        if snapshot is not None:
            if isinstance(snapshot, MetricsRegistry):
                snapshot = snapshot.snapshot()
            merged = flatten_snapshot(snapshot)
            merged.update(scalars)
            scalars = merged
        rec = {"ts": round(time.time(), 3), "step": int(step)}
        for k, v in scalars.items():
            try:
                f = float(v)
            except (TypeError, ValueError):
                rec[k] = str(v)
                continue
            # json.dumps would emit the invalid-JSON token `NaN` and
            # break jq/strict parsers on exactly the diverging runs
            # where the file matters most — stringify non-finite.
            rec[k] = f if math.isfinite(f) else str(f)
        line = json.dumps(rec, separators=(",", ":")) + "\n"
        with self._lock:
            self._f.write(line)
            self._f.flush()

    def close(self) -> None:
        with self._lock:
            try:
                self._f.close()
            except OSError:
                pass


# ------------------------------------------------------------- profiling

#: Observer for finished annotate() regions — ``fn(name, dur_s)``.
_annotate_observer = None


def set_annotate_observer(fn) -> None:
    """Install (or clear, with ``None``) the region observer. One
    observer per process."""
    global _annotate_observer
    _annotate_observer = fn


class _AnnotatedSpan:
    """A profiler range + distributed-trace span + region observer
    entered as one scope — profiler timelines, the flight recorder,
    and the observer see the same region."""

    __slots__ = ("_ann", "_sp", "_name", "_obs", "_t0")

    def __init__(self, ann, sp, name, obs):
        self._ann = ann
        self._sp = sp
        self._name = name
        self._obs = obs

    def __enter__(self):
        self._ann.__enter__()
        self._sp.__enter__()
        if self._obs is not None:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._obs is not None:
            dt = time.perf_counter() - self._t0
            try:
                self._obs(self._name, dt)
            except Exception:  # noqa: BLE001 — telemetry must never
                pass           # kill the step it observes, nor leak
                #                the span/range scopes.
        self._sp.__exit__(*exc)
        return self._ann.__exit__(*exc)


def annotate(name: str, **kwargs):
    """Named region in profiler traces (host and device timeline): a
    ``torch.profiler.record_function`` range, which costs nothing when
    no profiler is recording and never synchronizes. ``kwargs`` become
    the range's argument string.

    When distributed tracing is armed (:mod:`ptype_tpu_torch.trace`),
    the region also opens a span of the same name; when a region
    observer is installed (:func:`set_annotate_observer`), the region's
    host wall time is reported to it on exit."""
    import torch

    args = (",".join(f"{k}={v}" for k, v in sorted(kwargs.items()))
            if kwargs else None)
    ann = torch.profiler.record_function(name, args)
    obs = _annotate_observer
    if obs is None and not trace_mod.enabled():
        return ann
    return _AnnotatedSpan(ann, trace_mod.span(name), name, obs)


def step_annotation(step: int):
    """Mark one training step in the profile (``train#<step>``)."""
    import torch

    return torch.profiler.record_function(f"train#{int(step)}")


@dataclass
class StepStats:
    """Rolling per-step throughput tracker for training loops."""

    flops_per_token: float
    n_chips: int
    peak_tflops: float | None = None
    tokens: int = 0
    seconds: float = 0.0
    steps: int = 0
    _t0: float = field(default=0.0, repr=False)

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def step(self, n_tokens: int, n_steps: int = 1) -> None:
        """Fold ``n_tokens`` of COMPLETED work (``n_steps`` train steps)
        into the rolling rates. Callers that dispatch asynchronously call
        this only at drain boundaries: crediting tokens at dispatch time
        measures the queueing rate, not compute."""
        now = time.perf_counter()
        self.seconds += now - self._t0
        self._t0 = now
        self.tokens += n_tokens
        self.steps += n_steps

    @property
    def tokens_per_sec(self) -> float:
        return self.tokens / self.seconds if self.seconds else 0.0

    @property
    def tokens_per_sec_per_chip(self) -> float:
        return self.tokens_per_sec / max(self.n_chips, 1)

    @property
    def mfu(self) -> float | None:
        return mfu(self.tokens_per_sec, self.flops_per_token, self.n_chips,
                   self.peak_tflops)
