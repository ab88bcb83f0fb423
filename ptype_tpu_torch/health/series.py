"""Time-series tier of the cluster health plane — the port's copy of
``ptype_tpu/health/series.py``.

A telemetry pull alone returns point-in-time `MetricsRegistry`
snapshots — a number with no history, which no alert rule can reason
about (a shed *rate*, a loss *spike*, memory *growth* are all
derivatives). This module adds the bounded history:

- :class:`SeriesRing` — one named series, a fixed-capacity ring of
  (wall-clock t, value) points with non-decreasing timestamps;
- :class:`SeriesStore` — the per-process map of rings, snapshotted as
  plain ``{name: [[t, v], ...]}`` JSON for the telemetry endpoint;
- :class:`Sampler` — a background thread stamping the registry into
  the store at a fixed cadence. Change-driven: a family that did not
  move since the last tick appends nothing, and the walk list is
  cached against the registry's version, so an idle process's tick
  allocates nothing. Counters additionally get their rate window
  stamped (:meth:`~ptype_tpu_torch.metrics.Counter.sample`) and a
  ``<name>.rate`` series.

Arm the process-wide default with :func:`start`; the built-in
``ptype.Telemetry`` actor endpoint then includes ``series`` in every
pull, so ``telemetry.cluster_snapshot`` carries recent series per
node — the input the alert rules (:mod:`ptype_tpu_torch.health.rules`)
evaluate.
"""

from __future__ import annotations

import collections
import os
import threading
import time

from ptype_tpu_torch import lockcheck

from ptype_tpu_torch import metrics as metrics_mod

#: Default points kept per series: ~8.5 min of history at the default
#: 1 s cadence — enough for every rule window, bounded per process.
SERIES_CAPACITY = 512
#: Default sampler cadence.
DEFAULT_CADENCE_S = 1.0
#: Points returned per series in a telemetry pull (bounds the wire).
SNAPSHOT_LIMIT = 180


class SeriesRing:
    """One bounded time series: (t, value) points, timestamps clamped
    non-decreasing (a wall-clock step backwards — NTP slew — must not
    produce a series that runs backwards)."""

    __slots__ = ("name", "_points", "_lock")

    def __init__(self, name: str, capacity: int = SERIES_CAPACITY):
        self.name = name
        self._points: collections.deque = collections.deque(
            maxlen=int(capacity))
        self._lock = lockcheck.lock("health.series.ring")

    def append(self, t: float, value: float) -> None:
        with self._lock:
            if self._points and t < self._points[-1][0]:
                t = self._points[-1][0]
            self._points.append((float(t), float(value)))

    def points(self, limit: int | None = None) -> list[tuple[float, float]]:
        with self._lock:
            out = list(self._points)
        if limit is not None and len(out) > limit:
            out = out[-limit:]
        return out

    def last(self) -> tuple[float, float] | None:
        with self._lock:
            return self._points[-1] if self._points else None

    def __len__(self) -> int:
        with self._lock:
            return len(self._points)


class SeriesStore:
    """Named series for one process — what a ``ptype.Telemetry`` pull
    serializes and the alert rules read back per node."""

    def __init__(self, capacity: int = SERIES_CAPACITY):
        self.capacity = int(capacity)
        self._series: dict[str, SeriesRing] = {}
        self._lock = lockcheck.lock("health.series.store")

    def series(self, name: str) -> SeriesRing:
        with self._lock:
            ring = self._series.get(name)
            if ring is None:
                ring = self._series[name] = SeriesRing(name, self.capacity)
            return ring

    def get(self, name: str) -> SeriesRing | None:
        with self._lock:
            return self._series.get(name)

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._series)

    def snapshot(self, limit: int = SNAPSHOT_LIMIT) -> dict:
        """``{name: [[t, v], ...]}`` — plain JSON for the wire."""
        with self._lock:
            rings = list(self._series.values())
        return {r.name: [[round(t, 3), v] for t, v in r.points(limit)]
                for r in rings}


class Sampler:
    """Background registry→series sampler at a fixed cadence.

    Change-driven: per family the last stamped value (counters,
    gauges) or observation count (timings, histograms) is remembered,
    and an unchanged family appends no point — the zero-alloc-when-
    idle contract. The family walk list itself is cached against
    ``registry.version`` so a quiet tick is reads only.
    """

    def __init__(self, registry: metrics_mod.MetricsRegistry | None = None,
                 store: SeriesStore | None = None,
                 cadence_s: float = DEFAULT_CADENCE_S,
                 capacity: int = SERIES_CAPACITY,
                 memory: bool = True):
        self.registry = (registry if registry is not None
                         else metrics_mod.metrics)
        self.store = store if store is not None else SeriesStore(capacity)
        self.cadence_s = float(cadence_s)
        #: Also refresh the ``mem.*`` watermark gauges each tick, so
        #: memory-growth alerts have a series without any caller
        #: touching record_memory_gauges.
        self.memory = memory
        self.ticks = 0
        #: Wall time of the most recent tick — the measured overhead
        #: number (sampler_overhead_pct = last_tick_s / cadence_s).
        self.last_tick_s = 0.0
        self._last: dict[str, float] = {}
        self._walk: tuple | None = None
        self._walk_version = -1
        self._closed = threading.Event()
        self._thread: threading.Thread | None = None
        #: sample_once is called both by the background loop and by
        #: callers flushing final values — unserialized ticks would
        #: double-append points and double-stamp rate windows.
        self._tick_lock = lockcheck.lock("health.sampler.tick")

    # ---------------------------------------------------------- sampling

    def _families(self) -> tuple:
        version = self.registry.version
        if self._walk is None or version != self._walk_version:
            version, counters, timings, gauges, hists = \
                self.registry.families()
            self._walk = (counters, timings, gauges, hists)
            self._walk_version = version
        return self._walk

    def sample_once(self, now: float | None = None,
                    now_mono: float | None = None) -> int:
        """One tick: stamp every family that moved. Returns points
        appended. ``now`` (wall clock — series timestamps must stitch
        across nodes) and ``now_mono`` (rate windows) are injectable
        for deterministic tests."""
        now = time.time() if now is None else now
        now_mono = time.monotonic() if now_mono is None else now_mono
        with self._tick_lock:
            return self._sample_locked(now, now_mono)

    def _sample_locked(self, now: float, now_mono: float) -> int:
        if self.memory:
            metrics_mod.record_memory_gauges(self.registry)
        counters, timings, gauges, hists = self._families()
        last = self._last
        appended = 0
        for name, c in counters.items():
            v = c.value
            if last.get("c:" + name) == v:
                # Value flat — but a previously non-zero rate must
                # DECAY to zero, not freeze at its last busy reading:
                # keep stamping the rate window until it reads 0, then
                # go fully idle (the zero-alloc contract resumes).
                if last.get("r:" + name):
                    c.sample(now_mono)
                    rate = c.rate(now=now_mono)
                    if rate < 1e-9:
                        rate = 0.0
                    last["r:" + name] = rate
                    self.store.series(f"{name}.rate").append(now, rate)
                    appended += 1
                continue
            last["c:" + name] = v
            c.sample(now_mono)
            self.store.series(name).append(now, v)
            rate = c.rate(now=now_mono)
            last["r:" + name] = rate
            self.store.series(f"{name}.rate").append(now, rate)
            appended += 2
        for name, g in gauges.items():
            v = g.value
            if last.get("g:" + name) == v:
                continue
            last["g:" + name] = v
            self.store.series(name).append(now, v)
            appended += 1
        for name, t in timings.items():
            n = t.count
            if last.get("t:" + name) == n:
                continue
            last["t:" + name] = n
            self.store.series(f"{name}.last_s").append(now, t.last)
            self.store.series(f"{name}.count").append(now, n)
            appended += 2
        for name, h in hists.items():
            n = h.count
            if last.get("h:" + name) == n:
                continue
            last["h:" + name] = n
            self.store.series(f"{name}.p99").append(
                now, h.percentile(99.0))
            self.store.series(f"{name}.count").append(now, n)
            appended += 2
        self.ticks += 1
        return appended

    # ---------------------------------------------------------- lifecycle

    def start(self) -> "Sampler":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._loop, name="health-sampler", daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._closed.wait(self.cadence_s):
            t0 = time.perf_counter()
            self.sample_once()
            self.last_tick_s = time.perf_counter() - t0

    def close(self) -> None:
        self._closed.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


# --------------------------------------------------- process-wide default

_default: Sampler | None = None
_default_lock = threading.Lock()


def start(registry: metrics_mod.MetricsRegistry | None = None,
          cadence_s: float = DEFAULT_CADENCE_S,
          capacity: int = SERIES_CAPACITY) -> Sampler:
    """Arm (or return) the process-wide default sampler. Its store is
    what the built-in ``ptype.Telemetry`` endpoint serves as
    ``series`` — one call turns a node's metrics into history every
    cluster_snapshot carries."""
    global _default
    with _default_lock:
        if _default is None:
            _default = Sampler(registry, cadence_s=cadence_s,
                               capacity=capacity).start()
        return _default


def stop() -> None:
    global _default
    with _default_lock:
        sampler, _default = _default, None
    if sampler is not None:
        sampler.close()


def default() -> Sampler | None:
    return _default


def default_snapshot(limit: int = SNAPSHOT_LIMIT) -> dict:
    """The default sampler's series snapshot; ``{}`` when not armed —
    what :func:`ptype_tpu_torch.trace.telemetry` includes per pull."""
    sampler = _default
    return sampler.store.snapshot(limit) if sampler is not None else {}


def telemetry_endpoint(registry: metrics_mod.MetricsRegistry,
                       store: SeriesStore, service: str = ""):
    """A per-node ``ptype.Telemetry`` handler for processes hosting
    several SIMULATED nodes (drills, demos, tests): same shape as
    :func:`ptype_tpu_torch.trace.telemetry` but over THIS node's registry
    and series store. Register it per server:

    >>> server.register_function(
    ...     "ptype.Telemetry", telemetry_endpoint(reg, sampler.store))
    """

    def handler(span_limit: int = 256) -> dict:
        del span_limit  # simulated nodes carry no flight recorder
        return {
            "pid": os.getpid(),
            "service": service,
            "tracing": False,
            "ts": round(time.time(), 3),
            "metrics": registry.snapshot(),
            "series": store.snapshot(),
            "spans": [],
            "spans_finished": 0,
        }

    return handler
