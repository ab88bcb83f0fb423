"""Distributed tracing — spans, wire context, and the flight recorder:
the port's copy of ``ptype_tpu/trace.py``.

- **Spans** carry W3C-style context (``trace_id`` / ``span_id`` /
  parent) through a per-thread contextvar; :func:`span` opens a child
  of whatever is current, so nesting needs no plumbing.
- **Wire propagation**: :func:`traceparent` renders the active span as
  ``00-<trace_id>-<span_id>-01`` and :func:`span_from` /
  :func:`attach` adopt one on the receiving side, so one request is
  ONE trace across every process it touches. The serving ledger
  parents a request's synthesized span tree under the traceparent its
  caller carried.
- **Flight recorder**: each process keeps finished spans in a bounded
  ring (:class:`FlightRecorder`), dumpable on demand
  (:meth:`FlightRecorder.dump_jsonl`) or on unhandled error/shed
  (:func:`maybe_dump`, armed by ``PTYPE_TRACE_DUMP_DIR`` or
  ``enable(dump_dir=...)``).
- **Chaos correlation**: fault firings and recovery beacons
  (:mod:`ptype_tpu_torch.chaos`) land as events on the span they hit.

Zero-cost contract (same shape as chaos.py): with no recorder armed,
:func:`span` / :func:`span_from` / :func:`attach` return a module
singleton no-op context manager — one global load + ``None`` check,
no allocation; :func:`traceparent` returns ``None`` before touching
the contextvar. Tracing is enabled per process with :func:`enable`
or the ``PTYPE_TRACE`` env var.

This module imports only the stdlib plus :mod:`ptype_tpu_torch.chaos`
(itself stdlib-only) — it sits under logs/metrics and must never
create an import cycle.
"""

from __future__ import annotations

import collections
import contextvars
import json
import os
import random
import threading
import time

from ptype_tpu_torch import chaos

__all__ = [
    "Span", "FlightRecorder",
    "enable", "disable", "enabled", "recorder",
    "span", "span_from", "attach", "current", "traceparent",
    "parse_traceparent", "add_event", "maybe_dump", "telemetry",
]

#: Env var: truthy value arms tracing at import (multiprocess workers
#: join a traced run without code changes, like PTYPE_CHAOS_PLAN).
TRACE_ENV = "PTYPE_TRACE"
#: Env var: directory for on-error flight-recorder dumps.
DUMP_ENV = "PTYPE_TRACE_DUMP_DIR"

_ids = random.Random()


def _new_trace_id() -> str:
    return f"{_ids.getrandbits(128):032x}"


def _new_span_id() -> str:
    return f"{_ids.getrandbits(64):016x}"


class Span:
    """One timed operation. Created only while tracing is enabled;
    finished spans are frozen into the process flight recorder."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "start_s",
                 "dur_s", "attrs", "events", "status", "tid", "remote")

    def __init__(self, name: str, trace_id: str, parent_id: str | None,
                 remote: bool = False):
        self.name = name
        self.trace_id = trace_id
        self.span_id = _new_span_id()
        self.parent_id = parent_id
        #: Wall clock, NOT monotonic: cross-process spans must land on
        #: one shared timeline for the stitched Perfetto view.
        self.start_s = time.time()
        self.dur_s = 0.0
        self.attrs: dict = {}
        self.events: list[dict] = []
        self.status = "ok"
        self.tid = threading.get_ident()
        #: True for the placeholder parent re-created from a wire
        #: traceparent by :func:`attach` — context only, never recorded.
        self.remote = remote

    def set_attr(self, key: str, value) -> "Span":
        self.attrs[key] = value
        return self

    def set_status(self, status: str) -> "Span":
        """Mark the span's outcome explicitly — for failures the code
        CATCHES (a retried attempt, an absorbed transport error) that
        the context-manager exit therefore never sees."""
        self.status = status
        return self

    def add_event(self, name: str, **attrs) -> None:
        self.events.append({"name": name,
                            "t": round(time.time() - self.start_s, 6),
                            **({"attrs": attrs} if attrs else {})})

    def to_dict(self) -> dict:
        d = {"name": self.name, "trace_id": self.trace_id,
             "span_id": self.span_id, "parent_id": self.parent_id,
             "start_s": round(self.start_s, 6),
             "dur_s": round(self.dur_s, 6), "status": self.status,
             "tid": self.tid}
        if self.attrs:
            d["attrs"] = self.attrs
        if self.events:
            d["events"] = self.events
        return d

    def __repr__(self) -> str:
        return (f"Span({self.name!r} trace={self.trace_id[:8]} "
                f"span={self.span_id[:8]} {self.status})")


class FlightRecorder:
    """Bounded ring of finished spans — the per-process black box.

    A ring, not a file: tracing must be cheap enough to leave on in a
    soak, and the interesting spans are always the most recent ones.
    Pull the ring over RPC (:func:`telemetry` via ``ptype.Telemetry``)
    or dump it to JSONL when something goes wrong.
    """

    def __init__(self, service: str = "", capacity: int = 4096):
        self.service = service or f"pid-{os.getpid()}"
        self.pid = os.getpid()
        self.capacity = int(capacity)
        self._ring: "collections.deque[Span]" = collections.deque(
            maxlen=self.capacity)
        self._lock = threading.Lock()
        self._finished = 0

    def record(self, sp: Span) -> None:
        with self._lock:
            self._ring.append(sp)
            self._finished += 1

    @property
    def finished(self) -> int:
        with self._lock:
            return self._finished

    def spans(self, trace_id: str | None = None,
              limit: int | None = None) -> list[Span]:
        with self._lock:
            out = list(self._ring)
        if trace_id is not None:
            out = [s for s in out if s.trace_id == trace_id]
        if limit is not None and len(out) > limit:
            out = out[-limit:]
        return out

    def to_dicts(self, limit: int | None = None,
                 trace_id: str | None = None) -> list[dict]:
        return [s.to_dict() for s in self.spans(trace_id, limit)]

    def trace_ids(self) -> list[str]:
        """Distinct trace ids in the ring, oldest first."""
        seen: dict[str, None] = {}
        for s in self.spans():
            seen.setdefault(s.trace_id, None)
        return list(seen)

    def dump_jsonl(self, path: str) -> int:
        """Write the ring (one span dict per line); returns the count."""
        spans = self.to_dicts()
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            for s in spans:
                f.write(json.dumps(s, separators=(",", ":")) + "\n")
        return len(spans)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()


# -------------------------------------------------------------- module API

_recorder: FlightRecorder | None = None
_current: "contextvars.ContextVar[Span | None]" = contextvars.ContextVar(
    "ptype_trace_span", default=None)
_dump_dir: str | None = None
_dump_last = 0.0
_dump_lock = threading.Lock()
#: Minimum seconds between on-error dumps — an error storm must not
#: turn the flight recorder into a disk-filling loop.
DUMP_MIN_INTERVAL_S = 5.0


def enable(service: str = "", capacity: int = 4096,
           dump_dir: str | None = None) -> FlightRecorder:
    """Arm tracing process-wide; returns the fresh flight recorder.
    Also registers the chaos observer so fault firings / recovery
    beacons land as events on the span they hit."""
    global _recorder, _dump_dir
    rec = FlightRecorder(service, capacity)
    _recorder = rec
    if dump_dir is not None:
        _dump_dir = dump_dir
    chaos.set_observer(_chaos_observer)
    return rec


def disable() -> None:
    global _recorder, _dump_dir
    _recorder = None
    _dump_dir = None
    chaos.set_observer(None)


def _restore(rec: FlightRecorder | None, dump_dir: str | None) -> None:
    """Re-arm a previously captured (recorder, dump_dir) pair — how a
    probe that toggles tracing around its own measurement hands back
    the process's tracing state (ring, service name, dump config)."""
    global _recorder, _dump_dir
    _recorder = rec
    _dump_dir = dump_dir
    chaos.set_observer(_chaos_observer if rec is not None else None)


def enabled() -> bool:
    return _recorder is not None


def recorder() -> FlightRecorder | None:
    return _recorder


def dump_dir() -> str | None:
    """The on-error dump directory, if armed (``enable(dump_dir=...)``
    or ``PTYPE_TRACE_DUMP_DIR``) — where :func:`maybe_dump` writes,
    and where the health plane's alert-triggered profile captures
    land so a page's span ring and device timeline sit side by side."""
    return _dump_dir or os.environ.get(DUMP_ENV) or None


def current() -> Span | None:
    """The active span on this thread, or None (always None when
    tracing is disabled — stale contextvars from a disable() mid-span
    must not leak ids into logs)."""
    if _recorder is None:
        return None
    return _current.get()


def traceparent() -> str | None:
    """W3C-style ``00-<trace_id>-<span_id>-01`` for the active span —
    what the rpc/coord transports inject into outbound frames."""
    if _recorder is None:
        return None
    sp = _current.get()
    if sp is None:
        return None
    return f"00-{sp.trace_id}-{sp.span_id}-01"


def current_trace_id() -> str | None:
    """The active trace id on this thread, or None — the exemplar
    seam (:meth:`ptype_tpu_torch.metrics.Histogram.observe` attaches it to
    tail observations). One global load when tracing is disabled."""
    if _recorder is None:
        return None
    sp = _current.get()
    return sp.trace_id if sp is not None else None


def parse_traceparent(tp) -> tuple[str, str] | None:
    """(trace_id, span_id) from a traceparent, or None if malformed —
    a peer's garbage must degrade to 'start a fresh trace', not raise."""
    if not isinstance(tp, str):
        return None
    parts = tp.split("-")
    if len(parts) != 4 or len(parts[1]) != 32 or len(parts[2]) != 16:
        return None
    try:
        int(parts[1], 16), int(parts[2], 16)
    except ValueError:
        return None
    return parts[1], parts[2]


class _Noop:
    """The disabled-path singleton: a context manager that allocates
    nothing and absorbs the whole Span surface."""

    __slots__ = ()

    def __enter__(self) -> "_Noop":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set_attr(self, key: str, value) -> "_Noop":
        return self

    def set_status(self, status: str) -> "_Noop":
        return self

    def add_event(self, name: str, **attrs) -> None:
        pass


_NOOP = _Noop()


class _SpanCtx:
    """Context manager that opens a span as a child of the current (or
    an explicit remote) context, makes it current for the scope, and
    freezes it into the recorder on exit."""

    __slots__ = ("_rec", "_name", "_attrs", "_parent", "_span", "_token")

    def __init__(self, rec: FlightRecorder, name: str,
                 parent: tuple[str, str] | None, attrs: dict):
        self._rec = rec
        self._name = name
        self._attrs = attrs
        self._parent = parent  # (trace_id, span_id) | None
        self._span: Span | None = None
        self._token = None

    def __enter__(self) -> Span:
        if self._parent is not None:
            trace_id, parent_id = self._parent
        else:
            cur = _current.get()
            if cur is not None:
                trace_id, parent_id = cur.trace_id, cur.span_id
            else:
                trace_id, parent_id = _new_trace_id(), None
        sp = Span(self._name, trace_id, parent_id)
        if self._attrs:
            sp.attrs.update(self._attrs)
        self._span = sp
        self._token = _current.set(sp)
        # Monotonic duration clock alongside the wall-clock start.
        sp.attrs["_t0"] = time.perf_counter()
        return sp

    def __exit__(self, exc_type, exc, tb) -> bool:
        sp = self._span
        sp.dur_s = time.perf_counter() - sp.attrs.pop("_t0")
        if exc is not None:
            # ShedError is a typed refusal, not a failure — checked by
            # name so this module stays import-light.
            sp.status = ("shed" if type(exc).__name__ == "ShedError"
                         else "error")
            sp.add_event("exception", type=type(exc).__name__,
                         message=str(exc)[:200])
        _current.reset(self._token)
        self._rec.record(sp)
        return False


def span(name: str, **attrs):
    """Open a span (child of the current one) for a ``with`` scope.
    The no-op singleton when tracing is disabled — no allocation."""
    rec = _recorder
    if rec is None:
        return _NOOP
    return _SpanCtx(rec, name, None, attrs)


def span_from(tp, name: str, **attrs):
    """Open a span whose parent is a wire ``traceparent`` (the server
    side of a propagated call). Falls back to :func:`span` semantics
    when ``tp`` is absent/malformed; no-op when disabled."""
    rec = _recorder
    if rec is None:
        return _NOOP
    return _SpanCtx(rec, name, parse_traceparent(tp), attrs)


class _AttachCtx:
    """Make a remote traceparent the current context WITHOUT opening a
    recorded span — the seam for dispatch paths that already open
    their own span (ActorServer.dispatch) one frame below."""

    __slots__ = ("_parent", "_token")

    def __init__(self, parent: tuple[str, str]):
        self._parent = parent
        self._token = None

    def __enter__(self):
        trace_id, span_id = self._parent
        ph = Span("", trace_id, None, remote=True)
        ph.span_id = span_id  # impersonate the remote caller's span
        self._token = _current.set(ph)
        return ph

    def __exit__(self, *exc) -> bool:
        _current.reset(self._token)
        return False


def attach(tp):
    """Context manager adopting a wire traceparent as the current
    context (no span recorded). No-op when disabled or ``tp`` is
    absent/malformed."""
    if _recorder is None:
        return _NOOP
    parent = parse_traceparent(tp)
    if parent is None:
        return _NOOP
    return _AttachCtx(parent)


def add_event(name: str, **attrs) -> None:
    """Attach an event to the active span; free no-op otherwise."""
    if _recorder is None:
        return
    sp = _current.get()
    if sp is not None and not sp.remote:
        sp.add_event(name, **attrs)


def _chaos_observer(kind: str, site: str, action: str, key: str) -> None:
    """chaos.py observer: fault firings and recovery beacons become
    events on whatever span the afflicted thread is inside."""
    if _recorder is None:
        return
    sp = _current.get()
    if sp is not None and not sp.remote:
        sp.add_event(f"chaos.{kind}", site=site, action=action, key=key)


# ------------------------------------------------------- on-error dumping


def maybe_dump(reason: str = "") -> str | None:
    """Dump the flight recorder to ``<dump_dir>/flight-<pid>-<ns>.jsonl``
    if a dump dir is configured (``enable(dump_dir=...)`` or
    ``PTYPE_TRACE_DUMP_DIR``), rate-limited to one dump per
    :data:`DUMP_MIN_INTERVAL_S`. Returns the path or None.

    Called from unhandled-error and shed paths — the moments a
    post-mortem wants the ring."""
    global _dump_last
    rec = _recorder
    d = _dump_dir or os.environ.get(DUMP_ENV)
    if rec is None or not d:
        return None
    now = time.monotonic()
    with _dump_lock:
        if now - _dump_last < DUMP_MIN_INTERVAL_S:
            return None
        _dump_last = now
    path = os.path.join(
        d, f"flight-{rec.pid}-{time.monotonic_ns()}.jsonl")
    try:
        rec.dump_jsonl(path)
    except OSError:
        return None
    if reason:
        try:
            with open(path, "a", encoding="utf-8") as f:
                f.write(json.dumps({"flight_dump_reason": reason}) + "\n")
        except OSError:
            pass
    return path


# ------------------------------------------------------ telemetry surface


def telemetry(span_limit: int = 256) -> dict:
    """One node's observability snapshot — what the built-in
    ``ptype.Telemetry`` actor endpoint serves and
    :func:`ptype_tpu_torch.telemetry.cluster_snapshot` aggregates:
    process identity, the metrics registry snapshot (memory watermark
    gauges refreshed per pull), recent series when the health sampler
    is armed (:func:`ptype_tpu_torch.health.series.start` — the history
    the alert rules evaluate), and the most recent spans from the
    flight recorder."""
    from ptype_tpu_torch import metrics as metrics_mod  # lazy: torch
    from ptype_tpu_torch.health import series as series_mod

    metrics_mod.record_memory_gauges()
    rec = _recorder
    return {
        "pid": os.getpid(),
        "service": rec.service if rec is not None else "",
        "tracing": rec is not None,
        "ts": round(time.time(), 3),
        "metrics": metrics_mod.metrics.snapshot(),
        "series": series_mod.default_snapshot(),
        "spans": rec.to_dicts(limit=span_limit) if rec is not None else [],
        "spans_finished": rec.finished if rec is not None else 0,
    }


def _maybe_enable_from_env() -> None:
    raw = os.environ.get(TRACE_ENV, "")
    if raw and raw not in ("0", "false", "off") and _recorder is None:
        enable(service=raw if raw not in ("1", "true", "on") else "")


_maybe_enable_from_env()
