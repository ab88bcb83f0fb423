"""Runtime lock-order watchdog — the port's copy of
``ptype_tpu/lockcheck.py``.

CPython has no race detector, so this module instruments the locks
themselves. Every lock the package creates goes through the factory
seam (:func:`lock` / :func:`rlock` / :func:`condition`):

- **disarmed** (the default), the factory returns the plain
  ``threading`` primitive — zero per-acquire overhead, one extra
  function call at construction;
- **armed** (:func:`enable`, or ``PTYPE_LOCKCHECK=1`` in the
  environment at import), it returns a tracked wrapper that records
  the per-process lock-acquisition graph: an edge A→B for every
  acquire of B while A is held (by name — every instance of
  ``serve.actor.load`` is one node, which is what makes the graph
  finite and the order contract meaningful).

Findings:

- **cycle** — a new edge closes a directed cycle in the acquisition
  graph: two threads taking the same locks in opposite orders is a
  deadlock waiting for the right interleaving, whether or not it hung
  THIS run. Dumped through the flight-recorder seam
  (:func:`ptype_tpu_torch.trace.add_event` + ``trace.maybe_dump``)
  the moment it is detected, so a post-mortem carries the span ring of
  the run that produced it.
- **hold** — a lock held longer than ``hold_budget_s`` (default 1 s):
  not a deadlock, but blocking work inside a critical section,
  measured instead of inferred. Condition ``wait`` is exempt while
  parked — waiting released the lock.

Stdlib-only at import (the trace import is lazy, on the finding
path): locks are created at the very bottom of the stack and this
module must never cycle.
"""

from __future__ import annotations

import os
import threading
import time

__all__ = [
    "enable", "disable", "active", "lock", "rlock", "condition",
    "Watchdog", "ENV_VAR", "HOLD_ENV_VAR",
]

ENV_VAR = "PTYPE_LOCKCHECK"
HOLD_ENV_VAR = "PTYPE_LOCKCHECK_HOLD_MS"
DEFAULT_HOLD_BUDGET_S = 1.0


class Watchdog:
    """Per-process acquisition graph + findings ledger."""

    def __init__(self, hold_budget_s: float = DEFAULT_HOLD_BUDGET_S):
        self.hold_budget_s = float(hold_budget_s)
        self._mu = threading.Lock()          # guards graph + findings
        self._edges: dict[str, set[str]] = {}
        #: (src, dst) -> name of the thread that FIRST took dst under
        #: src — the attribution a cycle report carries (bounded by
        #: the lock-name universe, same as the edge set).
        self._edge_threads: dict[tuple[str, str], str] = {}
        self._findings: list[dict] = []
        #: Per-thread acquire tallies, summed by :meth:`report` — a
        #: shared `+= 1` on the no-edge fast path would lose updates
        #: under exactly the contention the watchdog observes, and
        #: taking ``_mu`` there would serialize every tracked lock in
        #: the process through one global lock.
        self._counts: list[list[int]] = []
        #: Releases with no matching acquire on THIS thread's stack:
        #: a lock acquired in one thread and released in another (the
        #: hand-off pattern) is outside the tracker's model — the
        #: acquirer's stack entry leaks and later edges from it are
        #: suspect. Nonzero here means treat the graph with care.
        self._unmatched_releases = 0
        self._tls = threading.local()

    # ------------------------------------------------------------ held

    def _held(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _count_cell(self) -> list[int]:
        cell = getattr(self._tls, "count", None)
        if cell is None:
            cell = self._tls.count = [0]
            with self._mu:
                self._counts.append(cell)
        return cell

    # -------------------------------------------------------- tracking

    def on_acquired(self, name: str) -> None:
        """Called by a tracked lock AFTER its acquire succeeded."""
        held = self._held()
        new_edges = []
        for h_name, _t0 in held:
            if h_name != name:  # reentrant re-acquire is not an order
                new_edges.append(h_name)
        held.append((name, time.monotonic()))
        self._count_cell()[0] += 1
        if not new_edges:
            return
        cycles: list[list[str]] = []
        with self._mu:
            for src in new_edges:
                dsts = self._edges.setdefault(src, set())
                if name in dsts:
                    continue
                dsts.add(name)
                self._edge_threads[(src, name)] = (
                    threading.current_thread().name)
                cycle = self._find_cycle_locked(name, src)
                if cycle is not None:
                    cycles.append(cycle)
        for cycle in cycles:
            # Record + emit OUTSIDE _mu: the emit path writes a
            # flight-recorder dump (disk I/O) — holding the global
            # graph lock across it would stall every edge-creating
            # acquire in the process (blocking work inside a critical
            # section, in the tool that polices it).
            self._record_cycle(cycle)

    def on_released(self, name: str, waited: bool = False) -> None:
        """Called by a tracked lock BEFORE its release. ``waited``
        marks a Condition.wait park — the hold budget excuses it (the
        lock was not actually held while parked)."""
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] == name:
                _, t0 = held.pop(i)
                dur = time.monotonic() - t0
                if not waited and dur > self.hold_budget_s:
                    self._record_hold(name, dur)
                return
        with self._mu:
            self._unmatched_releases += 1

    def on_released_all(self, name: str) -> int:
        """Unwind EVERY held entry for ``name`` (a Condition's
        ``_release_save`` drops all recursion levels of an RLock at
        once, to park in wait). Returns the count so the restore can
        re-arm the same depth. Never a hold finding — parking is not
        holding."""
        held = self._held()
        n = 0
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] == name:
                held.pop(i)
                n += 1
        return n

    def _find_cycle_locked(self, start: str,
                           target: str) -> list[str] | None:
        """Path start → … → target in the edge graph (its existence
        plus the just-added target→start edge is a cycle)."""
        stack = [(start, [start])]
        seen = {start}
        while stack:
            node, path = stack.pop()
            if node == target:
                return path
            for nxt in self._edges.get(node, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    # -------------------------------------------------------- findings

    def _record_cycle(self, path: list[str]) -> None:
        cycle = path + [path[0]]
        with self._mu:
            edges = {f"{a}->{b}": self._edge_threads.get((a, b), "?")
                     for a, b in zip(cycle, cycle[1:])}
        finding = {
            "kind": "cycle",
            "cycle": cycle,
            #: Which thread FIRST took each edge — the two (or more)
            #: call paths the runbook tells the operator to grep for.
            "edge_threads": edges,
            "thread": threading.current_thread().name,
            "t": time.time(),
        }
        with self._mu:
            self._findings.append(finding)
        self._emit(finding)

    def _record_hold(self, name: str, dur_s: float) -> None:
        finding = {
            "kind": "hold",
            "lock": name,
            "held_s": round(dur_s, 4),
            "budget_s": self.hold_budget_s,
            "thread": threading.current_thread().name,
            "t": time.time(),
        }
        with self._mu:
            self._findings.append(finding)
        self._emit(finding)

    @staticmethod
    def _emit(finding: dict) -> None:
        """Dump through the flight-recorder seam: an event on the
        active span (when tracing is armed) and a rate-limited ring
        dump for cycles — the post-mortem artifact. Lazy import: locks
        live below every other subsystem."""
        try:
            from ptype_tpu_torch import trace

            trace.add_event(f"lockcheck.{finding['kind']}",
                            **{k: str(v) for k, v in finding.items()
                               if k not in ("kind", "t")})
            if finding["kind"] == "cycle":
                trace.maybe_dump("lock-order cycle: "
                                 + " -> ".join(finding["cycle"]))
        except Exception:  # noqa: BLE001 — a watchdog must never
            pass           # break the lock it watches

    # ------------------------------------------------------ inspection

    def cycles(self) -> list[dict]:
        with self._mu:
            return [f for f in self._findings if f["kind"] == "cycle"]

    def holds(self) -> list[dict]:
        with self._mu:
            return [f for f in self._findings if f["kind"] == "hold"]

    def findings(self) -> list[dict]:
        with self._mu:
            return list(self._findings)

    def report(self) -> dict:
        with self._mu:
            return {
                "acquires": sum(c[0] for c in self._counts),
                "locks": sorted(
                    set(self._edges)
                    | {d for v in self._edges.values() for d in v}),
                "edges": {src: sorted(dsts)
                          for src, dsts in sorted(self._edges.items())},
                "edge_threads": {f"{a}->{b}": t for (a, b), t
                                 in sorted(self._edge_threads.items())},
                "cycles": [f for f in self._findings
                           if f["kind"] == "cycle"],
                "holds": [f for f in self._findings
                          if f["kind"] == "hold"],
                "unmatched_releases": self._unmatched_releases,
            }


class TrackedLock:
    """A named threading.Lock/RLock wrapper feeding the watchdog."""

    __slots__ = ("_name", "_inner", "_wd")

    def __init__(self, name: str, inner, wd: Watchdog):
        self._name = name
        self._inner = inner
        self._wd = wd

    def acquire(self, blocking: bool = True, timeout: float = -1):
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._wd.on_acquired(self._name)
        return got

    def release(self) -> None:
        self._wd.on_released(self._name)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    # -- the threading.Condition protocol. A Condition built OVER a
    # tracked lock (the coord idiom: ``threading.Condition(self._lock)``
    # with the state RLock) probes ownership via ``_is_owned`` and
    # parks via ``_release_save``/``_acquire_restore``. Without these
    # proxies, Condition's fallback probe does a non-blocking
    # ``acquire(0)`` — which SUCCEEDS on a wrapped re-entrant RLock
    # the caller already owns — and notify/wait raise
    # "cannot notify on un-acquired lock" the moment the watchdog
    # arms.

    def _is_owned(self) -> bool:
        inner = self._inner
        if hasattr(inner, "_is_owned"):
            return inner._is_owned()
        # Plain Lock: mirror Condition's own probe semantics.
        if inner.acquire(False):
            inner.release()
            return False
        return True

    def _release_save(self):
        n = self._wd.on_released_all(self._name)
        if hasattr(self._inner, "_release_save"):
            return (self._inner._release_save(), n)
        self._inner.release()
        return (None, n)

    def _acquire_restore(self, state) -> None:
        inner_state, n = state
        if hasattr(self._inner, "_acquire_restore"):
            self._inner._acquire_restore(inner_state)
        else:
            self._inner.acquire()
        for _ in range(n):
            # Re-arm exactly the depth _release_save unwound: the
            # wake-up re-acquire is an acquisition event (edges from
            # whatever this thread now holds are real order facts).
            self._wd.on_acquired(self._name)

    def __repr__(self) -> str:
        return f"TrackedLock({self._name!r}, {self._inner!r})"


class TrackedCondition:
    """A named Condition wrapper: acquire/release feed the watchdog;
    ``wait``/``wait_for`` unwind the hold (the condition RELEASES the
    lock while parked) and re-arm it on wake."""

    __slots__ = ("_name", "_inner", "_wd")

    def __init__(self, name: str, inner: threading.Condition,
                 wd: Watchdog):
        self._name = name
        self._inner = inner
        self._wd = wd

    def acquire(self, *args):
        got = self._inner.acquire(*args)
        if got:
            self._wd.on_acquired(self._name)
        return got

    def release(self) -> None:
        self._wd.on_released(self._name)
        self._inner.release()

    def __enter__(self):
        self._inner.__enter__()
        self._wd.on_acquired(self._name)
        return self

    def __exit__(self, *exc):
        self._wd.on_released(self._name)
        return self._inner.__exit__(*exc)

    def wait(self, timeout: float | None = None):
        self._wd.on_released(self._name, waited=True)
        try:
            return self._inner.wait(timeout)
        finally:
            self._wd.on_acquired(self._name)

    def wait_for(self, predicate, timeout: float | None = None):
        self._wd.on_released(self._name, waited=True)
        try:
            return self._inner.wait_for(predicate, timeout)
        finally:
            self._wd.on_acquired(self._name)

    def notify(self, n: int = 1) -> None:
        self._inner.notify(n)

    def notify_all(self) -> None:
        self._inner.notify_all()

    def __repr__(self) -> str:
        return f"TrackedCondition({self._name!r})"


# ------------------------------------------------------------ module API

_watchdog: Watchdog | None = None


def enable(hold_budget_s: float | None = None) -> Watchdog:
    """Arm the watchdog process-wide; locks created through the seam
    FROM NOW ON are tracked (existing plain locks are not retrofit —
    arm before constructing the stack under test). Returns the fresh
    watchdog; re-enabling replaces graph and findings."""
    global _watchdog
    if hold_budget_s is None:
        ms = os.environ.get(HOLD_ENV_VAR)
        hold_budget_s = (float(ms) / 1000.0 if ms
                         else DEFAULT_HOLD_BUDGET_S)
    _watchdog = Watchdog(hold_budget_s)
    return _watchdog


def disable() -> None:
    global _watchdog
    _watchdog = None


def active() -> Watchdog | None:
    return _watchdog


def lock(name: str):
    """A ``threading.Lock`` — tracked under ``name`` when armed. The
    one-line seam every lock in the package rides."""
    wd = _watchdog
    if wd is None:
        return threading.Lock()
    return TrackedLock(name, threading.Lock(), wd)


def rlock(name: str):
    wd = _watchdog
    if wd is None:
        return threading.RLock()
    return TrackedLock(name, threading.RLock(), wd)


def condition(name: str):
    wd = _watchdog
    if wd is None:
        return threading.Condition()
    return TrackedCondition(name, threading.Condition(), wd)


def _maybe_enable_from_env() -> None:
    if os.environ.get(ENV_VAR, "").lower() in ("1", "true", "on"):
        enable()


_maybe_enable_from_env()
