"""Reused daemon threads for short concurrent work — a request's local
dispatch, an RPC's ``go``, an actor server's handler, an open-loop
load generator's arrival.

:func:`spawn` runs ``fn(*args)`` on an idle worker thread of the
process's :class:`Pool`, or on a new one when none is idle: concurrency
is never bounded (a handler that blocks holds its thread, as a thread
of its own would). A worker idle for the pool's ``idle_s`` exits. The
point is the start: a new OS thread's first run waits for the
scheduler, and on a host whose cores are all busy that wait is a whole
scheduling slice (tens of ms) on every call, where waking a parked
thread is not.

Work on a reused thread sees the thread-local state the previous work
left (torch's grad mode and current device are restored by their
context managers); a function that sets thread-local state must reset
it.
"""

from __future__ import annotations

import queue
import threading
import traceback

#: Seconds an idle worker of the process's pool waits for work.
IDLE_S = 30.0


class Pool:
    """Parked worker threads, each with its own handoff queue; work goes
    to the most recently parked one."""

    def __init__(self, idle_s: float = IDLE_S):
        self.idle_s = idle_s
        self._idle: list = []
        self._lock = threading.Lock()

    def idle(self) -> int:
        """Workers parked now."""
        with self._lock:
            return len(self._idle)

    def spawn(self, fn, *args) -> None:
        """Run ``fn(*args)`` on a worker thread and return at once. An
        exception ``fn`` lets out is printed, as a thread's would be."""
        with self._lock:
            handoff = self._idle.pop() if self._idle else None
        if handoff is not None:
            handoff.put((fn, args))
            return
        threading.Thread(target=self._work,
                         args=(queue.SimpleQueue(), (fn, args)),
                         name="ptype-worker", daemon=True).start()

    def _work(self, handoff: queue.SimpleQueue, job) -> None:
        while True:
            fn, args = job
            try:
                fn(*args)
            except BaseException:  # noqa: BLE001 — reported as a thread's
                traceback.print_exc()
            del fn, args, job
            with self._lock:
                self._idle.append(handoff)
            try:
                job = handoff.get(timeout=self.idle_s)
            except queue.Empty:
                with self._lock:
                    if handoff in self._idle:
                        self._idle.remove(handoff)
                        return
                try:  # handed work as the wait ran out: it is on its way
                    job = handoff.get(timeout=self.idle_s)
                except queue.Empty:  # unparked without work: retire
                    return


#: The process's pool, which :func:`spawn` and :class:`Group` use.
POOL = Pool()


def spawn(fn, *args) -> None:
    """:meth:`Pool.spawn` on the process's pool."""
    POOL.spawn(fn, *args)


class Group:
    """Work spawned together and waited for together: the join of a set
    of threads, over reused ones (of ``pool``, the process's when
    None)."""

    def __init__(self, pool: Pool | None = None):
        self._pool = pool or POOL
        self._left = 0
        self._settled = threading.Condition()

    def spawn(self, fn, *args) -> None:
        with self._settled:
            self._left += 1
        self._pool.spawn(self._run, fn, args)

    def _run(self, fn, args) -> None:
        try:
            fn(*args)
        finally:
            with self._settled:
                self._left -= 1
                self._settled.notify_all()

    def wait(self, timeout: float | None = None) -> bool:
        """Wait until every spawned job has returned (or ``timeout``
        seconds); True when they all have."""
        with self._settled:
            return self._settled.wait_for(lambda: self._left == 0, timeout)
