"""Admission control: the gateway's bounded waiting room — the port's
copy of ``ptype_tpu/gateway/admission.py``.

Every request entering the gateway passes through one
:class:`AdmissionQueue` before it may touch a replica. The queue
enforces three invariants the raw RPC plane cannot:

- **bounded depth** — once ``max_depth`` requests are waiting, new
  arrivals are refused with a typed
  :class:`~ptype_tpu_torch.errors.ShedError` carrying a retry-after
  hint, instead of piling onto socket buffers until everything times
  out;
- **per-request deadlines** — a request that cannot be *started* before
  its deadline is shed at admit time (SLO-aware shedding: the estimated
  queue wait already exceeds the budget), and one whose deadline lapses
  *while queued* is shed the moment it would have been granted — a shed
  is a fast, typed, retryable answer; a timeout is a lost request;
- **concurrency capping** — at most ``capacity()`` requests are
  dispatched at once (the pool sizes this from live replicas), so a
  replica fleet is never concurrently oversubscribed past the point
  where every request's latency degrades together.

Chaos seam: ``gateway.admit`` (actions ``shed`` — force-refuse this
admission, ``delay`` — stall the admit path); recoveries pair on the
gateway class via the frontdoor's success beacon.
"""

from __future__ import annotations

import threading
import time

from ptype_tpu_torch import chaos, lockcheck, logs
from ptype_tpu_torch.errors import ShedError

log = logs.get_logger("gateway.admission")


class _Ticket:
    __slots__ = ("key", "deadline", "granted", "enq_t", "shed_reason")

    def __init__(self, key: str, deadline: float | None):
        self.key = key
        self.deadline = deadline
        self.granted = threading.Event()
        self.enq_t = time.monotonic()
        #: Set (with the event) when the queue refuses rather than
        #: grants — close() path; no dispatch slot was consumed.
        self.shed_reason: str | None = None


class AdmissionQueue:
    """FIFO waiting room with a dynamic concurrency cap.

    ``capacity`` is a callable (live replicas × per-replica in-flight
    limit — it changes as the pool evicts and revives replicas);
    ``est_service_s`` is a callable returning the current estimate of
    one request's service time (the SLO tracker's EWMA), used both for
    the admission-time deadline check and the shed retry-after hint.
    """

    def __init__(self, max_depth: int, capacity,
                 est_service_s=None):
        self.max_depth = int(max_depth)
        self._capacity = capacity
        self._est_service_s = est_service_s or (lambda: 0.1)
        self._lock = lockcheck.lock("gateway.admission")
        self._queue: list[_Ticket] = []
        self._inflight = 0
        self._closed = False
        # Shed accounting, by cause — the autoscale layer reads these.
        self.shed_full = 0
        self.shed_slo = 0
        self.shed_deadline = 0
        self.admitted = 0

    # -------------------------------------------------------------- admit

    def admit(self, key: str = "", deadline: float | None = None) -> None:
        """Block until this request may dispatch, or raise
        :class:`ShedError`. ``deadline`` is an absolute monotonic
        stamp. The caller MUST call :meth:`release` after its dispatch
        completes (success or failure)."""
        f = chaos.hit("gateway.admit", key)
        if f is not None:
            if f.action == "delay":
                f.sleep()
            elif f.action == "shed":
                with self._lock:
                    self.shed_slo += 1
                    ra = self._retry_after_locked()
                raise ShedError(
                    f"chaos: forced shed at admission ({key!r})",
                    retry_after_s=ra)
        with self._lock:
            if self._closed:
                raise ShedError("gateway is shutting down",
                                retry_after_s=1.0)
            if self._inflight < max(1, int(self._capacity())) \
                    and not self._queue:
                self._inflight += 1
                self.admitted += 1
                return
            if len(self._queue) >= self.max_depth:
                self.shed_full += 1
                raise ShedError(
                    f"admission queue full ({self.max_depth} waiting)",
                    retry_after_s=self._retry_after_locked())
            if deadline is not None:
                est_wait = ((len(self._queue) + 1)
                            * self._est_service_s()
                            / max(1, int(self._capacity())))
                if time.monotonic() + est_wait > deadline:
                    # SLO-aware shed: the queue alone already eats the
                    # budget — refuse NOW with a hint, don't make the
                    # caller discover it via a timeout.
                    self.shed_slo += 1
                    raise ShedError(
                        f"estimated queue wait {est_wait:.2f}s exceeds "
                        f"the request deadline",
                        retry_after_s=self._retry_after_locked())
            t = _Ticket(key, deadline)
            self._queue.append(t)
        timeout = (None if deadline is None
                   else max(0.0, deadline - time.monotonic()))
        if t.granted.wait(timeout=timeout):
            if t.shed_reason is not None:
                # Woken to be refused (close()): no slot was consumed.
                raise ShedError(t.shed_reason, retry_after_s=1.0)
            return
        # Deadline lapsed while queued. Two races to settle under the
        # lock: still queued (the common case — withdraw and shed), or
        # granted in the instant after wait() gave up (we own a slot:
        # return it before shedding).
        with self._lock:
            if t in self._queue:
                self._queue.remove(t)
            elif t.shed_reason is None:
                self._release_locked()
            self.shed_deadline += 1
            ra = self._retry_after_locked()
        raise ShedError("deadline lapsed in the admission queue",
                        retry_after_s=ra)

    def release(self) -> None:
        """One dispatched request finished; grant the next waiter."""
        with self._lock:
            self._release_locked()

    def poke(self) -> None:
        """Re-evaluate grants — call when capacity may have GROWN
        (replica revived/arrived); shrinkage self-corrects as in-flight
        requests drain."""
        with self._lock:
            self._pump_locked()

    # ------------------------------------------------------------ internal

    def _release_locked(self) -> None:
        self._inflight = max(0, self._inflight - 1)
        self._pump_locked()

    def _pump_locked(self) -> None:
        cap = max(1, int(self._capacity()))
        while self._queue and self._inflight < cap:
            t = self._queue.pop(0)
            self._inflight += 1
            self.admitted += 1
            t.granted.set()

    def _retry_after_locked(self) -> float:
        """Backlog-proportional hint: how long until the queue has
        plausibly drained one slot's worth of room for this caller;
        callers hold the lock (the queue length must be the one the
        shed decision was made against)."""
        est = ((len(self._queue) + 1) * self._est_service_s()
               / max(1, int(self._capacity())))
        return min(10.0, max(0.05, est))

    # ---------------------------------------------------------- inspection

    @property
    def depth(self) -> int:
        with self._lock:
            return len(self._queue)

    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    @property
    def shed_total(self) -> int:
        with self._lock:
            return self.shed_full + self.shed_slo + self.shed_deadline

    def close(self) -> None:
        """Refuse new admissions and fail every waiter (typed)."""
        with self._lock:
            self._closed = True
            waiters, self._queue = self._queue, []
            self.shed_deadline += len(waiters)
            for t in waiters:
                t.shed_reason = "gateway is shutting down"
        for t in waiters:
            t.granted.set()
