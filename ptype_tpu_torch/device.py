"""Device selection for the port's entry points, and the gate between
the loops that launch kernels and the profiler's switches.

CUPTI switches its kernel recording on at a profiler session's start and
off at its stop. Switched while another thread launches kernels, it can
stop recording kernels for that session and, as a rule, every later one
in the process. So every entry point that launches kernels for a
served request or a training step runs inside :func:`device_work`, and
``health.profiling`` starts and stops a session only through
:meth:`DeviceGate.switch`, with no such step in flight.
"""

from __future__ import annotations

import contextlib
import threading


def resolve_device(device=None) -> "torch.device":  # noqa: F821
    """The device an entry point runs on: ``cuda`` unless the caller
    names another. With no CUDA device and none named this raises —
    the port never drops to the CPU on its own. (torch is imported
    here, not with the module, so the control plane can import this
    without it.)"""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "on the CPU")
        return torch.device("cuda")
    return torch.device(device)


class DeviceGate:
    """Shared entry for device work, exclusive for a profiler switch.

    :meth:`work` is re-entrant on a thread and lets any number of
    threads in together; :meth:`switch` waits until none is inside and
    keeps new work out until it is done. A pending switch goes first:
    work that arrives while one waits queues behind it."""

    def __init__(self):
        self._cond = threading.Condition()
        self._inside = 0
        self._switching = False
        self._pending = 0
        self._local = threading.local()

    @contextlib.contextmanager
    def work(self):
        depth = getattr(self._local, "depth", 0)
        if depth == 0:
            with self._cond:
                while self._switching or self._pending:
                    self._cond.wait()
                self._inside += 1
        self._local.depth = depth + 1
        try:
            yield
        finally:
            self._local.depth = depth
            if depth == 0:
                with self._cond:
                    self._inside -= 1
                    if not self._inside:
                        self._cond.notify_all()

    def held(self) -> bool:
        """Whether this thread is inside :meth:`work`."""
        return getattr(self._local, "depth", 0) > 0

    @contextlib.contextmanager
    def switch(self):
        with self._cond:
            self._pending += 1
            while self._switching or self._inside:
                self._cond.wait()
            self._pending -= 1
            self._switching = True
        try:
            yield
        finally:
            with self._cond:
                self._switching = False
                self._cond.notify_all()


#: The process's gate between device work and the profiler's switches.
DEVICE_GATE = DeviceGate()


def device_work():
    """Context for a loop step that launches kernels (a decode round, an
    engine iteration, a train step): a profiler session never starts or
    stops inside one. Enter it before any lock such a step takes, and
    never around a call that waits for another thread's device work
    (an RPC to a handler of this process): a thread that waits for the
    gate while holding what another thread's device work needs would
    deadlock with a pending switch."""
    return DEVICE_GATE.work()
