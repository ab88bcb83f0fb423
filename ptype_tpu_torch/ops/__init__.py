"""The port's kernels: each a CUDA C++ source under ``csrc/`` for
Hopper, a wrapper that launches it on CUDA tensors and counts the
launches, and its plain PyTorch version for CPU tensors —
:mod:`~ptype_tpu_torch.ops.flash_attention` (forward, dq, dk/dv) and
:mod:`~ptype_tpu_torch.ops.paged_attention`.

A wrapper counts each launch with :func:`count_launch`, in its
function's ``launches`` attribute. Inside :func:`launch_tally` the
calling thread's launches are also tallied apart: a CUDA graph capture
(``serve_engine/programs.py``) records launches without running them,
takes its tally back, and adds it at each replay."""

import contextlib
import threading

_tally = threading.local()


def count_launch(fn) -> None:
    """One launch of ``fn``'s kernel: ``fn.launches``, and the tally of
    a :func:`launch_tally` open in this thread."""
    fn.launches += 1
    counts = getattr(_tally, "counts", None)
    if counts is not None:
        counts[fn] = counts.get(fn, 0) + 1


@contextlib.contextmanager
def launch_tally():
    """Yields ``{wrapper: launches}`` of the launches this thread's
    wrappers count inside the block (other threads' are not in it)."""
    prior = getattr(_tally, "counts", None)
    _tally.counts = counts = {}
    try:
        yield counts
    finally:
        _tally.counts = prior
