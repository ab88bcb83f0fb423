"""The paged engine's compiled programs: a step body captured once as a
``torch.cuda.CUDAGraph`` and replayed — the port's counterpart of the
reference engine's jitted programs (``ptype_tpu/serve_engine/engine.py``:
``_engine_step``, one program a sampling mode; ``_window_prog``, one a
``(W, sampled)`` key; ``_chunk_prog`` and ``_draft_chunk_prog``, one a
prefill chunk bucket ``C``).

A body reads and writes only tensors whose storage outlives its graph
(the parameter trees, the KV banks, the mirror's and the prefill
chunks' static input buffers) and returns its results. Keys are
captured lazily, at their first call, as the reference compiles. On the
first call of a key the body runs eagerly on the engine's capture
stream (the warm-up, and that call's result), then is captured once;
every later call replays the graph and returns the outputs the capture
left in the graph pool, which each replay overwrites. Nothing runs
while a capture records, so the warm-up's writes are the call's only
effect. Off CUDA a body just runs.

A sampled body draws from generators that outlive its graph (the
engine's per-slot ones). Each is registered on the graph before its
capture begins (``CUDAGraph.register_generator_state``): the capture
draws nothing from it, so it stays where the warm-up left it, and each
replay reads its seed and offset as they are then and advances it by
what the capture drew — a replayed draw continues the eager stream, and
a generator whose state was set in place since (an admission) draws
its new stream.

Captures are booked through the armed :mod:`jitwatch` as compiles
(``on_compile(fn, signature)``), run under a ``serve.capture``
sanctioned transfer (a capture synchronises the device), one at a time
in the process, in ``thread_local`` mode so other threads' CUDA calls
go on, and into one memory pool an engine's graphs share (they replay
one at a time on one stream). A capture that fails raises.

The kernel wrappers count launches in Python (``ops.count_launch``): a
capture tallies its own thread's, takes them back (it ran nothing), and
each replay adds them, so the counters count kernels that ran.
"""

from __future__ import annotations

import torch

from ptype_tpu_torch import jitwatch, lockcheck
from ptype_tpu_torch.ops import launch_tally

#: One capture at a time in the process.
_CAPTURE = lockcheck.lock("serve_engine.capture")


class Program:
    """One captured body: its graph, the outputs the capture left in
    the graph pool, and the kernel launches one replay makes
    (``{wrapper: n}``)."""

    def __init__(self, graph, outputs, launches: dict):
        self.graph = graph
        self.outputs = outputs
        self.launches = launches
        self.replays = 0

    def replay(self):
        """Launch the graph on the current stream; returns the static
        outputs (valid once the stream has run it)."""
        self.graph.replay()
        for fn, n in self.launches.items():
            fn.launches += n
        self.replays += 1
        return self.outputs


def capture(body, pool, stream, generators=()) -> Program:
    """Capture ``body()`` on ``stream`` into ``pool``, with the
    ``generators`` it draws from registered first. The wrappers' launch
    counts made while it records are taken back and kept as the
    program's launches a replay."""
    graph = torch.cuda.CUDAGraph()
    for g in generators:
        graph.register_generator_state(g)
    with launch_tally() as launches:
        with torch.cuda.graph(graph, pool=pool, stream=stream,
                              capture_error_mode="thread_local"):
            outputs = body()
    for fn, n in launches.items():
        fn.launches -= n
    return Program(graph, outputs, launches)


class Programs:
    """An engine's programs by ``(fn, signature)``: :meth:`run` captures
    a body at its key's first call on CUDA and replays it after; off
    CUDA it runs the body. ``generators``: those the body draws from."""

    def __init__(self, device: torch.device):
        self.device = device
        self.progs: dict[tuple[str, str], Program] = {}
        self._stream = None
        self._pool = None

    def run(self, fn: str, signature: str, body, generators=()):
        if self.device.type != "cuda":
            return body()
        prog = self.progs.get((fn, signature))
        if prog is not None:
            return prog.replay()
        cur = torch.cuda.current_stream(self.device)
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        # The warm-up on the capture stream (lazy library state, such as
        # a stream's cuBLAS workspace, is made outside the capture). Its
        # outputs are read on ``cur`` by a blocking copy before they are
        # dropped, so their blocks need no record on ``cur``.
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            out = body()
        cur.wait_stream(self._stream)
        with jitwatch.sanctioned_transfer("serve.capture"), _CAPTURE:
            self.progs[(fn, signature)] = capture(
                body, self._pool, self._stream, generators)
        if jitwatch._watch is not None:
            jitwatch._watch.on_compile(fn, signature)
        return out

    def close(self) -> None:
        """Drop the graphs (their pool is freed with the last one)."""
        self.progs.clear()
