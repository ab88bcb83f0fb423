#!/usr/bin/env python3
"""Time chip_smoke.py's PagedGeneratorActor run alone, on one NVIDIA GPU.

    python3 chip_engine_ab.py ROOT

ROOT is a checkout (its ptype_tpu_torch/ and chip_smoke.py are used).
The script builds the kernels, then serves phase 4's eight requests
(optimus-125m at full width, 100-700 prompt tokens sharing a 96-token
prefix, 64 new tokens each, attn="kernel") five times, each on a new
engine, and prints one JSON line per run: its wall seconds, the decode
steps and their summed wall seconds, the paged wrapper's Python calls
and their summed host time (where the greedy step is a replayed CUDA
graph, the wrapper runs only in its warm-up and its capture), and the
target prefill chunks: their count and summed times, split into the
chunks that captured their bucket's program and the others (replayed;
"eager" where the checkout runs chunks eagerly). A chunk's times are
its host wall (the call's) and its stream span (CUDA events around the
call on the engine's stream, read after the run: no synchronisation is
added). Each engine then serves the requests a second time (their
prompts now resident: each prefills its tail), printed as run ``R.1``.
The first run of a process carries one-off start-up costs. A last run
profiles the first two decode steps with every slot live (the first
follows the last admission) and the first chunk of bucket 256 that is
neither its prompt's last nor its bucket's first in the engine, and
prints, for each, its wall and device ms, kernel and graph launches,
kernel records on the card, host-to-device copies and synchronising
calls. To compare two checkouts, alternate them, one process each:

    for i in 1 2 3 4; do for r in A B; do python3 chip_engine_ab.py $r; done; done

    python3 chip_engine_ab.py ROOT --sampled

serves the same requests sampled instead, as chip_smoke.py's
sampled_engine phase does (``chip_smoke.SAMPLING``, request i with seed
i + 1, queued in order) on its plain engine (the first
``chip_smoke.SHORT_LAYERS`` layers of the same weights), once on each
of five new engines, with each run's TTFT and TPOT p50 and p99 from the
engine's ledger (a registry of its own); then the same profile.
"""

import json
import os
import sys
import time


#: Host calls that wait for the card.
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")


def step_profile(torch, step):
    """``step()`` under torch.profiler, synchronized: wall and device ms,
    ``cudaLaunchKernel`` and ``cudaGraphLaunch`` calls, kernel and
    host-to-device copy records on the card and synchronising calls by
    name (one ``cudaDeviceSynchronize`` is this function's own). Kept here rather than taken from ROOT's
    chip_smoke.py, so an older checkout is profiled the same way."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    row = {"wall_ms": wall * 1e3, "device_ms": 0.0, "launches": 0,
           "graph_launches": 0, "device_kernels": 0, "h2d_copies": 0,
           "sync_calls": {}}
    for ev in prof.key_averages():
        if "CUDA" in str(getattr(ev, "device_type", "")):
            row["device_ms"] += getattr(ev, "self_device_time_total", 0) / 1e3
            row["h2d_copies"] += ev.count if "Memcpy HtoD" in ev.key else 0
            row["device_kernels"] += (0 if ev.key.startswith(
                ("Memcpy", "Memset")) else ev.count)
        elif ev.key.startswith("cudaLaunchKernel"):
            row["launches"] += ev.count
        elif ev.key.startswith("cudaGraphLaunch"):
            row["graph_launches"] += ev.count
        elif ev.key in SYNC_CALLS:
            row["sync_calls"][ev.key] = ev.count
    return row


def next_chunk(eng, row, budget):
    """The chunk ``_prefill_one_chunk(row, budget)`` will run: (n, its
    bucket, whether it is the prompt's last), or None before the row's
    prefix-reuse walk (a row's first chunk) and for a migrated row.
    Kept here, as ``step_profile`` is, so an older checkout is read the
    same way."""
    if getattr(row, "migrated", False) or row.prefill_pos < 0:
        return None
    start, L = row.prefill_pos, len(row.prompt)
    n = max(1, min(eng.prefill_chunk, L - start, budget))
    return n, max(16, 1 << (n - 1).bit_length()), start + n >= L


class ChunkClock:
    """Times each target prefill chunk of ``eng``: host wall, and the
    stream span between CUDA events recorded before and after the call
    (read by :meth:`summary`, after the run). A chunk that grew the
    engine's programs captured its bucket; of its host wall,
    ``capture_ms`` is the capture's own (``programs.capture``: the
    graph's recording and instantiation), the rest mostly the warm-up
    call of the body."""

    def __init__(self, torch, eng):
        self.torch, self.rows, self.capture_s = torch, [], [0.0]
        chunk = eng._prefill_one_chunk
        staged = hasattr(eng, "_chunk")  # chunks run as programs

        def timed(row, budget):
            n0 = len(eng._programs.progs)
            self.capture_s[0] = 0.0
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            t0 = time.perf_counter()
            out = chunk(row, budget)
            host = time.perf_counter() - t0
            e1.record()
            kind = ("captured" if len(eng._programs.progs) > n0
                    else "replayed" if staged else "eager")
            self.rows.append((kind, out[0], host, e0, e1,
                              self.capture_s[0]))
            return out

        eng._prefill_one_chunk = timed
        if staged:
            from ptype_tpu_torch.serve_engine import programs

            capture = getattr(programs.capture, "untimed", programs.capture)

            def timed_capture(*a):
                t0 = time.perf_counter()
                try:
                    return capture(*a)
                finally:
                    self.capture_s[0] += time.perf_counter() - t0

            timed_capture.untimed = capture
            programs.capture = timed_capture

    def summary(self):
        self.torch.cuda.synchronize()
        out = {"chunks": len(self.rows), "chunk_tokens": 0}
        for kind, n, host, e0, e1, cap in self.rows:
            d = out.setdefault(kind, {"chunks": 0, "tokens": 0,
                                      "host_ms": 0.0, "span_ms": 0.0})
            d["chunks"] += 1
            d["tokens"] += n
            d["host_ms"] += host * 1e3
            d["span_ms"] += e0.elapsed_time(e1)
            if kind == "captured":
                d["capture_ms"] = d.get("capture_ms", 0.0) + cap * 1e3
            out["chunk_tokens"] += n
        self.rows = []
        return out


def main(root, sampled=False):
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_engine_ab: no CUDA device")
    sys.path.insert(0, os.path.abspath(root))
    import chip_smoke
    from ptype_tpu_torch.models import generate as gen_mod
    from ptype_tpu_torch.models import transformer as tfm
    from ptype_tpu_torch.models.weights import init_params
    from ptype_tpu_torch.ops import _build
    from ptype_tpu_torch.ops import paged_attention as paged_mod
    from ptype_tpu_torch.metrics import MetricsRegistry
    from ptype_tpu_torch.serve_engine import PagedGeneratorActor

    _build.build_all()
    cfg = tfm.preset("optimus-125m")
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    # Phase 4's prompts, as chip_smoke.main builds them inline.
    gp = torch.Generator().manual_seed(2)
    shared = torch.randint(1, cfg.vocab_size, (96,), generator=gp)
    prompts = [torch.cat([shared, torch.randint(
        1, cfg.vocab_size, (n - 96,), generator=gp)])
        for n in (100, 180, 260, 340, 420, 500, 600, 700)]
    if sampled:
        params, cfg = gen_mod.truncated_draft_params(
            params, cfg, chip_smoke.SHORT_LAYERS)
    seeds = list(range(1, len(prompts) + 1))

    def serve(eng):
        """Phase 4's requests on ``eng``; returns the wall seconds."""
        if not sampled:
            return chip_smoke.run_requests(eng, prompts, 64)[1]
        t0 = time.monotonic()
        chip_smoke.run_in_order(eng, prompts, 64, seeds)
        return time.monotonic() - t0

    # The decode step imports the wrapper by name at each call, so the
    # timed stand-in is what it runs.
    wrapper, host = paged_mod.paged_attention, [0.0, 0]

    def timed(*args):
        t0 = time.perf_counter()
        out = wrapper(*args)
        host[0] += time.perf_counter() - t0
        host[1] += 1
        return out

    timed.launches = 0
    paged_mod.paged_attention = timed
    kw = dict(device="cuda", n_slots=8, block_tokens=16, prefill_chunk=256)
    for run in range(5):
        # Its own registry: the ledger's percentiles are this engine's.
        eng = PagedGeneratorActor(cfg, params=params, attn="kernel",
                                  metrics_registry=MetricsRegistry(), **kw)
        step, step_s = eng._plain_step, [0.0]

        def timed_step():
            t0 = time.perf_counter()
            step()
            step_s[0] += time.perf_counter() - t0

        eng._plain_step = timed_step
        clock = ChunkClock(torch, eng)
        try:
            for again in range(1 if sampled else 2):
                host[:] = [0.0, 0]
                step_s[0] = 0.0
                steps0 = eng.Info()["engine_steps"]
                wall = serve(eng)
                info = eng.Info()
                steps = info["engine_steps"] - steps0
                print(json.dumps({
                    "root": root, "run": f"{run}.{again}",
                    "sampled": sampled, "wall_s": wall,
                    "decode_steps": steps, "steps_s": step_s[0],
                    "paged_calls": host[1], "paged_host_ms": host[0] * 1e3,
                    "prefill": clock.summary(),
                    **({k: info[k] for k in ("ttft_p50_ms", "ttft_p99_ms",
                                             "tpot_p50_ms", "tpot_p99_ms")}
                       if sampled else {})}), flush=True)
        finally:
            eng.close()
    paged_mod.paged_attention = wrapper
    eng = PagedGeneratorActor(cfg, params=params, attn="kernel", **kw)
    step, chunk, rows = eng._plain_step, eng._prefill_one_chunk, []
    chunk_row, seen = {}, set()

    def profiled():
        if len(rows) == 2 or not eng._active.all():
            return step()
        rows.append(step_profile(torch, step))

    def profiled_chunk(row, budget):
        cut = next_chunk(eng, row, budget)
        ready = (cut is not None and cut[1] == 256 and not cut[2]
                 and not chunk_row)
        if ready and hasattr(eng, "_chunk"):  # the bucket's program
            ready = any(key[0] == "serve.prefill_chunk"
                        and key[1].startswith("C=256,")
                        for key in eng._programs.progs)
        elif ready:  # an eager chunk after one of its bucket
            ready = 256 in seen
        if cut is not None:
            seen.add(cut[1])
        if not ready:
            return chunk(row, budget)
        out = []
        chunk_row.update(step_profile(torch, lambda: out.append(
            chunk(row, budget))), n=cut[0], C=cut[1])
        return out[0]

    eng._plain_step, eng._prefill_one_chunk = profiled, profiled_chunk
    try:
        serve(eng)
    finally:
        eng.close()
    print(json.dumps({"root": root, "sampled": sampled,
                      "profiled_steps": rows,
                      "profiled_chunk": chunk_row}), flush=True)


if __name__ == "__main__":
    if len(sys.argv) not in (2, 3) or sys.argv[2:] not in ([],
                                                          ["--sampled"]):
        sys.exit(__doc__)
    main(sys.argv[1], sampled=sys.argv[2:] == ["--sampled"])
