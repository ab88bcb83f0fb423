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
graph, the wrapper runs only in its warm-up and its capture). The first
run of a process carries one-off start-up costs. A last run profiles
the first two decode steps with every slot live (the first follows the
last admission) and prints, for each, its wall and device ms, kernel
and graph launches, kernel records on the card, host-to-device copies
and synchronising calls. To compare two checkouts, alternate them, one
process each:

    for i in 1 2 3 4; do for r in A B; do python3 chip_engine_ab.py $r; done; done
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


def main(root):
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_engine_ab: no CUDA device")
    sys.path.insert(0, os.path.abspath(root))
    import chip_smoke
    from ptype_tpu_torch.models import transformer as tfm
    from ptype_tpu_torch.models.weights import init_params
    from ptype_tpu_torch.ops import _build
    from ptype_tpu_torch.ops import paged_attention as paged_mod
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
        eng = PagedGeneratorActor(cfg, params=params, attn="kernel", **kw)
        step, step_s = eng._plain_step, [0.0]

        def timed_step():
            t0 = time.perf_counter()
            step()
            step_s[0] += time.perf_counter() - t0

        eng._plain_step = timed_step
        try:
            host[:] = [0.0, 0]
            steps0 = eng.Info()["engine_steps"]
            _, wall = chip_smoke.run_requests(eng, prompts, 64)
            steps = eng.Info()["engine_steps"] - steps0
        finally:
            eng.close()
        print(json.dumps({"root": root, "run": run, "wall_s": wall,
                          "decode_steps": steps, "steps_s": step_s[0],
                          "paged_calls": host[1],
                          "paged_host_ms": host[0] * 1e3}), flush=True)
    paged_mod.paged_attention = wrapper
    eng = PagedGeneratorActor(cfg, params=params, attn="kernel", **kw)
    step, rows = eng._plain_step, []

    def profiled():
        if len(rows) == 2 or not eng._active.all():
            return step()
        rows.append(step_profile(torch, step))

    eng._plain_step = profiled
    try:
        chip_smoke.run_requests(eng, prompts, 64)
    finally:
        eng.close()
    print(json.dumps({"root": root, "profiled_steps": rows}), flush=True)


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    main(sys.argv[1])
