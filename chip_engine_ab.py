#!/usr/bin/env python3
"""Time chip_smoke.py's PagedGeneratorActor run alone, on one NVIDIA GPU.

    python3 chip_engine_ab.py ROOT

ROOT is a checkout (its ptype_tpu_torch/ and chip_smoke.py are used).
The script builds the kernels, then serves phase 4's eight requests
(optimus-125m at full width, 100-700 prompt tokens sharing a 96-token
prefix, 64 new tokens each, attn="kernel") three times, each on a new
engine, and prints one JSON line per run: its wall seconds, the decode
steps, the paged wrapper's calls and their summed host time. The first
run of a process carries one-off start-up costs. To compare two
checkouts, alternate them, one process each:

    for i in 1 2 3 4; do for r in A B; do python3 chip_engine_ab.py $r; done; done
"""

import json
import os
import sys
import time


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
    for run in range(3):
        eng = PagedGeneratorActor(cfg, params=params, attn="kernel", **kw)
        try:
            host[:] = [0.0, 0]
            steps0 = eng.Info()["engine_steps"]
            _, wall = chip_smoke.run_requests(eng, prompts, 64)
            steps = eng.Info()["engine_steps"] - steps0
        finally:
            eng.close()
        print(json.dumps({"root": root, "run": run, "wall_s": wall,
                          "decode_steps": steps, "paged_calls": host[1],
                          "paged_host_ms": host[0] * 1e3}), flush=True)


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    main(sys.argv[1])
