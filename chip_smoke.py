#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ptype_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each printing its own lines:

1. build — every CUDA kernel under ptype_tpu_torch/ops/csrc is compiled
   by nvcc for sm_90a (one nvcc per source, all at once); prints the
   build seconds and the card's name and power limit;
2. kernels — each kernel against its plain PyTorch version at the
   shapes the serving path gives it (bf16, plus f32), with the stated
   tolerance, its time, the plain version's time, one library call's
   time where one computes the same function, and the least time the
   card could take (the larger of bytes / 3.35 TB/s and operations /
   the peak rate of their type);
3. GeneratorActor.Generate at optimus-125m full width, prompt (4, 512),
   32 new tokens: the flash kernel must have been launched; per-step
   logits under teacher forcing are held against the same actor built
   with attn_impl="xla" (dense attention);
4. PagedGeneratorActor at optimus-125m full width, attn="kernel", 8
   concurrent requests of 100-700 tokens sharing a 96-token prefix,
   64 new tokens each: the paged kernel must run decode steps x 12
   layers times; greedy tokens in f32 equal the attn="gather" engine's;
   one bf16 decode step's logits agree between the two paths.

Then the kernels' JSON line, the card line, and as the last line
``{"ok": true, "device": {...}}``. Any failed check exits non-zero.
Weights are random, from a fixed seed. Without a CUDA device, or
outside a checkout, it exits non-zero and prints no result.
"""

import json
import os
import subprocess
import sys
import threading
import time
import traceback

HBM_BYTES_PER_S = 3.35e12            # H100 SXM
PEAK_OPS = {"bf16": 989e12, "f32": 67e12}   # dense tensor-core bf16; f32 FMA
TOL = {"flash": {"bf16": 3e-2, "f32": 2e-4},
       "paged": {"bf16": 1e-2, "f32": 1e-5}}
#: Logits tolerance between two bf16 attention paths at optimus-125m:
#: bf16 keeps 8 mantissa bits and the two paths round scores and
#: probabilities at different points through 12 layers, on logits of
#: standard deviation ~0.5.
LOGIT_TOL_BF16 = 0.1


class SmokeError(Exception):
    pass


def check(ok, msg):
    if not ok:
        raise SmokeError(msg)


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout else "unknown"


def time_ms(torch, fn, iters=10, flush=None):
    """Mean device time of ``fn`` over ``iters`` launches, each timed
    with CUDA events after the L2 cache was overwritten (the serving
    path meets these inputs cold: a decode step walks 12 bank layers)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        total += s.elapsed_time(e)
    return total / iters


def bound(nbytes, ops, kind):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[kind]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ----------------------------------------------------------- phase 2


def flash_case(torch, F, flash_mod, B, S, H, K, dtype, flush, gen):
    Dh = 128
    q = torch.randn(B, S, H, Dh, generator=gen, device="cuda").to(dtype)
    k = torch.randn(B, S, K, Dh, generator=gen, device="cuda").to(dtype)
    v = torch.randn(B, S, K, Dh, generator=gen, device="cuda").to(dtype)
    got = flash_mod.flash_attention(q, k, v, causal=True)
    want = flash_mod.flash_attention_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    kind = "bf16" if dtype == torch.bfloat16 else "f32"
    check(torch.isfinite(got).all().item(), "flash output not finite")
    check(err <= TOL["flash"][kind],
          f"flash {B}x{S}x{H}/{K} {kind}: max err {err} > "
          f"{TOL['flash'][kind]}")
    ms = time_ms(torch, lambda: flash_mod.flash_attention(q, k, v), 10,
                 flush)
    plain_ms = time_ms(
        torch, lambda: flash_mod.flash_attention_plain(q, k, v), 3, flush)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=K != H), 10, flush)
    esz = q.element_size()
    nbytes = (2 * B * S * H * Dh + 2 * B * S * K * Dh) * esz
    pairs = S * (S + 1) // 2                      # causal (q, k) pairs
    ops = 4 * B * H * Dh * pairs                  # QK^T and PV, 2 each
    bound_ms, by = bound(nbytes, ops, kind)
    return {"kernel": "flash_fwd", "B": B, "S": S, "H": H, "K": K,
            "Dh": Dh, "dtype": kind, "max_abs_err": err,
            "tol": TOL["flash"][kind], "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bound_ms, "bound_by": by}


def paged_case(torch, paged_mod, H, Kh, dtype, flush, gen):
    B, bt, nb, n_blocks, Dh = 8, 16, 64, 513, 128
    kc = torch.randn(n_blocks, bt, Kh, Dh, generator=gen,
                     device="cuda").to(dtype)
    vc = torch.randn(n_blocks, bt, Kh, Dh, generator=gen,
                     device="cuda").to(dtype)
    q = torch.randn(B, 1, H, Dh, generator=gen, device="cuda").to(dtype)
    # Each row's own blocks, as the pool hands them out.
    perm = torch.randperm(n_blocks - 1, generator=gen, device="cuda") + 1
    tables = perm[:B * nb].reshape(B, nb).to(torch.int32)
    # 0, a block boundary on each side, the last position of the reach.
    pos_list = [0, 15, 16, 100, 333, 512, 777, 1023]
    pos = torch.tensor(pos_list, dtype=torch.int32, device="cuda")
    got = paged_mod.paged_attention(q, kc, vc, tables, pos)
    want = paged_mod.paged_attention_plain(q, kc, vc, tables, pos)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    kind = "bf16" if dtype == torch.bfloat16 else "f32"
    check(torch.isfinite(got).all().item(), "paged output not finite")
    check(err <= TOL["paged"][kind],
          f"paged H={H} Kh={Kh} {kind}: max err {err} > "
          f"{TOL['paged'][kind]}")
    ms = time_ms(torch, lambda: paged_mod.paged_attention(
        q, kc, vc, tables, pos), 20, flush)
    plain_ms = time_ms(torch, lambda: paged_mod.paged_attention_plain(
        q, kc, vc, tables, pos), 5, flush)
    esz = q.element_size()
    toks = sum(p + 1 for p in pos_list)           # live keys this run
    nbytes = (2 * toks * Kh * Dh + 2 * B * H * Dh) * esz + 4 * B * (nb + 1)
    ops = 4 * H * Dh * toks
    bound_ms, by = bound(nbytes, ops, kind)
    return {"kernel": "paged_decode", "B": B, "H": H, "Kh": Kh, "Dh": Dh,
            "bt": bt, "nb": nb, "pos": pos_list, "dtype": kind,
            "max_abs_err": err, "tol": TOL["paged"][kind], "ms": ms,
            "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": bound_ms, "bound_by": by}


# ----------------------------------------------------------- phase 3


def teacher_forced_logits(torch, gen_mod, params, cfg, prompt, toks):
    """Logits of every generated position, feeding the given tokens."""
    B, S = prompt.shape
    cache = gen_mod.init_cache(cfg, B, max_seq=S + toks.shape[1],
                               device=prompt.device)
    with torch.no_grad():
        lg, cache = gen_mod.prefill(params, prompt, cfg, cache)
        out = [lg]
        for i in range(toks.shape[1] - 1):
            lg, cache = gen_mod.decode_step(params, toks[:, i], S + i, cfg,
                                            cache)
            out.append(lg)
    return torch.stack(out, dim=1)


# ----------------------------------------------------------- phase 4


def run_requests(engine, prompts, max_new):
    outs = [None] * len(prompts)
    errs = []

    def call(i):
        try:
            outs[i] = engine.Generate(prompts[i][None], max_new)
        except Exception as e:  # noqa: BLE001 — reported below
            errs.append(repr(e))

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(prompts))]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.monotonic() - t0
    check(not errs, f"engine requests failed: {errs}")
    check(all(o is not None for o in outs), "engine requests hung")
    return outs, wall


def paged_logits_pair(torch, gen_mod, params, cfg, prompts):
    """One bf16 decode step through the kernel and through the gather
    path, from the same prefilled bank."""
    bt, nb = 16, 64
    n_blocks = len(prompts) * nb + 1
    shape = (cfg.n_layers, n_blocks, bt, cfg.kv_heads, cfg.head_dim)
    kb = torch.zeros(shape, dtype=cfg.dtype, device="cuda")
    vb = torch.zeros_like(kb)
    tables = torch.zeros((len(prompts), nb), dtype=torch.int32,
                         device="cuda")
    last = []
    with torch.no_grad():
        for b, p in enumerate(prompts):
            p = p.to("cuda")
            n = len(p)
            blocks = torch.arange(1 + b * nb, 1 + (b + 1) * nb,
                                  dtype=torch.int32, device="cuda")
            tables[b] = blocks
            lg, _, _ = gen_mod.prefill_paged_chunk(
                params, p[None], 0, n, cfg, kb, vb, blocks)
            last.append(int(lg.argmax()))
        pos = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                           device="cuda")
        tok = torch.tensor(last, device="cuda")
        wr_b = tables[torch.arange(len(prompts), device="cuda"),
                      (pos // bt).long()]
        outs = {}
        for impl in ("kernel", "gather"):
            lg, _, _ = gen_mod.decode_step_paged(
                params, tok, pos, cfg, kb.clone(), vb.clone(), tables, wr_b,
                pos % bt, attn_impl=impl)
            outs[impl] = lg
    return outs["kernel"], outs["gather"]


def main():
    import torch

    if not torch.cuda.is_available():
        raise SmokeError("no CUDA device: chip_smoke.py runs on a GPU")
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "ptype_tpu_torch")):
        raise SmokeError("ptype_tpu_torch/ not found beside chip_smoke.py: "
                         "run from a checkout of the repository")
    sys.path.insert(0, root)
    import torch.nn.functional as F

    from ptype_tpu_torch.models import generate as gen_mod
    from ptype_tpu_torch.models import transformer as tfm
    from ptype_tpu_torch.models.weights import init_params
    from ptype_tpu_torch.ops import _build
    from ptype_tpu_torch.ops import flash_attention as flash_mod
    from ptype_tpu_torch.ops import paged_attention as paged_mod
    from ptype_tpu_torch.serve import GeneratorActor
    from ptype_tpu_torch.serve_engine import PagedGeneratorActor

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()

    # 1. build
    t0 = time.monotonic()
    built = _build.build_all()
    regs = {n: [ln.strip() for ln in log.splitlines() if "registers" in ln]
            for n, log in _build.build_logs.items()}
    emit({"phase": "build", "seconds": time.monotonic() - t0,
          "built": built, "ptxas": regs, "card": card})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. kernels against their plain versions
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for dt in (torch.bfloat16, torch.float32):
        for H, Kh in ((6, 6), (32, 8)):
            cases.append(paged_case(torch, paged_mod, H, Kh, dt, flush, g))
            emit(cases[-1])
    for B, S, H, K, dt in ((4, 512, 6, 6, torch.bfloat16),
                           (4, 1024, 6, 6, torch.bfloat16),
                           (1, 2048, 32, 8, torch.bfloat16),
                           (4, 512, 6, 6, torch.float32)):
        cases.append(flash_case(torch, F, flash_mod, B, S, H, K, dt, flush,
                                g))
        emit(cases[-1])
    del flush

    # 3. GeneratorActor at optimus-125m
    cfg = tfm.preset("optimus-125m")
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    actor = GeneratorActor(cfg, params=params, device="cuda")
    gc = torch.Generator().manual_seed(1)
    prompt = torch.randint(1, cfg.vocab_size, (4, 512), generator=gc)
    prompt = prompt.to("cuda")
    flash_mod.flash_attention.launches = 0
    paged_mod.paged_attention.launches = 0
    t0 = time.monotonic()
    out = actor.Generate(prompt, 32)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    flash_launches = flash_mod.flash_attention.launches
    check(flash_launches > 0, "GeneratorActor.Generate launched no flash "
          "kernel")
    check(tuple(out.shape) == (4, 32), f"Generate shape {tuple(out.shape)}")
    check(bool(((out >= 0) & (out < cfg.vocab_size)).all()),
          "Generate tokens out of range")
    tf_flash = teacher_forced_logits(torch, gen_mod, params, cfg, prompt,
                                     out)
    check(torch.equal(tf_flash.argmax(-1), out),
          "teacher-forced flash logits do not reproduce Generate's tokens")
    cfg_xla = tfm.preset("optimus-125m", attn_impl="xla")
    tf_xla = teacher_forced_logits(torch, gen_mod, params, cfg_xla, prompt,
                                   out)
    diff = (tf_flash - tf_xla).abs()
    check(torch.isfinite(tf_flash).all().item(), "logits not finite")
    check(diff.max().item() <= LOGIT_TOL_BF16,
          f"flash vs xla logits differ by {diff.max().item()}")
    emit({"phase": "generator_actor", "prompt": [4, 512], "max_new": 32,
          "flash_launches": flash_launches, "seconds": wall,
          "tokens_per_s": 4 * 32 / wall,
          "tf_logits_max_abs_diff": diff.max().item(),
          "tf_logits_mean_abs_diff": diff.mean().item(),
          "tf_logits_std": tf_xla.std().item(), "tol": LOGIT_TOL_BF16,
          "argmax_agree": (tf_flash.argmax(-1) == tf_xla.argmax(-1))
          .float().mean().item()})
    del actor, tf_flash, tf_xla

    # 4. PagedGeneratorActor at optimus-125m
    gp = torch.Generator().manual_seed(2)
    shared = torch.randint(1, cfg.vocab_size, (96,), generator=gp)
    lens = (100, 180, 260, 340, 420, 500, 600, 700)
    prompts = [torch.cat([shared, torch.randint(
        1, cfg.vocab_size, (n - 96,), generator=gp)]) for n in lens]
    max_new = 64
    kw = dict(device="cuda", n_slots=8, block_tokens=16, prefill_chunk=256)
    eng = PagedGeneratorActor(cfg, params=params, attn="kernel", **kw)
    try:
        flash_mod.flash_attention.launches = 0
        paged_mod.paged_attention.launches = 0
        steps0 = eng.Info()["engine_steps"]
        outs_bf16, wall = run_requests(eng, prompts, max_new)
        torch.cuda.synchronize()
        paged_launches = paged_mod.paged_attention.launches
        info = eng.Info()
        steps = info["engine_steps"] - steps0
        check(paged_launches == steps * cfg.n_layers,
              f"paged launches {paged_launches} != decode steps {steps} x "
              f"{cfg.n_layers}")
        check(steps > 0, "no decode step ran")
        check(all(tuple(o.shape) == (1, max_new) for o in outs_bf16),
              "engine output shapes")
        check(eng.pool.check_invariants() == [], "pool invariants")
    finally:
        eng.close()
    emit({"phase": "paged_engine", "requests": len(prompts),
          "prompt_lens": list(lens), "shared_prefix": 96,
          "max_new": max_new, "decode_steps": steps,
          "paged_launches": paged_launches, "seconds": wall,
          "tokens_per_s": len(prompts) * max_new / wall,
          "prefix_hit_rate": info["prefix_hit_rate"],
          "max_live_slots": info["max_live_slots"],
          "prefill_stall_ms": info["prefill_stall_ms"]})
    paged_main_launches = paged_launches

    # f32: greedy tokens of the kernel and gather engines are identical.
    cfg32 = tfm.preset("optimus-125m", dtype=torch.float32)
    got = {}
    for attn in ("kernel", "gather"):
        e = PagedGeneratorActor(cfg32, params=params, attn=attn, **kw)
        try:
            got[attn], _ = run_requests(e, prompts, max_new)
        finally:
            e.close()
    same = all(torch.equal(a, b) for a, b in zip(got["kernel"],
                                                   got["gather"]))
    check(same, "f32 greedy tokens differ between kernel and gather engines")
    lk, lg = paged_logits_pair(torch, gen_mod, params, cfg, prompts)
    ldiff = (lk - lg).abs().max().item()
    check(ldiff <= LOGIT_TOL_BF16, f"bf16 paged logits differ by {ldiff}")
    emit({"phase": "paged_parity", "f32_greedy_identical": same,
          "bf16_step_logits_max_abs_diff": ldiff, "tol": LOGIT_TOL_BF16})

    def main_row(name, route, source, replaces, launches, row):
        return {"name": name, "route": route, "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "library_ms": row["library_ms"], "dtype": row["dtype"]}

    flash_row = next(c for c in cases if c["kernel"] == "flash_fwd"
                     and c["S"] == 512 and c["dtype"] == "bf16")
    paged_row = next(c for c in cases if c["kernel"] == "paged_decode"
                     and c["H"] == 6 and c["dtype"] == "bf16")
    emit({"kernels": [
        main_row("flash_fwd", "cuda",
                 "ptype_tpu_torch/ops/csrc/flash_fwd.cu",
                 "ptype_tpu/ops/flash_attention.py:160", flash_launches,
                 flash_row),
        main_row("paged_decode", "cuda",
                 "ptype_tpu_torch/ops/csrc/paged_decode.cu",
                 "ptype_tpu/ops/paged_attention.py:149",
                 paged_main_launches, paged_row)]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": count}})


if __name__ == "__main__":
    try:
        main()
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
    except Exception:  # noqa: BLE001 — any failure is a failed run
        traceback.print_exc()
        sys.exit(1)
