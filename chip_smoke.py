#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ptype_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each printing its own lines:

1. build — every CUDA kernel under ptype_tpu_torch/ops/csrc is compiled
   by nvcc for sm_90a (one nvcc per source, all at once); prints the
   build seconds, each kernel's registers and spills, its counts of
   HGMMA (wgmma), UTMALDG (TMA load) and HMMA (mma.sync) instructions
   from cuobjdump -sass, and the card's name and power limit. The bf16
   flash forward, dq and dk/dv kernels must contain HGMMA and UTMALDG;
2. kernels — each kernel against its plain PyTorch version at the
   shapes the serving and training paths give it, at optimus-125m's
   head width (Dh=128) and optimus-moe's (Dh=64) (bf16, plus f32), with
   the stated tolerance, its time, the plain version's time, one
   library call's time where one computes the same function (for the
   backward kernels: torch.autograd.grad through
   F.scaled_dot_product_attention) and the ratio of the two
   (vs_library), and the least time the card could take (the larger of
   bytes / 3.35 TB/s and operations / the peak rate of their type). The
   paged rows also give the kernels' device time per call with no host
   time in it (device_ms: calls queued behind a sleeping kernel, timed
   by CUDA events) and the wrapper's host time per call (host_us);
3. GeneratorActor.Generate at optimus-125m full width, prompt (4, 512),
   32 new tokens: the flash kernel must have been launched once a layer;
   per-step logits under teacher forcing reproduce the tokens and are
   held against the same actor built with attn_impl="xla" (dense
   attention);
4. PagedGeneratorActor at optimus-125m full width, attn="kernel", 8
   concurrent requests of 100-700 tokens sharing a 96-token prefix,
   64 new tokens each: the paged kernel must run decode steps x 12
   layers times; greedy tokens in f32 equal the attn="gather" engine's;
   one bf16 decode step's logits agree between the two paths;
   cluster_rpc: phases 3 and 4 served over the port's cluster plane.
   The script seeds a TCP coordinator with ``join`` (lease TTL 1 s)
   and starts a server process of itself (``--actor-server COORD``:
   a GeneratorActor and an 8-slot PagedGeneratorActor at optimus-125m
   from seed 0, joined as service ``llm``); ``new_client("llm")``
   calls Generate on the (4, 512) int32 CUDA prompt, 32 new tokens (rpc,
   in-process, in-process, rpc), and sends phase 4's requests queued in
   a fixed order behind the server's dispatch lock: every reply lands
   on the card equal to in-process actors' tokens, and the server's
   counters show 24 flash launches (two prefills) and decode steps x
   12 paged ones. It prints the empty-call round trip (p50/p99 us)
   over TCP and through _LocalConn, GB/s each way for a 256 MB f32
   CUDA tensor, the ms from the server's join to the client's first
   connection, and after SIGKILL of the server the ms to the
   registry's empty snapshot (at most TTL + sweep + 0.25 s) and to
   NoClientAvailableError. The native wire must load on both sides;
5. Trainer at optimus-125m full width, B=16, S=1024, 8 AdamW steps on
   one repeated batch: forward, dq and dk/dv kernels each launched
   steps x 12 times, a finite loss that falls; steps/s, tokens/s, MFU
   against the H100's bf16 peak, peak memory; and on one B=4 batch each
   parameter's gradient through the kernels against the same gradient
   through dense attention (attn_impl="xla");
   then phases 3-5 at optimus-moe full width (moe_generator: the
   attention paths held to each other in f32, since a bf16 difference
   flips some tokens' experts; moe_mlp_syncs: one decode-shape MoE MLP
   makes no host sync; moe_paged_engine and moe_paged_parity: f32
   engine tokens equal the contiguous path's; moe_trainer: a finite
   router aux), and spec_engine: optimus-125m's engine with a 2-layer
   truncated draft, k=4, beside a plain engine (bf16, attn="kernel":
   plain, spec, spec, plain), then in f32 on the gather path the two
   engines' greedy tokens must be identical and each window must
   synchronize with the host exactly once; then, at optimus-125m:
   sampled_engine: phase 4's requests sampled (temperature 0.8, top-k
   50, top-p 0.95, seeds 1-8) on the kernel engine and on the
   speculative one, queued in a fixed order: two bf16 runs in fresh
   engines give the same tokens, in f32 a co-batched row equals its
   solo run (on the speculative engine while the row has k+1 tokens to
   go), a sampled window reads the host once; serving_ledger: phase 4's
   run as its ServingLedger saw it (TTFT, TPOT and e2e percentiles, 8
   records retired complete, one TPOT sample a token after the first,
   the seams' cost), and no host sync from the ledger's modules in a
   plain step; disagg_engine: a prefill-class and a decode-class kernel
   engine migrating phase 4's requests one after another, f32 over the
   exact wire equal to a unified engine's tokens, bf16 over the exact
   and the q8 wire (q8 at (1 + 4/512)/2 of the exact bytes, residuals
   on the prefill side), 42 dedup hits, paged launches = the decode
   engine's steps x 12 and none from the prefill engine, both pools'
   invariants; batching_generator: BatchingGeneratorActor with 8
   concurrent greedy requests, equal lengths (8 x 512: one batch, the
   flash kernel once a layer) and phase 4's mixed lengths (one batch,
   no flash launch), tokens equal to solo runs in f32;
   store_dp: StoreDPTrainer through the TensorStore on a world-1 NCCL
   group (file rendezvous), optimus-125m, phase 5's batch and
   optimizer, 4 steps from one init on each rung of STORE_DP_RUNGS
   (overlap False/"drain"/True, the bf16 and int8+EF wires, ZeRO 1/2/3,
   ZeRO-2 on int8): the first rung equal to the Trainer, drain to the
   first elementwise, overlap=True (its own per-bucket apply) and ZeRO
   in loss and in each leaf's movement, the compressed wires within
   5e-3 of it and falling, the flash kernels steps x 12 times a rung,
   ZeRO-3 holding no replicated leaves, no host sync from the data
   plane in a steady step; per rung the step time against the
   Trainer's, tokens/s, MFU, peak memory, buckets, collective calls and
   wire bytes a step, the optimizer state's bytes; the planted faults'
   readings; the ladder and overlap probes (S=128); then in f32 compute
   at B=4 every zero-0 overlap mode and ZeRO 1/2/3 held to the first
   elementwise, and each planted fault rejected by that check;
   checkpoint: at optimus-125m (B=16, S=1024) a Trainer saves step 2
   in the background while steps 3-4 run, and a fresh Trainer restored
   from it runs steps 3-4 with the same losses, params and moments bit
   for bit; the same for ZeRO-2 on the world-1 NCCL mesh through
   ZeroCheckpoint + StoreCheckpoint; a ZeroCheckpoint of seeded moments
   (optimus-125m's plan) written by 2 gloo CPU rank processes of this
   script (``--zero-writer``, started at the phase's start and joined
   before its first timed figure) restores on the card byte for byte;
   bytes written, save, snapshot (first and with its pinned buffers
   reused), background write and restore ms, the step while the write
   runs and without;
   elastic: ElasticZeroTrainer (ZeRO-2) with rank 0 registered and a
   second simulated registration of the same rank on a local
   coordinator (lease TTL 0.5 s); inject_loss on it, MembershipChanged,
   recover (a 1 -> 1 reshard), the retried step: losses and params
   equal to a run without the fault; the detection time, reshard_ms,
   and measure_reshard's live and checkpoint recoveries in step units;
6. after every host-timed phase (a process that has run a
   torch.profiler session launches kernels more slowly afterwards),
   under torch.profiler (wall, device-busy and idle share, device time
   by kernel family, top host ops): a new engine's first decode
   iteration with every slot live (phase 4's configuration, 32 new
   tokens); one train step each of optimus-125m and optimus-moe, the
   latter with its router, dispatch, experts and combine named apart;
   one speculation window with every slot live, draft, verify and
   accept named apart; one StoreDPTrainer step each of (ZeRO 0,
   overlap) and (ZeRO-2, exact), NCCL and the bucket pack (cat) among
   the families.

Then the kernels' JSON line, the card line, and as the last line
``{"ok": true, "device": {...}}``. Any failed check exits non-zero.
Weights are random, from a fixed seed. Without a CUDA device, or
outside a checkout, it exits non-zero and prints no result.
"""

import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import traceback

HBM_BYTES_PER_S = 3.35e12            # H100 SXM
PEAK_OPS = {"bf16": 989e12, "f32": 67e12}   # dense tensor-core bf16; f32 FMA
TOL = {"flash": {"bf16": 3e-2, "f32": 2e-4},
       "paged": {"bf16": 1e-2, "f32": 1e-5}}
#: Backward kernels vs plain, as max abs error over the largest plain
#: magnitude: f32 sums the same terms in another order; bf16 rounds P and
#: dS to bf16 (8-bit mantissa) before the tensor-core products, where
#: the plain version keeps f32.
BWD_TOL = {"bf16": 2e-2, "f32": 1e-4}
#: Per-parameter gradient through the kernels vs through dense attention,
#: both bf16, as ||g_flash - g_dense|| / ||g_dense||: the two round
#: probabilities, dP and dS to bf16 at different points in 12 layers.
GRAD_REL_TOL = 5e-2
#: Logits tolerance between two bf16 attention paths at optimus-125m:
#: bf16 keeps 8 mantissa bits and the two paths round scores and
#: probabilities at different points through 12 layers, on logits of
#: standard deviation ~0.5.
LOGIT_TOL_BF16 = 0.1
#: The same in f32 at optimus-moe: both paths sum the same terms in other
#: orders (the f32 kernel is within 1e-6 of plain attention); a token
#: whose top-2 experts flipped would move its logits by ~0.1 or more.
LOGIT_TOL_F32 = 1e-3


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


def on_device(ev):
    """A torch.profiler event of the card itself (a CPU op also reports
    the device time of the kernels it launched)."""
    return "CUDA" in str(getattr(ev, "device_type", ""))


def device_ms(torch, fn, iters=20, flush=None):
    """Device time per call of ``fn``, host time left out: a sleeping
    kernel holds the stream (~25 ms) while ``iters`` calls, each after
    the L2 flush, are queued behind it, so the card then runs them back
    to back; the flushes alone, queued the same way, are subtracted."""
    def queued(body):
        body()
        torch.cuda.synchronize()
        torch.cuda._sleep(50_000_000)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(iters):
            body()
        e.record()
        e.synchronize()
        return s.elapsed_time(e) / iters

    if flush is None:
        return queued(fn)
    return queued(lambda: (flush.zero_(), fn())) - queued(flush.zero_)


def host_us(torch, fn, iters=200):
    """Host time per call of ``fn`` in microseconds: ``iters`` calls
    queued back to back, on the host clock, before the synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return us


def bound(nbytes, ops, kind):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[kind]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def ptxas_summary(build, log):
    """{kernel<args>: "N regs, S spill bytes"} from ptxas -v. A kernel
    that rebalances registers with setmaxnreg reports its launch count."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = build.kernel_label(m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m and name:
            out[name] = f"spill {m.group(1)} B"
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out[name] = f"{m.group(1)} regs, " + out.get(name, "")
    return out


# ----------------------------------------------------------- phase 2


def flash_case(torch, F, flash_mod, B, S, H, K, dtype, flush, gen, Dh=128):
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
          f"flash {B}x{S}x{H}/{K} Dh={Dh} {kind}: max err {err} > "
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
            "library_ms": lib_ms, "vs_library": ms / lib_ms,
            "bound_ms": bound_ms, "bound_by": by}


def bwd_case(torch, F, flash_mod, B, S, H, K, dtype, causal, flush, gen,
             Dh=128):
    """The dq and dk/dv kernels against their plain versions: two rows."""

    def rand(heads):
        return torch.randn(B, S, heads, Dh, generator=gen,
                           device="cuda").to(dtype)

    q, k, v, do = rand(H), rand(K), rand(K), rand(H)
    o, lse = flash_mod.flash_attention(q, k, v, causal, return_lse=True)
    delta = flash_mod.bwd_delta(o, do)
    args = (q, k, v, do, lse, delta, causal)
    got = {"dq": flash_mod.flash_attention_dq(*args)}
    got["dk"], got["dv"] = flash_mod.flash_attention_dkv(*args)
    want = {"dq": flash_mod.flash_attention_dq_plain(*args)}
    want["dk"], want["dv"] = flash_mod.flash_attention_dkv_plain(*args)
    torch.cuda.synchronize()
    kind = "bf16" if dtype == torch.bfloat16 else "f32"
    err, rel = {}, {}
    for n in got:
        check(torch.isfinite(got[n]).all().item(), f"{n} not finite")
        err[n] = (got[n].float() - want[n].float()).abs().max().item()
        rel[n] = err[n] / want[n].float().abs().max().item()
        check(rel[n] <= BWD_TOL[kind],
              f"{n} {B}x{S}x{H}/{K} Dh={Dh} {kind} causal={causal}: max "
              f"err {err[n]} is {rel[n]} of the largest value > "
              f"{BWD_TOL[kind]}")
    del got, want
    ms = {"dq": time_ms(torch, lambda: flash_mod.flash_attention_dq(*args),
                        10, flush),
          "dkv": time_ms(torch,
                         lambda: flash_mod.flash_attention_dkv(*args), 10,
                         flush)}
    plain = {"dq": time_ms(torch, lambda: flash_mod.flash_attention_dq_plain(
                 *args), 3, flush),
             "dkv": time_ms(torch, lambda: flash_mod.flash_attention_dkv_plain(
                 *args), 3, flush)}
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                         enable_gqa=K != H)
    dot = do.transpose(1, 2)
    lib_ms = time_ms(torch, lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True), 10, flush)
    esz = q.element_size()
    q_bytes, kv_bytes = B * S * H * Dh * esz, B * S * K * Dh * esz
    rows = 2 * B * H * S * 4                      # lse and delta, f32
    pairs = S * (S + 1) // 2 if causal else S * S
    bounds = {
        # q, dO, dQ; k, v: S = QK^T, dP = dO V^T, dQ = dS K
        "dq": bound(3 * q_bytes + 2 * kv_bytes + rows,
                    6 * Dh * pairs * B * H, kind),
        # q, dO; k, v, dK, dV: S, dP, dV = P^T dO, dK = dS^T Q
        "dkv": bound(2 * q_bytes + 4 * kv_bytes + rows,
                     8 * Dh * pairs * B * H, kind)}
    base = {"B": B, "S": S, "H": H, "K": K, "Dh": Dh, "dtype": kind,
            "causal": causal, "tol_rel": BWD_TOL[kind],
            "library_ms": lib_ms, "library": "sdpa backward (dq, dk, dv)"}
    return [
        {"kernel": "flash_bwd_dq", **base, "max_abs_err": err["dq"],
         "max_rel_err": rel["dq"], "ms": ms["dq"], "plain_ms": plain["dq"],
         "vs_library": ms["dq"] / lib_ms,
         "bound_ms": bounds["dq"][0], "bound_by": bounds["dq"][1]},
        {"kernel": "flash_bwd_dkv", **base,
         "max_abs_err": max(err["dk"], err["dv"]),
         "max_rel_err": max(rel["dk"], rel["dv"]),
         "dk_max_abs_err": err["dk"], "dv_max_abs_err": err["dv"],
         "ms": ms["dkv"], "plain_ms": plain["dkv"],
         "vs_library": ms["dkv"] / lib_ms,
         "bound_ms": bounds["dkv"][0], "bound_by": bounds["dkv"][1]}]


def paged_case(torch, paged_mod, H, Kh, dtype, flush, gen, Dh=128):
    B, bt, nb, n_blocks = 8, 16, 64, 513
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
          f"paged H={H} Kh={Kh} Dh={Dh} {kind}: max err {err} > "
          f"{TOL['paged'][kind]}")

    def call():
        return paged_mod.paged_attention(q, kc, vc, tables, pos)

    ms = time_ms(torch, call, 20, flush)
    dev_ms = device_ms(torch, call, 20, flush)
    call_us = host_us(torch, call)
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
            "device_ms": dev_ms, "host_us": call_us,
            "plain_ms": plain_ms, "library_ms": None, "vs_library": None,
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


def generator_phase(torch, tfm, gen_mod, flash_mod, GeneratorActor, name,
                    params, prompt, max_new, phase):
    """``GeneratorActor.Generate`` at full width: the flash forward runs
    once a layer (the prefill), the teacher-forced logits reproduce the
    tokens, and they agree with dense attention's (attn_impl="xla"). In
    an MoE model a bf16 difference in attention can flip a token's top-2
    experts, which moves its logits by far more than the attention
    difference: there the two paths are held to each other in f32 (the
    bf16 difference is reported). Emits its row, then checks."""
    cfg = tfm.preset(name)
    actor = GeneratorActor(cfg, params=params, device="cuda")
    flash_mod.flash_attention.launches = 0
    t0 = time.monotonic()
    out = actor.Generate(prompt, max_new)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = flash_mod.flash_attention.launches
    B = prompt.shape[0]
    tf_flash = teacher_forced_logits(torch, gen_mod, params, cfg, prompt,
                                     out)
    tf_xla = teacher_forced_logits(torch, gen_mod, params,
                                   tfm.preset(name, attn_impl="xla"),
                                   prompt, out)
    diff = (tf_flash - tf_xla).abs()
    row = {"phase": phase, "preset": name, "head_dim": cfg.head_dim,
           "prompt": list(prompt.shape), "max_new": max_new,
           "flash_launches": launches, "seconds": wall,
           "tokens_per_s": B * max_new / wall,
           "tf_logits_max_abs_diff": diff.max().item(),
           "tf_logits_mean_abs_diff": diff.mean().item(),
           "tf_logits_std": tf_xla.std().item(),
           "argmax_agree": (tf_flash.argmax(-1) == tf_xla.argmax(-1))
           .float().mean().item()}
    if cfg.n_experts:
        f32 = {impl: teacher_forced_logits(
            torch, gen_mod, params,
            tfm.preset(name, dtype=torch.float32, attn_impl=impl), prompt,
            out) for impl in ("flash", "xla")}
        d32 = (f32["flash"] - f32["xla"]).abs().max().item()
        row.update({"f32_tf_logits_max_abs_diff": d32,
                    "tol_f32": LOGIT_TOL_F32})
        del f32
    else:
        row["tol"] = LOGIT_TOL_BF16
    emit(row)
    check(launches == cfg.n_layers, f"{phase}: {launches} flash launches, "
          f"want one a layer ({cfg.n_layers})")
    check(tuple(out.shape) == (B, max_new),
          f"{phase}: Generate shape {tuple(out.shape)}")
    check(bool(((out >= 0) & (out < cfg.vocab_size)).all()),
          f"{phase}: Generate tokens out of range")
    check(torch.equal(tf_flash.argmax(-1), out), f"{phase}: teacher-forced "
          "flash logits do not reproduce Generate's tokens")
    check(torch.isfinite(tf_flash).all().item(), f"{phase}: logits not "
          "finite")
    if cfg.n_experts:
        check(d32 <= LOGIT_TOL_F32,
              f"{phase}: f32 flash vs xla logits differ by {d32}")
    else:
        check(diff.max().item() <= LOGIT_TOL_BF16,
              f"{phase}: flash vs xla logits differ by {diff.max().item()}")
    return launches


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


def engine_phase(torch, paged_mod, PagedGeneratorActor, name, cfg, params,
                 prompts, lens, max_new, kw, phase):
    """The paged engine with attn="kernel" serving ``prompts``: the
    paged kernel runs once a decode step and layer."""
    eng = PagedGeneratorActor(cfg, params=params, attn="kernel", **kw)
    try:
        paged_mod.paged_attention.launches = 0
        steps0 = eng.Info()["engine_steps"]
        outs, wall = run_requests(eng, prompts, max_new)
        torch.cuda.synchronize()
        launches = paged_mod.paged_attention.launches
        info = eng.Info()
        steps = info["engine_steps"] - steps0
        check(steps > 0, f"{phase}: no decode step ran")
        check(launches == steps * cfg.n_layers,
              f"{phase}: paged launches {launches} != decode steps {steps} "
              f"x {cfg.n_layers}")
        check(all(tuple(o.shape) == (1, max_new) for o in outs),
              f"{phase}: engine output shapes")
        check(eng.pool.check_invariants() == [], f"{phase}: pool invariants")
        ledger = {"summary": eng.ledger.summary(),
                  "records": eng.ledger.records(),
                  "iterations": eng.ledger.iteration_summary()}
    finally:
        eng.close()
    row = {"phase": phase, "preset": name, "requests": len(prompts),
           "prompt_lens": list(lens), "shared_prefix": 96,
           "max_new": max_new, "decode_steps": steps,
           "paged_launches": launches, "seconds": wall,
           "tokens_per_s": len(prompts) * max_new / wall,
           "prefix_hit_rate": info["prefix_hit_rate"],
           "max_live_slots": info["max_live_slots"],
           "prefill_stall_ms": info["prefill_stall_ms"]}
    return row, launches, outs, ledger


def first_divergence(torch, gen_mod, params, cfg, prompts, got, want):
    """Where two greedy runs first part: the request, the position, both
    tokens and the top-2 margin of ``want``'s own logits there (from the
    contiguous path, teacher-forced). None when they agree."""
    for r, (a, b) in enumerate(zip(got, want)):
        a, b = a.reshape(-1), b.reshape(-1)
        diff = (a != b).nonzero()
        if len(diff):
            i = int(diff[0])
            lg = teacher_forced_logits(torch, gen_mod, params, cfg,
                                       prompts[r].to("cuda")[None],
                                       b[None].to("cuda"))
            top2 = lg[0, i].topk(2).values
            return {"request": r, "position": i, "got": int(a[i]),
                    "want": int(b[i]),
                    "top2_margin": float(top2[0] - top2[1])}
    return None


def engine_iteration_profile(torch, eng, prompts, max_new):
    """One decode iteration of the engine under torch.profiler, taken by
    the engine's own thread: the instance's ``_plain_step`` is wrapped so
    that the first step with every slot live runs under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    step, got = eng._plain_step, {}

    def profiled():
        if got or not eng._active.all():
            return step()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            step()
            torch.cuda.synchronize()
            wall_ms = (time.monotonic() - t0) * 1e3
        got.update(profile_summary(prof, wall_ms))

    eng._plain_step = profiled
    try:
        run_requests(eng, prompts, max_new)
    finally:
        del eng._plain_step
    return got or {"device_time": "not measured (no step had every slot "
                                  "live)"}


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


# ----------------------------------------------------------- phase 5


def new_trainer(torch, train_mod, cfg):
    tr = train_mod.Trainer(
        cfg, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(0),
        optimizer=train_mod.default_optimizer(lr=1e-3, warmup=2),
        sync_every=0)
    batch = next(train_mod.synthetic_batches(cfg.vocab_size, 16, 1024,
                                             seed=3, device="cuda"))
    return tr, batch


def trainer_phase(torch, tfm, flash_mod, train_mod, name, phase):
    """Trainer at full width, B=16, S=1024: launches, a falling loss (and
    for MoE a finite router aux), throughput."""
    cfg = tfm.preset(name)
    B, S, steps, warm = 16, 1024, 8, 2
    tr, batch = new_trainer(torch, train_mod, cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = (flash_mod.flash_attention, flash_mod.flash_attention_dq,
                flash_mod.flash_attention_dkv)
    for c in counters:
        c.launches = 0
    losses = []
    for i in range(steps):
        if i == warm:
            torch.cuda.synchronize()
            t0 = time.monotonic()
        losses.append(tr.step(batch)["loss"])
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = [c.launches for c in counters]
    tr.sync()
    losses = [float(x) for x in losses]
    want = steps * cfg.n_layers
    check(launches == [want] * 3,
          f"{phase}: launches fwd/dq/dkv {launches} != {want} each")
    check(all(math.isfinite(x) for x in losses),
          f"{phase}: loss not finite: {losses}")
    check(losses[-1] < losses[0], f"{phase}: loss did not fall: {losses}")
    timed = steps - warm
    tok_s = timed * B * S / wall
    fpt = tfm.flops_per_token(cfg, S)
    peak = 989e12
    row = {"phase": phase, "preset": name, "B": B, "S": S,
           "steps": steps, "timed_steps": timed, "losses": losses,
           "launches": {"flash_fwd": launches[0], "flash_bwd_dq":
                        launches[1], "flash_bwd_dkv": launches[2]},
           "step_ms": wall / timed * 1e3, "steps_per_s": timed / wall,
           "tokens_per_s": tok_s, "flops_per_token": fpt,
           "mfu": tok_s * fpt / peak,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "trainer_throughput_all_steps": tr.throughput()}
    if cfg.n_experts:
        with torch.no_grad():
            _, aux = tfm.hidden_with_aux(tr.state.params,
                                         batch["tokens"][:2], cfg)
        row["router_aux_2_rows"] = float(aux)
        check(math.isfinite(row["router_aux_2_rows"]),
              f"{phase}: router aux not finite: {float(aux)}")
    del tr
    return row, launches


def kernel_family(name):
    low = name.lower()
    for key, fam in (("nccl", "nccl"), ("catarraybatchedcopy", "cat"),
                     ("flash_fwd", "flash_fwd"), ("flash_bwd_dq", "flash_dq"),
                     ("flash_bwd_dkv", "flash_dkv"),
                     ("paged_decode", "paged"), ("gemm", "matmul"),
                     ("cutlass", "matmul"), ("xmma", "matmul"),
                     ("nvjet", "matmul"),
                     ("softmax", "softmax"), ("reduce", "reduction"),
                     ("index", "gather/scatter"), ("gather", "gather/scatter"),
                     ("scatter", "gather/scatter"), ("elementwise",
                                                     "elementwise")):
        if key in low:
            return fam
    return "other"


def profiled(torch, fn):
    """``fn()`` under torch.profiler (CPU and CUDA), synchronized: the
    profile and the wall time in ms."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    return prof, wall_ms


def profile_summary(prof, wall_ms, ranges=()):
    """Device time by kernel family, the top kernels, the host ops with
    the most self time, and the device's idle share of ``wall_ms`` (the
    profiler's own overhead included). Named ``ranges`` also show on the
    device's timeline as spans; they are not kernels and are left out."""
    fams, kernels = {}, {}
    for ev in prof.key_averages():
        if not on_device(ev) or ev.key in ranges:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us <= 0:
            continue
        fam = kernel_family(ev.key)
        fams[fam] = fams.get(fam, 0.0) + us / 1e3
        kernels[ev.key[:80]] = (us / 1e3, ev.count)
    busy = sum(fams.values())
    if busy == 0:
        return {"device_time": "not measured (profiler saw no device time)"}
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
    host = sorted(((ev.key, ev.self_cpu_time_total / 1e3, ev.count)
                   for ev in prof.key_averages() if not on_device(ev)),
                  key=lambda x: -x[1])[:10]
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": 1 - busy / wall_ms,
            "by_family_ms": dict(sorted(fams.items(), key=lambda kv: -kv[1])),
            "top_kernels": [{"name": n, "ms": t, "calls": c}
                            for n, (t, c) in top],
            "top_host_ops": [{"name": n[:80], "self_ms": t, "calls": c}
                             for n, t, c in host]}


def device_ms_of(ev):
    us = getattr(ev, "device_time_total", None)
    if us is None:
        us = getattr(ev, "cuda_time_total", 0.0)
    return us / 1e3


#: Autograd nodes run their backward under events of this prefix.
BACKWARD = "autograd::engine::evaluate_function: "


def range_summary(prof, labels):
    """Device time of the kernels launched inside each named range
    (summed over its calls; the ranges' own spans on the device's
    timeline include idle gaps), and, for the backward, by autograd
    node: the ranges cover the forward only."""
    ranges = {label: 0.0 for label in labels}
    calls = {label: 0 for label in labels}
    backward = {}
    for ev in prof.events():
        if on_device(ev):
            continue
        if ev.name in ranges:
            ranges[ev.name] += device_ms_of(ev)
            calls[ev.name] += 1
        elif ev.name.startswith(BACKWARD):
            node = ev.name[len(BACKWARD):]
            backward[node] = backward.get(node, 0.0) + device_ms_of(ev)
    top = sorted(backward.items(), key=lambda kv: -kv[1])[:12]
    return {"forward_ranges_ms": ranges, "forward_range_calls": calls,
            "backward_nodes_ms": dict(top)}


class named_ranges:
    """Within the block, each listed function of ``module`` runs inside
    ``torch.profiler.record_function(label)``, so a profile names it."""

    def __init__(self, torch, module, names):
        self.torch, self.module, self.names = torch, module, names
        self.saved = {}

    def __enter__(self):
        for fn, label in self.names:
            orig = getattr(self.module, fn)
            self.saved[fn] = orig

            def wrapped(*a, _orig=orig, _label=label, **k):
                with self.torch.profiler.record_function(_label):
                    return _orig(*a, **k)

            setattr(self.module, fn, wrapped)
        return self

    def __exit__(self, *exc):
        for fn, orig in self.saved.items():
            setattr(self.module, fn, orig)


MOE_RANGES = (("_moe_route", "moe.router"),
              ("_moe_dispatch", "moe.dispatch"),
              ("_moe_experts", "moe.experts"),
              ("_moe_combine", "moe.combine"))
SPEC_RANGES = (("draft_propose_paged", "spec.draft"),
               ("verify_step_paged", "spec.verify"),
               ("spec_accept_rows", "spec.accept"))


def trainer_profile(torch, tfm, train_mod, name, ranges=()):
    """A fresh trainer, two steps, then one step under torch.profiler
    (with ``ranges`` named): device time by family, idle share, and the
    named ranges' device time."""
    cfg = tfm.preset(name)
    tr, batch = new_trainer(torch, train_mod, cfg)
    for _ in range(2):
        tr.step(batch)
    labels = [label for _, label in ranges]
    with named_ranges(torch, tfm, ranges):
        prof, wall_ms = profiled(torch, lambda: tr.step(batch))
    out = {"phase": "trainer_profile", "preset": name,
           **profile_summary(prof, wall_ms, labels)}
    if ranges:
        out.update(range_summary(prof, labels))
    del tr
    return out


def grad_parity(torch, tfm, train_mod, cfg):
    """Each parameter's gradient through the kernels against the same
    gradient through dense attention, on one B=4 batch."""
    from dataclasses import replace

    from ptype_tpu_torch.models.weights import init_params

    params = init_params(torch.Generator(device="cuda").manual_seed(0),
                         cfg)
    for _, p in train_mod.trainer._flatten(params):
        p.requires_grad_(True)
    batch = next(train_mod.synthetic_batches(cfg.vocab_size, 4, 1024,
                                             seed=4, device="cuda"))
    lf, gf = train_mod.trainer.grads_of(params, batch, cfg)
    lx, gx = train_mod.trainer.grads_of(params, batch,
                                        replace(cfg, attn_impl="xla"))
    rel = {}
    for (path, a), (_, b) in zip(train_mod.trainer._flatten(gf),
                                 train_mod.trainer._flatten(gx)):
        rel["/".join(path)] = ((a.float() - b.float()).norm()
                               / b.float().norm()).item()
    worst = max(rel, key=rel.get)
    check(rel[worst] <= GRAD_REL_TOL,
          f"grad of {worst} differs from dense by {rel[worst]} (relative "
          f"norm) > {GRAD_REL_TOL}")
    return {"phase": "grad_parity", "B": 4, "S": 1024,
            "loss_flash": float(lf), "loss_dense": float(lx),
            "grad_rel_norm_diff": rel, "worst": worst,
            "tol": GRAD_REL_TOL}


# ------------------------------------------------------- store_dp phase

#: (zero, overlap, wire) of each StoreDPTrainer rung, the first the base.
STORE_DP_RUNGS = ((0, False, "exact"), (0, "drain", "exact"),
                  (0, True, "exact"), (0, False, "bf16"), (0, False, "int8"),
                  (1, False, "exact"), (2, False, "exact"),
                  (3, False, "exact"), (2, False, "int8"))
#: An exact rung against the base rung, and the base against the
#: Trainer: the reference's own tolerances for its rungs
#: (tests/test_zero_train.py): the same gradients, the optimizer's sums
#: and clip scale in another order.
STORE_DP_LOSS_RTOL = 1e-5
STORE_DP_PARAM_TOL = (2e-5, 1e-6)   # rtol, atol
#: A rung that scales its gradients by clip/||g|| with the norm summed
#: over bucket flats (ZeRO, overlap=True: the reference's arithmetic for
#: them) against the base rung in bf16 compute: the loss at
#: STORE_DP_LOSS_RTOL and each leaf's movement from the init within this
#: (relative L2) of the base's. Their moments start 1 ulp off the base's
#: and bf16 compute grows that to O(lr) in some elements, so their
#: elementwise check is made in f32 compute (STORE_DP_F32_RUNGS).
STORE_DP_MOVE_RTOL = 2e-2
#: The same rungs again in f32 compute (TF32 off) at B=4, each held to
#: the first at the reference's elementwise tolerance.
STORE_DP_F32_RUNGS = ((0, False), (0, "drain"), (0, True), (1, False),
                      (2, False), (3, False))
#: Planted faults, a ZeRO-2 rung with one hyperparameter off: the f32
#: check must reject each; in bf16 their readings are printed beside the
#: movement limit's.
STORE_DP_FAULTS = {"no_weight_decay": {"weight_decay": 0.0},
                   "lr_x1.05": {"lr": 1.05e-3}}
#: A compressed wire's loss curve against exact (the reference's bound,
#: tests/test_quantized_train.py).
STORE_DP_WIRE_RTOL = 5e-3
STORE_DP_OPT = dict(lr=1e-3, warmup=2)
COLLECTIVE_COUNTERS = ("collectives.bucket_launches", "collectives.calls",
                       "collectives.wire_bytes")


def flat_params(torch, tree):
    from ptype_tpu_torch.parallel.collectives import tree_flatten

    return torch.cat([p.detach().reshape(-1).float()
                      for _, p in tree_flatten(tree)])


def params_close(torch, a, b, p0=None, sizes=None):
    """(all within STORE_DP_PARAM_TOL, max abs difference, the largest
    difference over its element's tolerance, and with the initial
    params ``p0`` and the leaves' ``sizes``: the share of elements
    outside the tolerance and the largest per-leaf
    ||a - b|| / ||b - p0||)."""
    rtol, atol = STORE_DP_PARAM_TOL
    d = (a - b).abs()
    tol = atol + rtol * b.abs()
    out = d <= tol
    res = [bool(out.all()), d.max().item(), (d / tol).max().item()]
    if p0 is not None:
        res.append(1.0 - out.float().mean().item())
        rel = [((x - y).norm() / (y - z).norm().clamp_min(1e-30)).item()
               for x, y, z in zip(a.split(sizes), b.split(sizes),
                                  p0.split(sizes))]
        res.append(max(rel))
    return tuple(res)


def store_dp_trainer(torch, train_mod, sd, mesh, cfg, params, zero, overlap,
                     wire, **opt):
    """A StoreDPTrainer rung with the trainer phase's optimizer, ``opt``
    overriding its hyperparameters: ZeRO rungs take them as
    zero_hparams, overlap=True's own per-bucket apply from the recipe's
    pieces patched to them (the returned context, held over its steps),
    the other rungs as one whole-tree AdamW."""
    import functools
    from unittest import mock

    from ptype_tpu_torch.parallel.collectives import WireConfig
    from ptype_tpu_torch.parallel.tensorstore import TensorStore

    hp = {**STORE_DP_OPT, **opt}
    kw = ({"zero_hparams": train_mod.OptHParams(**hp)} if zero
          else {} if overlap is True
          else {"optimizer": train_mod.default_optimizer(**hp)})
    store = TensorStore(mesh, wire=(None if wire == "exact"
                                    else WireConfig(compress=wire)))
    pieces = mock.patch.object(sd, "default_optimizer_pieces",
                               functools.partial(
                                   train_mod.trainer.default_optimizer_pieces,
                                   **hp))
    return sd.StoreDPTrainer(cfg, store, params=params, overlap=overlap,
                             zero=zero, **kw), pieces


def check_bucket_apply(tr, name):
    """overlap=True must have run its per-bucket apply, not the
    whole-tree fallback kept for a caller's own optimizer."""
    check(tr.overlap is not True or (not tr._custom_opt
                                     and tr._bucket_opts is not None),
          f"store_dp {name}: overlap=True did not apply per bucket")


def vs_base(torch, losses, flat, base, p0, sizes):
    """A rung's readings against the base rung's (losses, params): the
    losses within STORE_DP_LOSS_RTOL, and params_close's readings."""
    ok, diff, over, share, rel = params_close(torch, flat, base[1], p0,
                                              sizes)
    return {"loss_ok": all(abs(a - b) <= STORE_DP_LOSS_RTOL * abs(b)
                           for a, b in zip(losses, base[0])),
            "params_within_tol": ok, "param_max_abs_diff": diff,
            "max_diff_over_tol": over, "share_outside_tol": share,
            "worst_leaf_rel_movement_diff": rel}


def run_rung(torch, train_mod, sd, mesh, cfg, params, batch, counters,
             steps, zero, overlap, **opt):
    """``steps`` steps of an exact-wire rung: (losses, flat params,
    flash launches)."""
    name = f"zero{zero}/overlap={overlap}/{opt or ''}"
    tr, pieces = store_dp_trainer(torch, train_mod, sd, mesh, cfg, params,
                                  zero, overlap, "exact", **opt)
    with pieces:
        for c in counters:
            c.launches = 0
        losses = [float(tr.step(batch)["loss"]) for _ in range(steps)]
        launches = [c.launches for c in counters]
    check_bucket_apply(tr, name)
    flat = flat_params(torch, tr.params())
    del tr
    torch.cuda.empty_cache()
    check(launches == [steps * cfg.n_layers] * 3,
          f"store_dp {name}: launches fwd/dq/dkv {launches}")
    check(all(math.isfinite(x) for x in losses),
          f"store_dp {name}: loss not finite: {losses}")
    return losses, flat, launches


def opt_state_bytes(tr):
    from ptype_tpu_torch.parallel.collectives import tree_flatten

    if tr.zero:
        return tr.zero_state().moment_bytes_per_replica()
    states = tr._bucket_states or [tr.opt_state]
    return sum(t.numel() * t.element_size() for st in states
               for tree in (st.mu, st.nu) for _, t in tree_flatten(tree))


def store_dp_phase(torch, tfm, flash_mod, train_mod, mesh):
    """StoreDPTrainer at optimus-125m full width on a world-1 NCCL mesh,
    B=16, S=1024, each rung of STORE_DP_RUNGS for 4 steps from the same
    params: the exact rungs' losses and params against the first rung
    (the scaled rungs' movement), the first against the port's Trainer,
    the compressed wires' curves against exact; kernel launches, host
    syncs, step time, buckets, collective calls and wire bytes a step,
    optimizer-state bytes. Then the planted faults' readings and the
    ladder and overlap probes (S=128). Returns the rungs' flash launches
    (fwd, dq, dkv)."""
    import statistics

    from ptype_tpu_torch.metrics import metrics
    from ptype_tpu_torch.models.weights import init_params
    from ptype_tpu_torch.train import store_dp as sd

    cfg = tfm.preset("optimus-125m")
    B, S, steps = 16, 1024, 4
    fpt = tfm.flops_per_token(cfg, S)
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    p0 = flat_params(torch, params)
    from ptype_tpu_torch.parallel.collectives import tree_flatten
    sizes = [p.numel() for _, p in tree_flatten(params)]
    batch = next(train_mod.synthetic_batches(cfg.vocab_size, B, S, seed=3,
                                             device="cuda"))
    counters = (flash_mod.flash_attention, flash_mod.flash_attention_dq,
                flash_mod.flash_attention_dkv)
    src = sd.__file__
    loss_line = next(i for i, ln in enumerate(open(src).read().splitlines(),
                                              1) if "float(mean)" in ln)
    loss_site = f"{os.path.relpath(src)}:{loss_line}"

    def timed_steps(step):
        losses, ms = [], []
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            losses.append(float(step()))
            ms.append((time.monotonic() - t0) * 1e3)
        return losses, ms

    tr = train_mod.Trainer(cfg, device="cuda", params=params, sync_every=0,
                           optimizer=train_mod.default_optimizer(
                               **STORE_DP_OPT))
    trainer_losses, ms = timed_steps(lambda: tr.step(batch)["loss"])
    trainer_ms = statistics.median(ms[1:])
    trainer_params = flat_params(torch, tr.state.params)
    del tr
    torch.cuda.empty_cache()
    emit({"phase": "store_dp_trainer_base", "losses": trainer_losses,
          "step_ms": trainer_ms, "step_ms_all": ms})

    base, totals = None, [0, 0, 0]
    for zero, overlap, wire in STORE_DP_RUNGS:
        name = f"zero{zero}/overlap={overlap}/{wire}"
        held = torch.cuda.memory_allocated()  # this phase's own copies
        tr, pieces = store_dp_trainer(torch, train_mod, sd, mesh, cfg,
                                      params, zero, overlap, wire)
        with pieces:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for c in counters:
                c.launches = 0
            m0 = [metrics.counter(k).value for k in COLLECTIVE_COUNTERS]
            losses, ms = timed_steps(lambda: tr.step(batch)["loss"])
            launches = [c.launches for c in counters]
            m1 = [metrics.counter(k).value for k in COLLECTIVE_COUNTERS]
            flat = flat_params(torch, tr.params())
            # One more steady step, its host syncs counted.
            _, sites = count_syncs(torch, lambda: tr.step(batch))
        check_bucket_apply(tr, name)
        peak = torch.cuda.max_memory_allocated() / 2**30
        own = peak - held / 2**30
        want = steps * cfg.n_layers
        check(launches == [want] * 3,
              f"store_dp {name}: launches fwd/dq/dkv {launches} != {want}")
        totals = [t + n for t, n in zip(totals, launches)]
        check(all(math.isfinite(x) for x in losses),
              f"store_dp {name}: loss not finite: {losses}")
        ours = [x for x in sites if "ptype_tpu_torch/parallel/" in x
                or "train/store_dp.py" in x]
        check(all(x == loss_site for x in ours),
              f"store_dp {name}: host syncs from the data plane: {ours}")
        med = statistics.median(ms[1:])
        row = {"phase": "store_dp", "rung": name, "zero": zero,
               "overlap": overlap, "wire": wire, "B": B, "S": S,
               "losses": losses, "step_ms": med, "step_ms_all": ms,
               "tokens_per_s": B * S / med * 1e3,
               "mfu": B * S / med * 1e3 * fpt / 989e12,
               "peak_mem_gib": peak, "rung_peak_mem_gib": own,
               "vs_trainer_step": med / trainer_ms,
               "launches": {"flash_fwd": launches[0],
                            "flash_bwd_dq": launches[1],
                            "flash_bwd_dkv": launches[2]},
               "buckets_per_step": (m1[0] - m0[0]) / steps,
               "collective_calls_per_step": (m1[1] - m0[1]) / steps,
               "wire_bytes_per_step": (m1[2] - m0[2]) / steps,
               "opt_state_bytes": opt_state_bytes(tr),
               "last_grad_bytes": tr.last_grad_bytes,
               "host_sync_sites": sites}
        if zero == 3:
            keys = [k for k in tr.store.keys() if k.startswith("params/")]
            check(tr._param_leaves is None and all(
                k.startswith("params/bucket") for k in keys),
                f"store_dp {name}: replicated leaves remain: {keys[:3]}")
            row["param_keys"] = len(keys)
        if base is None:
            base = (losses, flat)
            ok, diff = params_close(torch, flat, trainer_params)[:2]
            row.update(vs_trainer_losses=trainer_losses,
                       vs_trainer_param_max_abs_diff=diff)
            check(ok and all(abs(a - b) <= STORE_DP_LOSS_RTOL * abs(b)
                             for a, b in zip(losses, trainer_losses)),
                  f"store_dp {name}: differs from the Trainer: {losses} vs "
                  f"{trainer_losses}, params max diff {diff}")
        elif wire == "exact":
            got = vs_base(torch, losses, flat, base, p0, sizes)
            row["vs_base"] = got
            ok = (got["worst_leaf_rel_movement_diff"] <= STORE_DP_MOVE_RTOL
                  if zero or overlap is True else got["params_within_tol"])
            check(ok and got["loss_ok"],
                  f"store_dp {name}: differs from the base rung: {losses} "
                  f"vs {base[0]}, {got}")
        else:
            check(all(abs(a - b) <= STORE_DP_WIRE_RTOL * abs(b)
                      for a, b in zip(losses, base[0]))
                  and losses[-1] < losses[0],
                  f"store_dp {name}: does not track exact: {losses} vs "
                  f"{base[0]}")
        emit(row)
        del tr, flat
        torch.cuda.empty_cache()
    check(base[0][-1] < base[0][0], f"store_dp: loss did not fall: {base[0]}")
    for fault, opt in STORE_DP_FAULTS.items():
        losses, flat, _ = run_rung(torch, train_mod, sd, mesh, cfg, params,
                                   batch, counters, steps, 2, False, **opt)
        emit({"phase": "store_dp_fault", "fault": fault, "zero": 2,
              "losses": losses,
              "vs_base": vs_base(torch, losses, flat, base, p0, sizes),
              "move_rtol": STORE_DP_MOVE_RTOL})
        del flat
    t0 = time.monotonic()
    ladder = sd.measure_zero_ladder(mesh, "optimus-125m", steps=2, batch=16)
    overlap = sd.measure_overlap(mesh, "optimus-125m", steps=3, batch=16,
                                 bucket_bytes=4 << 20)
    emit({"phase": "store_dp_probes", "S": 128, "zero_ladder": ladder,
          "overlap": overlap, "seconds": time.monotonic() - t0})
    torch.cuda.empty_cache()
    return totals


def store_dp_f32_phase(torch, tfm, flash_mod, train_mod, mesh):
    """The rungs of STORE_DP_F32_RUNGS in f32 compute (TF32 off),
    optimus-125m at B=4, S=1024, 4 steps from one init: each within the
    reference's elementwise tolerance of the first (losses and params),
    and each planted fault of STORE_DP_FAULTS (on ZeRO-2) outside it."""
    from ptype_tpu_torch.models.weights import init_params
    from ptype_tpu_torch.parallel.collectives import tree_flatten
    from ptype_tpu_torch.train import store_dp as sd

    cfg = tfm.preset("optimus-125m", dtype=torch.float32)
    B, S, steps = 4, 1024, 4
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    p0 = flat_params(torch, params)
    sizes = [p.numel() for _, p in tree_flatten(params)]
    batch = next(train_mod.synthetic_batches(cfg.vocab_size, B, S, seed=3,
                                             device="cuda"))
    counters = (flash_mod.flash_attention, flash_mod.flash_attention_dq,
                flash_mod.flash_attention_dkv)
    rungs = ([(z, o, None, {}) for z, o in STORE_DP_F32_RUNGS]
             + [(2, False, f, o) for f, o in STORE_DP_FAULTS.items()])
    base = None
    for zero, overlap, fault, opt in rungs:
        name = f"f32 zero{zero}/overlap={overlap}/{fault or 'sound'}"
        t0 = time.monotonic()
        losses, flat, _ = run_rung(torch, train_mod, sd, mesh, cfg, params,
                                   batch, counters, steps, zero, overlap,
                                   **opt)
        row = {"phase": "store_dp_f32", "zero": zero, "overlap": overlap,
               "fault": fault, "B": B, "S": S, "losses": losses,
               "seconds": time.monotonic() - t0}
        if base is None:
            base = (losses, flat)
        else:
            got = vs_base(torch, losses, flat, base, p0, sizes)
            row["vs_base"] = got
            held = got["loss_ok"] and got["params_within_tol"]
            check(held if fault is None else not held,
                  f"store_dp {name}: " + ("differs from the base rung"
                                          if fault is None else
                                          "fault not seen") + f": {got}")
        emit(row)
        del flat
    check(base[0][-1] < base[0][0],
          f"store_dp f32: loss did not fall: {base[0]}")


def store_dp_profile(torch, tfm, train_mod, mesh, zero, overlap):
    """One profiled step of a StoreDPTrainer rung after two warm steps:
    device time by family (NCCL and the bucket pack among them), idle
    share."""
    from ptype_tpu_torch.models.weights import init_params
    from ptype_tpu_torch.train import store_dp as sd

    cfg = tfm.preset("optimus-125m")
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    batch = next(train_mod.synthetic_batches(cfg.vocab_size, 16, 1024,
                                             seed=3, device="cuda"))
    tr, pieces = store_dp_trainer(torch, train_mod, sd, mesh, cfg, params,
                                  zero, overlap, "exact")
    with pieces:
        for _ in range(2):
            tr.step(batch)
        prof, wall_ms = profiled(torch, lambda: tr.step(batch))
    del tr
    # The trainer's and the store's annotate regions (train.*, store.*)
    # are ranges, not kernels: their device time is their kernels'.
    labels = sorted({ev.key for ev in prof.key_averages()
                     if ev.key.startswith(("train.", "store."))})
    return {"phase": "store_dp_profile", "zero": zero, "overlap": overlap,
            **profile_summary(prof, wall_ms, labels),
            **range_summary(prof, labels)}


# --------------------------------------------------- speculative decoding


#: The warning torch gives, in sync debug mode "warn", for each
#: synchronizing CUDA call.
SYNC_WARNING = "called a synchronizing CUDA operation"


def count_syncs(torch, fn):
    """The synchronizing CUDA calls torch reports while ``fn()`` runs in
    this thread (``torch.cuda.set_sync_debug_mode("warn")``): a host read
    of a device value, a pageable host-to-device copy, a stream
    synchronize. Returns their number and the source lines that made
    them. Other threads' calls in the meantime are not counted."""
    import warnings

    me, sites = threading.get_ident(), []

    def record(message, category, filename, lineno, file=None, line=None):
        if threading.get_ident() == me and SYNC_WARNING in str(message):
            sites.append(f"{os.path.relpath(filename)}:{lineno}")

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return len(sites), sites


def count_window_syncs(torch, eng):
    """Wrap ``eng``'s speculation windows to count, per window, its host
    synchronizations (:func:`count_syncs`) and whether it first caught
    the draft up. Returns the list the windows append ``(syncs,
    caught_up, sites)`` to."""
    step, catch_up = eng._spec_step, eng._draft_catch_up
    rec, state = [], {"caught_up": False}

    def counted_catch_up(slot, row):
        if int(eng._dpos[slot]) < int(eng._pos[slot]):
            state["caught_up"] = True
        catch_up(slot, row)

    def counted(k_eff):
        state["caught_up"] = False
        n, sites = count_syncs(torch, lambda: step(k_eff))
        rec.append((n, state["caught_up"], sites))

    eng._spec_step, eng._draft_catch_up = counted, counted_catch_up
    return rec


def spec_phase(torch, tfm, gen_mod, paged_mod, PagedGeneratorActor,
               SpecConfig, params, prompts, max_new, kw):
    """optimus-125m with a 2-layer truncated draft, k=4, fixed depth:
    the bf16 kernel engine beside a plain one in this process (plain,
    spec, spec, plain), then the f32 gather-path greedy identity with
    TF32 off, counting each window's host synchronizations. Emits its
    row, then checks."""
    cfg = tfm.preset("optimus-125m")
    dp, dc = gen_mod.truncated_draft_params(params, cfg, n_layers=2)
    spec = SpecConfig(draft_params=dp, draft_cfg=dc, k=4, adaptive=False)
    runs, outs, launches = [], {}, {}
    for kind in ("plain", "spec", "spec", "plain"):
        eng = PagedGeneratorActor(cfg, params=params, attn="kernel",
                                  spec=spec if kind == "spec" else None,
                                  **kw)
        try:
            paged_mod.paged_attention.launches = 0
            got, wall = run_requests(eng, prompts, max_new)
            torch.cuda.synchronize()
            n = paged_mod.paged_attention.launches
            info = eng.Info()
        finally:
            eng.close()
        windows = info.get("spec_windows", 0)
        plain_steps = info["engine_steps"] - windows
        check(n == plain_steps * cfg.n_layers,
              f"spec_engine ({kind}): paged launches {n} != plain steps "
              f"{plain_steps} x {cfg.n_layers}")
        run = {"kind": kind, "seconds": wall, "engine_steps":
               info["engine_steps"], "plain_steps": plain_steps,
               "paged_launches": n,
               "tokens_per_s": len(prompts) * max_new / wall}
        if kind == "spec":
            check(windows > 0, "spec_engine: no speculation window ran")
            run.update({k: info[k] for k in (
                "spec_windows", "spec_proposed", "spec_accepted",
                "spec_tokens", "spec_accept_rate")})
            # Tokens a window commits over all its live rows.
            run["tokens_per_window"] = info["spec_tokens"] / windows
        runs.append(run)
        outs.setdefault(kind, got)
        launches.setdefault(kind, n)
    check(launches["plain"] > 0, "spec_engine: the plain engine launched "
          "no paged kernel")
    same = sum(int((a == b).sum()) for a, b in zip(outs["spec"],
                                                   outs["plain"]))
    share = same / (len(prompts) * max_new)

    # f32 on the gather path, TF32 off: greedy tokens must be identical.
    cfg32 = tfm.preset("optimus-125m", dtype=torch.float32)
    dp32, dc32 = gen_mod.truncated_draft_params(params, cfg32, n_layers=2)
    got32 = {}
    for kind in ("plain", "spec"):
        eng = PagedGeneratorActor(
            cfg32, params=params, attn="gather",
            spec=(SpecConfig(dp32, dc32, k=4, adaptive=False)
                  if kind == "spec" else None), **kw)
        try:
            syncs = count_window_syncs(torch, eng) if kind == "spec" else None
            got32[kind], _ = run_requests(eng, prompts, max_new)
        finally:
            eng.close()
    div = first_divergence(torch, gen_mod, params, cfg32, prompts,
                           got32["spec"], got32["plain"])
    steady = [n for n, caught_up, _ in syncs if not caught_up]
    row = {"phase": "spec_engine", "preset": "optimus-125m",
           "draft_layers": 2, "k": 4, "adaptive": False,
           "requests": len(prompts), "max_new": max_new, "runs": runs,
           "bf16_kernel_identical_token_share": share,
           "f32_gather_greedy_identical": div is None,
           "f32_first_divergence": div,
           "f32_windows": len(syncs),
           "host_syncs_per_window": sorted(set(steady)),
           "host_syncs_after_catch_up": sorted(
               {n for n, caught_up, _ in syncs if caught_up}),
           "host_sync_sites": sorted({site for _, _, sites in syncs
                                      for site in sites})}
    emit(row)
    check(div is None, f"spec_engine: f32 gather greedy tokens differ from "
          f"the plain engine's: {div}")
    check(steady and set(steady) == {1}, f"spec_engine: a window without "
          f"catch-up made {sorted(set(steady))} host syncs, want 1")
    return launches, sorted(set(steady))


def spec_window_profile(torch, gen_mod, eng, prompts, max_new):
    """The first speculation window with every slot live, under
    torch.profiler, with the draft, the verify and the acceptance named
    apart."""
    step, got = eng._spec_step, {}

    def window(k_eff):
        if got or not eng._active.all():
            return step(k_eff)
        labels = [label for _, label in SPEC_RANGES]
        with named_ranges(torch, gen_mod, SPEC_RANGES):
            prof, wall_ms = profiled(torch, lambda: step(k_eff))
        got.update({"k_eff": k_eff,
                    **profile_summary(prof, wall_ms, labels),
                    **range_summary(prof, labels)})

    eng._spec_step = window
    try:
        run_requests(eng, prompts, max_new)
    finally:
        del eng._spec_step
    return got or {"device_time": "not measured (no window had every "
                                  "slot live)"}


# ------------------------------------------- sampled, ledger, disagg, batch


#: The sampled phase's request parameters (request i draws from seed i+1).
SAMPLING = dict(temperature=0.8, top_k=50, top_p=0.95)


def run_in_order(engine, prompts, max_new, seeds=None):
    """``prompts`` from one thread each, queued in order while the
    engine's dispatch lock is held, so the engine admits and batches
    them the same way in every run (a bf16 row's numerics depend on its
    prefill chunks, which depend on the queue). ``seeds``: one sampling
    seed a request (``SAMPLING``), else greedy. Returns the outputs."""
    outs, errs = [None] * len(prompts), []

    def call(i):
        try:
            kw = ({} if seeds is None
                  else dict(SAMPLING, seed=seeds[i]))
            outs[i] = engine.Generate(prompts[i][None], max_new, **kw)
        except Exception as e:  # noqa: BLE001 — reported below
            errs.append(repr(e))

    threads = []
    with engine._lock:
        for i in range(len(prompts)):
            threads.append(threading.Thread(target=call, args=(i,)))
            threads[-1].start()
            deadline = time.monotonic() + 60
            while (len(engine._queue) + (engine._admitting is not None)
                   < i + 1 and time.monotonic() < deadline and not errs):
                time.sleep(0.001)
    for t in threads:
        t.join(timeout=600)
    check(not errs, f"engine requests failed: {errs}")
    check(all(o is not None for o in outs), "engine requests hung")
    return outs


def same_tokens(a, b):
    return sum(int((x.cpu() == y.cpu()).sum()) for x, y in zip(a, b))


def sampled_phase(torch, tfm, gen_mod, paged_mod, PagedGeneratorActor,
                  SpecConfig, params, prompts, max_new, kw):
    """Sampled requests on the card (temperature 0.8, top-k 50, top-p
    0.95, seeds 1-8), on the plain kernel engine and on the speculative
    one (2-layer draft, k=4): two bf16 runs in fresh engines give the
    same tokens; in f32 every co-batched row equals its solo run — the
    whole row on the plain engine, and on the speculative one the tokens
    committed while the row had at least k+1 to go (past that a window's
    depth follows the deepest live row, so a co-batched row's last
    window draws more than its solo one); and each sampled window reads
    the host as often as a greedy one. Emits its row, then checks."""
    cfg = tfm.preset("optimus-125m")
    cfg32 = tfm.preset("optimus-125m", dtype=torch.float32)
    seeds = list(range(1, len(prompts) + 1))
    k = 4
    row = {"phase": "sampled_engine", "preset": "optimus-125m",
           "sampling": SAMPLING, "seeds": seeds, "max_new": max_new,
           "requests": len(prompts)}
    launches, checks = 0, {}
    for kind in ("plain", "spec"):
        def spec(c):
            if kind == "plain":
                return None
            dp, dc = gen_mod.truncated_draft_params(params, c, n_layers=2)
            return SpecConfig(dp, dc, k=k, adaptive=False)

        runs, syncs = [], None
        for rep in range(2):
            eng = PagedGeneratorActor(cfg, params=params, attn="kernel",
                                      spec=spec(cfg), **kw)
            try:
                if kind == "spec" and rep == 0:
                    syncs = count_window_syncs(torch, eng)
                paged_mod.paged_attention.launches = 0
                t0 = time.monotonic()
                runs.append(run_in_order(eng, prompts, max_new, seeds))
                torch.cuda.synchronize()
                wall = time.monotonic() - t0
                n = paged_mod.paged_attention.launches
                info = eng.Info()
            finally:
                eng.close()
            plain_steps = info["engine_steps"] - info.get("spec_windows", 0)
            check(n == plain_steps * cfg.n_layers,
                  f"sampled_engine ({kind}): paged launches {n} != plain "
                  f"steps {plain_steps} x {cfg.n_layers}")
            if kind == "plain":
                launches += n
            row[f"{kind}_bf16_run{rep}"] = {
                "seconds": wall, "engine_steps": info["engine_steps"],
                "paged_launches": n,
                **{key: info[key] for key in ("spec_windows",
                                              "spec_accept_rate")
                   if key in info}}
        same = same_tokens(runs[0], runs[1])
        row[f"{kind}_bf16_reproduced_tokens"] = same
        row[f"{kind}_bf16_distinct_tokens"] = len(
            {int(t) for o in runs[0] for t in o.reshape(-1)})
        # f32: co-batched against solo.
        eng = PagedGeneratorActor(cfg32, params=params,
                                  attn="kernel" if kind == "plain"
                                  else "gather", spec=spec(cfg32), **kw)
        try:
            batched = run_in_order(eng, prompts, max_new, seeds)
            solo = [run_in_order(eng, [p], max_new, [s])[0]
                    for p, s in zip(prompts, seeds)]
        finally:
            eng.close()
        cut = max_new if kind == "plain" else max_new - k
        held = all(torch.equal(a[:, :cut].cpu(), b[:, :cut].cpu())
                   for a, b in zip(batched, solo))
        row[f"{kind}_f32_cobatched_equals_solo_first_tokens"] = cut
        row[f"{kind}_f32_cobatched_equals_solo"] = held
        row[f"{kind}_f32_identical_share"] = same_tokens(batched, solo) / (
            len(prompts) * max_new)
        if kind == "spec":
            steady = sorted({n for n, up, _ in syncs if not up})
            row.update({"sampled_windows": len(syncs),
                        "sampled_window_host_syncs": steady,
                        "sampled_window_host_syncs_after_catch_up": sorted(
                            {n for n, up, _ in syncs if up}),
                        "sampled_window_sync_sites": sorted(
                            {x for _, _, sites in syncs for x in sites})})
        checks[kind] = (same, held)
    emit(row)
    for kind, (same, held) in checks.items():
        check(same == len(prompts) * max_new,
              f"sampled_engine ({kind}): a second bf16 run reproduced "
              f"{same} of {len(prompts) * max_new} tokens")
        check(held, f"sampled_engine ({kind}): an f32 co-batched row differs "
              f"from its solo run in its first "
              f"{row[kind + '_f32_cobatched_equals_solo_first_tokens']} "
              f"tokens")
    check(row["sampled_window_host_syncs"] == [1],
          f"sampled_engine: a sampled window without catch-up made "
          f"{row['sampled_window_host_syncs']} host syncs, want 1")
    return launches


def count_step_syncs(torch, eng):
    """Wrap ``eng``'s plain steps to record each one's synchronizing
    calls (:func:`count_syncs`)."""
    step, rec = eng._plain_step, []

    def counted():
        rec.append(count_syncs(torch, step))

    eng._plain_step = counted
    return rec


def ledger_phase(torch, serving_mod, PagedGeneratorActor, cfg, params,
                 prompts, max_new, kw, ledger, spec_syncs):
    """The serving ledger of the paged_engine phase's run: TTFT, TPOT and
    e2e from its histograms; every record retired complete with a TTFT
    and one TPOT sample a token after the first; the seams' cost on
    this host; and, on a fresh engine, the host syncs of a plain step
    with the ledger wired (none from the ledger's modules). Emits its
    row, then checks."""
    s, recs = ledger["summary"], ledger["records"]
    eng = PagedGeneratorActor(cfg, params=params, attn="kernel", **kw)
    try:
        steps = count_step_syncs(torch, eng)
        run_requests(eng, prompts[:2], 8)
    finally:
        eng.close()
    sites = sorted({x for _, ss in steps for x in ss})
    row = {"phase": "serving_ledger", "preset": "optimus-125m",
           "requests": len(recs),
           **{key: s[key] for key in ("ttft_p50_ms", "ttft_p99_ms",
                                      "tpot_p50_ms", "tpot_p99_ms",
                                      "e2e_p50_ms", "e2e_p99_ms",
                                      "queue_wait_p99_ms",
                                      "retire_reasons")},
           "iterations": ledger["iterations"],
           "ttft_ms": [r.get("ttft_ms") for r in recs],
           "tpot_ms": [r.get("tpot_ms") for r in recs],
           "tokens_out": [r["tokens_out"] for r in recs],
           "tpot_samples": [len(r.get("decode_deltas_ms", ()))
                            for r in recs],
           "seam_cost": serving_mod.measure_seam_cost_us(),
           "plain_step_host_syncs": sorted({n for n, _ in steps}),
           "plain_step_sync_sites": sites,
           "spec_window_host_syncs": spec_syncs}
    emit(row)
    check(len(recs) == len(prompts)
          and all(r["reason"] == "complete" for r in recs),
          f"serving_ledger: records {[r['reason'] for r in recs]}")
    check(all((r.get("ttft_ms") or 0) > 0 for r in recs),
          "serving_ledger: a record has no TTFT")
    check(all(r["tokens_out"] == max_new
              and len(r["decode_deltas_ms"]) == max_new - 1 for r in recs),
          "serving_ledger: TPOT samples != tokens - 1")
    check(s["ttft_p99_ms"] >= s["ttft_p50_ms"] > 0
          and s["tpot_p99_ms"] >= s["tpot_p50_ms"] > 0,
          f"serving_ledger: summary {s}")
    check(not any(("health" in x or "metrics.py" in x or "trace.py" in x)
                  for x in sites),
          f"serving_ledger: the ledger's modules synchronized: {sites}")
    check(spec_syncs == [1], f"serving_ledger: a spec window made "
          f"{spec_syncs} host syncs with the ledger wired, want 1")


def disagg_run(torch, PagedGeneratorActor, cfg, params, prompts, max_new,
               kw, wire):
    """A prefill-class and a decode-class kernel engine in this process:
    each request is prefilled, planned, exported, imported and released
    one after another (each plan after the previous import), its decode
    started in a thread of its own. Returns (tokens, a summary dict)."""
    pre = PagedGeneratorActor(cfg, params=params, attn="kernel",
                              serve_class="prefill", **kw)
    dec = PagedGeneratorActor(cfg, params=params, attn="kernel",
                              serve_class="decode", **kw)
    outs, errs, threads, legs = [None] * len(prompts), [], [], []
    try:
        t0 = time.monotonic()
        for i, p in enumerate(prompts):
            rep = pre.Prefill(p[None], max_new)
            plan = dec.MigratePlan(p[None], max_new)
            t1 = time.monotonic()
            w = pre.ExportBlocks(rep["export_id"], plan["need"], wire)
            t2 = time.monotonic()
            dec.ImportBlocks(plan["ticket"], w)
            t3 = time.monotonic()
            check(pre.ReleaseExport(rep["export_id"]),
                  "disagg_engine: export not released")
            legs.append({"blocks": len(w["blocks"]), "bytes": w["nbytes"],
                         "need": len(plan["need"]),
                         "resident": plan["resident"],
                         "export_ms": (t2 - t1) * 1e3,
                         "import_ms": (t3 - t2) * 1e3})

            def decode(i=i, ticket=plan["ticket"], first=rep["first_token"]):
                try:
                    outs[i] = torch.tensor(
                        dec.MigrateDecode(ticket, first))[None]
                except Exception as e:  # noqa: BLE001 — reported below
                    errs.append(repr(e))

            threads.append(threading.Thread(target=decode))
            threads[-1].start()
        for t in threads:
            t.join(timeout=600)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        check(not errs, f"disagg_engine ({wire}): {errs}")
        check(all(o is not None for o in outs),
              f"disagg_engine ({wire}): a migrated decode hung")
        pi, di = pre.Info(), dec.Info()
        recs = dec.ledger.records()
        bad = pre.pool.check_invariants() + dec.pool.check_invariants()
        out = {"wire": wire, "seconds": wall, "legs": legs,
               "prefill_engine_steps": pi["engine_steps"],
               "decode_engine_steps": di["engine_steps"],
               "migrations": di["migrations"],
               "migrate_bytes": di["migrate_bytes"],
               "migrate_dedup_hits": di["migrate_dedup_hits"],
               "ledger_migrate_ms": [r.get("migrate_ms") for r in recs],
               "ledger_migrate_bytes": [r.get("migrate_bytes")
                                        for r in recs],
               "ttft_p50_ms": di["ttft_p50_ms"],
               "tpot_p50_ms": di["tpot_p50_ms"],
               "residuals_prefill": pre._migrator.residual_count(),
               "residuals_decode": dec._migrator.residual_count(),
               "pool_invariants": bad}
    finally:
        pre.close()
        dec.close()
    return outs, out


def disagg_phase(torch, tfm, paged_mod, PagedGeneratorActor, params,
                 prompts, max_new, kw):
    """Disaggregated prefill/decode at optimus-125m: f32 over the exact
    wire equals a unified engine token for token; bf16 over the exact
    wire (identical-token share printed) and over the q8 wire (every
    request decodes, at (1 + 4/512)/2 of the exact bytes, residuals on
    the prefill side); dedup of the shared prefix; paged launches only
    on the decode engine. Emits its row, then checks."""
    cfg = tfm.preset("optimus-125m")
    cfg32 = tfm.preset("optimus-125m", dtype=torch.float32)
    runs, toks = {}, {}
    for name, c, wire in (("f32_exact", cfg32, "exact"),
                          ("bf16_exact", cfg, "exact"),
                          ("bf16_q8", cfg, "q8")):
        paged_mod.paged_attention.launches = 0
        toks[name], runs[name] = disagg_run(
            torch, PagedGeneratorActor, c, params, prompts, max_new, kw,
            wire)
        runs[name]["paged_launches"] = paged_mod.paged_attention.launches
    uni = {}
    for name, c in (("f32", cfg32), ("bf16", cfg)):
        e = PagedGeneratorActor(c, params=params, attn="kernel", **kw)
        try:
            uni[name], _ = run_requests(e, prompts, max_new)
        finally:
            e.close()
    total = len(prompts) * max_new
    f32_same = same_tokens(toks["f32_exact"], uni["f32"])
    ex, q8 = runs["bf16_exact"], runs["bf16_q8"]
    ratio = q8["migrate_bytes"] / ex["migrate_bytes"]
    n_prefix = 96 // kw["block_tokens"]
    want_hits = (len(prompts) - 1) * n_prefix
    row = {"phase": "disagg_engine", "preset": "optimus-125m",
           "requests": len(prompts), "max_new": max_new,
           "block_pair_bytes_exact_bf16": ex["legs"][0]["bytes"]
           // ex["legs"][0]["blocks"],
           "f32_exact_identical_to_unified": f32_same == total,
           "bf16_exact_identical_share": same_tokens(
               toks["bf16_exact"], uni["bf16"]) / total,
           "bf16_q8_identical_share": same_tokens(
               toks["bf16_q8"], uni["bf16"]) / total,
           "q8_over_exact_bytes": ratio, "want_ratio": (1 + 4 / 512) / 2,
           "want_dedup_hits": want_hits, "runs": runs}
    emit(row)
    check(f32_same == total, f"disagg_engine: f32 exact-wire tokens equal "
          f"the unified engine's at {f32_same} of {total}")
    for name, r in runs.items():
        check(r["migrations"] == len(prompts),
              f"disagg_engine ({name}): {r['migrations']} migrations")
        check(r["migrate_dedup_hits"] == want_hits,
              f"disagg_engine ({name}): dedup hits "
              f"{r['migrate_dedup_hits']} != {want_hits}")
        check(r["prefill_engine_steps"] == 0,
              f"disagg_engine ({name}): the prefill engine decoded")
        check(r["paged_launches"] == r["decode_engine_steps"] * cfg.n_layers,
              f"disagg_engine ({name}): paged launches "
              f"{r['paged_launches']} != decode steps "
              f"{r['decode_engine_steps']} x {cfg.n_layers}")
        check(r["pool_invariants"] == [],
              f"disagg_engine ({name}): {r['pool_invariants']}")
    check(all(tuple(o.shape) == (1, max_new)
              and bool(((o >= 0) & (o < cfg.vocab_size)).all())
              for o in toks["bf16_q8"]),
          "disagg_engine: a q8-wire request did not decode in full")
    check(q8["migrate_bytes"] * 512 * 2 == ex["migrate_bytes"] * 516,
          f"disagg_engine: q8 bytes {q8['migrate_bytes']} are {ratio} of "
          f"exact {ex['migrate_bytes']}, want {(1 + 4 / 512) / 2}")
    check(q8["residuals_prefill"] > 0 and q8["residuals_decode"] == 0,
          "disagg_engine: q8 residuals not on the prefill side")
    return runs["bf16_exact"]["paged_launches"] + q8["paged_launches"]


def batching_phase(torch, tfm, flash_mod, BatchingGeneratorActor,
                   GeneratorActor, params, mixed, max_new):
    """``BatchingGeneratorActor`` with 8 concurrent greedy requests:
    equal-length prompts (8 x 512) coalesce into one batch whose prefill
    launches the flash kernel once a layer; mixed lengths (100-700)
    coalesce, left-padded, and launch none; in f32 every request's
    tokens equal its solo run. Emits its row, then checks."""
    gp = torch.Generator().manual_seed(5)
    cfg = tfm.preset("optimus-125m")
    equal = [torch.randint(1, cfg.vocab_size, (512,), generator=gp)
             for _ in range(8)]
    row = {"phase": "batching_generator", "preset": "optimus-125m",
           "requests": 8, "max_new": max_new}
    launches, flags = 0, []
    for dt in ("bf16", "f32"):
        c = tfm.preset("optimus-125m", **({} if dt == "bf16"
                                          else {"dtype": torch.float32}))
        actor = BatchingGeneratorActor(c, params=params, device="cuda",
                                       window_ms=500.0)
        solo = GeneratorActor(c, params=params, device="cuda")
        try:
            for name, prompts in (("equal", equal), ("mixed", mixed)):
                b0 = actor.Info()["batches"]
                flash_mod.flash_attention.launches = 0
                outs = [None] * len(prompts)
                barrier = threading.Barrier(len(prompts))

                def call(i, prompts=prompts, outs=outs, barrier=barrier):
                    barrier.wait()
                    outs[i] = actor.Generate(prompts[i][None].to("cuda"),
                                             max_new)

                ts = [threading.Thread(target=call, args=(i,))
                      for i in range(len(prompts))]
                t0 = time.monotonic()
                for t in ts:
                    t.start()
                for t in ts:
                    t.join(timeout=600)
                torch.cuda.synchronize()
                wall = time.monotonic() - t0
                n = flash_mod.flash_attention.launches
                check(all(o is not None for o in outs),
                      f"batching_generator ({dt}, {name}): a request hung")
                r = {"seconds": wall, "flash_launches": n,
                     "batches": actor.Info()["batches"] - b0,
                     "prompt_lens": sorted({len(p) for p in prompts})}
                if dt == "bf16" and name == "equal":
                    launches = n
                if dt == "f32":
                    same = same_tokens(outs, [solo.Generate(
                        p[None].to("cuda"), max_new) for p in prompts])
                    r["identical_to_solo"] = same == len(prompts) * max_new
                    flags.append((name, r["identical_to_solo"]))
                row[f"{dt}_{name}"] = r
        finally:
            actor.close()
    emit(row)
    want = {"equal": cfg.n_layers, "mixed": 0}
    for dt in ("bf16", "f32"):
        for name in ("equal", "mixed"):
            r = row[f"{dt}_{name}"]
            check(r["batches"] == 1, f"batching_generator ({dt}, {name}): "
                  f"{r['batches']} batches, want 1")
            check(r["flash_launches"] == want[name],
                  f"batching_generator ({dt}, {name}): "
                  f"{r['flash_launches']} flash launches, want {want[name]}")
    for name, ok in flags:
        check(ok, f"batching_generator (f32, {name}): tokens differ from "
              f"the solo runs")
    return launches


# ------------------------------------------- checkpoint and elastic


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def tensors_equal(torch, a, b):
    """Two trees (dicts of tensors, or lists) equal bit for bit."""
    from ptype_tpu_torch.checkpoint import _flatten

    def same(x, y):
        if torch.is_tensor(x) and torch.is_tensor(y):
            return torch.equal(x.detach(), y.detach())
        return x == y

    fa, fb = _flatten(a), _flatten(b)
    return ([p for p, _ in fa] == [p for p, _ in fb]
            and all(same(x, y) for (_, x), (_, y) in zip(fa, fb)))


def zero_writer_plan(torch, tfm):
    """The optimus-125m ZeRO plan's leaves (meta tensors, store-sorted
    key order) and decay masks — what the 2-rank writer and the card's
    restore both build."""
    from ptype_tpu_torch.models.weights import param_shapes
    from ptype_tpu_torch.parallel.collectives import tree_flatten

    cfg = tfm.preset("optimus-125m")
    pairs = sorted(((("params",) + path, shape) for path, shape in
                    tree_flatten(param_shapes(cfg))),
                   key=lambda kv: "/".join(kv[0]))
    leaves = [torch.empty(shape, device="meta", dtype=cfg.param_dtype)
              for _, shape in pairs]
    masks = ["norm" not in path[-1] and len(shape) > 1
             for path, shape in pairs]
    return leaves, masks


def zero_writer_moments(torch, b, i):
    """Bucket i's whole (unpadded) mu and nu, drawn from a seeded CPU
    generator: the source the card's restore is held to."""
    total = b.elems - b.pad
    g = torch.Generator().manual_seed(1000 + i)
    return (torch.randn(total, generator=g),
            torch.rand(total, generator=g))


def zero_writer(rank, world, workdir):
    """Helper mode (``--zero-writer RANK WORLD DIR``): one of ``world``
    gloo CPU ranks writing the optimus-125m ZeroCheckpoint of seeded
    moments into DIR/zero (the checkpoint phase restores it on the
    card)."""
    import torch

    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from ptype_tpu_torch.checkpoint import ZeroCheckpoint
    from ptype_tpu_torch.models import transformer as tfm
    from ptype_tpu_torch.parallel.mesh import build_mesh, init_distributed
    from ptype_tpu_torch.parallel.zero import ShardPlan, ZeroState
    from ptype_tpu_torch.train.trainer import default_optimizer_hparams

    torch.set_num_threads(2)
    init_distributed(f"file://{workdir}/rdv", rank, world, device="cpu")
    try:
        mesh = build_mesh({"data": world}, device="cpu")
        leaves, masks = zero_writer_plan(torch, tfm)
        plan = ShardPlan.for_leaves(leaves, world)
        zs = ZeroState.create(plan, mesh, "data",
                              default_optimizer_hparams(), masks)
        for i, b in enumerate(plan.buckets):
            mu, nu = zero_writer_moments(torch, b, i)
            s = plan.shard_elems(b)
            for acc, src in ((zs.mu, mu), (zs.nu, nu)):
                full = torch.zeros(b.elems)
                full[:src.numel()] = src
                acc[i] = full[rank * s:(rank + 1) * s].clone()
        zs.count = 7
        ZeroCheckpoint(os.path.join(workdir, "zero")).save(7, zs)
        torch.distributed.barrier()
    finally:
        torch.distributed.destroy_process_group()


def start_zero_writers(world):
    workdir = tempfile.mkdtemp(prefix="chip_smoke_zero_")
    env = dict(os.environ, OMP_NUM_THREADS="2", CUDA_VISIBLE_DEVICES="")
    script = os.path.abspath(__file__)
    procs = [subprocess.Popen([sys.executable, script, "--zero-writer",
                               str(r), str(world), workdir],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env)
             for r in range(world)]
    return workdir, procs


def join_zero_writers(procs, timeout=300):
    deadline = time.monotonic() + timeout
    try:
        for r, p in enumerate(procs):
            left = max(1.0, deadline - time.monotonic())
            out, _ = p.communicate(timeout=left)
            check(p.returncode == 0,
                  f"zero writer rank {r} exited {p.returncode}: "
                  f"{out.decode(errors='replace')[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def checkpoint_phase(torch, tfm, flash_mod, train_mod, mesh):
    """The checkpoint tier at optimus-125m (B=16, S=1024, bf16 compute,
    f32 params, seed 0): a Trainer saves step 2 in the background while
    steps 3-4 run, and a fresh Trainer restored from it runs steps 3-4
    bit for bit; the same for ZeRO-2 (ZeroCheckpoint + StoreCheckpoint)
    on the world-1 NCCL mesh; a ZeroCheckpoint of seeded moments written
    by 2 gloo CPU rank processes restores on the card byte for byte.
    Returns the phase's flash launches (fwd, dq, dkv)."""
    from ptype_tpu_torch.checkpoint import (Checkpointer, StoreCheckpoint,
                                            ZeroCheckpoint)
    from ptype_tpu_torch.parallel.tensorstore import TensorStore
    from ptype_tpu_torch.parallel.zero import ShardPlan, ZeroState
    from ptype_tpu_torch.train import store_dp as sd
    from ptype_tpu_torch.train import trainer as tr_mod

    writers_dir, writers = start_zero_writers(2)
    cfg = tfm.preset("optimus-125m")
    stream = train_mod.synthetic_batches(cfg.vocab_size, 16, 1024, seed=3,
                                         device="cuda")
    batches = [next(stream) for _ in range(4)]
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    counters = (flash_mod.flash_attention, flash_mod.flash_attention_dq,
                flash_mod.flash_attention_dkv)
    row = {"phase": "checkpoint", "preset": "optimus-125m", "B": 16,
           "S": 1024}
    try:
        for c in counters:
            c.launches = 0
        # The Trainer: async save of step 2 while steps 3-4 run.
        a, _ = new_trainer(torch, train_mod, cfg)
        ck = Checkpointer(os.path.join(root, "trainer"))
        la = [float(a.step(b)["loss"]) for b in batches[:2]]
        # The writers' disk traffic must not overlap any timed figure.
        join_zero_writers(writers)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        a.save(ck, background=True)
        row["async_call_ms"] = (time.monotonic() - t0) * 1e3
        row["snapshot_ms"] = ck.last_snapshot_s * 1e3
        t0 = time.monotonic()
        la += [float(a.step(b)["loss"]) for b in batches[2:]]
        row["step_ms_while_writing"] = (time.monotonic() - t0) / 2 * 1e3
        ck.wait()
        row["background_write_ms"] = ck.last_write_s * 1e3
        copy = lambda t: tr_mod.tree_map(torch.clone, t)  # noqa: E731
        opt = a.state.opt_state
        a_at_4 = tr_mod.TrainState(
            copy(a.state.params),
            tr_mod.AdamWState(opt.count, copy(opt.mu), copy(opt.nu)),
            a.state.step)
        row["bytes_written"] = dir_bytes(ck._step_dir(2))
        t0 = time.monotonic()
        a.save(ck)
        row["save_ms"] = (time.monotonic() - t0) * 1e3
        row["snapshot_ms_buffers_reused"] = ck.last_snapshot_s * 1e3
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for b in batches[:2]:  # steps 5-6, no write running
            a.step(b)
        torch.cuda.synchronize()
        row["step_ms_without_write"] = (time.monotonic() - t0) / 2 * 1e3
        b_ = train_mod.Trainer(
            cfg, device="cuda",
            generator=torch.Generator(device="cuda").manual_seed(1),
            optimizer=train_mod.default_optimizer(lr=1e-3, warmup=2),
            sync_every=0)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        b_.restore(ck, 2)
        torch.cuda.synchronize()
        row["restore_ms"] = (time.monotonic() - t0) * 1e3
        lb = [float(b_.step(b)["loss"]) for b in batches[2:]]
        row["losses"], row["resumed_losses"] = la, lb
        same = tensors_equal(torch, tr_mod.state_tree(a_at_4),
                             tr_mod.state_tree(b_.state))
        row["trainer_resume_bit_exact"] = lb == la[2:] and same
        check(row["trainer_resume_bit_exact"],
              f"checkpoint: the restored Trainer differs: {lb} vs {la[2:]},"
              f" state equal {same}")
        del a, b_, a_at_4
        torch.cuda.empty_cache()

        # ZeRO-2 on the world-1 NCCL mesh: ZeroCheckpoint + StoreCheckpoint.
        def z2(seed):
            return sd.StoreDPTrainer(
                cfg, TensorStore(mesh), zero=2,
                generator=torch.Generator(device="cuda").manual_seed(seed),
                zero_hparams=train_mod.OptHParams(lr=1e-3, warmup=2))

        t1 = z2(0)
        l1 = [t1.step(b)["loss"] for b in batches[:2]]
        t0 = time.monotonic()
        ZeroCheckpoint(os.path.join(root, "zero")).save(2, t1.zero_state())
        StoreCheckpoint(t1.store, os.path.join(root, "store"),
                        keys_prefix="params/").save(2)
        row["zero_save_ms"] = (time.monotonic() - t0) * 1e3
        row["zero_bytes_written"] = (
            dir_bytes(os.path.join(root, "zero"))
            + dir_bytes(os.path.join(root, "store")))
        l1 += [t1.step(b)["loss"] for b in batches[2:]]
        t2 = z2(1)
        t0 = time.monotonic()
        StoreCheckpoint(t2.store, os.path.join(root, "store"),
                        keys_prefix="params/").resume()
        ZeroCheckpoint(os.path.join(root, "zero")).restore_into(
            t2.zero_state())
        torch.cuda.synchronize()
        row["zero_restore_ms"] = (time.monotonic() - t0) * 1e3
        l2 = [t2.step(b)["loss"] for b in batches[2:]]
        z1, z2_ = t1.zero_state(), t2.zero_state()
        same = (tensors_equal(torch, t1.params(), t2.params())
                and tensors_equal(torch, z1.mu, z2_.mu)
                and tensors_equal(torch, z1.nu, z2_.nu)
                and z1.count == z2_.count)
        row["zero2_losses"], row["zero2_resumed_losses"] = l1, l2
        row["zero2_resume_bit_exact"] = l2 == l1[2:] and same
        check(row["zero2_resume_bit_exact"],
              f"checkpoint: the restored ZeRO-2 trainer differs: {l2} vs "
              f"{l1[2:]}, state equal {same}")
        del t1, t2, z1, z2_
        torch.cuda.empty_cache()
        launches = [c.launches for c in counters]
        want = (6 + 2 + 4 + 2) * cfg.n_layers  # A, B, ZeRO-2's two runs
        check(launches == [want] * 3,
              f"checkpoint: launches fwd/dq/dkv {launches} != {want} each")

        # The 2-rank CPU ZeroCheckpoint, restored at world 1 on the card.
        leaves, masks = zero_writer_plan(torch, tfm)
        plan = ShardPlan.for_leaves(leaves, 1)
        zs = ZeroState.create(plan, mesh, "data",
                              train_mod.OptHParams(), masks)
        zdir = os.path.join(writers_dir, "zero")
        t0 = time.monotonic()
        step = ZeroCheckpoint(zdir).restore_into(zs)
        torch.cuda.synchronize()
        row["cross_rank_restore_ms"] = (time.monotonic() - t0) * 1e3
        row["cross_rank_bytes"] = dir_bytes(zdir)
        manifests = sorted(f for f in os.listdir(os.path.join(
            zdir, "step_7")) if f.startswith("manifest"))
        ok = step == 7 and zs.count == 7 and manifests == [
            "manifest.p0.json", "manifest.p1.json"]
        for i, b in enumerate(plan.buckets):
            mu, nu = zero_writer_moments(torch, b, i)
            ok = ok and torch.equal(zs.mu[i].cpu(), mu) and torch.equal(
                zs.nu[i].cpu(), nu)
        row["cross_rank_buckets"] = len(plan.buckets)
        row["cross_rank_restore_byte_exact"] = ok
        check(ok, "checkpoint: the 2-rank ZeroCheckpoint did not restore "
              "byte for byte on the card")
        del zs
        emit(row)
        return launches
    finally:
        for p in writers:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(writers_dir, ignore_errors=True)
        torch.cuda.empty_cache()


def elastic_phase(torch, tfm, flash_mod, train_mod, mesh):
    """ElasticZeroTrainer (ZeRO-2) at optimus-125m on the world-1 NCCL
    mesh: rank 0 registered, and a second simulated registration on a
    local coordinator (lease TTL 0.5 s) advertising the same rank.
    inject_loss on it → MembershipChanged → recover (a 1 → 1 reshard) →
    the retried step; the losses and params must equal a run without
    the fault. Then measure_reshard at world 1. Returns the phase's
    flash launches (fwd, dq, dkv)."""
    from ptype_tpu_torch.coord.core import CoordState
    from ptype_tpu_torch.coord.local import LocalCoord
    from ptype_tpu_torch.elastic import (ElasticZeroTrainer,
                                         MembershipChanged, inject_loss)
    from ptype_tpu_torch.registry import CoordRegistry
    from ptype_tpu_torch.train import store_dp as sd

    cfg = tfm.preset("optimus-125m")
    stream = train_mod.synthetic_batches(cfg.vocab_size, 16, 1024, seed=4,
                                         device="cuda")
    batches = [next(stream) for _ in range(4)]
    counters = (flash_mod.flash_attention, flash_mod.flash_attention_dq,
                flash_mod.flash_attention_dkv)
    state = CoordState(sweep_interval=0.05)
    reg = CoordRegistry(LocalCoord(state), lease_ttl=0.5)
    hp = train_mod.OptHParams(lr=1e-3, warmup=2)
    row = {"phase": "elastic", "preset": "optimus-125m", "B": 16,
           "S": 1024, "zero": 2, "lease_ttl_s": 0.5}

    def trainer(service):
        return ElasticZeroTrainer(
            cfg, reg, service, mesh, zero=2, zero_hparams=hp,
            generator=torch.Generator(device="cuda").manual_seed(0))

    regs = []
    try:
        for c in counters:
            c.launches = 0
        regs.append(reg.register("base", "w0", "127.0.0.1", 9100,
                                 process_id=0))
        base = trainer("base")
        lb = [base.step(b)["loss"] for b in batches]
        pb = base.params()
        base.close()
        del base
        torch.cuda.empty_cache()
        regs.append(reg.register("elastic", "w0", "127.0.0.1", 9100,
                                 process_id=0))
        sim = reg.register("elastic", "w1", "127.0.0.1", 9101, process_id=0)
        regs.append(sim)
        t = trainer("elastic")
        lf = [t.step(b)["loss"] for b in batches[:2]]
        torch.cuda.synchronize()
        t0 = time.monotonic()
        inject_loss(sim)
        while not t.detector.changed and time.monotonic() - t0 < 10:
            time.sleep(0.0005)
        row["detect_ms"] = (time.monotonic() - t0) * 1e3
        raised = None
        try:
            lf.append(t.step(batches[2])["loss"])
        except MembershipChanged as e:
            raised = e
        check(raised is not None and raised.lost == ["127.0.0.1:9101"],
              f"elastic: no MembershipChanged for the lost registration "
              f"({raised}, losses {lf})")
        info = t.recover()
        row["recover"] = info
        row["reshard_ms"] = info["reshard_ms"]
        lf += [t.step(b)["loss"] for b in batches[2:]]
        row["losses"], row["faulted_losses"] = lb, lf
        same = tensors_equal(torch, t.params(), pb)
        row["equal_to_run_without_fault"] = lf == lb and same
        check(row["equal_to_run_without_fault"],
              f"elastic: the recovered run differs: {lf} vs {lb}, params "
              f"equal {same}")
        t.close()
        del t
        torch.cuda.empty_cache()
        launches = [c.launches for c in counters]
        want = 8 * cfg.n_layers
        check(launches == [want] * 3,
              f"elastic: launches fwd/dq/dkv {launches} != {want} each")
        t0 = time.monotonic()
        row["measure_reshard"] = sd.measure_reshard(
            mesh, preset="optimus-125m", steps=3, batch=16, seq=1024,
            zero=2)
        row["measure_reshard_s"] = time.monotonic() - t0
        emit(row)
        return launches
    finally:
        for h in regs:
            h.close()
        state.close()
        torch.cuda.empty_cache()


# ------------------------------------------------------- cluster_rpc phase


#: The cluster_rpc phase's lease TTL (s): a SIGKILLed server's
#: registration lapses within it, and the seed's sweeper (its
#: ``CoordState`` sweep interval) then deletes it.
CLUSTER_TTL = 1.0
#: Allowance on top of TTL + sweep for the watch push to reach the
#: client (a relist and one frame on loopback).
CLUSTER_DELIVERY_S = 0.25
#: Empty calls timed a transport, and the size of the bulk tensor.
RTT_CALLS = 2000
BULK_ELEMS = 64 * 2**20          # 256 MB of f32


class ServerProbe:
    """The cluster_rpc server's own endpoints: its kernel launch
    counters, an empty call, bulk transfers, and a gate that holds the
    paged engine's dispatch lock while requests queue in a fixed order
    (as ``run_in_order`` does in process)."""

    def __init__(self, torch, flash_mod, paged_mod, native, engine):
        self.torch, self.flash, self.paged = torch, flash_mod, paged_mod
        self.native, self.engine = native, engine
        self._held = threading.Event()
        self._release = threading.Event()
        self._holder = None

    def Counters(self):
        return {"flash_fwd": self.flash.flash_attention.launches,
                "paged_decode": self.paged.paged_attention.launches,
                "engine_steps": self.engine.Info()["engine_steps"],
                "native": self.native.available()}

    def Reset(self):
        self.flash.flash_attention.launches = 0
        self.paged.paged_attention.launches = 0

    def Nop(self):
        return None

    def Recv(self, x):
        """Where the tensor landed and its ends (the client checks them
        against what it sent)."""
        return [str(x.device), x.numel(), float(x[0]), float(x[-1])]

    def Send(self, n):
        return self.torch.arange(n, dtype=self.torch.float32, device="cuda")

    def Echo(self, x):
        return x

    def Hold(self):
        def hold():
            with self.engine._lock:
                self._held.set()
                self._release.wait(600)

        self._release.clear()
        self._held.clear()
        self._holder = threading.Thread(target=hold, daemon=True)
        self._holder.start()
        return self._held.wait(60)

    def Queued(self):
        return len(self.engine._queue) + (self.engine._admitting is not None)

    def Release(self):
        self._release.set()
        self._holder.join(timeout=60)
        return not self._holder.is_alive()


def actor_server(coord):
    """Helper mode (``--actor-server COORD``): the cluster_rpc phase's
    server process. Builds a ``GeneratorActor`` and an 8-slot
    ``PagedGeneratorActor`` (attn="kernel") at optimus-125m from seed-0
    weights on the card, serves them as ``Generator`` and ``Paged`` and
    a ``ServerProbe`` as ``Probe`` on an ``ActorServer`` (tensor
    arguments decode onto ``cuda``), then joins the TCP coordinator at
    COORD as service ``llm`` (lease TTL ``CLUSTER_TTL``). Prints one
    JSON line (when it called ``join``, whether the native wire
    loaded) and serves until killed."""
    import torch

    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from ptype_tpu_torch import (ActorServer, Config, PlatformConfig, join,
                                 native)
    from ptype_tpu_torch.models import transformer as tfm
    from ptype_tpu_torch.models.weights import init_params
    from ptype_tpu_torch.ops import flash_attention as flash_mod
    from ptype_tpu_torch.ops import paged_attention as paged_mod
    from ptype_tpu_torch.serve import GeneratorActor
    from ptype_tpu_torch.serve_engine import PagedGeneratorActor

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = tfm.preset("optimus-125m")
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    engine = PagedGeneratorActor(cfg, params=params, attn="kernel",
                                 device="cuda", n_slots=8, block_tokens=16,
                                 prefill_chunk=256)
    server = ActorServer()
    server.register(GeneratorActor(cfg, params=params, device="cuda"),
                    "Generator")
    server.register(engine, "Paged")
    server.register(ServerProbe(torch, flash_mod, paged_mod, native,
                                engine), "Probe")
    server.serve()
    join_called_at = time.time()
    cluster = join(Config(
        service_name="llm", node_name="actor-server", port=server.port,
        initial_cluster_client_urls=[coord],
        platform=PlatformConfig(name="actor-server", coordinator_address=coord,
                                lease_ttl=CLUSTER_TTL)))
    print(json.dumps({"join_called_at": join_called_at,
                      "native": native.available()}), flush=True)
    try:
        while True:
            time.sleep(3600)
    finally:
        cluster.close()
        server.close()
        engine.close()


def wait_child_line(proc, path, log, timeout):
    """The first line the child writes to ``path`` (JSON), or fail with
    its log if it exits or stays silent past ``timeout`` seconds."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        with open(path) as f:
            line = f.readline()
        if line.endswith("\n"):
            return json.loads(line)
        if proc.poll() is not None:
            break
        time.sleep(0.05)
    with open(log) as f:
        tail = f.read()[-4000:]
    raise SmokeError(f"cluster_rpc: the actor server wrote no ready line "
                     f"(exit {proc.poll()}):\n{tail}")


def percentiles_us(samples):
    s = sorted(samples)
    return {"p50_us": s[len(s) // 2] * 1e6,
            "p99_us": s[min(len(s) - 1, int(len(s) * 0.99))] * 1e6}


def rtt(client, n=RTT_CALLS):
    for _ in range(50):
        client.call("Probe.Nop")
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        client.call("Probe.Nop")
        out.append(time.perf_counter() - t0)
    return percentiles_us(out)


def cluster_rpc_phase(torch, flash_mod, paged_mod, GeneratorActor,
                      PagedGeneratorActor, params, prompt, gen_new, prompts,
                      max_new, kw, card):
    """The serving path through the port's cluster plane: a server
    process (``--actor-server``) found through a TCP coordinator that
    this process seeds with ``join``; ``new_client("llm")`` calls its
    ``Generator`` and ``Paged`` with CUDA prompts, and the replies land
    on the card equal, token for token, to in-process actors built from
    the same seed. Returns the server's (flash, paged) launches."""
    from ptype_tpu_torch import (ActorServer, Config, ConnConfig,
                                 PlatformConfig, join, native, rpc)
    from ptype_tpu_torch.errors import NoClientAvailableError
    from ptype_tpu_torch.models import transformer as tfm

    cfg = tfm.preset("optimus-125m")
    check(native.available(), "cluster_rpc: the native wire did not build")
    local = ActorServer()
    local.register(ServerProbe(torch, flash_mod, paged_mod, native, None),
                   "Probe")
    local.serve()
    seed = join(Config(
        service_name="local", node_name="smoke-seed", port=local.port,
        platform=PlatformConfig(name="smoke-seed",
                                coordinator_address="127.0.0.1:0",
                                is_coordinator=True, lease_ttl=CLUSTER_TTL)))
    addr = seed._owned_server.address
    sweep = seed._owned_server.state._sweep_interval
    work = tempfile.mkdtemp(prefix="chip_smoke_rpc_")
    out_path, log_path = (os.path.join(work, n) for n in ("out", "log"))
    with open(out_path, "w") as out_f, open(log_path, "w") as log_f:
        child = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--actor-server",
             addr], stdout=out_f, stderr=log_f)
    row = {"phase": "cluster_rpc", "preset": "optimus-125m", "card": card,
           "lease_ttl_s": CLUSTER_TTL, "sweep_s": sweep}
    client = local_client = engine = None
    try:
        conn_cfg = ConnConfig(initial_node_timeout=300, debounce_time=0.1,
                              retries=0, call_timeout=600)
        # new_client waits for the server's registration and dials it;
        # meanwhile this thread watches the child, so a server that dies
        # while it builds fails the phase at once.
        dialed = {}

        def dial():
            try:
                dialed["client"] = seed.new_client("llm", conn_cfg)
                dialed["at"] = time.time()
            except Exception as e:  # noqa: BLE001 — reported below
                dialed["error"] = e

        dialer = threading.Thread(target=dial, daemon=True)
        dialer.start()
        while dialer.is_alive() and child.poll() is None:
            dialer.join(timeout=0.05)
        ready = wait_child_line(child, out_path, log_path, 60)
        dialer.join(timeout=300)
        check("client" in dialed, f"cluster_rpc: no client: {dialed}")
        client = dialed["client"]
        row["join_to_first_connection_ms"] = (
            (dialed["at"] - ready["join_called_at"]) * 1e3)
        check(isinstance(client._conns.get(), rpc._Conn),
              "cluster_rpc: the client did not dial the server over TCP")
        row["native_wire"] = {"client": native.available(),
                              "server": ready["native"]}
        check(ready["native"], "cluster_rpc: the server's native wire "
              "did not build")

        # Generate: warm both sides, then rpc, in-process, in-process,
        # rpc (the server's launches counted over the two rpc calls).
        actor = GeneratorActor(cfg, params=params, device="cuda")
        wire_prompt = prompt.to(torch.int32)  # the reference's token type
        client.call("Generator.Generate", wire_prompt, gen_new)
        actor.Generate(prompt, gen_new)
        torch.cuda.synchronize()
        client.call("Probe.Reset")
        walls = {"rpc": [], "in_process": []}
        outs = []
        for side in ("rpc", "in_process", "in_process", "rpc"):
            t0 = time.monotonic()
            if side == "rpc":
                outs.append(client.call("Generator.Generate", wire_prompt,
                                        gen_new))
            else:
                want = actor.Generate(prompt, gen_new)
            torch.cuda.synchronize()
            walls[side].append(time.monotonic() - t0)
        gen_counts = client.call("Probe.Counters")
        del actor
        check(all(o.device.type == "cuda" for o in outs),
              f"cluster_rpc: Generate's reply landed on {outs[0].device}")
        check(all(torch.equal(o, want) for o in outs), "cluster_rpc: "
              "Generate over RPC differs from the in-process actor's tokens")
        check(gen_counts["flash_fwd"] == 2 * cfg.n_layers,
              f"cluster_rpc: {gen_counts['flash_fwd']} flash launches for "
              f"two prefills, want {2 * cfg.n_layers}")
        row.update({"generate_prompt": list(prompt.shape),
                    "generate_max_new": gen_new,
                    "generate_rpc_s": walls["rpc"],
                    "generate_in_process_s": walls["in_process"],
                    "generate_server_counters": gen_counts})

        # Paged: phase 4's requests queued in a fixed order behind the
        # server's dispatch lock, against an in-process engine's.
        client.call("Probe.Reset")
        steps0 = client.call("Probe.Counters")["engine_steps"]
        check(client.call("Probe.Hold"), "cluster_rpc: gate not taken")
        futs = []
        for i, p in enumerate(prompts):
            futs.append(client.go("Paged.Generate",
                                  p.to("cuda", torch.int32)[None], max_new))
            deadline = time.monotonic() + 60
            while (client.call("Probe.Queued") < i + 1
                   and time.monotonic() < deadline):
                time.sleep(0.001)
        t0 = time.monotonic()
        check(client.call("Probe.Release"), "cluster_rpc: gate stuck")
        paged_got = [f.result(timeout=600) for f in futs]
        row["paged_rpc_s"] = time.monotonic() - t0
        paged_counts = client.call("Probe.Counters")
        steps = paged_counts["engine_steps"] - steps0
        engine = PagedGeneratorActor(cfg, params=params, attn="kernel", **kw)
        t0 = time.monotonic()
        paged_want = run_in_order(engine, [p.to("cuda") for p in prompts],
                                  max_new)
        row["paged_in_process_s"] = time.monotonic() - t0
        engine.close()
        engine = None
        same = sum(int(torch.equal(a, b))
                   for a, b in zip(paged_got, paged_want))
        row.update({"paged_requests": len(prompts), "paged_decode_steps":
                    steps, "paged_server_counters": paged_counts,
                    "paged_rows_equal": same})
        check(all(o.device.type == "cuda" for o in paged_got),
              "cluster_rpc: paged replies not on the card")
        check(same == len(prompts), f"cluster_rpc: {len(prompts) - same} "
              "paged rows over RPC differ from the in-process engine's")
        check(steps > 0 and paged_counts["paged_decode"]
              == steps * cfg.n_layers,
              f"cluster_rpc: paged launches {paged_counts['paged_decode']} "
              f"!= decode steps {steps} x {cfg.n_layers}")

        # Round trips of an empty call: TCP, and _LocalConn in process.
        local_client = seed.new_client("local", conn_cfg)
        check(isinstance(local_client._conns.get(), rpc._LocalConn),
              "cluster_rpc: the in-process client did not take _LocalConn")
        row["rtt_tcp"] = rtt(client)
        row["rtt_local"] = rtt(local_client)

        # Bulk: a 256 MB f32 CUDA tensor each way, then echoed.
        x = torch.arange(BULK_ELEMS, dtype=torch.float32, device="cuda")
        nbytes = x.numel() * 4
        up, down = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            seen = client.call("Probe.Recv", x)
            up.append(time.monotonic() - t0)
            check(seen[0].startswith("cuda") and seen[1:] == [
                x.numel(), float(x[0]), float(x[-1])],
                f"cluster_rpc: the bulk tensor arrived as {seen}")
            t0 = time.monotonic()
            y = client.call("Probe.Send", BULK_ELEMS)
            torch.cuda.synchronize()
            down.append(time.monotonic() - t0)
            check(y.device.type == "cuda" and torch.equal(y, x),
                  "cluster_rpc: the bulk tensor came back different")
            del y
        echoed = client.call("Probe.Echo", x)
        check(echoed.device.type == "cuda" and torch.equal(echoed, x),
              "cluster_rpc: the echoed bulk tensor differs")
        del echoed, x
        row.update({"bulk_bytes": nbytes,
                    "to_server_GBps": [nbytes / t / 1e9 for t in up],
                    "to_client_GBps": [nbytes / t / 1e9 for t in down]})

        # Loss: SIGKILL the server; the registry watch must deliver the
        # empty snapshot within TTL + sweep, then calls find no node.
        watch = seed.registry.watch_service("llm")
        check(len(watch.get(timeout=5) or []) == 1,
              "cluster_rpc: the server is not registered")
        t0 = time.monotonic()
        os.kill(child.pid, signal.SIGKILL)
        snap = None
        while snap != [] and time.monotonic() - t0 < 10:
            snap = watch.get(timeout=10 - (time.monotonic() - t0))
        empty_s = time.monotonic() - t0
        watch.cancel()
        refused = None
        while time.monotonic() - t0 < 20:
            try:
                client.call("Probe.Nop")
            except NoClientAvailableError as e:
                refused = e
                break
            except Exception:  # noqa: BLE001 — a dying connection first
                pass
            time.sleep(0.01)
        nca_s = time.monotonic() - t0
        row.update({"kill_to_empty_snapshot_ms": empty_s * 1e3,
                    "kill_to_no_client_ms": nca_s * 1e3,
                    "detect_bound_ms": (CLUSTER_TTL + sweep
                                        + CLUSTER_DELIVERY_S) * 1e3})
        emit(row)
        check(snap == [], "cluster_rpc: no empty snapshot after the kill")
        check(empty_s <= CLUSTER_TTL + sweep + CLUSTER_DELIVERY_S,
              f"cluster_rpc: the loss took {empty_s:.3f} s to detect")
        check(refused is not None, "cluster_rpc: calls after the kill did "
              "not raise NoClientAvailableError")
        return gen_counts["flash_fwd"], paged_counts["paged_decode"]
    finally:
        if child.poll() is None:
            child.kill()
        child.wait(timeout=60)
        for h in (client, local_client, engine):
            if h is not None:
                h.close()
        seed.close()
        local.close()
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()


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
    from ptype_tpu_torch.parallel.mesh import build_mesh, init_distributed
    from ptype_tpu_torch.health import serving as serving_mod
    from ptype_tpu_torch.serve import BatchingGeneratorActor, GeneratorActor
    from ptype_tpu_torch.serve_engine import PagedGeneratorActor, SpecConfig
    import ptype_tpu_torch.train as train_mod

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()

    # 1. build
    t0 = time.monotonic()
    built = _build.build_all()
    regs = {n: ptxas_summary(_build, log)
            for n, log in _build.build_logs.items()}
    sass = {p.stem: _build.sass_counts(p.stem)
            for p in sorted(_build.CSRC.glob("*.cu"))}
    emit({"phase": "build", "seconds": time.monotonic() - t0,
          "built": built, "ptxas": regs, "sass": sass, "card": card})
    for lib, kernel in (("flash_fwd", "flash_fwd_kernel_bf16"),
                        ("flash_bwd", "flash_bwd_dq_kernel_bf16"),
                        ("flash_bwd", "flash_bwd_dkv_kernel_bf16")):
        for dh in (64, 128):
            ops = sass[lib].get(f"{kernel}<{dh}>", {})
            check(ops.get("HGMMA", 0) > 0 and ops.get("UTMALDG", 0) > 0,
                  f"{kernel}<{dh}> has no wgmma or TMA load in its SASS: "
                  f"{ops}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. kernels against their plain versions, at the shapes of
    # optimus-125m (Dh=128) and optimus-moe (Dh=64)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for dt in (torch.bfloat16, torch.float32):
        for H, Kh in ((6, 6), (32, 8)):
            cases.append(paged_case(torch, paged_mod, H, Kh, dt, flush, g))
            emit(cases[-1])
    cases.append(paged_case(torch, paged_mod, 12, 12, torch.bfloat16, flush,
                            g, Dh=64))
    emit(cases[-1])
    for B, S, H, K, dt, Dh in ((4, 512, 6, 6, torch.bfloat16, 128),
                               (4, 1024, 6, 6, torch.bfloat16, 128),
                               (16, 1024, 6, 6, torch.bfloat16, 128),
                               (1, 2048, 32, 8, torch.bfloat16, 128),
                               (4, 512, 6, 6, torch.float32, 128),
                               (4, 512, 12, 12, torch.bfloat16, 64),
                               (16, 1024, 12, 12, torch.bfloat16, 64)):
        cases.append(flash_case(torch, F, flash_mod, B, S, H, K, dt, flush,
                                g, Dh=Dh))
        emit(cases[-1])
    for B, S, H, K, dt, causal, Dh in (
            (16, 1024, 6, 6, torch.bfloat16, True, 128),
            (4, 512, 6, 6, torch.float32, True, 128),
            (1, 2048, 32, 8, torch.bfloat16, True, 128),
            (4, 1024, 6, 6, torch.bfloat16, False, 128),
            (16, 1024, 12, 12, torch.bfloat16, True, 64)):
        for row in bwd_case(torch, F, flash_mod, B, S, H, K, dt, causal,
                            flush, g, Dh=Dh):
            cases.append(row)
            emit(row)
    del flush

    # 3. GeneratorActor at optimus-125m
    cfg = tfm.preset("optimus-125m")
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    gc = torch.Generator().manual_seed(1)
    prompt = torch.randint(1, cfg.vocab_size, (4, 512), generator=gc)
    prompt = prompt.to("cuda")
    flash_launches = generator_phase(
        torch, tfm, gen_mod, flash_mod, GeneratorActor, "optimus-125m",
        params, prompt, 32, "generator_actor")

    # 4. PagedGeneratorActor at optimus-125m
    gp = torch.Generator().manual_seed(2)
    shared = torch.randint(1, cfg.vocab_size, (96,), generator=gp)
    lens = (100, 180, 260, 340, 420, 500, 600, 700)
    prompts = [torch.cat([shared, torch.randint(
        1, cfg.vocab_size, (n - 96,), generator=gp)]) for n in lens]
    max_new = 64
    kw = dict(device="cuda", n_slots=8, block_tokens=16, prefill_chunk=256)
    row, paged_main_launches, _, paged_ledger = engine_phase(
        torch, paged_mod, PagedGeneratorActor, "optimus-125m", cfg, params,
        prompts, lens, max_new, kw, "paged_engine")
    emit(row)

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
    del e
    torch.cuda.empty_cache()

    # cluster_rpc: phases 3 and 4 served over the port's cluster plane
    rpc_flash, rpc_paged = cluster_rpc_phase(
        torch, flash_mod, paged_mod, GeneratorActor, PagedGeneratorActor,
        params, prompt, 32, prompts, max_new, kw, card)

    # 5. Trainer at optimus-125m
    row, (fwd_n, dq_n, dkv_n) = trainer_phase(torch, tfm, flash_mod,
                                              train_mod, "optimus-125m",
                                              "trainer")
    emit(row)
    emit(grad_parity(torch, tfm, train_mod, cfg))
    torch.cuda.empty_cache()

    # MoE: GeneratorActor, paged engine and Trainer at optimus-moe
    mcfg = tfm.preset("optimus-moe")
    mparams = init_params(torch.Generator(device="cuda").manual_seed(0),
                          mcfg)
    moe_flash_launches = generator_phase(
        torch, tfm, gen_mod, flash_mod, GeneratorActor, "optimus-moe",
        mparams, prompt, 32, "moe_generator")
    h = torch.randn(8, 1, mcfg.d_model, generator=g, device="cuda").to(
        mcfg.dtype)
    layer = tfm.layer_params(mparams, 0)
    n, sites = count_syncs(torch, lambda: tfm._moe_mlp(h, layer, mcfg,
                                                       capacity=8))
    emit({"phase": "moe_mlp_syncs", "shape": [8, 1, mcfg.d_model],
          "host_syncs": n, "sites": sites})
    check(n == 0, f"the MoE MLP synchronized with the host {n} times: "
          f"{sites}")
    row, moe_paged_launches, _, _ = engine_phase(
        torch, paged_mod, PagedGeneratorActor, "optimus-moe", mcfg,
        mparams, prompts, lens, max_new, kw, "moe_paged_engine")
    emit(row)
    mcfg32 = tfm.preset("optimus-moe", dtype=torch.float32)
    e = PagedGeneratorActor(mcfg32, params=mparams, attn="kernel", **kw)
    try:
        eng32, _ = run_requests(e, prompts, max_new)
    finally:
        e.close()
    contiguous = [gen_mod.generate(mparams, mcfg32, p.to("cuda")[None],
                                   max_new) for p in prompts]
    div = first_divergence(torch, gen_mod, mparams, mcfg32, prompts, eng32,
                           contiguous)
    emit({"phase": "moe_paged_parity",
          "f32_kernel_engine_equals_contiguous": div is None,
          "first_divergence": div})
    check(div is None, f"moe f32 engine tokens differ from the contiguous "
          f"path's: {div}")
    del e, eng32, contiguous
    torch.cuda.empty_cache()
    row, (moe_fwd_n, moe_dq_n, moe_dkv_n) = trainer_phase(
        torch, tfm, flash_mod, train_mod, "optimus-moe", "moe_trainer")
    emit(row)
    torch.cuda.empty_cache()

    # Speculative decoding on the paged engine at optimus-125m
    spec_launches, spec_syncs = spec_phase(torch, tfm, gen_mod, paged_mod,
                               PagedGeneratorActor, SpecConfig, params,
                               prompts, max_new, kw)
    torch.cuda.empty_cache()

    # Sampled requests, the serving ledger, disaggregated prefill/decode
    # and the batching actor, at optimus-125m
    sampled_launches = sampled_phase(torch, tfm, gen_mod, paged_mod,
                                     PagedGeneratorActor, SpecConfig, params,
                                     prompts, max_new, kw)
    torch.cuda.empty_cache()
    ledger_phase(torch, serving_mod, PagedGeneratorActor, cfg, params,
                 prompts, max_new, kw, paged_ledger, spec_syncs)
    disagg_launches = disagg_phase(torch, tfm, paged_mod, PagedGeneratorActor,
                                   params, prompts, max_new, kw)
    torch.cuda.empty_cache()
    batch_launches = batching_phase(torch, tfm, flash_mod,
                                    BatchingGeneratorActor, GeneratorActor,
                                    params, prompts, 32)
    torch.cuda.empty_cache()

    # store_dp: StoreDPTrainer through the Store, world 1 over NCCL
    rdv = tempfile.mkdtemp(prefix="chip_smoke_pg_")
    init_distributed(f"file://{rdv}/rdv", 0, 1)
    mesh = build_mesh({"data": 1})
    store_launches = store_dp_phase(torch, tfm, flash_mod, train_mod, mesh)
    store_dp_f32_phase(torch, tfm, flash_mod, train_mod, mesh)
    torch.cuda.empty_cache()

    # checkpoint and elastic: save/resume and live reshard at optimus-125m
    ckpt_launches = checkpoint_phase(torch, tfm, flash_mod, train_mod, mesh)
    elastic_launches = elastic_phase(torch, tfm, flash_mod, train_mod, mesh)

    # 6. profiles, after every host-timed phase: one engine decode
    # iteration, one train step of each model, one speculation window,
    # one StoreDPTrainer step each of two rungs
    eng = PagedGeneratorActor(cfg, params=params, attn="kernel", **kw)
    try:
        emit({"phase": "engine_iteration_profile",
              **engine_iteration_profile(torch, eng, prompts, 32)})
    finally:
        eng.close()
    emit(trainer_profile(torch, tfm, train_mod, "optimus-125m"))
    torch.cuda.empty_cache()
    emit(trainer_profile(torch, tfm, train_mod, "optimus-moe", MOE_RANGES))
    torch.cuda.empty_cache()
    dp, dc = gen_mod.truncated_draft_params(params, cfg, n_layers=2)
    eng = PagedGeneratorActor(
        cfg, params=params, attn="kernel",
        spec=SpecConfig(dp, dc, k=4, adaptive=False), **kw)
    try:
        emit({"phase": "spec_window_profile",
              **spec_window_profile(torch, gen_mod, eng, prompts, 128)})
    finally:
        eng.close()
    torch.cuda.empty_cache()
    for zero, overlap in ((0, True), (2, False)):
        emit(store_dp_profile(torch, tfm, train_mod, mesh, zero, overlap))
        torch.cuda.empty_cache()
    torch.distributed.destroy_process_group()
    shutil.rmtree(rdv, ignore_errors=True)

    def main_row(name, source, replaces, launches, row, by_path, **extra):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "launches_by_path": by_path,
                "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "library_ms": row["library_ms"],
                "vs_library": row["vs_library"], "dtype": row["dtype"],
                "shape": {k: row[k] for k in ("B", "S", "H", "K", "Kh", "Dh")
                          if k in row},
                **extra}

    def pick(kernel, B, H, Dh, S=None):
        return next(c for c in cases if c["kernel"] == kernel
                    and c.get("S") == S and c["B"] == B and c["H"] == H
                    and c["Dh"] == Dh and c["dtype"] == "bf16"
                    and c.get("causal", True))

    fwd_src = "ptype_tpu_torch/ops/csrc/flash_fwd.cu"
    bwd_src = "ptype_tpu_torch/ops/csrc/flash_bwd.cu"
    paged_src = "ptype_tpu_torch/ops/csrc/paged_decode.cu"
    fwd_ref = "ptype_tpu/ops/flash_attention.py:160"
    dq_ref = "ptype_tpu/ops/flash_attention.py:320"
    dkv_ref = "ptype_tpu/ops/flash_attention.py:342"
    paged_ref = "ptype_tpu/ops/paged_attention.py:149"
    fwd128 = {"generator_actor": flash_launches, "cluster_rpc": rpc_flash,
              "trainer": fwd_n,
              "batching_generator": batch_launches,
              "store_dp": store_launches[0],
              "checkpoint": ckpt_launches[0],
              "elastic": elastic_launches[0]}
    fwd64 = {"moe_generator": moe_flash_launches, "moe_trainer": moe_fwd_n}
    paged128 = {"paged_engine": paged_main_launches,
                "cluster_rpc": rpc_paged,
                "spec_engine": spec_launches["spec"],
                "spec_engine_plain_run": spec_launches["plain"],
                "sampled_engine": sampled_launches,
                "disagg_engine": disagg_launches}
    paged64 = {"moe_paged_engine": moe_paged_launches}

    def rows(name, src, ref, row, by_path, **extra):
        return main_row(name, src, ref, sum(by_path.values()), row, by_path,
                        **extra)

    paged_rows = [pick("paged_decode", 8, 6, 128),
                  pick("paged_decode", 8, 12, 64)]
    emit({"kernels": [
        rows("flash_fwd", fwd_src, fwd_ref,
             pick("flash_fwd", 4, 6, 128, 512), fwd128),
        rows("flash_fwd", fwd_src, fwd_ref,
             pick("flash_fwd", 16, 6, 128, 1024), fwd128),
        rows("flash_fwd", fwd_src, fwd_ref,
             pick("flash_fwd", 4, 12, 64, 512), fwd64),
        rows("flash_fwd", fwd_src, fwd_ref,
             pick("flash_fwd", 16, 12, 64, 1024), fwd64),
        rows("flash_bwd_dq", bwd_src, dq_ref,
             pick("flash_bwd_dq", 16, 6, 128, 1024),
             {"trainer": dq_n, "store_dp": store_launches[1],
              "checkpoint": ckpt_launches[1],
              "elastic": elastic_launches[1]}),
        rows("flash_bwd_dq", bwd_src, dq_ref,
             pick("flash_bwd_dq", 16, 12, 64, 1024),
             {"moe_trainer": moe_dq_n}),
        rows("flash_bwd_dkv", bwd_src, dkv_ref,
             pick("flash_bwd_dkv", 16, 6, 128, 1024),
             {"trainer": dkv_n, "store_dp": store_launches[2],
              "checkpoint": ckpt_launches[2],
              "elastic": elastic_launches[2]}),
        rows("flash_bwd_dkv", bwd_src, dkv_ref,
             pick("flash_bwd_dkv", 16, 12, 64, 1024),
             {"moe_trainer": moe_dkv_n}),
        rows("paged_decode", paged_src, paged_ref, paged_rows[0], paged128,
             device_ms=paged_rows[0]["device_ms"],
             host_us=paged_rows[0]["host_us"]),
        rows("paged_decode", paged_src, paged_ref, paged_rows[1], paged64,
             device_ms=paged_rows[1]["device_ms"],
             host_us=paged_rows[1]["host_us"])]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": count}})


if __name__ == "__main__":
    if sys.argv[1:2] == ["--zero-writer"]:
        zero_writer(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        sys.exit(0)
    if sys.argv[1:2] == ["--actor-server"]:
        actor_server(sys.argv[2])
        sys.exit(0)
    try:
        main()
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
    except Exception:  # noqa: BLE001 — any failure is a failed run
        traceback.print_exc()
        sys.exit(1)
