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
   gateway_serving: two replica processes of the script (``--actor-server
   COORD --serve-class prefill|decode --service llm-gw``: an 8-slot bf16
   ``Paged`` and f32 ``Paged32`` kernel engine each) behind the port's
   InferenceGateway (per_replica_inflight 8): (a) phase 4's requests
   interleaved in f32, int32 answers on the card equal to in-process solo
   runs, both replicas used; (b) the same disaggregated over the exact
   wire, equal to (a)'s, 8 migrations and no fallback, the migration
   stage's ms and bytes; (c) bf16 over the q8 wire at (1 + 4/512)/2 of
   exact's bytes a block; (d) open-loop traffic (the port's loadgen:
   ``synth_trace`` seed 0, 8 s of arrivals at each rate of GW_RATES, RAG's
   prompt tail cut to 800) through ``OpenLoopDriver`` and
   ``gateway_target``: every arrival answered or shed typed, per rate the
   traffic ledger's, the gateway's and the replicas' TTFT/TPOT/e2e tails,
   tokens/s, issue lag and the gateway's stage ms, then the knee and the
   rate where the gateway saturates (sheds, or a queue-wait p99 past the
   TTFT yardstick); (e) the decode replica SIGKILLed halfway
   through a run at half the knee: no arrival lost, the ms to its
   eviction. Paged launches on both replicas = decode steps x 12 in
   (a) and (b);
   reconciler: the port's Reconciler (min 2, max 3, one warm standby,
   cooldown 2 s, tick 0.2 s) over replica worker processes
   (``ProcessLauncher``, ``python -m ptype_tpu_torch.reconciler.worker``
   of kind ``custom`` with ``chip_smoke:rec_replica``: gateway_serving's
   bf16 ``Paged`` engine) behind the port's gateway (8 in flight a
   replica): (a) from an empty fleet to 2 active and 1 warm, with each
   spawn's Popen -> ready -> activate times; (b) phase 4's requests one
   at a time, int32 on the card equal to an in-process solo run; (c) 16
   s of open-loop arrivals at 8 rps (``synth_trace`` seed 0), the newest
   active replica SIGKILLed at 4 s: one death, one replacement (the warm
   standby), every arrival answered or shed typed, the ms from the kill
   to its leaving the registry, to the replacement's activation and
   first answer, and to the warm pool's refill, and the fleet's answered
   rps and tails before and after; (d) scripted hints grow the fleet to
   3 and shrink it under traffic: one drain, nothing lost, no
   escalation, its wall time; (e) a ``kind="paged"`` worker with no
   device variable serves on the card. Every replica's paged launches =
   its decode steps x 12; no worker process outlives the phase;
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
   health: the port's health plane at optimus-125m: (a) a GoodputLedger
   on the annotate seam (analytic and counted FLOPs, the default
   Sampler armed) over 8 StoreDPTrainer steps (ZeRO 0, exact, B=16,
   S=1024, after 2 warm ones): 8 records closed, each one's legs
   summing to its step, train.steps +8, the counted-vs-analytic FLOPs
   gap within 10%, fwd/dq/dkv launched 10 x 12 times; the same over the
   plain Trainer, whose regions time dispatch (printed, not gated);
   (b) blocks of 8 steps with the Sampler at its default cadence and
   without, alternated, beside a tick's cost over the cadence; (c) a
   replica process of the script (``--actor-server COORD --service
   llm-health --series 0.2``), warmed by one short request, serves
   phase 4's 8 requests on its bf16 ``Paged`` engine and one (1, 512)
   prompt on its ``Generator`` (whose prefill runs the flash forward;
   the engine's chunked prefill attends through the block table) while
   ``telemetry.cluster_profile`` captures 1 s of it over
   ``ptype.Profile``: the shipped Chrome trace holds
   flash_fwd_kernel_bf16 and paged_decode_split_kernel events, and the
   ``memory`` verb's bytes_in_use is at least the weights' bytes; (d)
   a ``cluster_snapshot`` of the replica and this process: no alert
   from ``default_rules()``, ``render_top``/``render_serve`` printed,
   an OpenMetrics line for every metric family;
   failover: coordinator failover and the operator CLI at optimus-125m,
   every process a ``python -m ptype_tpu_torch`` verb of this checkout
   with a two-level config tree (written as JSON): (a) a ``witness``, a
   seed (``join``, witness-fenced, lease TTL 1 s), a wal-stream
   ``standby`` and a ``serve`` replica (BatchingGeneratorActor), each
   one's ms from Popen to its ready line and the standby's to
   promote-eligible; (b) phase 4's prompts one at a time, 32 greedy
   tokens, through ``new_client``: the replica's answers on the card
   equal an in-process BatchingGeneratorActor's; (c) one (1, 512)
   prompt at 2 rps for 12 s, the seed SIGKILLed at 4 s: every request
   answered, the ms from the kill to the standby's promotion (its
   address accepting), the witness lease changing hands, a registry read
   through the promoted standby listing the replica and a client built
   after the promotion answering, the new term; the old seed restarted
   on its data dir refuses a write fenced with that term; (d) ``obs`` of
   the promoted cluster writes trace.json and spans.jsonl and lists the
   replica, and ``obs profile`` under load ships a trace with at least
   12 flash_fwd_kernel_bf16 records; (e) the ``train`` verb in this
   process (``__main__.main()``, store mode, B=16, S=1024, 8 steps,
   CKPT_EVERY 4) on a fresh seed and wal-stream standby, the seed
   SIGKILLed after the first step, beside an uninterrupted run of the
   same verb on the promoted cluster: equal losses, 96 launches each of
   forward, dq and dk/dv a run, manifests on the promoted standby, each
   step's ms and the stall of the steps after the kill; ``eval`` of its
   checkpoint (3 steps) reads step 8; (f) ``info`` reads the card;
   (g) no child process outlives the phase;
6. after every host-timed phase (a process that has run a
   torch.profiler session launches kernels more slowly afterwards),
   under torch.profiler (wall, device-busy and idle share, device time
   by kernel family, top host ops): a new engine's first decode
   iteration with every slot live (phase 4's configuration, 32 new
   tokens); one train step each of optimus-125m and optimus-moe, the
   latter with its router, dispatch, experts and combine named apart;
   one speculation window with every slot live, draft, verify and
   accept named apart; one StoreDPTrainer step each of (ZeRO 0,
   exact) — health's goodput rung —, (ZeRO 0, overlap) and (ZeRO-2,
   exact), NCCL and the bucket pack (cat) among the families.

Then the kernels' JSON line, the card line, and as the last line
``{"ok": true, "device": {...}}``. Any failed check exits non-zero.
Weights are random, from a fixed seed. Without a CUDA device, or
outside a checkout, it exits non-zero and prints no result.
"""

import dataclasses
import json
import math
import os
import re
import shutil
import signal
import socket
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
    # The Trainer's own step ranges (train.step, train#<n>) are ranges,
    # not kernels, as the named ones are.
    own = sorted({ev.key for ev in prof.key_averages()
                  if ev.key.startswith(("train.", "train#"))})
    out = {"phase": "trainer_profile", "preset": name,
           **profile_summary(prof, wall_ms, labels + own)}
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
    """A server process's own endpoints: its kernel launch counters
    (and both paged engines' decode steps), an empty call, bulk
    transfers, the bf16 engine's ledger records, and a gate that holds
    the paged engine's dispatch lock while requests queue in a fixed
    order (as ``run_in_order`` does in process)."""

    def __init__(self, torch, flash_mod, paged_mod, native, engine,
                 engine32=None):
        self.torch, self.flash, self.paged = torch, flash_mod, paged_mod
        self.native, self.engine, self.engine32 = native, engine, engine32
        self._held = threading.Event()
        self._release = threading.Event()
        self._holder = None

    def Counters(self):
        out = {"flash_fwd": self.flash.flash_attention.launches,
               "paged_decode": self.paged.paged_attention.launches,
               "engine_steps": self.engine.Info()["engine_steps"],
               "native": self.native.available()}
        if self.engine32 is not None:
            out["engine_steps32"] = self.engine32.Info()["engine_steps"]
            out["migrations32"] = self.engine32.Info()["migrations"]
        return out

    def Records(self, since):
        """The bf16 engine's retired records enqueued at or after the
        wall time ``since``: (ttft_ms, tpot_ms, e2e_ms) each."""
        return [[r.get("ttft_ms"), r.get("tpot_ms"), r.get("e2e_ms")]
                for r in self.engine.ledger.records() if r["t"] >= since]

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


def actor_server(coord, serve_class="unified", service="llm",
                 series_s=None):
    """Helper mode (``--actor-server COORD [--serve-class CLASS]
    [--service NAME] [--series CADENCE]``): the server process of the
    cluster_rpc phase and the replicas of gateway_serving and health. Builds a ``GeneratorActor`` and
    two 8-slot ``PagedGeneratorActor``s of serving class CLASS
    (attn="kernel", 16-token blocks, 256-token prefill chunks; bf16 and
    f32) at optimus-125m from seed-0 weights on the card, serves them
    as ``Generator``, ``Paged`` and ``Paged32`` and a ``ServerProbe``
    as ``Probe`` on an ``ActorServer`` (tensor arguments decode onto
    ``cuda``), arms the health sampler every CADENCE seconds when
    given (its series then ride every ``ptype.Telemetry`` pull), then
    joins the TCP coordinator at COORD as service NAME (lease TTL
    ``CLUSTER_TTL``). Prints one JSON line (when it called ``join``,
    whether the native wire loaded) and serves until killed."""
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
    cfg32 = tfm.preset("optimus-125m", dtype=torch.float32)
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    kw = dict(params=params, attn="kernel", device="cuda", n_slots=8,
              block_tokens=16, prefill_chunk=256, serve_class=serve_class)
    engine = PagedGeneratorActor(cfg, **kw)
    engine32 = PagedGeneratorActor(cfg32, **kw)
    server = ActorServer()
    server.register(GeneratorActor(cfg, params=params, device="cuda"),
                    "Generator")
    server.register(engine, "Paged")
    server.register(engine32, "Paged32")
    server.register(ServerProbe(torch, flash_mod, paged_mod, native,
                                engine, engine32), "Probe")
    server.serve()
    if series_s is not None:
        from ptype_tpu_torch.health import series

        series.start(cadence_s=series_s)
    join_called_at = time.time()
    name = f"actor-server-{serve_class}-{os.getpid()}"
    cluster = join(Config(
        service_name=service, node_name=name, port=server.port,
        initial_cluster_client_urls=[coord],
        platform=PlatformConfig(name=name, coordinator_address=coord,
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
        engine32.close()


def wait_child_line(proc, path, log, timeout, phase="cluster_rpc"):
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
    raise SmokeError(f"{phase}: the actor server wrote no ready line "
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


# --------------------------------------------------- gateway_serving phase


#: gateway_serving's open-loop grid (offered rps, ascending; its top
#: rates lie past the two replicas' capacity, so saturation shows as
#: typed sheds or a queue-wait tail past the TTFT yardstick), the seeded
#: trace each rate draws at that rate (8 s of arrivals whatever the
#: rate), the yardstick SLOs (written down, not a target), the drain
#: pause between rates, each request's deadline, the replicas' probe
#: cadence, and the RAG family's prompt tail cut so its longest request
#: (96 + 800 prompt + 128 new tokens) fits optimus-125m's reach of 1,024.
GW_RATES = (4, 8, 16, 24, 28, 32, 48)
GW_TRACE = dict(process="poisson", duration_s=8.0)
GW_SLO_TTFT_MS = 1000.0
GW_SLO_TPOT_MS = 50.0
GW_SETTLE_S = 1.0
GW_DEADLINE_S = 10.0
GW_PROBE_S = 0.2
GW_RAG_PROMPT_MAX = 800
GW_SERVICE = "llm-gw"


def start_replica(coord, serve_class, work, service=GW_SERVICE,
                  series_s=None):
    """A replica process of this script (``--actor-server``) of serving
    class ``serve_class`` in ``service``, with the health sampler armed
    at ``series_s`` seconds when given; returns (process, its
    ready-line path, its log path)."""
    out_path = os.path.join(work, f"{serve_class}.out")
    log_path = os.path.join(work, f"{serve_class}.log")
    args = [sys.executable, os.path.abspath(__file__), "--actor-server",
            coord, "--serve-class", serve_class, "--service", service]
    if series_s is not None:
        args += ["--series", str(series_s)]
    with open(out_path, "w") as out_f, open(log_path, "w") as log_f:
        proc = subprocess.Popen(args, stdout=out_f, stderr=log_f)
    return proc, out_path, log_path


def replica_call(r, method, *args, timeout=120):
    """One call to a replica over the gateway pool's own connection."""
    return r.conn.call_async(method, args).result(timeout=timeout)


def wait_for(cond, timeout, what, phase="gateway_serving"):
    deadline = time.monotonic() + timeout
    while not cond():
        check(time.monotonic() < deadline, f"{phase}: {what}")
        time.sleep(0.01)


def gateway_generate_all(torch, gw, prompts, max_new):
    """Every prompt through ``gw.generate`` at once (a thread each, CUDA
    int32 prompts); the answers in prompt order."""
    outs, errs = [None] * len(prompts), []

    def call(i):
        try:
            outs[i] = gw.generate(prompts[i].to("cuda", torch.int32)[None],
                                  max_new)
        except Exception as e:  # noqa: BLE001 — re-raised below
            errs.append(e)

    threads = [threading.Thread(target=call, args=(i,), daemon=True)
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if errs:
        raise errs[0]
    check(all(o is not None for o in outs),
          "gateway_serving: a request did not come back")
    return outs


def nearest_rank(vals, p):
    """Nearest-rank percentile (the ledgers' rule); None when empty."""
    vals = sorted(v for v in vals if v is not None)
    if not vals:
        return None
    return vals[min(len(vals) - 1, int(round(p / 100 * (len(vals) - 1))))]


class CountingTarget:
    """A driver target wrapped to count, apart from the traffic ledger,
    what the driver handed it: calls, answers, typed sheds, and other
    errors by type."""

    def __init__(self, target, shed_type):
        self.target, self.shed_type = target, shed_type
        self.lock = threading.Lock()
        self.issued = self.answered = self.shed = 0
        self.errors = {}

    def __call__(self, arr):
        with self.lock:
            self.issued += 1
        try:
            res = self.target(arr)
        except self.shed_type:
            with self.lock:
                self.shed += 1
            raise
        except Exception as e:
            with self.lock:
                name = type(e).__name__
                self.errors[name] = self.errors.get(name, 0) + 1
            raise
        with self.lock:
            self.answered += 1
        return res

    def counts(self):
        with self.lock:
            return {"issued": self.issued, "answered": self.answered,
                    "shed": self.shed, "errors": sum(self.errors.values()),
                    "error_types": dict(self.errors)}


def migrate_spans(trace):
    """(bytes, blocks) of each ``gateway.migrate`` span in the flight
    recorder, then clear it."""
    rec = trace.recorder()
    out = [(int(s.attrs.get("bytes", 0)), int(s.attrs.get("blocks", 0)))
           for s in rec.spans() if s.name == "gateway.migrate"]
    rec.clear()
    return out


def gateway_serving_phase(torch, tfm, PagedGeneratorActor, params, prompts,
                          max_new, kw, card):
    """optimus-125m served from two replica processes (``--actor-server
    --serve-class prefill|decode``, one service) through the port's
    ``InferenceGateway``: (a) interleaved f32 tokens equal to in-process
    solo runs, both replicas used; (b) disaggregated f32 over the exact
    wire, tokens equal to (a)'s, 8 migrations and no fallback; (c)
    disaggregated bf16 over the q8 wire at (1 + 4/512)/2 of exact's
    bytes a block at equal dtype; (d) open-loop traffic from the port's
    load generator, 8 s of arrivals at each rate of ``GW_RATES`` through
    ``OpenLoopDriver`` and ``gateway_target``, every arrival answered or
    shed typed, the knee, and saturation at the top rate; (e) the decode replica SIGKILLed halfway through a run at half
    the knee: no arrival lost, the dead replica evicted. Returns the
    replicas' paged-kernel launches over (a)-(e) up to the kill."""
    from ptype_tpu_torch import Config, PlatformConfig, join, trace
    from ptype_tpu_torch.errors import ShedError
    from ptype_tpu_torch.gateway import GatewayConfig, InferenceGateway
    from ptype_tpu_torch.loadgen import (DEFAULT_MIX, DriverConfig,
                                         OpenLoopDriver, TrafficLedger,
                                         gateway_target, locate_knee,
                                         point_from_summary, synth_trace)
    from ptype_tpu_torch.metrics import MetricsRegistry

    cfg = tfm.preset("optimus-125m")
    cfg32 = tfm.preset("optimus-125m", dtype=torch.float32)
    n_layers = cfg.n_layers
    seed = join(Config(
        service_name="gw-seed", node_name="gw-seed", port=9001,
        platform=PlatformConfig(name="gw-seed",
                                coordinator_address="127.0.0.1:0",
                                is_coordinator=True, lease_ttl=CLUSTER_TTL)))
    coord = seed._owned_server.address
    work = tempfile.mkdtemp(prefix="chip_smoke_gw_")
    procs = {c: start_replica(coord, c, work) for c in ("prefill", "decode")}
    gws = []

    def gateway(reg, **over):
        gcfg = GatewayConfig(probe_interval_s=GW_PROBE_S,
                             default_deadline_s=600.0,
                             per_replica_inflight=kw["n_slots"],
                             generate_method="Paged32.Generate",
                             info_method="Paged32.Info")
        for k, v in over.items():
            setattr(gcfg, k, v)
        gw = InferenceGateway(seed.registry, GW_SERVICE, gcfg,
                              metrics_registry=reg, device="cuda")
        gws.append(gw)
        wait_for(lambda: gw.pool.n_healthy() == 2
                 and all(r.serve_class() for r in gw.pool.healthy()), 120,
                 "the gateway did not see both replicas")
        return gw

    def replicas(gw):
        return {r.serve_class(): r for r in gw.pool.healthy()}

    def counters(reps):
        return {c: replica_call(r, "Probe.Counters") for c, r in reps.items()}

    row = {"phase": "gateway_serving", "preset": "optimus-125m",
           "card": card, "service": GW_SERVICE,
           "per_replica_inflight": kw["n_slots"], "requests": len(prompts),
           "max_new": max_new}
    t_phase = time.monotonic()
    try:
        # In-process solo f32 runs while the replicas start.
        t0 = time.monotonic()
        e32 = PagedGeneratorActor(cfg32, params=params, attn="kernel", **kw)
        try:
            solo = [e32.Generate(p.to("cuda")[None], max_new).to(torch.int32)
                    for p in prompts]
        finally:
            e32.close()
        row["solo_f32_s"] = time.monotonic() - t0
        for proc, out_path, log_path in procs.values():
            wait_child_line(proc, out_path, log_path, 300, "gateway_serving")
        row["replicas_ready_s"] = time.monotonic() - t0

        # (a) interleaved, f32
        gw = gateway(MetricsRegistry())
        reps = replicas(gw)
        check(set(reps) == {"prefill", "decode"},
              f"gateway_serving: replica classes {sorted(reps)}")
        for r in reps.values():   # each engine's first prefill and steps
            for engine in ("Paged32", "Paged"):
                replica_call(r, f"{engine}.Generate",
                             torch.ones((1, 16), dtype=torch.int32,
                                        device="cuda"), 4)
            replica_call(r, "Probe.Reset")
        c0 = counters(reps)
        t0 = time.monotonic()
        outs_a = gateway_generate_all(torch, gw, prompts, max_new)
        row["a_s"] = time.monotonic() - t0
        c1 = counters(reps)
        split = {d["serve_class"]: d["calls"]
                 for d in gw.pool.status()["replicas"]}
        row["a"] = {
            "split": split,
            "equal_to_solo": sum(int(torch.equal(o, s))
                                 for o, s in zip(outs_a, solo)),
            "int32_on_card": all(o.dtype == torch.int32
                                 and o.device.type == "cuda"
                                 for o in outs_a),
            "counters": {c: {k: c1[c][k] - c0[c][k] for k in (
                "paged_decode", "engine_steps", "engine_steps32")}
                for c in reps}}
        gw.close()

        # (b) disaggregated, f32, exact wire
        trace.enable("chip-smoke-gateway")
        reg_b = MetricsRegistry()
        gw = gateway(reg_b, disagg=True, kv_wire="exact")
        reps = replicas(gw)
        c0 = counters(reps)
        t0 = time.monotonic()
        outs_b = gateway_generate_all(torch, gw, prompts, max_new)
        row["b_s"] = time.monotonic() - t0
        c1 = counters(reps)
        spans_b = migrate_spans(trace)
        hist = reg_b.snapshot()["histograms"]
        mig = reg_b.histogram(f"gateway.{GW_SERVICE}.stage_ms.migrate")
        row["b"] = {
            "equal_to_a": sum(int(torch.equal(x, y))
                              for x, y in zip(outs_b, outs_a)),
            "int32_on_card": all(o.dtype == torch.int32
                                 and o.device.type == "cuda"
                                 for o in outs_b),
            "stage_counts": {s: hist.get(
                f"gateway.{GW_SERVICE}.stage_ms.{s}", {}).get("count", 0)
                for s in ("prefill", "migrate", "decode")},
            "migrations": c1["decode"]["migrations32"]
            - c0["decode"]["migrations32"],
            "migrate_ms": {"p50": mig.percentile(50),
                           "max": mig.percentile(100)},
            "migrate_bytes": sum(b for b, _ in spans_b),
            "migrate_blocks": sum(n for _, n in spans_b),
            "migrate_spans": len(spans_b),
            "counters": {c: {k: c1[c][k] - c0[c][k] for k in (
                "paged_decode", "engine_steps", "engine_steps32")}
                for c in reps}}
        gw.close()

        # (c) disaggregated, bf16, q8 wire
        gw = gateway(MetricsRegistry(), disagg=True, kv_wire="q8",
                     generate_method="Paged.Generate",
                     info_method="Paged.Info")
        t0 = time.monotonic()
        outs_c = gateway_generate_all(torch, gw, prompts, max_new)
        row["c_s"] = time.monotonic() - t0
        spans_c = migrate_spans(trace)
        trace.disable()
        gw.close()
        b_bytes, b_blocks = row["b"]["migrate_bytes"], row["b"]["migrate_blocks"]
        c_bytes = sum(b for b, _ in spans_c)
        c_blocks = sum(n for _, n in spans_c)
        row["c"] = {
            "answered": sum(int(tuple(o.shape) == (1, max_new)
                                and bool(((o >= 0)
                                          & (o < cfg.vocab_size)).all()))
                            for o in outs_c),
            "migrate_bytes": c_bytes, "migrate_blocks": c_blocks,
            # exact f32 bytes / 2 is exact bf16's, block for block
            "q8_over_exact_at_equal_dtype": (
                (c_bytes / c_blocks) / (b_bytes / b_blocks / 2)
                if c_blocks and b_blocks else None),
            "want": (1 + 4 / 512) / 2}
        emit({**row, "part": "a-c"})

        # (d) open-loop load, bf16, interleaved, prefix-affine. Each rate
        # draws its own 8 s trace (one trace compressed by ``at_rate``
        # would give the fast rates a fraction of a second) and gets a
        # fresh gateway, so its SLO tracker's histograms hold that rate
        # alone.
        mix = tuple(dataclasses.replace(f, prompt_max=GW_RAG_PROMPT_MAX)
                    if f.name == "rag" else f for f in DEFAULT_MIX)
        dcfg = DriverConfig(deadline_s=GW_DEADLINE_S, join_timeout_s=120)
        svc = f"gateway.{GW_SERVICE}"
        points, rows_d = [], []
        t0 = time.monotonic()
        for rate in GW_RATES:
            if points:
                time.sleep(GW_SETTLE_S)   # the fleet drains between rates
            tr = synth_trace(0, mix=mix, rate_rps=rate, **GW_TRACE)
            check(max(a.prompt_len + a.max_new for a in tr.arrivals)
                  <= cfg.max_seq,
                  "gateway_serving: a request exceeds the reach")
            reg_d = MetricsRegistry()
            gw = gateway(reg_d, generate_method="Paged.Generate",
                         info_method="Paged.Info",
                         slo_ttft_p99_ms=GW_SLO_TTFT_MS,
                         slo_tpot_p99_ms=GW_SLO_TPOT_MS)
            reps = replicas(gw)
            counting = CountingTarget(
                gateway_target(gw, deadline_s=GW_DEADLINE_S,
                               vocab=cfg.vocab_size), ShedError)
            led = TrafficLedger(slo_ttft_ms=GW_SLO_TTFT_MS,
                                slo_tpot_ms=GW_SLO_TPOT_MS, offered_rps=rate)
            since = time.time()
            OpenLoopDriver(tr, counting, ledger=led, cfg=dcfg).run()
            recs = [x for r in reps.values()
                    for x in replica_call(r, "Probe.Records", since)]
            gw.close()
            s = led.summary()
            p = point_from_summary(s)
            p.offered_rps = float(rate)
            points.append(p)
            stage_ms = {st: reg_d.histogram(f"{svc}.stage_ms.{st}").summary()
                        for st in ("queue-wait", "route", "rpc")}
            lreg = led.registry
            tpot = lreg.histogram("loadgen.tpot_ms")
            point = {
                "phase": "gateway_serving", "part": "d", "rate_rps": rate,
                "trace_arrivals": len(tr.arrivals),
                "trace_s": tr.duration_s, "offered": s["offered"],
                "offered_rps": s["offered_rps"],
                "answered_rps": s["achieved_rps"],
                **counting.counts(),
                "ledger_shed": s["shed"], "ledger_errors": s["errors"],
                "dropped": s["dropped"], "overruns": s["overruns"],
                "goodput_pct": p.goodput_pct, "goodput_rps": p.goodput_rps,
                "culprit_stage": p.culprit_stage,
                "slo_bad_stages": p.slo_bad_stages,
                "tokens_per_s": sum(o.tokens for o in led.outcomes()
                                    if o.status == "ok") / s["wall_s"],
                "issue_lag_p99_ms": lreg.histogram(
                    "loadgen.issue_lag_ms").percentile(99),
                # no per-request TTFT or TPOT on the interleaved path:
                # the ledger prices e2e as TTFT (its conservative rule)
                "traffic_ledger": {
                    "ttft_p50_ms": s["ttft_p50_ms"],
                    "ttft_p99_ms": s["ttft_p99_ms"],
                    "e2e_p99_ms": s["e2e_p99_ms"],
                    "tpot_p50_ms": tpot.percentile(50) if tpot.count else None,
                    "tpot_p99_ms": tpot.percentile(99) if tpot.count else None},
                "gateway_slo": {
                    "e2e_ms": reg_d.histogram(f"{svc}.latency_ms").summary(),
                    "goodput": gw.slo.goodput(),
                    "tokens_per_s": gw.slo.tokens_per_sec(),
                    "stage_ms": stage_ms},
                # the per-request samples the gateway's TTFT histogram
                # is fed from, read from the replicas' own ledgers
                "replica_ledgers": {
                    name: {"p50": nearest_rank([x[i] for x in recs], 50),
                           "p99": nearest_rank([x[i] for x in recs], 99)}
                    for i, name in enumerate(("ttft_ms", "tpot_ms",
                                              "e2e_ms"))},
                "saturated": (s["shed"] > 0 or stage_ms["queue-wait"]["p99"]
                              > GW_SLO_TTFT_MS)}
            emit(point)
            rows_d.append(point)
        knee = locate_knee(points, 90.0)
        saturated = [pt["rate_rps"] for pt in rows_d if pt["saturated"]]
        row["d_s"] = time.monotonic() - t0
        row["d"] = {"rates": list(GW_RATES), "trace": GW_TRACE,
                    "trace_arrivals": [pt["trace_arrivals"] for pt in rows_d],
                    "rag_prompt_max": GW_RAG_PROMPT_MAX,
                    "slo_ttft_ms": GW_SLO_TTFT_MS,
                    "slo_tpot_ms": GW_SLO_TPOT_MS,
                    "deadline_s": GW_DEADLINE_S,
                    "goodput_pct": [p.goodput_pct for p in points],
                    "knee_rps": knee.offered_rps if knee else None,
                    "knee_goodput_pct": knee.goodput_pct if knee else None,
                    "knee_priced_on": "e2e as TTFT",
                    "saturation_rps": min(saturated) if saturated else None}
        emit({**row, "part": "d"})
        for pt in rows_d:
            check(pt["errors"] == 0 and pt["ledger_errors"] == 0,
                  f"gateway_serving: errors at {pt['rate_rps']} rps: "
                  f"{pt['error_types']}")
            check(pt["offered"] == pt["trace_arrivals"] == pt["issued"]
                  and pt["issued"] == pt["answered"] + pt["shed"]
                  + pt["errors"] and pt["shed"] == pt["ledger_shed"],
                  f"gateway_serving: an arrival unaccounted at "
                  f"{pt['rate_rps']} rps: {pt}")
        check(knee is not None, "gateway_serving: no knee")
        check(rows_d[-1]["saturated"],
              f"gateway_serving: no saturation up to {GW_RATES[-1]} rps "
              "(no shed, queue-wait p99 under the TTFT yardstick)")

        # (e) the decode replica SIGKILLed halfway through half the knee
        rate = knee.offered_rps / 2
        tr = synth_trace(0, mix=mix, rate_rps=rate, **GW_TRACE)
        half_s = tr.duration_s / 2
        gw = gateway(MetricsRegistry(), generate_method="Paged.Generate",
                     info_method="Paged.Info")
        reps = replicas(gw)
        dead = reps["decode"]
        counting = CountingTarget(
            gateway_target(gw, deadline_s=GW_DEADLINE_S,
                           vocab=cfg.vocab_size), ShedError)
        kill = {}

        def killer():
            time.sleep(half_s)
            kill["counters"] = counters(reps)
            kill["t"] = time.monotonic()
            os.kill(procs["decode"][0].pid, signal.SIGKILL)
            deadline = kill["t"] + 30
            while time.monotonic() < deadline:
                now = time.monotonic()
                if "unroutable" not in kill and gw.pool.n_healthy() == 1:
                    kill["unroutable"] = now
                if "evicted" not in kill and not any(
                        d["key"] == dead.key and d["up"]
                        for d in gw.pool.status()["replicas"]):
                    kill["evicted"] = now
                if "unroutable" in kill and "evicted" in kill:
                    return
                time.sleep(0.001)

        led = TrafficLedger(offered_rps=rate)
        kt = threading.Thread(target=killer, daemon=True)
        kt.start()
        t_run = time.monotonic()
        OpenLoopDriver(tr, counting, ledger=led, cfg=dcfg).run()
        kt.join(timeout=60)
        s = led.summary()
        row["e"] = {
            "rate_rps": rate, "trace_arrivals": len(tr.arrivals),
            "kill_after_s": half_s, "offered": s["offered"],
            **counting.counts(),
            "answered_after_kill": sum(
                o.status == "ok" and t_run + o.t_done > kill.get(
                    "t", float("inf")) for o in led.outcomes()),
            "kill_to_unroutable_ms": ((kill["unroutable"] - kill["t"]) * 1e3
                                      if "unroutable" in kill else None),
            "kill_to_evicted_ms": ((kill["evicted"] - kill["t"]) * 1e3
                                   if "evicted" in kill else None)}
        gw.close()
        launches = {c: d["paged_decode"]
                    for c, d in kill.get("counters", {}).items()}
        row["paged_launches_to_the_kill"] = launches
        row["phase_s"] = time.monotonic() - t_phase
        emit({**row, "part": "all"})

        a, b, c = row["a"], row["b"], row["c"]
        check(a["equal_to_solo"] == len(prompts) and a["int32_on_card"],
              f"gateway_serving (a): {a['equal_to_solo']} of {len(prompts)} "
              "answers equal the in-process solo f32 tokens")
        check(min(split.values()) >= 1,
              f"gateway_serving (a): a replica served nothing: {split}")
        for part in (a, b):
            for cls, d in part["counters"].items():
                check(d["paged_decode"] == (d["engine_steps"]
                                            + d["engine_steps32"]) * n_layers,
                      f"gateway_serving: the {cls} replica's paged launches "
                      f"{d['paged_decode']} != decode steps x {n_layers}: {d}")
        check(b["equal_to_a"] == len(prompts) and b["int32_on_card"],
              f"gateway_serving (b): {b['equal_to_a']} of {len(prompts)} "
              "disaggregated answers equal (a)'s")
        check(b["migrations"] == len(prompts) and b["migrate_spans"]
              == len(prompts) and all(
                  n == len(prompts) for n in b["stage_counts"].values()),
              f"gateway_serving (b): migrations {b['migrations']}, stages "
              f"{b['stage_counts']} (a fallback has no decode stage)")
        check(b["counters"]["prefill"]["engine_steps32"] == 0,
              "gateway_serving (b): the prefill replica decoded")
        check(c["answered"] == len(prompts),
              f"gateway_serving (c): {c['answered']} answered")
        check(c_bytes * 2048 * b_blocks == b_bytes * 516 * c_blocks,
              f"gateway_serving (c): q8 {c['q8_over_exact_at_equal_dtype']}"
              f" of exact bytes a block, want {c['want']}")
        e = row["e"]
        check(e["errors"] == 0 and e["issued"] == e["offered"]
              == e["trace_arrivals"]
              and e["answered"] + e["shed"] == e["issued"],
              f"gateway_serving (e): requests lost through the kill: {e}")
        check(e["answered_after_kill"] > 0,
              "gateway_serving (e): nothing answered after the kill")
        check(e["kill_to_evicted_ms"] is not None,
              "gateway_serving (e): the dead replica was not evicted")
        check(len(launches) == 2, "gateway_serving (e): no kill counters")
        return sum(launches.values())
    finally:
        if trace.enabled():
            trace.disable()
        for gw in gws:
            gw.close()
        for proc, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=60)
        seed.close()
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()


#: The reconciler phase: its service, its replicas' counters directory
#: variable, the open-loop traces of the kill (c) and the drain (d), the
#: kill's offset into (c)'s run, and the drain's trigger offset in (d).
REC_SERVICE = "llm-rec"
REC_COUNTERS_ENV = "CHIP_SMOKE_REC_COUNTERS"
REC_KILL_TRACE = dict(process="poisson", rate_rps=8.0, duration_s=16.0)
REC_KILL_AT_S = 4.0
REC_DRAIN_TRACE = dict(process="poisson", rate_rps=8.0, duration_s=6.0)
REC_DRAIN_AT_S = 1.0


def rec_replica():
    """Factory of the reconciler phase's replicas
    (``PTYPE_REPLICA_FACTORY=chip_smoke:rec_replica``, run in the worker
    process): gateway_serving's ``Paged`` engine — optimus-125m from
    seed-0 weights, bf16, attn="kernel", 8 slots, 16-token blocks,
    256-token prefill chunks, on ``cuda`` — with ``Counters`` (the
    process's flash and paged launch counts and the engine's decode
    steps) and ``Records`` (its ledger's retired requests). On close it
    writes its counters to ``$CHIP_SMOKE_REC_COUNTERS/<pid>.json``, so a
    replica that drains and exits still reports its launches."""
    import torch

    from ptype_tpu_torch.models import transformer as tfm
    from ptype_tpu_torch.models.weights import init_params
    from ptype_tpu_torch.ops import flash_attention as flash_mod
    from ptype_tpu_torch.ops import paged_attention as paged_mod
    from ptype_tpu_torch.serve_engine import PagedGeneratorActor

    class RecEngine(PagedGeneratorActor):
        def Counters(self):
            return {"flash_fwd": flash_mod.flash_attention.launches,
                    "paged_decode": paged_mod.paged_attention.launches,
                    "engine_steps": self.Info()["engine_steps"],
                    "pid": os.getpid()}

        def Records(self):
            """(enqueue wall time, ttft_ms, tpot_ms, e2e_ms) of each
            retired request."""
            return [[r["t"], r.get("ttft_ms"), r.get("tpot_ms"),
                     r.get("e2e_ms")] for r in self.ledger.records()]

        def close(self):
            out = os.environ.get(REC_COUNTERS_ENV)
            if out:
                with open(os.path.join(out, f"{os.getpid()}.json"),
                          "w") as f:
                    json.dump(self.Counters(), f)
            super().close()

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tfm.preset("optimus-125m")
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    return RecEngine(cfg, params=params, attn="kernel", device="cuda",
                     n_slots=8, block_tokens=16, prefill_chunk=256)


def rec_warmup(actor):
    """The worker's warm-up: one 1-token Generate, read back to the host,
    so activation never pays the first kernel load or launch."""
    import torch

    actor.Generate(torch.ones((1, 4), dtype=torch.int32,
                              device=actor.device), 1).cpu()


rec_replica.warmup = rec_warmup


def reconciler_phase(torch, tfm, PagedGeneratorActor, params, prompts,
                     max_new, kw, card):
    """The port's reconciler keeping an optimus-125m fleet behind the
    port's gateway: replicas are worker processes (``ProcessLauncher``,
    kind ``custom``, ``rec_replica``) under ``Reconciler(min 2, max 3,
    warm pool 1, cooldown 2 s, tick 0.2 s)``. (a) bootstrap from an
    empty fleet to 2 active and 1 warm; (b) phase 4's prompts one at a
    time, greedy, equal to an in-process solo run of the same engine;
    (c) 16 s of open-loop traffic at 8 rps with the newest active
    replica SIGKILLed at 4 s: one death, one replacement (the warm
    standby), every arrival answered or shed typed, the kill-to-event
    times, the fleet's rates and tails before and after the kill; (d)
    scripted hints grow the fleet to 3, then shrink it: the newest
    active replica drains under traffic with nothing lost and no
    escalation; (e) one ``kind="paged"`` worker with no device variable
    serves on the card. No worker process outlives the phase. Returns
    the replicas' (paged, flash) launches."""
    from ptype_tpu_torch import Config, PlatformConfig, join
    from ptype_tpu_torch import rpc as rpc_mod
    from ptype_tpu_torch.errors import ShedError
    from ptype_tpu_torch.gateway import GatewayConfig, InferenceGateway
    from ptype_tpu_torch.gateway.slo import ScaleHint
    from ptype_tpu_torch.loadgen import (DEFAULT_MIX, DriverConfig,
                                         OpenLoopDriver, TrafficLedger,
                                         gateway_target, synth_trace)
    from ptype_tpu_torch.metrics import MetricsRegistry
    from ptype_tpu_torch.reconciler import (ProcessLauncher, Reconciler,
                                            ReconcilerConfig)
    from ptype_tpu_torch.registry import Node

    root = os.path.dirname(os.path.abspath(__file__))
    cfg = tfm.preset("optimus-125m")
    n_layers = cfg.n_layers
    t_phase = time.monotonic()
    seed = join(Config(
        service_name="rec-seed", node_name="rec-seed", port=9001,
        platform=PlatformConfig(name="rec-seed",
                                coordinator_address="127.0.0.1:0",
                                is_coordinator=True, lease_ttl=CLUSTER_TTL)))
    coord = seed._owned_server.address
    work = tempfile.mkdtemp(prefix="chip_smoke_rec_")
    timings, spawned = {}, []

    class TimedLauncher(ProcessLauncher):
        """Stamps each spawn (Popen, ready file, activation) and keeps
        its process."""

        def spawn(self, name, **kw_):
            t0 = time.monotonic()
            h = super().spawn(name, **kw_)
            spawned.append(h._proc)
            timings[name] = {"start": t0, "ready": time.monotonic()}
            activate = h.activate

            def stamped():
                activate()
                timings[name].setdefault("activated", time.monotonic())

            h.activate = stamped
            return h

    launcher = TimedLauncher(coord, service=REC_SERVICE, kind="custom",
                             factory="chip_smoke:rec_replica",
                             spawn_timeout_s=120,
                             env={"PYTHONPATH": root,
                                  REC_COUNTERS_ENV: work})
    mreg = MetricsRegistry()
    gw = InferenceGateway(
        seed.registry, REC_SERVICE,
        GatewayConfig(probe_interval_s=GW_PROBE_S, default_deadline_s=600.0,
                      per_replica_inflight=kw["n_slots"]),
        metrics_registry=MetricsRegistry(), device="cuda")
    hint = {"fn": gw.scale_hint}
    rec = None
    row = {"phase": "reconciler", "preset": "optimus-125m", "card": card,
           "service": REC_SERVICE, "min_replicas": 2, "max_replicas": 3,
           "warm_pool": 1, "cooldown_s": 2.0, "tick_interval_s": 0.2,
           "per_replica_inflight": kw["n_slots"]}
    mix = tuple(dataclasses.replace(f, prompt_max=GW_RAG_PROMPT_MAX)
                if f.name == "rag" else f for f in DEFAULT_MIX)
    dcfg = DriverConfig(deadline_s=GW_DEADLINE_S, join_timeout_s=120)

    def counter(name):
        return int(mreg.counter(f"scale.{name}").value)

    def fleet():
        """name -> (lifecycle, draining) of the replicas the reconciler
        holds."""
        return {n: (r["lifecycle"], r["draining"])
                for n, r in rec.status()["replicas"].items()}

    def n_state(state):
        return sum(lc == state and not dr for lc, dr in fleet().values())

    def handle(name):
        with rec._lock:
            return rec._handles.get(name)

    def call(addr, method, *args, timeout=120):
        host, port = addr.split(":")
        conn = rpc_mod._dial(Node(address=host, port=int(port)), 10.0,
                             device="cuda")
        try:
            return conn.call_async(method, args).result(timeout=timeout)
        finally:
            conn.close()

    def wait(cond, timeout, what):
        deadline = time.monotonic() + timeout
        while not cond():
            check(time.monotonic() < deadline, f"reconciler: {what}")
            time.sleep(0.005)
        return time.monotonic()

    def records_by_wall(recs, t_from, t_wall):
        before = [x for x in recs if t_from <= x[0] < t_wall]
        after = [x for x in recs if x[0] >= t_wall]
        return {part: {f"{name}_{p}": nearest_rank([x[i] for x in xs], p)
                       for i, name in ((1, "ttft_ms"), (2, "tpot_ms"))
                       for p in (50, 99)} | {"requests": len(xs)}
                for part, xs in (("before", before), ("after", after))}

    try:
        # (a) bootstrap from an empty fleet; the solo runs for (b) on an
        # in-process engine while the replicas come up.
        t0 = time.monotonic()
        rec = Reconciler(
            seed.registry, REC_SERVICE, launcher,
            hints=lambda: hint["fn"](),
            cfg=ReconcilerConfig(min_replicas=2, max_replicas=3,
                                 warm_pool=1, cooldown_s=2,
                                 tick_interval_s=0.2, drain_deadline_s=30,
                                 spawn_timeout_s=120),
            metrics_registry=mreg).start()
        solo_eng = PagedGeneratorActor(cfg, params=params, attn="kernel",
                                       **kw)
        try:
            rec_warmup(solo_eng)
            solo = [solo_eng.Generate(p.to("cuda")[None], max_new)
                    .to(torch.int32) for p in prompts]
        finally:
            solo_eng.close()
        t_up = wait(lambda: n_state("active") == 2 and n_state("warm") == 1
                    and not rec.status()["pending_spawns"]
                    and gw.pool.n_healthy() == 2, 180,
                    "no 2 active + 1 warm replicas seen by the gateway")
        row["a"] = {
            "bootstrap_s": t_up - t0,
            "spawns": {n: {"popen_to_ready_s": t["ready"] - t["start"],
                           "ready_to_activate_s": (
                               t["activated"] - t["ready"]
                               if "activated" in t else None)}
                       for n, t in timings.items()},
            "fleet": fleet()}
        emit({"phase": "reconciler", "part": "a", **row["a"]})

        # (b) one at a time, greedy, through a gateway whose affinity
        # never yields to load: one shared key pins every request to one
        # replica, which then sees the solo engine's sequence.
        gw_b = InferenceGateway(
            seed.registry, REC_SERVICE,
            GatewayConfig(probe_interval_s=GW_PROBE_S,
                          default_deadline_s=600.0,
                          per_replica_inflight=kw["n_slots"],
                          affinity_slack=float("inf")),
            metrics_registry=MetricsRegistry(), device="cuda")
        try:
            wait(lambda: gw_b.pool.n_healthy() == 2, 30,
                 "the pinned gateway did not see both replicas")
            t0 = time.monotonic()
            outs_b = [gw_b.generate(p.to("cuda", torch.int32)[None],
                                    max_new, affinity_key="reconciler-b")
                      for p in prompts]
            split = {d["key"]: d["calls"]
                     for d in gw_b.pool.status()["replicas"]}
        finally:
            gw_b.close()
        row["b"] = {
            "s": time.monotonic() - t0,
            "equal_to_solo": sum(int(torch.equal(o, s))
                                 for o, s in zip(outs_b, solo)),
            "int32_on_card": all(o.dtype == torch.int32
                                 and o.device.type == "cuda"
                                 for o in outs_b),
            "split": split}
        emit({"phase": "reconciler", "part": "b", **row["b"]})

        # (c) SIGKILL the newest active replica 4 s into 16 s of arrivals
        tr = synth_trace(0, mix=mix, **REC_KILL_TRACE)
        check(max(a.prompt_len + a.max_new for a in tr.arrivals)
              <= cfg.max_seq, "reconciler: a request exceeds the reach")
        counting = CountingTarget(
            gateway_target(gw, deadline_s=GW_DEADLINE_S,
                           vocab=cfg.vocab_size), ShedError)
        led = TrafficLedger(offered_rps=REC_KILL_TRACE["rate_rps"])
        deaths0, repl0 = counter("deaths"), counter("replacements")
        kill = {}

        def killer():
            time.sleep(REC_KILL_AT_S)
            victim = rec._pick_victim()
            warm = [n for n, (lc, dr) in fleet().items()
                    if lc == "warm" and not dr]
            kill.update(victim=victim.name, addr=victim.addr,
                        standby=warm[0] if warm else None,
                        counters=call(victim.addr, "Generator.Counters"),
                        records=call(victim.addr, "Generator.Records"))
            kill["wall"] = time.time()
            kill["t"] = time.monotonic()
            victim._proc.kill()
            deadline = kill["t"] + 60
            while time.monotonic() < deadline:
                now = time.monotonic()
                if "unregistered" not in kill and all(
                        f"{n.address}:{n.port}" != kill["addr"]
                        for n in seed.registry.nodes(REC_SERVICE)):
                    kill["unregistered"] = now
                if "replaced" not in kill and counter("replacements") > repl0:
                    kill["replaced"] = now
                if "refilled" not in kill and "replaced" in kill and (
                        n_state("warm") == 1
                        and not rec.status()["pending_spawns"]):
                    kill["refilled"] = now
                if all(k in kill for k in ("unregistered", "replaced",
                                           "refilled")):
                    return
                time.sleep(0.005)

        kt = threading.Thread(target=killer, daemon=True)
        t_run, t_run_wall = time.monotonic(), time.time()
        kt.start()
        OpenLoopDriver(tr, counting, ledger=led, cfg=dcfg).run()
        kt.join(timeout=90)
        check("t" in kill, "reconciler (c): the kill did not happen")
        # the replacement is the standby the reconciler activated
        repl = kill["standby"]
        repl_addr = handle(repl).addr if handle(repl) else None
        recs = {n: call(handle(n).addr, "Generator.Records")
                for n, (lc, dr) in fleet().items() if lc == "active"}
        first = [x[0] + x[3] / 1e3 for x in recs.get(repl, [])
                 if x[3] is not None and x[0] >= t_run_wall]
        s = led.summary()
        k_rel = kill["t"] - t_run
        end_rel = max(o.t_done for o in led.outcomes() if o.t_done)
        ok_before = [o for o in led.outcomes() if o.status == "ok"
                     and o.t_issued < k_rel]
        ok_after = [o for o in led.outcomes() if o.status == "ok"
                    and o.t_issued >= k_rel]
        all_recs = kill["records"] + [x for n in recs
                                      for x in recs[n]]
        row["c"] = {
            "trace": REC_KILL_TRACE, "kill_at_s": REC_KILL_AT_S,
            "trace_arrivals": len(tr.arrivals), "offered": s["offered"],
            **counting.counts(), "ledger_shed": s["shed"],
            "ledger_errors": s["errors"],
            "victim": kill["victim"], "replacement": repl,
            "replacement_addr": repl_addr,
            "deaths": counter("deaths") - deaths0,
            "replacements": counter("replacements") - repl0,
            "kill_to_unregistered_ms": ((kill["unregistered"] - kill["t"])
                                        * 1e3 if "unregistered" in kill
                                        else None),
            "kill_to_replacement_active_ms": (
                (kill["replaced"] - kill["t"]) * 1e3
                if "replaced" in kill else None),
            "kill_to_replacement_first_answer_ms": (
                (min(first) - kill["wall"]) * 1e3 if first else None),
            "kill_to_warm_refilled_ms": ((kill["refilled"] - kill["t"])
                                         * 1e3 if "refilled" in kill
                                         else None),
            "traffic_ledger": {
                "answered_rps_before": len(ok_before) / k_rel,
                "answered_rps_after": len(ok_after) / (end_rel - k_rel),
                "e2e_p50_ms_before": nearest_rank(
                    [o.e2e_ms for o in ok_before], 50),
                "e2e_p99_ms_before": nearest_rank(
                    [o.e2e_ms for o in ok_before], 99),
                "e2e_p50_ms_after": nearest_rank(
                    [o.e2e_ms for o in ok_after], 50),
                "e2e_p99_ms_after": nearest_rank(
                    [o.e2e_ms for o in ok_after], 99),
                "ttft_p99_ms": s["ttft_p99_ms"]},
            "replica_ledgers": records_by_wall(all_recs, t_run_wall,
                                               kill["wall"])}
        emit({"phase": "reconciler", "part": "c", **row["c"]})

        # (d) scripted hints: grow to 3 (the warm standby activates),
        # then shrink one under traffic: the newest active drains.
        grow = ScaleHint(delta=1, reason="scripted grow")
        shrink = ScaleHint(delta=-1, reason="scripted idle")
        drains0, esc0 = counter("drains"), counter("drain_escalations")
        hint["fn"] = lambda: grow
        wait(lambda: n_state("active") == 3 and gw.pool.n_healthy() == 3,
             60, "the scripted grow did not reach 3 active replicas")
        tr_d = synth_trace(1, mix=mix, **REC_DRAIN_TRACE)
        counting_d = CountingTarget(
            gateway_target(gw, deadline_s=GW_DEADLINE_S,
                           vocab=cfg.vocab_size), ShedError)
        led_d = TrafficLedger(offered_rps=REC_DRAIN_TRACE["rate_rps"])
        drain = {}

        def drainer():
            time.sleep(REC_DRAIN_AT_S)
            hint["fn"] = lambda: shrink
            drain["t_hint"] = time.monotonic()
            deadline = drain["t_hint"] + 60
            while time.monotonic() < deadline:
                with rec._lock:
                    names = list(rec._draining)
                if names and "name" not in drain:
                    drain["t"] = time.monotonic()
                    drain["name"] = names[0]
                    drain["h"] = rec._handles.get(names[0])
                    drain["inflight"] = sum(
                        r.inflight for r in gw.pool.healthy()
                        if r.key == drain["h"].addr)
                if "h" in drain and not drain["h"].alive():
                    drain["exited"] = time.monotonic()
                    return
                time.sleep(0.005)

        dt = threading.Thread(target=drainer, daemon=True)
        dt.start()
        OpenLoopDriver(tr_d, counting_d, ledger=led_d, cfg=dcfg).run()
        dt.join(timeout=90)
        hint["fn"] = gw.scale_hint
        wait(lambda: not rec.status()["pending_spawns"], 120,
             "the warm pool's refill did not land")
        check("exited" in drain, f"reconciler (d): no drain finished: "
              f"{ {k: v for k, v in drain.items() if k != 'h'} }")
        wait(lambda: all(f"{n.address}:{n.port}" != drain["h"].addr
                         for n in seed.registry.nodes(REC_SERVICE)), 10,
             "the drained replica stayed registered")
        s_d = led_d.summary()
        row["d"] = {
            "trace": REC_DRAIN_TRACE, "hint_at_s": REC_DRAIN_AT_S,
            "trace_arrivals": len(tr_d.arrivals), "offered": s_d["offered"],
            **counting_d.counts(), "ledger_errors": s_d["errors"],
            "drained": drain["name"],
            "in_flight_at_order": drain["inflight"],
            "hint_to_order_ms": (drain["t"] - drain["t_hint"]) * 1e3,
            "drain_wall_ms": (drain["exited"] - drain["t"]) * 1e3,
            "exit_code": drain["h"]._proc.returncode,
            "drains": counter("drains") - drains0,
            "drain_escalations": counter("drain_escalations") - esc0}
        emit({"phase": "reconciler", "part": "d", **row["d"]})

        # (e) kind="paged" with no device variable: the worker's own
        # path, on the card.
        check("PTYPE_REPLICA_DEVICE" not in os.environ,
              "reconciler (e): PTYPE_REPLICA_DEVICE is set")
        paged = ProcessLauncher(coord, service="llm-rec-paged",
                                kind="paged", preset="optimus-125m",
                                spawn_timeout_s=120,
                                env={"PYTHONPATH": root})
        try:
            t0 = time.monotonic()
            ph = paged.spawn("rec-paged-e")
            t_ready = time.monotonic() - t0
            spawned.append(ph._proc)
            out_e = call(ph.addr, "Generator.Generate",
                         torch.ones((1, 16), dtype=torch.int32,
                                    device="cuda"), 8)
            info_e = call(ph.addr, "Generator.Info")
            ph.exit()
            ph._proc.wait(timeout=60)
            row["e"] = {"popen_to_ready_s": t_ready,
                        "shape": list(out_e.shape),
                        "device": info_e["device"], "attn": info_e["attn"],
                        "device_bytes_in_use": info_e["memory"].get(
                            "device_bytes_in_use"),
                        "exit_code": ph._proc.returncode}
        finally:
            paged.close()
        emit({"phase": "reconciler", "part": "e", **row["e"]})

        # the end: close the loop and the fleet; every replica's
        # counters (the victim's read before the kill)
        spawn_failures = counter("spawn_failures")
        rec.close(stop_fleet=True)
        rec = None
        launcher.close()
        gw.close()
        leaked = [p.pid for p in spawned if p.poll() is None]
        finals = []
        for name in os.listdir(work):
            with open(os.path.join(work, name)) as f:
                finals.append(json.load(f))
        per_replica = [kill["counters"]] + finals
        paged_n = sum(c["paged_decode"] for c in per_replica)
        flash_n = sum(c["flash_fwd"] for c in per_replica)
        row["end"] = {
            "spawn_failures": spawn_failures,
            "scale": {k: v for k, v in
                      mreg.snapshot()["counters"].items()
                      if k.startswith("scale.")},
            "replica_counters": per_replica,
            "paged_launches": paged_n, "flash_launches": flash_n,
            "leaked_workers": leaked,
            "phase_s": time.monotonic() - t_phase}
        emit({**row, "part": "end"})

        a, b, c, d, e = (row[k] for k in "abcde")
        check(len(a["spawns"]) == 3,
              f"reconciler (a): {len(a['spawns'])} spawns to bootstrap")
        check(b["equal_to_solo"] == len(prompts) and b["int32_on_card"],
              f"reconciler (b): {b['equal_to_solo']} of {len(prompts)} "
              "answers equal the in-process solo run")
        check(c["deaths"] == 1 and c["replacements"] == 1,
              f"reconciler (c): deaths {c['deaths']}, replacements "
              f"{c['replacements']}")
        check(c["errors"] == 0 and c["ledger_errors"] == 0
              and c["issued"] == c["offered"] == c["trace_arrivals"]
              and c["answered"] + c["shed"] == c["issued"],
              f"reconciler (c): an arrival lost through the kill: {c}")
        check(None not in (c["kill_to_unregistered_ms"],
                           c["kill_to_replacement_active_ms"],
                           c["kill_to_replacement_first_answer_ms"],
                           c["kill_to_warm_refilled_ms"]),
              f"reconciler (c): a kill-to-event time is missing: {c}")
        check(d["errors"] == 0 and d["ledger_errors"] == 0
              and d["issued"] == d["offered"] == d["trace_arrivals"]
              and d["answered"] + d["shed"] == d["issued"]
              and d["exit_code"] == 0,
              f"reconciler (d): the drain lost work: {d}")
        check(d["drains"] == 1 and d["drain_escalations"] == 0,
              f"reconciler (d): drains {d['drains']}, escalations "
              f"{d['drain_escalations']}")
        check(e["device"].startswith("cuda") and e["shape"] == [1, 8]
              and e["exit_code"] == 0,
              f"reconciler (e): the paged worker: {e}")
        check(spawn_failures == 0,
              f"reconciler: {spawn_failures} spawn failures")
        check(not leaked, f"reconciler: worker processes leaked: {leaked}")
        # An idle replica's counts close exactly; the victim's were read
        # under traffic, where one step may be between its launches and
        # its step count.
        for cnt in finals:
            check(cnt["paged_decode"] == cnt["engine_steps"] * n_layers,
                  f"reconciler: a replica's paged launches != decode "
                  f"steps x {n_layers}: {cnt}")
        lag = kill["counters"]["paged_decode"] - (
            kill["counters"]["engine_steps"] * n_layers)
        check(0 <= lag <= n_layers,
              f"reconciler: the victim's paged launches are not its decode "
              f"steps x {n_layers}: {kill['counters']}")
        check(paged_n > 0, "reconciler: the replicas launched no paged "
              "decode kernel")
        return paged_n, flash_n
    finally:
        hint["fn"] = gw.scale_hint
        if rec is not None:
            rec.close(stop_fleet=True)
        launcher.close()
        gw.close()
        for p in spawned:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=60)
        seed.close()
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()


# ------------------------------------------------------------ health plane

#: The health phase's replica service, its sampler cadence, the profile
#: capture's length, the FLOPs gap bar (the reference's own), and the
#: reference's sampler overhead bar (``ptype_tpu/health/bench.py``).
HEALTH_SERVICE = "llm-health"
HEALTH_SERIES_S = 0.2
HEALTH_PROFILE_S = 1.0
HEALTH_GAP_PCT = 10.0
HEALTH_SAMPLER_BAR_PCT = 1.0
HEALTH_WARM, HEALTH_STEPS = 2, 8


def goodput_run(torch, tfm, step, cfg, compiled_flops, batch_tokens):
    """``HEALTH_WARM`` warm steps, then a ``GoodputLedger`` (analytic
    and compiled FLOPs) on the annotate seam and the default ``Sampler``
    armed, and ``HEALTH_STEPS`` steps: the ledger's records and
    summary, the ``train.steps`` advance and the steps' wall ms."""
    from ptype_tpu_torch.health import goodput as goodput_mod
    from ptype_tpu_torch.health import series as series_mod
    from ptype_tpu_torch.metrics import metrics

    for _ in range(HEALTH_WARM):
        step()
    torch.cuda.synchronize()
    ledger = goodput_mod.install(
        tokens_per_step=batch_tokens,
        flops_per_token=tfm.flops_per_token(cfg, 1024))
    ledger.set_compiled_flops(compiled_flops)
    sampler = series_mod.start()
    steps0 = metrics.counter("train.steps").value
    try:
        t0 = time.monotonic()
        for _ in range(HEALTH_STEPS):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
        sampler.sample_once()
    finally:
        goodput_mod.uninstall()
        series_mod.stop()
    return (ledger.records(), ledger.summary(),
            metrics.counter("train.steps").value - steps0, wall_ms)


LEGS = ("compute_ms", "data_ms", "collective_ms", "checkpoint_ms",
        "optimizer_ms", "prefill_ms")


def sampler_overhead(torch, step):
    """The Sampler at its default cadence against none, alternated in
    blocks of ``HEALTH_STEPS`` steps (A B A B; host clock around
    synchronized blocks), beside the reference's direct estimate: one
    tick's cost over the cadence."""
    import statistics

    from ptype_tpu_torch.health import series as series_mod

    blocks = {"with": [], "without": []}
    for arm in ("with", "without", "with", "without"):
        sampler = series_mod.Sampler().start() if arm == "with" else None
        try:
            torch.cuda.synchronize()
            t0 = time.monotonic()
            for _ in range(HEALTH_STEPS):
                step()
            torch.cuda.synchronize()
            blocks[arm].append((time.monotonic() - t0) * 1e3 / HEALTH_STEPS)
        finally:
            if sampler is not None:
                sampler.close()
    probe = series_mod.Sampler()
    n = 200
    t0 = time.perf_counter()
    for _ in range(n):
        probe.sample_once()
    tick_s = (time.perf_counter() - t0) / n
    on = statistics.mean(blocks["with"])
    off = statistics.mean(blocks["without"])
    return {"step_ms_with": blocks["with"], "step_ms_without":
            blocks["without"], "ab_overhead_pct": 100.0 * (on - off) / off,
            "tick_us": tick_s * 1e6, "cadence_s": probe.cadence_s,
            "sampler_overhead_pct": 100.0 * tick_s / probe.cadence_s,
            "bar_pct": HEALTH_SAMPLER_BAR_PCT}


def trace_kernels(profile_dir, top=12):
    """The device-side records of the gzipped Chrome traces under
    ``profile_dir``: their count by category, and the most frequent
    kernel names."""
    import collections
    import gzip

    cats, names = collections.Counter(), collections.Counter()
    for root, _, files in os.walk(profile_dir):
        for f in files:
            if not f.endswith(".trace.json.gz"):
                continue
            with gzip.open(os.path.join(root, f), "rt") as fp:
                for ev in json.load(fp).get("traceEvents", ()):
                    if ev.get("ph") == "X" and ev.get("cat") in (
                            "kernel", "gpu_memcpy", "gpu_memset"):
                        cats[ev["cat"]] += 1
                        if ev["cat"] == "kernel":
                            names[ev.get("name", "?")[:120]] += 1
    return {"by_category": dict(cats), "top": names.most_common(top)}


def health_phase(torch, tfm, flash_mod, train_mod, mesh, params, prompts,
                 max_new, card):
    """The port's health plane at optimus-125m on the card: (a) goodput
    of a StoreDPTrainer (ZeRO 0, exact wire) and of the plain Trainer
    at B=16, S=1024; (b) the sampler's overhead; (c) a profile of a
    serving replica process over RPC; (d) alerts, ``obs`` views and
    OpenMetrics over a cluster snapshot. Returns the launches of this
    phase: (this process's fwd, dq, dkv; the replica's fwd, paged)."""
    from ptype_tpu_torch import Config, PlatformConfig, join, telemetry
    from ptype_tpu_torch import rpc as rpc_mod
    from ptype_tpu_torch.health import (AlertEngine, default_rules,
                                        profiling, render_serve,
                                        render_top)
    from ptype_tpu_torch.metrics import device_peak_tflops
    from ptype_tpu_torch.parallel.collectives import tree_flatten
    from ptype_tpu_torch.train import store_dp as sd

    cfg = tfm.preset("optimus-125m")
    B, S = 16, 1024
    batch = next(train_mod.synthetic_batches(cfg.vocab_size, B, S, seed=3,
                                             device="cuda"))
    counters = (flash_mod.flash_attention, flash_mod.flash_attention_dq,
                flash_mod.flash_attention_dkv)
    own = [0, 0, 0]
    row = {"phase": "health", "preset": "optimus-125m", "card": card,
           "B": B, "S": S, "peak_tflops": device_peak_tflops()}
    t_phase = time.monotonic()

    # (a) goodput of the StoreDPTrainer: host regions; the step reads
    # its loss, so train.step is the true step.
    tr, pieces = store_dp_trainer(torch, train_mod, sd, mesh, cfg, params,
                                  0, False, "exact")
    with pieces:
        tr.step(batch)
        t0 = time.monotonic()
        cost = tr.compiled_cost()
        row["compiled_cost_s"] = time.monotonic() - t0
        row["compiled_flops_per_token"] = cost["flops_per_token"]
        row["compiled_bytes_per_token"] = (cost["bytes_accessed"]
                                           / cost["tokens_per_step"])
        row["count_device"] = cost["programs"]["grads"]["device"]
        for c in counters:
            c.launches = 0
        recs, summary, advanced, wall_ms = goodput_run(
            torch, tfm, lambda: tr.step(batch), cfg, cost["flops"], B * S)
        launches = [c.launches for c in counters]
        own = [a + b for a, b in zip(own, launches)]
        row["store_dp"] = {"goodput": summary, "wall_ms": wall_ms,
                           "records": recs, "train_steps": advanced,
                           "launches": launches}
        check(len(recs) == HEALTH_STEPS,
              f"health: {len(recs)} goodput records closed, want "
              f"{HEALTH_STEPS}")
        for r in recs:
            legs = sum(r[k] for k in LEGS)
            check(abs(legs - r["step_ms"]) <= 0.01,
                  f"health: a record's legs sum to {legs} ms, its step is "
                  f"{r['step_ms']} ms: {r}")
        check(advanced == HEALTH_STEPS,
              f"health: train.steps advanced {advanced}, want "
              f"{HEALTH_STEPS}")
        gap = summary.get("mfu_gap_pct")
        check(gap is not None and abs(gap) <= HEALTH_GAP_PCT,
              f"health: compiled vs analytic FLOPs gap {gap}% "
              f"(bar {HEALTH_GAP_PCT}%)")
        want = (HEALTH_STEPS + HEALTH_WARM) * cfg.n_layers
        check(launches == [want] * 3,
              f"health: goodput steps launched fwd/dq/dkv {launches}, "
              f"want {want} each")
        # (b) the sampler's overhead on the same trainer.
        for c in counters:
            c.launches = 0
        row["sampler"] = sampler_overhead(torch, lambda: tr.step(batch))
        own = [a + c.launches for a, c in zip(own, counters)]
    del tr
    torch.cuda.empty_cache()

    # (a) the plain Trainer: it dispatches without waiting, so its
    # regions time the host's dispatch (figures printed, not gated).
    ptr, pbatch = new_trainer(torch, train_mod, cfg)
    for c in counters:
        c.launches = 0
    recs, summary, advanced, wall_ms = goodput_run(
        torch, tfm, lambda: ptr.step(pbatch), cfg, cost["flops"], B * S)
    ptr.sync()
    own = [a + c.launches for a, c in zip(own, counters)]
    row["trainer"] = {"goodput": summary, "wall_ms": wall_ms,
                      "train_steps": advanced,
                      "step_ms": [r["step_ms"] for r in recs]}
    check(advanced == HEALTH_STEPS and len(recs) == HEALTH_STEPS,
          f"health: the Trainer's seam saw {len(recs)} steps, "
          f"train.steps advanced {advanced}")
    del ptr
    torch.cuda.empty_cache()
    emit({**row, "step": "goodput"})

    # (c) a bf16 Paged replica process profiled over RPC while it serves
    # phase 4's requests.
    seed = join(Config(
        service_name="health-seed", node_name="health-seed", port=9003,
        platform=PlatformConfig(name="health-seed",
                                coordinator_address="127.0.0.1:0",
                                is_coordinator=True, lease_ttl=CLUSTER_TTL)))
    work = tempfile.mkdtemp(prefix="chip_smoke_health_")
    proc, out_path, log_path = start_replica(
        seed._owned_server.address, "unified", work, HEALTH_SERVICE,
        series_s=HEALTH_SERIES_S)
    conns = []
    try:
        t0 = time.monotonic()
        wait_child_line(proc, out_path, log_path, 300, "health")
        wait_for(lambda: seed.registry.nodes(HEALTH_SERVICE), 60,
                 "the replica did not register", "health")
        row["replica_ready_s"] = time.monotonic() - t0
        node = seed.registry.nodes(HEALTH_SERVICE)[0]
        conns = [rpc_mod._dial(node, 10.0, "cuda") for _ in range(2)]
        ctl, calls = conns

        def call(conn, method, *args, timeout=600):
            return conn.call_async(method, args).result(timeout=timeout)

        # One short request first, so the kernels' modules are loaded
        # and the allocator warm before the capture's window.
        call(calls, "Paged.Generate", prompts[0].to("cuda")[None], 4)
        call(ctl, "Probe.Reset")
        weight_bytes = sum(p.numel() * p.element_size()
                           for _, p in tree_flatten(params))
        mem0 = call(ctl, "ptype.Profile", "memory")
        prof_dir = os.path.join(work, "profile")
        box = {}
        profiler = threading.Thread(target=lambda: box.setdefault(
            "res", telemetry.cluster_profile(
                seed.registry, duration_s=HEALTH_PROFILE_S,
                out_dir=prof_dir, services=[HEALTH_SERVICE],
                timeout=HEALTH_PROFILE_S + 120)), daemon=True)
        t_cap = time.monotonic()
        profiler.start()
        wait_for(lambda: call(ctl, "ptype.Profile", "status")["active"]
                 or not profiler.is_alive(), 120,
                 "the replica's profile session did not start", "health")
        row["capture_start_s"] = time.monotonic() - t_cap
        outs, errs = [None] * len(prompts), []

        def generate(i):
            try:
                outs[i] = call(calls, "Paged.Generate",
                               prompts[i].to("cuda")[None], max_new)
            except Exception as e:  # noqa: BLE001 — re-raised below
                errs.append(e)

        def prefill():
            # The paged engine's chunked prefill attends through the
            # block table; the replica's flash forward runs in its
            # GeneratorActor's prefill (one 512-token prompt).
            try:
                box["generator"] = call(calls, "Generator.Generate",
                                        prompts[-1][:512].to("cuda")[None],
                                        8)
            except Exception as e:  # noqa: BLE001 — re-raised below
                errs.append(e)

        t_req = time.monotonic()
        reqs = [threading.Thread(target=generate, args=(i,), daemon=True)
                for i in range(len(prompts))]
        reqs.append(threading.Thread(target=prefill, daemon=True))
        for t in reqs:
            t.start()
        profiler.join(timeout=HEALTH_PROFILE_S + 300)
        row["capture_wall_s"] = time.monotonic() - t_cap
        for t in reqs:
            t.join(timeout=600)
        row["requests_s"] = time.monotonic() - t_req
        if errs:
            raise errs[0]
        check(all(o is not None and tuple(o.shape) == (1, max_new)
                  for o in outs) and tuple(box["generator"].shape) == (1, 8),
              "health: a request through the profiled replica did not "
              "come back whole")
        res = box.get("res")
        check(res is not None and not res["errors"] and res["nodes"],
              f"health: cluster_profile failed: {res}")
        (key, got), = res["nodes"].items()
        mem = call(ctl, "ptype.Profile", "memory")
        replica = call(ctl, "Probe.Counters")
        row["replica_launches"] = replica

        # (d) one snapshot of the replica and this process: no alert over
        # the clean run, the obs views, an OpenMetrics line a family.
        snap = telemetry.cluster_snapshot(seed.registry,
                                          services=[HEALTH_SERVICE])
        check(not snap["errors"] and len(snap["nodes"]) == 2,
              f"health: snapshot errors {snap['errors']}, nodes "
              f"{sorted(snap['nodes'])}")
        alerts = AlertEngine(default_rules()).evaluate(snap)
        row["alerts"] = [a.to_dict() for a in alerts]
        check(not alerts, f"health: alerts over a clean run: "
              f"{row['alerts']}")
        row["series"] = {k: sorted(t.get("series", {}))
                         for k, t in snap["nodes"].items()}
        check(snap["nodes"][key]["series"], "health: the replica's pull "
              "carries no series (its sampler is armed)")
        om = telemetry.openmetrics(snap)
        missing = [n for t in snap["nodes"].values()
                   for fam in ("counters", "gauges", "timings",
                               "histograms")
                   for n in t["metrics"].get(fam, {})
                   if f"# TYPE {telemetry._om_name(n)} " not in om]
        row["openmetrics_lines"] = om.count("\n")
        check(not missing, f"health: OpenMetrics lacks {missing[:10]}")
        row["render_top"] = render_top(snap, alerts)
        row["render_serve"] = render_serve(snap, alerts)
        print(row["render_top"], flush=True)
        print(row["render_serve"], flush=True)
        call(ctl, "Probe.Reset")
        # The cluster is done with: the shipped trace is parsed after it
        # closes (parsing holds the interpreter lock for most of a
        # second, longer than the seed's 1 s lease).
        proc.kill()
        proc.wait(timeout=60)
        seed.close()

        # (c)'s checks on the shipped artifacts.
        s = profiling.summarize(got["dir"], top=100_000)
        names = [op["name"] for op in s["top_ops"]]
        kernels = trace_kernels(got["dir"])
        found = {k: sum(op["count"] for op in s["top_ops"] if k in op["name"])
                 for k in ("flash_fwd_kernel_bf16",
                           "paged_decode_split_kernel")}
        sizes = {f["path"]: f["size"] for f in profiling.artifact_files(
            got["dir"])}
        stats = mem["devices"][0]["stats"]
        row["profile"] = {
            "node": key, "capture_s": got["capture_s"],
            "files": sizes, "events": s["events"],
            "kernel_events": found, "remote_dir": got["remote_dir"],
            "kernels": kernels, "truncated": got.get("truncated"),
            "top_ops": s["top_ops"][:12],
            "memory_before": mem0["devices"][0]["stats"],
            "memory_after": stats, "weight_bytes": weight_bytes,
            "memory_profile_size": mem.get("memory_profile_size")}
        check(all(n > 0 for n in found.values()),
              f"health: the shipped trace lacks the kernels' events "
              f"{found}; its kernels: {kernels}; top: {names[:30]}")
        check(stats["bytes_in_use"] >= weight_bytes,
              f"health: the replica holds {stats['bytes_in_use']} bytes, "
              f"under its weights' {weight_bytes}")
        check(replica["flash_fwd"] > 0 and replica["paged_decode"] > 0,
              f"health: the replica launched no kernel: {replica}")
        row["seconds"] = time.monotonic() - t_phase
        emit(row)
        return own, (replica["flash_fwd"], replica["paged_decode"])
    finally:
        for c in conns:
            c.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        seed.close()
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()


FO_SERVICE = "llm-fo"
FO_LEASE_TTL = 1.0
FO_WITNESS_TTL = 3.0
FO_RPS = 2.0
FO_TRAFFIC_S = 12.0
FO_KILL_AT_S = 4.0
FO_MAX_NEW = 32
FO_TRAIN = dict(PRESET="optimus-125m", MODE="store", BATCH="16",
                SEQ="1024", STEPS="8", CKPT_EVERY="4")
FO_EVAL_STEPS = 3
FO_FLASH_RECORDS = 12


def listening(addr):
    """True once something accepts TCP connections on ``addr``."""
    host, _, port = addr.rpartition(":")
    try:
        socket.create_connection((host, int(port)), timeout=0.2).close()
        return True
    except OSError:
        return False


def free_addr():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def cli_config(work, name, service, urls=(), **platform):
    """A two-level config tree of the CLI (``CONFIG`` names a cluster
    file whose ``platform_config_file`` is beside it), written as JSON,
    which is YAML."""
    d = os.path.join(work, "cfg", name)
    os.makedirs(d)
    with open(os.path.join(d, "platform.yaml"), "w") as f:
        json.dump({"name": name, **platform}, f)
    with open(os.path.join(d, "node.yaml"), "w") as f:
        json.dump({"service_name": service, "node_name": name, "port": 0,
                   "initial_cluster_client_urls": list(urls),
                   "platform_config_file": "platform.yaml"}, f)
    return os.path.join(d, "node.yaml")


class CliProc:
    """``python -m ptype_tpu_torch VERB...`` of this checkout as a child
    process, its output (stdout and stderr) in a log under ``work``."""

    def __init__(self, verb, cfg, work, name, **env):
        root = os.path.dirname(os.path.abspath(__file__))
        self.name = name
        self.log = os.path.join(work, f"{name}.log")
        e = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]),
            **env)
        if cfg is not None:
            e["CONFIG"] = cfg
        with open(self.log, "w") as f:
            self.t0 = time.monotonic()
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "ptype_tpu_torch", *verb.split()],
                stdout=f, stderr=subprocess.STDOUT, env=e, cwd=root)

    def text(self):
        with open(self.log) as f:
            return f.read()

    def wait(self, needle, timeout=300):
        """ms from the Popen to a line holding ``needle``."""
        deadline = time.monotonic() + timeout
        while needle not in self.text():
            check(self.proc.poll() is None and time.monotonic() < deadline,
                  f"failover: {self.name} printed no {needle!r} (exit "
                  f"{self.proc.poll()}):\n{self.text()[-4000:]}")
            time.sleep(0.02)
        return (time.monotonic() - self.t0) * 1e3

    def finish(self, timeout=300):
        """The verb's whole output, once it exited 0."""
        try:
            rc = self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            rc = None
        check(rc == 0, f"failover: {self.name} exited {rc}:\n"
              f"{self.text()[-4000:]}")
        return self.text()

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(timeout=60)


def run_verb(cli, argv, env):
    """``python -m ptype_tpu_torch ARGV`` in this process (so the launch
    counters of its kernels are readable here) under ``env``; its
    standard output, echoed."""
    import contextlib
    import io

    saved_env, saved_argv = dict(os.environ), sys.argv
    os.environ.update(env)
    sys.argv = ["ptype_tpu_torch", *argv]
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            cli.main()
    finally:
        sys.argv = saved_argv
        os.environ.clear()
        os.environ.update(saved_env)
        print(buf.getvalue(), end="", flush=True)
    return buf.getvalue()


class StepClock:
    """Times every ``StoreDPTrainer.step`` (its loss is read on the host,
    so a step's host time is its whole time) and runs ``after_first``
    once the first step returned."""

    def __init__(self, cls, after_first=None):
        self.cls, self.orig = cls, cls.step
        self.after_first = after_first
        self.rows = []

    def __enter__(self):
        clock = self

        def step(tr, batch):
            t0 = time.monotonic()
            out = clock.orig(tr, batch)
            t1 = time.monotonic()
            clock.rows.append({"step": out["step"], "loss": out["loss"],
                               "ms": (t1 - t0) * 1e3, "t0": t0, "t1": t1})
            if len(clock.rows) == 1 and clock.after_first is not None:
                clock.after_first()
            return out

        self.cls.step = step
        return self

    def __exit__(self, *exc):
        self.cls.step = self.orig


def failover_phase(torch, tfm, flash_mod, prompts, card):
    """Coordinator failover and the operator CLI at optimus-125m, every
    process a ``python -m ptype_tpu_torch`` verb: (a) a witness, a seed
    (``join``), a wal-stream ``standby`` and a ``serve`` replica;
    (b) phase 4's prompts through the replica equal an in-process
    ``BatchingGeneratorActor``; (c) the seed SIGKILLed under 2 rps of
    (1, 512) requests: none lost, the standby's promotion, the witness
    handover, the replica's re-listing, a fresh client's first answer,
    and the old seed restarted on its data refused by the term fence;
    (d) ``obs`` and ``obs profile`` of the promoted cluster, the
    replica's flash forward records; (e) the ``train`` verb in this
    process (store mode, B=16, S=1024, 8 steps) through a second seed's
    SIGKILL: losses equal an uninterrupted run's, the kernels' launches,
    each step's ms, then ``eval`` of its checkpoint; (f) ``info``;
    (g) no child left. Returns the phase's launches (fwd, dq, dkv) and
    the replica's flash forward records."""
    from ptype_tpu_torch import Config, PlatformConfig, join
    from ptype_tpu_torch import __main__ as cli
    from ptype_tpu_torch.coord import wire, witness
    from ptype_tpu_torch.coord.remote import RemoteCoord
    from ptype_tpu_torch.errors import CoordinationError
    from ptype_tpu_torch.health import profiling
    from ptype_tpu_torch.registry import CoordRegistry
    from ptype_tpu_torch.rpc import ConnConfig
    from ptype_tpu_torch.serve import BatchingGeneratorActor
    from ptype_tpu_torch.store import KVStore, with_prefix
    from ptype_tpu_torch.train.store_dp import StoreDPTrainer

    t_phase = time.monotonic()
    row = {"phase": "failover", "card": card, "preset": "optimus-125m"}
    work = tempfile.mkdtemp(prefix="chip_smoke_failover_")
    procs, clients, coords = [], [], []

    def start(verb, cfg, name, **env):
        p = CliProc(verb, cfg, work, name, **env)
        procs.append(p)
        return p

    def eligible(members, addr):
        return any((m.metadata or {}).get("role") == "standby"
                   and (m.metadata or {}).get("learner") is False
                   and m.peer_addr == addr for m in members)

    def kill(p):
        os.kill(p.proc.pid, signal.SIGKILL)
        p.proc.wait(timeout=60)
        return time.monotonic()

    counters = (flash_mod.flash_attention, flash_mod.flash_attention_dq,
                flash_mod.flash_attention_dkv)
    try:
        # (a) a witness, a seed, a wal-stream standby and a replica.
        seed_addr, sb_addr, wit_addr = free_addr(), free_addr(), free_addr()
        quorum = dict(witness_address=wit_addr,
                      witness_ttl=FO_WITNESS_TTL)
        seed_cfg = cli_config(
            work, "seed", "fo-seed", coordinator_address=seed_addr,
            is_coordinator=True, data_dir=os.path.join(work, "seed"),
            lease_ttl=FO_LEASE_TTL, **quorum)
        ready = {}
        wit = start("witness", cli_config(
            work, "witness", "fo-witness", coordinator_address=seed_addr,
            data_dir=os.path.join(work, "witness"), **quorum), "witness")
        ready["witness"] = wit.wait("witness on")
        seed = start("join", seed_cfg, "seed")
        ready["seed"] = seed.wait("joined as")
        sb = start("standby", cli_config(
            work, "standby", "fo-standby", coordinator_address=seed_addr,
            data_dir=os.path.join(work, "standby"), lease_ttl=FO_LEASE_TTL,
            **quorum), "standby", STANDBY_ADDR=sb_addr,
            STANDBY_REPLICATE="1")
        ready["standby"] = sb.wait("standby for")
        rep = start("serve", cli_config(
            work, "replica", FO_SERVICE, urls=[seed_addr, sb_addr],
            coordinator_address=seed_addr, lease_ttl=FO_LEASE_TTL),
            "replica", PRESET="optimus-125m")
        client = join(Config(
            service_name="", node_name="fo-client", port=0,
            initial_cluster_client_urls=[seed_addr, sb_addr],
            platform=PlatformConfig(name="fo-client",
                                    coordinator_address=seed_addr,
                                    lease_ttl=FO_LEASE_TTL)),
            device="cuda")
        clients.append(client)
        wait_for(lambda: eligible(client.member_list(), sb_addr), 120,
                 "the standby never became promote-eligible", "failover")
        ready["standby_promote_eligible"] = (time.monotonic()
                                             - sb.t0) * 1e3
        ready["replica"] = rep.wait("serving Generator", 600)
        row["ready_ms"] = ready

        # (b) phase 4's prompts one at a time, greedy, 32 new tokens.
        gen = client.new_client(FO_SERVICE)
        local = BatchingGeneratorActor(tfm.preset("optimus-125m"),
                                       device="cuda")
        same = []
        try:
            for p in prompts:
                x = p.to("cuda", torch.int32)[None]
                got = gen.call("Generator.Generate", x, FO_MAX_NEW)
                want = local.Generate(x, FO_MAX_NEW)
                check(got.device.type == "cuda"
                      and tuple(got.shape) == (1, FO_MAX_NEW),
                      f"failover: the replica answered {got.device} "
                      f"{tuple(got.shape)}")
                same.append(bool(torch.equal(got, want)))
        finally:
            local.close()
            del local
            torch.cuda.empty_cache()
        row["tokens_equal_in_process"] = same
        check(all(same), f"failover: the CLI replica's tokens differ from "
              f"an in-process BatchingGeneratorActor's: {same}")

        # (c) SIGKILL the seed at 4 s of 12 s of 2 rps.
        x512 = prompts[-1][:512].to("cuda", torch.int32)[None]
        x16 = x512[:, :16]
        holder0 = witness.status(wit_addr)["holder"]
        results, lock = [], threading.Lock()
        mon = {"missing_reads": 0, "reads": 0}
        stop_mon = threading.Event()

        def request(t_send):
            try:
                out = gen.call("Generator.Generate", x512, FO_MAX_NEW)
                ok, err = tuple(out.shape) == (1, FO_MAX_NEW), None
            except Exception as e:  # noqa: BLE001 — counted below
                ok, err = False, repr(e)
            with lock:
                results.append({"t_send": t_send, "ok": ok, "err": err,
                                "ms": (time.monotonic() - t_send) * 1e3})

        def monitor(t_kill):
            def since():
                return (time.monotonic() - t_kill) * 1e3

            coord = None
            while not stop_mon.is_set():
                if "witness_handover_ms" not in mon:
                    try:
                        st = witness.status(wit_addr, timeout=0.5)
                        if st["holder"] not in (holder0, None):
                            mon["witness_handover_ms"] = since()
                            mon["witness"] = st
                    except OSError:
                        pass
                if coord is None:
                    if listening(sb_addr):
                        mon.setdefault("promoted_ms", since())
                        try:
                            coord = RemoteCoord([sb_addr], dial_timeout=1.0,
                                                request_timeout=2.0,
                                                reconnect_timeout=2.0)
                            coords.append(coord)
                        except CoordinationError:
                            pass
                else:
                    try:
                        nodes = CoordRegistry(coord).nodes(FO_SERVICE)
                        mon["reads"] += 1
                        mon["term"] = coord.term
                        if nodes:
                            mon.setdefault("listed_ms", since())
                        else:
                            # Listed once, then gone: the replica's
                            # lease lapsed before its keepalive found
                            # the promoted standby (it re-registers).
                            mon["missing_reads"] += 1
                            mon.setdefault("first_missing_ms", since())
                            mon["last_missing_ms"] = since()
                    except CoordinationError as e:
                        mon.setdefault("read_errors", []).append(repr(e))
                time.sleep(0.01)

        def fresh_client(t_kill):
            deadline = t_kill + 60
            while "promoted_ms" not in mon and time.monotonic() < deadline:
                time.sleep(0.01)
            while time.monotonic() < deadline:
                try:
                    c = client.new_client(
                        FO_SERVICE, ConnConfig(initial_node_timeout=2.0))
                    try:
                        c.call("Generator.Generate", x16, 4)
                    finally:
                        c.close()
                    mon["new_client_ms"] = (time.monotonic() - t_kill) * 1e3
                    return
                except Exception as e:  # noqa: BLE001 — retried
                    mon.setdefault("new_client_errors", []).append(repr(e))
                    time.sleep(0.05)

        n = int(FO_TRAFFIC_S * FO_RPS)
        t_start, t_kill, reqs, watchers = time.monotonic(), None, [], []
        for i in range(n):
            due = t_start + i / FO_RPS
            if t_kill is None and due >= t_start + FO_KILL_AT_S:
                time.sleep(max(0.0, t_start + FO_KILL_AT_S
                               - time.monotonic()))
                t_kill = kill(seed)
                watchers = [threading.Thread(target=fn, args=(t_kill,),
                                             daemon=True)
                            for fn in (monitor, fresh_client)]
                for t in watchers:
                    t.start()
            time.sleep(max(0.0, due - time.monotonic()))
            reqs.append(threading.Thread(target=request, args=(due,),
                                         daemon=True))
            reqs[-1].start()
        for t in reqs:
            t.join(timeout=600)
        watchers[1].join(timeout=60)
        stop_mon.set()
        watchers[0].join(timeout=60)
        before = [r["ms"] for r in results if r["t_send"] < t_kill]
        after = [r["ms"] for r in results if r["t_send"] >= t_kill]
        term = sb.text().split("term bumped (promotion) term=")
        row["kill"] = {
            **{k: v for k, v in mon.items() if k != "read_errors"},
            "read_errors": len(mon.get("read_errors", [])),
            "promotion_term_logged": (int(term[1].split()[0])
                                      if len(term) > 1 else None),
            "requests": n, "answered": sum(r["ok"] for r in results),
            "errors": [r["err"] for r in results if not r["ok"]],
            "ms_before_kill": {"p50": nearest_rank(before, 50),
                               "max": max(before)},
            "ms_after_kill": {"p50": nearest_rank(after, 50),
                              "max": max(after)}}
        row["kill"].pop("new_client_errors", None)
        check(len(results) == n and all(r["ok"] for r in results),
              f"failover: requests lost across the kill: {row['kill']}")
        for key in ("promoted_ms", "witness_handover_ms", "listed_ms",
                    "new_client_ms"):
            check(key in mon, f"failover: no {key} after the kill: "
                  f"{row['kill']}")
        check(mon["term"] >= 1 and mon["witness"]["holder"] == sb_addr,
              f"failover: the promoted standby's term {mon['term']}, "
              f"witness {mon['witness']}")

        # The old seed restarted on its old data dir: the term fence
        # refuses a client that has seen the promoted term.
        again = start("join", seed_cfg, "seed-restarted")
        again.wait("joined as")
        host, _, port = seed_addr.rpartition(":")
        s = socket.create_connection((host, int(port)), timeout=5)
        try:
            wire.send_msg(s, threading.Lock(),
                          {"op": "put", "id": 1, "key": "store/fo",
                           "value": "stale", "min_term": mon["term"]})
            reply = wire.recv_msg(s)
        finally:
            s.close()
        row["stale_seed_reply"] = reply
        check(reply.get("stale") and not reply.get("ok"),
              f"failover: the restarted stale seed served a fenced "
              f"write: {reply}")
        again.stop()

        # (d) obs of the promoted cluster, and obs profile under load.
        obs_cfg = cli_config(work, "obs", "fo-obs",
                             coordinator_address=sb_addr)
        obs_dir = os.path.join(work, "obs")
        os.makedirs(obs_dir)
        out = start("obs", obs_cfg, "obs", OBS_DIR=obs_dir).finish(120)
        files = {f: os.path.getsize(os.path.join(obs_dir, f))
                 for f in ("trace.json", "spans.jsonl")
                 if os.path.exists(os.path.join(obs_dir, f))}
        row["obs"] = {"files": files,
                      "lists_replica": f"{FO_SERVICE}/" in out}
        check(len(files) == 2 and row["obs"]["lists_replica"],
              f"failover: obs wrote {files}, listed the replica: "
              f"{row['obs']['lists_replica']}:\n{out[-3000:]}")
        # A process's first torch.profiler session pays CUPTI's start-up
        # (~7 s) inside the verb's reply timeout (its window + 15 s, as
        # the reference's): a short capture with no load takes it out
        # of the measured one.
        t_warm = time.monotonic()
        warm = start("obs profile", obs_cfg, "obs-profile-warm",
                     OBS_DIR=os.path.join(work, "obs-warm"),
                     PROFILE_DURATION="0.1").finish(120)
        check("FAILED" not in warm, f"failover: the warm-up capture "
              f"failed:\n{warm[-3000:]}")
        warm_s = time.monotonic() - t_warm
        prof = start("obs profile", obs_cfg, "obs-profile", OBS_DIR=obs_dir,
                     PROFILE_DURATION="1")
        load_errors = []

        def load():
            while prof.proc.poll() is None:
                try:
                    gen.call("Generator.Generate", x512, 8)
                except Exception as e:  # noqa: BLE001 — checked below
                    load_errors.append(repr(e))
                    return

        loaders = [threading.Thread(target=load, daemon=True)
                   for _ in range(2)]
        for t in loaders:
            t.start()
        out = prof.finish(300)
        prof_s = time.monotonic() - prof.t0
        for t in loaders:
            t.join(timeout=120)
        check(not load_errors, f"failover: requests under the profile "
              f"failed: {load_errors}")
        pdir = os.path.join(obs_dir, "profile")
        rep_dirs = [os.path.join(pdir, d)
                    for d in (os.listdir(pdir) if os.path.isdir(pdir) else ())
                    if d.startswith(FO_SERVICE + "_")]
        check(len(rep_dirs) == 1, f"failover: obs profile shipped no "
              f"capture of the replica:\n{out[-3000:]}")
        ops = profiling.summarize(rep_dirs[0], top=100_000)["top_ops"]
        records = sum(op["count"] for op in ops
                      if "flash_fwd_kernel_bf16" in op["name"])
        row["obs_profile"] = {"warm_up_s": warm_s,
                              "capture_wall_s": prof_s,
                              "flash_fwd_kernel_bf16_records": records,
                              "kernels": trace_kernels(rep_dirs[0])}
        check(records >= FO_FLASH_RECORDS,
              f"failover: the replica's shipped trace holds {records} "
              f"flash_fwd_kernel_bf16 records (< {FO_FLASH_RECORDS}):\n"
              f"{out[-3000:]}")
        gen.close()

        # (e) the train verb through a second seed's SIGKILL, beside an
        # uninterrupted run of the same verb on the promoted cluster.
        seed2_addr, sb2_addr = free_addr(), free_addr()
        seed2 = start("join", cli_config(
            work, "seed2", "fo-seed2", coordinator_address=seed2_addr,
            is_coordinator=True, data_dir=os.path.join(work, "seed2"),
            lease_ttl=FO_LEASE_TTL), "seed2")
        seed2.wait("joined as")
        sb2 = start("standby", cli_config(
            work, "standby2", "fo-standby2", coordinator_address=seed2_addr,
            data_dir=os.path.join(work, "standby2"),
            lease_ttl=FO_LEASE_TTL), "standby2", STANDBY_ADDR=sb2_addr,
            STANDBY_REPLICATE="1")
        sb2.wait("standby for")
        coord2 = RemoteCoord([seed2_addr])
        coords.append(coord2)
        wait_for(lambda: eligible(coord2.member_list(), sb2_addr), 120,
                 "the second standby never became promote-eligible",
                 "failover")
        coord2.close()
        runs = {}
        for name, urls, coord_addr, on_first in (
                ("uninterrupted", [sb_addr], sb_addr, None),
                ("failover", [seed2_addr, sb2_addr], seed2_addr,
                 lambda: runs.__setitem__("t_kill", kill(seed2)))):
            ckpt = os.path.join(work, f"ckpt_{name}")
            cfg = cli_config(work, f"train_{name}", "fo-train", urls=urls,
                             coordinator_address=coord_addr,
                             mesh_axes={"data": 1}, lease_ttl=FO_LEASE_TTL)
            for c in counters:
                c.launches = 0
            with StepClock(StoreDPTrainer, on_first) as clock:
                out = run_verb(cli, ["train"],
                               dict(FO_TRAIN, CONFIG=cfg, CKPT_DIR=ckpt))
            torch.cuda.synchronize()
            runs[name] = {"steps": clock.rows, "stdout": out, "ckpt": ckpt,
                          "launches": [c.launches for c in counters]}
        fo, calm = runs["failover"], runs["uninterrupted"]
        want = int(FO_TRAIN["STEPS"]) * 12
        for name in ("uninterrupted", "failover"):
            r = runs[name]
            check(len(r["steps"]) == int(FO_TRAIN["STEPS"]),
                  f"failover: the {name} run took {len(r['steps'])} steps")
            check(r["launches"] == [want] * 3,
                  f"failover: the {name} run's launches fwd/dq/dkv "
                  f"{r['launches']} != {want} each")
            check("optimus[store] optimus-125m on 1 devices, batch=16 "
                  "seq=1024" in r["stdout"],
                  f"failover: {name}'s lines:\n{r['stdout']}")
        l_fo = [r["loss"] for r in fo["steps"]]
        l_calm = [r["loss"] for r in calm["steps"]]
        check(l_fo == l_calm, f"failover: losses {l_fo} differ from the "
              f"uninterrupted run's {l_calm}")
        check(all(math.isfinite(x) for x in l_fo),
              f"failover: loss not finite: {l_fo}")
        t_kill2 = runs["t_kill"]
        wait_for(lambda: listening(sb2_addr), 60,
                 "the second standby never promoted", "failover")
        coord3 = RemoteCoord([sb2_addr], reconnect_timeout=10.0)
        coords.append(coord3)
        manifests = [json.loads(v) for v in
                     KVStore(coord3).get("tensors/", with_prefix())]
        calm_ms = sorted(r["ms"] for r in calm["steps"][1:])
        span = [r for r in fo["steps"] if r["t1"] >= t_kill2]
        def gaps(rows):  # between steps: the checkpoint saves, prints
            return [(b["t0"] - a["t1"]) * 1e3 for a, b in zip(rows, rows[1:])]

        row["train"] = {
            "losses": l_fo, "losses_equal_uninterrupted": True,
            "step_ms": [r["ms"] for r in fo["steps"]],
            "uninterrupted_step_ms": [r["ms"] for r in calm["steps"]],
            "gap_ms": gaps(fo["steps"]),
            "uninterrupted_gap_ms": gaps(calm["steps"]),
            "steps_after_kill_ms": [r["ms"] for r in span],
            "stall_ms": (max(r["ms"] for r in span)
                         - calm_ms[len(calm_ms) // 2]) if span else None,
            "kill_after_step": fo["steps"][0]["step"],
            "launches": {"uninterrupted": calm["launches"],
                         "failover": fo["launches"]},
            "manifests_on_promoted_standby": len(manifests),
            "manifest_max_epoch": max(m["epoch"] for m in manifests)}
        check(manifests, "failover: no tensor manifests on the promoted "
              "standby")
        counters[0].launches = 0
        out = run_verb(cli, ["eval"], dict(
            CKPT_DIR=fo["ckpt"], PRESET="optimus-125m",
            BATCH=FO_TRAIN["BATCH"], SEQ=FO_TRAIN["SEQ"],
            EVAL_STEPS=str(FO_EVAL_STEPS)))
        ev = json.loads(out.strip().splitlines()[-1])
        eval_fwd = counters[0].launches
        row["eval"] = {**ev, "flash_fwd_launches": eval_fwd}
        check(ev["checkpoint_step"] == int(FO_TRAIN["STEPS"])
              and math.isfinite(ev["loss"]),
              f"failover: eval read {ev}")
        check(eval_fwd == FO_EVAL_STEPS * 12,
              f"failover: eval launched the flash forward {eval_fwd} times")

        # (f) info on the card.
        out = start("info", None, "info").finish(120)
        info = json.loads(out[out.index("{"):out.rindex("}") + 1])
        row["info"] = info
        check(info["platform"] == "cuda" and info["devices"] == 1
              and info["device_kind"] == torch.cuda.get_device_name(0)
              and info["native_wire"] is True, f"failover: info {info}")
    finally:
        for c in coords:
            c.close()
        for c in clients:
            c.close()
        for p in procs:
            p.stop()
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()
    # (g) every child has exited.
    left = [p.name for p in procs if p.proc.poll() is None]
    row["children"] = len(procs)
    check(not left, f"failover: children outlived the phase: {left}")
    row["seconds"] = time.monotonic() - t_phase
    emit(row)
    launches = [calm["launches"][i] + fo["launches"][i] for i in range(3)]
    launches[0] += eval_fwd
    return launches, records


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

    # gateway_serving: two replica processes behind the port's gateway,
    # interleaved, disaggregated, and under open-loop load
    gw_paged = gateway_serving_phase(torch, tfm, PagedGeneratorActor,
                                     params, prompts, max_new, kw, card)

    # reconciler: the port's reconciler spawns, heals and drains a fleet
    # of replica processes behind the gateway under open-loop traffic
    rec_paged, rec_flash = reconciler_phase(torch, tfm, PagedGeneratorActor,
                                            params, prompts, max_new, kw,
                                            card)

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

    # health: goodput, the sampler's cost, a replica profiled over RPC,
    # alerts and the obs views, at optimus-125m
    health_own, (health_rep_fwd, health_rep_paged) = health_phase(
        torch, tfm, flash_mod, train_mod, mesh, params, prompts, max_new,
        card)
    torch.cuda.empty_cache()

    # failover: coordinator failover and the operator CLI, every process
    # a python -m ptype_tpu_torch verb, at optimus-125m
    fo_launches, fo_records = failover_phase(torch, tfm, flash_mod, prompts,
                                             card)

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
    for zero, overlap in ((0, False), (0, True), (2, False)):
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
              "elastic": elastic_launches[0],
              "health": health_own[0] + health_rep_fwd,
              "failover": fo_launches[0] + fo_records}
    if rec_flash:
        fwd128["reconciler"] = rec_flash
    fwd64 = {"moe_generator": moe_flash_launches, "moe_trainer": moe_fwd_n}
    paged128 = {"paged_engine": paged_main_launches,
                "cluster_rpc": rpc_paged,
                "gateway_serving": gw_paged,
                "reconciler": rec_paged,
                "spec_engine": spec_launches["spec"],
                "spec_engine_plain_run": spec_launches["plain"],
                "sampled_engine": sampled_launches,
                "disagg_engine": disagg_launches,
                "health": health_rep_paged}
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
              "elastic": elastic_launches[1], "health": health_own[1],
              "failover": fo_launches[1]}),
        rows("flash_bwd_dq", bwd_src, dq_ref,
             pick("flash_bwd_dq", 16, 12, 64, 1024),
             {"moe_trainer": moe_dq_n}),
        rows("flash_bwd_dkv", bwd_src, dkv_ref,
             pick("flash_bwd_dkv", 16, 6, 128, 1024),
             {"trainer": dkv_n, "store_dp": store_launches[2],
              "checkpoint": ckpt_launches[2],
              "elastic": elastic_launches[2], "health": health_own[2],
              "failover": fo_launches[2]}),
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
        opts = dict(zip(sys.argv[3::2], sys.argv[4::2]))
        actor_server(sys.argv[2], opts.get("--serve-class", "unified"),
                     opts.get("--service", "llm"),
                     (float(opts["--series"]) if "--series" in opts
                      else None))
        sys.exit(0)
    try:
        main()
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
    except Exception:  # noqa: BLE001 — any failure is a failed run
        traceback.print_exc()
        sys.exit(1)
