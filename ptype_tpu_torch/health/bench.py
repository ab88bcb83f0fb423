"""Health-plane cost probe: goodput numbers + measured overhead — the
port's copy of ``ptype_tpu/health/bench.py``.

Runs the world-1 store-DP step loop with the ledger installed on the
real annotate seam and the sampler ticking, then costs the machinery
DIRECTLY (same method as ``telemetry.measure_trace_overhead`` — the
per-call cost measures in microseconds against a step measured in
milliseconds, so a wall-clock A/B reports scheduler noise, not the
signal):

- sampler: ``tick cost / cadence`` — the sampler thread spends one
  tick per cadence window regardless of step rate;
- ledger: ``observe cost × regions/step / step time`` — the observer
  fires once per annotate region.

Acceptance bar (the reference's): sampler overhead < 1% of step time;
armed jitwatch (:func:`measure_jitwatch_overhead`) < 5% of the step.
"""

from __future__ import annotations

import time


def measure_health_overhead(steps: int = 12, preset: str = "tiny",
                            batch: int = 8, seq: int = 32,
                            cadence_s: float = 0.05,
                            device=None) -> dict:
    """Goodput and overhead of the health plane on ``steps`` world-1
    ``StoreDPTrainer`` steps on ``device`` (``cuda`` unless named)."""
    from ptype_tpu_torch import metrics as metrics_mod
    from ptype_tpu_torch import telemetry
    from ptype_tpu_torch.health import goodput as goodput_mod
    from ptype_tpu_torch.health import series as series_mod
    from ptype_tpu_torch.models import transformer as tfm

    cfg = tfm.preset(preset)
    with telemetry.probe_trainer(preset, device) as (trainer, batches):
        trainer.step(batches(batch, seq))  # warm-up outside the clock
        ledger = goodput_mod.install(
            tokens_per_step=batch * seq,
            flops_per_token=tfm.flops_per_token(cfg, seq),
            n_chips=trainer.n_workers)
        sampler = series_mod.Sampler(cadence_s=cadence_s).start()
        try:
            t_loop0 = time.perf_counter()
            for _ in range(steps):
                trainer.step(batches(batch, seq))
            loop_s = time.perf_counter() - t_loop0
            summary = ledger.summary()
            step_s = max(loop_s / steps, 1e-9)

            # Direct sampler tick cost over the live registry.
            n_ticks = 200
            t0 = time.perf_counter()
            for _ in range(n_ticks):
                sampler.sample_once()
            tick_s = (time.perf_counter() - t0) / n_ticks

            # Direct observer cost (a throwaway ledger so the probe
            # does not pollute the measured records).
            probe = goodput_mod.GoodputLedger(
                registry=metrics_mod.MetricsRegistry())
            n_obs = 20_000
            t0 = time.perf_counter()
            for _ in range(n_obs):
                probe.observe("store.push_tree/probe", 0.0)
            obs_s = (time.perf_counter() - t0) / n_obs
        finally:
            sampler.close()
            goodput_mod.uninstall()

    regions_per_step = 3.0  # train.step + train.data + store.push_tree
    return {
        "goodput_pct": summary["goodput_pct"],
        "step_breakdown": summary["step_breakdown"],
        "tokens_per_sec": summary.get("tokens_per_sec"),
        "mfu": summary.get("mfu"),
        "steps": steps,
        "step_ms": round(step_s * 1e3, 2),
        "sampler_tick_us": round(tick_s * 1e6, 2),
        "sampler_cadence_s": cadence_s,
        "sampler_overhead_pct": round(100.0 * tick_s / cadence_s, 4),
        "ledger_observe_us": round(obs_s * 1e6, 3),
        "ledger_overhead_pct": round(
            100.0 * obs_s * regions_per_step / step_s, 5),
    }


def _lockcheck_probe_pass(ticks: int, families: int) -> float:
    """One pass of the lock-heavy control-plane probe: a fresh
    registry + sampler + series store. Every lock inside them —
    registry walk, histogram rings, series rings, store map, sampler
    tick — is created through the lockcheck seam at construction
    (metrics.py / health/series.py route ALL of them), so the
    armed/disarmed variants differ exactly by the wrapper under
    test. Returns wall seconds for the sample ticks alone (the
    mutation load between ticks is the workload, not the machinery)."""
    from ptype_tpu_torch import metrics as metrics_mod
    from ptype_tpu_torch.health import series as series_mod

    reg = metrics_mod.MetricsRegistry()
    counters = [reg.counter(f"probe.c{i}") for i in range(families)]
    gauges = [reg.gauge(f"probe.g{i}") for i in range(families)]
    sampler = series_mod.Sampler(reg, store=series_mod.SeriesStore(),
                                 memory=False)
    spent = 0.0
    for t in range(ticks):
        for i, c in enumerate(counters):
            c.add(1)
            gauges[i].set(float(t + i))
        t0 = time.perf_counter()
        sampler.sample_once(now=float(t), now_mono=float(t))
        spent += time.perf_counter() - t0
    return spent


def measure_lockcheck_overhead(ticks: int = 1500,
                               families: int = 16,
                               repeats: int = 4,
                               cadence_s: float = 0.05) -> dict:
    """``lockcheck_overhead_pct`` (the reference's bar: <1% with the
    watchdog disarmed, <5% armed).

    Same method as ``sampler_overhead_pct`` above: cost the machinery
    DIRECTLY and charge it against its operating point. The armed
    wrapper's cost lands once per LOCK ACQUIRE, and the health
    plane's acquire rate is one sampler tick's worth per cadence
    window — so the armed overhead is (armed tick − disarmed tick) /
    cadence. A raw wall A/B of a lock-only microloop would report
    the wrapper at ~100% duty cycle, a workload no armed tier runs.
    Best-of-``repeats`` per side so one scheduler hiccup can't fake
    a regression; ``lockcheck_wrap_us_per_acquire`` carries the raw
    per-acquire price for the microloop reader. Disarmed cost: the
    seam's factory returns a PLAIN ``threading.Lock`` when disarmed
    (zero per-acquire residue by construction — the only seam cost
    is one factory call per lock CREATED); the spin A/B demonstrates
    that empirically — a nonzero reading bounds scheduler noise, not
    wrapper cost.
    """
    import threading

    from ptype_tpu_torch import lockcheck

    was = lockcheck.active()
    lockcheck.disable()
    try:
        _lockcheck_probe_pass(ticks // 4, families)  # warm the path
        t_off = min(_lockcheck_probe_pass(ticks, families)
                    for _ in range(repeats))
        # Disarmed residue at the primitive: seam-made vs direct lock.
        n = 400_000
        seam_lock = lockcheck.lock("bench.probe")
        raw_lock = threading.Lock()

        def spin(lk):
            t0 = time.perf_counter()
            for _ in range(n):
                with lk:
                    pass
            return time.perf_counter() - t0

        spin(raw_lock)   # warm BOTH: the first pass over either
        spin(seam_lock)  # object pays cache/allocator noise
        t_raw = min(spin(raw_lock) for _ in range(repeats + 2))
        t_seam = min(spin(seam_lock) for _ in range(repeats + 2))
        disabled_pct = 100.0 * (t_seam - t_raw) / max(t_raw, 1e-9)

        lockcheck.enable()
        _lockcheck_probe_pass(ticks // 4, families)
        t_on = min(_lockcheck_probe_pass(ticks, families)
                   for _ in range(repeats))
        wd = lockcheck.active()
        report = wd.report() if wd is not None else {}
    finally:
        lockcheck.disable()
        if was is not None:
            # Hand back the caller's armed watchdog (graph intact).
            lockcheck._watchdog = was
    tick_off = t_off / ticks
    tick_on = t_on / ticks
    # Acquires per armed tick, from the watchdog's own tally over
    # the armed passes (warm + repeats).
    armed_ticks = (ticks // 4) + repeats * ticks
    per_tick = report.get("acquires", 0) / max(1, armed_ticks)
    wrap_us = (1e6 * (tick_on - tick_off) / per_tick
               if per_tick else 0.0)
    return {
        "lockcheck_overhead_pct": round(
            100.0 * max(0.0, tick_on - tick_off) / cadence_s, 3),
        "lockcheck_disabled_overhead_pct": round(max(disabled_pct,
                                                     0.0), 3),
        "lockcheck_cadence_s": cadence_s,
        "lockcheck_tick_us": round(tick_off * 1e6, 2),
        "lockcheck_tick_armed_us": round(tick_on * 1e6, 2),
        "lockcheck_acquires_per_tick": round(per_tick, 1),
        "lockcheck_wrap_us_per_acquire": round(max(wrap_us, 0.0), 3),
        "lockcheck_cycles": len(report.get("cycles", [])),
    }


def measure_jitwatch_overhead(iters: int = 1500, repeats: int = 5,
                              device=None) -> dict:
    """Backs ``jitwatch_overhead_pct`` (the reference's bar: armed < 5%
    of the step), on ``device`` (``cuda`` unless named).

    The armed watchdog costs per STEP, not per compile: the compile
    hook fires only on a kernel-cache miss (none in steady state), so
    the recurring price is ONE hot-region entry around each dispatch.
    The reference's method: price the region directly (a bare-dispatch
    A/B microloop), then charge it against the step it wraps — an
    engine-shaped step with its one host read, measured in the same
    process. A wall A/B of the bare microloop would report the guard at
    100% duty cycle, a workload no armed engine runs. Best of
    ``repeats`` a side; ``jitwatch_region_us`` is the raw price of one
    region, and the probe books its own steady-state recompiles. An
    armed watchdog is re-armed on exit (fresh books, its storm
    threshold and level)."""
    import torch

    from ptype_tpu_torch import jitwatch
    from ptype_tpu_torch.device import resolve_device

    dev = resolve_device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # The region-cost microloop: bare async dispatch against dispatch
    # under the guard — the difference is the armed price of a step.
    x = torch.ones(256, device=dev)

    def f(v):
        return v * 2.0 + 1.0

    # The engine-shaped step the guard wraps: a forward-sized program
    # with the one host read a step the engine pays.
    w = torch.full((256, 256), 0.01, device=dev)
    sx = torch.ones((64, 256), device=dev)

    def step():
        return (torch.tanh(sx @ w) @ w).cpu()

    f(x)
    step()
    sync()

    def drive(armed: bool) -> float:
        t0 = time.perf_counter()
        if armed:
            for _ in range(iters):
                with jitwatch.hot_region("bench.step", dev):
                    f(x)
        else:
            for _ in range(iters):
                f(x)
        sync()
        return time.perf_counter() - t0

    def drive_step(n: int = 60) -> float:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        return (time.perf_counter() - t0) / n

    was = jitwatch.active()
    jitwatch.disable()
    try:
        drive(False)  # warm the loop path
        t_off = min(drive(False) for _ in range(repeats))
        step_s = min(drive_step() for _ in range(3))
        jw = jitwatch.enable()
        jw.mark_steady()
        drive(True)
        t_on = min(drive(True) for _ in range(repeats))
        steady = jw.recompiles_since_steady()
    finally:
        jitwatch.disable()
        if was is not None:
            jitwatch.enable(was.storm_threshold, was.transfer_level)
    region_s = max(0.0, (t_on - t_off) / iters)
    return {
        "jitwatch_overhead_pct": round(
            100.0 * region_s / max(step_s, 1e-12), 3),
        "jitwatch_region_us": round(region_s * 1e6, 3),
        "jitwatch_dispatch_us": round(t_off / iters * 1e6, 2),
        "jitwatch_step_ms": round(step_s * 1e3, 3),
        "jitwatch_steady_recompiles": sum(steady.values()),
        "device": str(dev),
    }
