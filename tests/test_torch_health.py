"""The port's health plane against the JAX reference's, on the CPU —
the cases of ``tests/test_health.py`` with each reference function and
its port fed the same registry contents, spans and injected clock:
series rings and the sampler, the goodput ledger (the annotate seam,
between-step checkpoints, the ``Trainer.step`` seam repair), straggler
detection, every alert rule over synthetic snapshots (all of
``default_rules`` with both SLOs armed), the alert engine's cooldown,
counters and flight-recorder dumps, the ``obs`` renders, the straggler
drill over port ``ActorServer``s on ``device="cpu"`` (a chaos-delayed
``store.push`` on one of three simulated workers is named, the clean
run raises nothing), and the cases that waited for this plane in
``tests/test_reconciler.py`` (those of ``tests/test_loadgen.py`` are in
``test_torch_loadgen.py``).

Exact equality is the tolerance throughout: the host modules are
copies, and every stamp comes from the injected clock or the
snapshot."""

import json
import math
import os
import tempfile
import time
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest
import torch

from ptype_tpu import metrics as jmetrics
from ptype_tpu import trace as jtrace
from ptype_tpu.health import goodput as jgoodput
from ptype_tpu.health import rules as jrules
from ptype_tpu.health import series as jseries
from ptype_tpu.health import top as jtop
from ptype_tpu_torch import chaos, metrics, trace
from ptype_tpu_torch.health import goodput, rules, series, top

REF = SimpleNamespace(name="ref", metrics=jmetrics, series=jseries,
                      goodput=jgoodput, rules=jrules, top=jtop,
                      trace=jtrace)
PORT = SimpleNamespace(name="port", metrics=metrics, series=series,
                       goodput=goodput, rules=rules, top=top, trace=trace)


def both(fn):
    """``fn(pkg)`` for the reference and the port; equal, returned."""
    want, got = fn(REF), fn(PORT)
    assert got == want
    return got


@pytest.fixture(autouse=True)
def _disarm_port_health():
    """The port twin of conftest's ``_disarm_health``: no ledger,
    sampler or chaos plan leaks into a later test."""
    yield
    metrics.set_annotate_observer(None)
    series.stop()
    goodput.uninstall()
    chaos.disarm()


class Clock:
    """One injected clock for both packages: ``time.perf_counter``,
    ``time.monotonic`` and ``time.time`` read it, the test moves it."""

    def __init__(self, t=100.0):
        self.t = t

    def __enter__(self):
        self._p = [mock.patch("time.perf_counter", lambda: self.t),
                   mock.patch("time.monotonic", lambda: self.t),
                   mock.patch("time.time", lambda: 1.7e9 + self.t)]
        for p in self._p:
            p.start()
        return self

    def __exit__(self, *exc):
        for p in self._p:
            p.stop()


def _alerts(found):
    return [a.to_dict() for a in found]


def _snap(nodes: dict, ts: float = 1000.0) -> dict:
    return {"ts": ts, "nodes": nodes, "errors": {}}


# ------------------------------------------------------------- series


def test_series_ring_bounded_and_monotonic():
    def run(pkg):
        r = pkg.series.SeriesRing("s", capacity=4)
        for i in range(6):
            r.append(float(i), i * 10.0)
        first = r.points()
        r.append(1.0, 99.0)  # a wall-clock step back clamps
        return first, r.points(), r.last(), len(r)

    first, pts, last, n = both(run)
    assert len(first) == 4 and first[0] == (2.0, 20.0)
    assert pts[-1] == (5.0, 99.0) and last == (5.0, 99.0) and n == 4


def test_sampler_change_driven_and_counter_rate():
    def run(pkg):
        reg = pkg.metrics.MetricsRegistry()
        reg.counter("c").add(3)
        reg.gauge("g").set(7.0)
        reg.timing("t").observe(0.05)
        reg.histogram("h").observe(12.0)
        s = pkg.series.Sampler(registry=reg, cadence_s=0.05, memory=False)
        counts = [s.sample_once(now=100.0, now_mono=10.0),
                  s.sample_once(now=101.0, now_mono=11.0)]
        reg.counter("c").add(5)
        counts.append(s.sample_once(now=102.0, now_mono=12.0))
        counts.append(s.sample_once(now=103.0, now_mono=13.0))
        for i in range(70):  # flat samples age the busy window out
            s.sample_once(now=104.0 + i, now_mono=14.0 + i)
        counts.append(s.sample_once(now=200.0, now_mono=110.0))
        return counts, s.store.snapshot(), s.ticks

    counts, snap, ticks = both(run)
    assert counts[0] > 0 and counts[1] == 0 and counts[2] == 2
    assert counts[3] == 1 and counts[-1] == 0 and ticks == 75
    assert snap["c"] == [[100.0, 3.0], [102.0, 8.0]]
    assert snap["c.rate"][-1][1] == 0.0
    assert snap["h.p99"] == [[100.0, 12.0]]


def test_sampler_walk_cache_follows_registry_growth():
    def run(pkg):
        reg = pkg.metrics.MetricsRegistry()
        reg.counter("a").add(1)
        s = pkg.series.Sampler(registry=reg, cadence_s=0.05, memory=False)
        s.sample_once(now=1.0, now_mono=1.0)
        reg.gauge("late").set(4.0)
        s.sample_once(now=2.0, now_mono=2.0)
        return s.store.snapshot(), s.store.names()

    snap, names = both(run)
    assert snap["late"] == [[2.0, 4.0]] and "late" in names


def test_memory_gauges_on_the_cpu_are_absent_not_zero():
    """The reference's watermarks carry the host RSS on every backend;
    the port's are the CUDA allocator's only (``{}`` on the CPU, pinned
    in test_torch_serving_obs.py), so a CPU sampler stamps no ``mem.*``
    point rather than a zero the memory-growth rule would read."""
    reg = metrics.MetricsRegistry()
    s = series.Sampler(registry=reg, cadence_s=0.05)
    assert s.sample_once(now=1.0, now_mono=1.0) == 0
    assert not [n for n in s.store.names() if n.startswith("mem.")]


def test_telemetry_includes_series_when_sampler_armed():
    t = trace.telemetry()
    assert t["series"] == {}
    assert set(t) == set(jtrace.telemetry())
    sampler = series.start(cadence_s=0.05)
    try:
        assert series.start() is sampler and series.default() is sampler
        metrics.metrics.gauge("health.test.g").set(1.0)
        sampler.sample_once()
        assert trace.telemetry()["series"]["health.test.g"]
        assert series.default_snapshot()["health.test.g"]
    finally:
        series.stop()
    assert series.default() is None and series.default_snapshot() == {}


def test_telemetry_endpoint_matches_the_reference():
    def run(pkg):
        reg = pkg.metrics.MetricsRegistry()
        reg.counter("x").add(2)
        store = pkg.series.SeriesStore()
        store.series("x").append(5.0, 2.0)
        with Clock():
            out = pkg.series.telemetry_endpoint(reg, store, "w0")(16)
        out.pop("pid")
        return out

    out = both(run)
    assert out["service"] == "w0" and out["series"] == {"x": [[5.0, 2.0]]}


def test_sampler_thread_runs_and_closes():
    reg = metrics.MetricsRegistry()
    s = series.Sampler(registry=reg, cadence_s=0.01, memory=False).start()
    try:
        reg.gauge("g").set(1.0)
        deadline = time.monotonic() + 10
        while "g" not in s.store.names() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert s.store.snapshot()["g"]
        assert s.last_tick_s >= 0.0 and s.ticks >= 1
    finally:
        s.close()
    assert s._thread is None


def test_metrics_writer_merges_registry_snapshot(tmp_path):
    def run(pkg):
        reg = pkg.metrics.MetricsRegistry()
        reg.counter("req").add(4)
        reg.gauge("depth").set(2.0)
        reg.timing("step").observe(0.125)
        path = tmp_path / f"{pkg.name}.jsonl"
        w = pkg.metrics.MetricsWriter(str(path))
        with Clock():
            w.emit(7, snapshot=reg, loss=1.5, req=99)
        w.close()
        return json.loads(path.read_text())

    rec = both(run)
    assert rec["req"] == 99 and rec["depth"] == 2.0


# ------------------------------------------------------------ goodput


def _ledger_script(pkg, **kw):
    reg = pkg.metrics.MetricsRegistry()
    led = pkg.goodput.GoodputLedger(registry=reg, tokens_per_step=1000,
                                    **kw)
    with Clock() as clock:
        end = 50.0
        for _ in range(3):
            led.observe("train.data", 0.01, end=end + 0.01)
            led.observe("store.push_tree/grads", 0.03, end=end + 0.05)
            led.observe("train.opt/zero", 0.004, end=end + 0.06)
            led.observe("serve.prefill", 0.002, end=end + 0.07)
            led.observe("checkpoint.save/1", 0.005, end=end + 0.08)
            led.observe("unrelated.region", 9.0, end=end + 0.09)
            end += 0.125  # 100 ms step + 25 ms inter-step stall
            clock.t += 1.0
            led.observe("train.step", 0.1, end=end)
    return led.records(), led.summary(), led.summary(limit=1), \
        reg.snapshot()


def test_goodput_ledger_breakdown_and_publish():
    recs, summary, last, snap = both(
        lambda pkg: _ledger_script(pkg, flops_per_token=1e6,
                                   peak_tflops=100.0))
    rec = recs[-1]
    assert rec["collective_ms"] == pytest.approx(30.0)
    assert rec["compute_ms"] == pytest.approx(59.0)  # data ran before it
    assert rec["tokens_per_sec"] == pytest.approx(8000.0)
    assert rec["mfu"] > 0
    assert snap["gauges"]["goodput.pct"] == rec["goodput_pct"]
    assert snap["counters"]["goodput.steps"] == 3
    assert summary["steps"] == 3 and "mfu" in summary


def test_goodput_ledger_publishes_no_mfu_without_a_peak():
    """On a device the port's peak table does not name (the CPU), the
    port's MFU is None, and the ledger then publishes no ``mfu`` at
    all — never a 0 or another chip's rate. Everything else equals the
    reference's records."""
    recs, summary, _, snap = _ledger_script(PORT, flops_per_token=1e6)
    assert all("mfu" not in r and "mfu_compiled" not in r for r in recs)
    assert "goodput.mfu" not in snap["gauges"] and "mfu" not in summary
    led = goodput.GoodputLedger(registry=metrics.MetricsRegistry(),
                                tokens_per_step=1000, flops_per_token=1e6)
    led.set_compiled_flops(5e9)
    led.observe("train.step", 0.1, end=1.0)
    assert not {"mfu", "mfu_compiled", "mfu_gap_pct"} & set(
        led.records()[-1])
    ref, _, _, _ = _ledger_script(REF, flops_per_token=1e6)
    strip = [{k: v for k, v in r.items() if k != "mfu"} for r in ref]
    assert recs == strip


def test_goodput_compiled_flops_and_gap_match_the_reference():
    def run(pkg):
        reg = pkg.metrics.MetricsRegistry()
        led = pkg.goodput.GoodputLedger(
            registry=reg, tokens_per_step=8 * 32, flops_per_token=7e5,
            peak_tflops=50.0).set_compiled_flops(2.0e8)
        with Clock():
            end = 10.0
            for _ in range(2):
                end += 0.1
                led.observe("train.step", 0.1, end=end)
        return led.records(), led.summary(), reg.snapshot()["gauges"]

    recs, summary, gauges = both(run)
    assert recs[-1]["mfu_gap_pct"] == gauges["goodput.mfu_gap_pct"]
    assert "mfu_compiled" in summary


def test_goodput_ledger_rides_the_annotate_seam():
    led = goodput.install(registry=metrics.MetricsRegistry())
    try:
        assert goodput.default() is led
        with metrics.annotate("store.push_tree/x"):
            pass
        with metrics.annotate("train.step"):
            pass
        assert led.records() and led.records()[-1]["step"] == 1
    finally:
        goodput.uninstall()
    with metrics.annotate("train.step"):
        pass
    assert len(led.records()) == 1 and goodput.default() is None


def test_goodput_ledger_attributes_between_step_checkpoint():
    def run(pkg):
        led = pkg.goodput.GoodputLedger(
            registry=pkg.metrics.MetricsRegistry())
        with Clock():
            led.observe("train.step", 0.1, end=10.0)
            led.observe("checkpoint.save/5", 0.2, end=10.25)
            led.observe("train.step", 0.1, end=10.4)
        return led.records()

    rec = both(run)[-1]
    assert rec["checkpoint_ms"] == pytest.approx(200.0)
    assert rec["goodput_pct"] == pytest.approx(25.0)


def test_checkpoint_save_feeds_the_ledger_through_the_seam(tmp_path):
    from ptype_tpu_torch.checkpoint import Checkpointer

    led = goodput.install(registry=metrics.MetricsRegistry())
    try:
        Checkpointer(str(tmp_path)).save(1, {"w": torch.ones(4)})
        led.observe("train.step", 0.01)
        assert led.records()[-1]["checkpoint_ms"] > 0.0
    finally:
        goodput.uninstall()


def test_trainer_step_opens_the_health_seam():
    """``Trainer.step`` runs as a ``train.step`` region (one ledger
    record a step), under a ``train#<n>`` profiler range, counts
    ``train.steps`` and stamps ``train.loss`` at its drains — as the
    reference's does. Before, a ledger or ``StallRule`` saw no step of
    the plain trainer."""
    from ptype_tpu_torch.models import transformer as ttfm
    from ptype_tpu_torch.train import Trainer

    cfg = ttfm.preset("tiny", dtype=torch.float32)
    tr = Trainer(cfg, device="cpu", sync_every=2)
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (2, 17), generator=gen)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    steps0 = metrics.metrics.counter("train.steps").value
    led = goodput.install(registry=metrics.MetricsRegistry(),
                          tokens_per_step=32)
    seen = []
    try:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(4):
                out = tr.step(batch)
                seen.append(float(out["loss"]))
    finally:
        goodput.uninstall()
    assert len(led.records()) == 4
    assert all(r["tokens_per_sec"] > 0 for r in led.records())
    assert metrics.metrics.counter("train.steps").value == steps0 + 4
    assert metrics.metrics.gauge("train.loss").value == seen[-1]
    names = {e.key for e in prof.key_averages()}
    assert {"train.step", "train#0", "train#3"} <= names


def test_cluster_view_dedups_aliases_for_every_rule():
    telem = {"pid": 42, "service": "",
             "series": {"train.loss": [[1.0, 2.5],
                                       [2.0, float("nan")]]}}
    snap = _snap({"work/h:1": telem, "infer/h:1": dict(telem)})
    found = both(lambda pkg: _alerts(pkg.rules.LossRule().evaluate(
        pkg.rules.ClusterView(snap))))
    assert len(found) == 1


def test_node_series_means_dedups_process_aliases():
    telem = {"pid": 42, "service": "", "series": {"m": [[1.0, 5.0]]}}
    snap = {"nodes": {"a/x:1": telem, "b/x:1": dict(telem)}}
    snap2 = {"nodes": {
        "a": {"pid": 42, "service": "w0", "series": {"m": [[1.0, 5.0]]}},
        "b": {"pid": 42, "service": "w1", "series": {"m": [[1.0, 7.0]]}}}}
    spans = {"nodes": {f"w{i}": {"spans": [
        {"name": "store.push_tree/g", "start_s": 9.0, "dur_s": d}]}
        for i, d in enumerate((0.01, 0.02))}}
    got = both(lambda pkg: (
        pkg.goodput.node_series_means(snap, "m"),
        pkg.goodput.node_series_means(snap2, "m"),
        pkg.goodput.node_series_means(snap2, "m", window_s=1.0, now=99.0),
        pkg.goodput.node_span_means(spans, "store.push", 5.0, 10.0)))
    assert got[0] == {"a/x:1": 5.0} and len(got[1]) == 2 and got[2] == {}


@pytest.mark.parametrize("values,kw", [
    ({"a": 10.0, "b": 11.0, "c": 9.5, "d": 300.0}, {"min_excess": 50.0}),
    ({"a": 10.0, "b": 11.0, "c": 9.5, "d": 14.0}, {"min_excess": 50.0}),
    ({"a": 1.0, "b": 99.0}, {"min_excess": 0.0}),
    ({f"n{i}": float(v) for i, v in enumerate(
        np.random.default_rng(5).lognormal(3.0, 0.6, 12))}, {"k": 2.0}),
])
def test_detect_stragglers_median_mad_with_floors(values, kw):
    both(lambda pkg: pkg.goodput.detect_stragglers(values, **kw))


# ---------------------------------------------------- rules (unit tier)


def test_counter_delta_window_and_reset():
    pts = [[0.0, 10.0], [10.0, 20.0], [20.0, 50.0]]
    got = both(lambda pkg: [
        pkg.rules.counter_delta(pts, 15.0, 20.0),
        pkg.rules.counter_delta(pts, 100.0, 20.0),
        pkg.rules.counter_delta([[0.0, 100.0], [10.0, 5.0]], 100.0, 10.0),
        pkg.rules.counter_delta([], 10.0, 0.0)])
    assert got == [40.0, 40.0, 0.0, 0.0]


GIB = 1024 ** 3


def _rule_snapshots():
    """Synthetic snapshots that fire (and spare) every rule of
    ``default_rules`` with both SLOs armed, one family at a time, plus
    one healthy node throughout."""
    calm = {"pid": 1, "service": "calm", "series": {
        "goodput.steps": [[998.0, 50.0]],
        "goodput.step_ms": [[998.0, 100.0]],
        "train.loss": [[996.0, 2.0], [997.0, 2.0], [998.0, 2.1]]}}
    fire = {
        "gw": {"series": {
            "gateway.llm.requests": [[940.0, 0.0], [1000.0, 100.0]],
            "gateway.llm.shed": [[940.0, 0.0], [1000.0, 20.0]],
            "gateway.llm.latency_ms.p99": [[999.0, 350.0]],
            "gateway.llm.stage_ms.queue-wait.p99": [[999.0, 1900.0]],
            "gateway.llm.stage_ms.queue-wait.count": [[999.0, 30.0]],
            "gateway.llm.stage_ms.route.p99": [[999.0, 900.0]],
            "gateway.llm.stage_ms.route.count": [[999.0, 30.0]]}},
        "stall": {"series": {
            "goodput.steps": [[900.0, 5.0], [950.0, 10.0]],
            "goodput.step_ms": [[900.0, 1000.0], [950.0, 1000.0]]}},
        "loss": {"series": {"train.loss": [
            [1.0, 2.0], [2.0, 2.1], [3.0, 1.9], [4.0, 9.0]]}},
        "coord": {"series": {"coord.term": [
            [900.0, 1.0], [940.0, 2.0], [980.0, 3.0]]}},
        "mem": {"series": {"mem.device_bytes_in_use": [
            [500.0, 2 * GIB], [900.0, 4 * GIB]]}},
        "mfu": {"series": {"goodput.mfu": [[999.0, 0.40]],
                           "goodput.mfu_compiled": [[999.0, 0.55]]}},
        "ttft": {"series": {"serve.ttft_ms.count": [[999.0, 20.0]],
                            "serve.ttft_ms.p99": [[999.0, 2500.0]]}},
        "kv": {"series": {
            "kv.total_blocks": [[900.0, 100.0]],
            "kv.free_blocks": [[950.0, 5.0], [960.0, 4.0],
                               [970.0, 50.0], [980.0, 3.0]],
            "kv.evictions.rate": [[960.0, 2.0]]}},
        "hit": {"series": {"kv.prefix_hit_rate": [
            [900.0, 0.8], [920.0, 0.7], [940.0, 0.5], [990.0, 0.05]]}},
        "serve": {"series": {
            "serve.steps": [[900.0, 50.0]],
            "serve.step_ms": [[900.0, 20.0]],
            "serve.queue_depth": [[990.0, 3.0]]}},
        "jit": {"series": {"jit.recompiles": [[950.0, 1.0],
                                              [990.0, 6.0]],
                           "jit.fn.step": [[990.0, 5.0]]},
                "metrics": {"gauges": {"jit.fn.other": 2.0}}},
        "mig": {"series": {"serve.migrate_inflight": [[950.0, 2.0],
                                                      [990.0, 1.0]],
                           "serve.migrations": [[900.0, 4.0]]}},
        "reshard": {"series": {"train.reshard_inflight": [
            [950.0, 1.0], [990.0, 1.0]]}},
        "cap": {"series": {"loadgen.knee_rps": [[900.0, 10.0]],
                           "loadgen.offered": [[975.0, 0.0],
                                               [1000.0, 400.0]]}},
        "strag": {"series": {"goodput.step_ms": [[999.0, 400.0]]}},
    }
    for i, ms in enumerate((10.0, 12.0, 11.0)):
        fire[f"w{i}"] = {"series": {"goodput.step_ms": [[999.0, ms]]}}
    spans = {f"s{i}": {"spans": [{"name": "store.push_tree/grads",
                                  "start_s": 999.0, "dur_s": d}]}
             for i, d in enumerate((0.01, 0.012, 0.011, 0.4))}
    return {"fire": _snap({**fire, "calm": calm}),
            "calm": _snap({"calm": calm}),
            "spans": _snap(spans),
            "empty": _snap({}),
            "late": _snap({**fire, "calm": calm}, ts=5000.0)}


RULE_SNAPS = _rule_snapshots()
RULE_NAMES = [r.name for r in jrules.default_rules(
    slo_p99_ms=200.0, slo_ttft_ms=2000.0)] + ["straggler-spans"]


@pytest.mark.parametrize("snap", sorted(RULE_SNAPS))
@pytest.mark.parametrize("rule", RULE_NAMES)
def test_every_rule_fires_as_the_reference_does(rule, snap):
    def run(pkg):
        if rule == "straggler-spans":
            chosen = [pkg.rules.StragglerRule(min_excess_ms=50.0)]
        else:
            chosen = [r for r in pkg.rules.default_rules(
                slo_p99_ms=200.0, slo_ttft_ms=2000.0) if r.name == rule]
        view = pkg.rules.ClusterView(RULE_SNAPS[snap])
        return [_alerts(r.evaluate(view)) for r in chosen]

    got = both(run)
    if snap == "fire" and rule != "straggler-spans":
        assert got[0], rule  # every rule has a firing case here
    if snap in ("calm", "empty"):
        assert got == [[]] * len(got)


def test_default_rules_and_engine_over_every_firing():
    def run(pkg):
        reg = pkg.metrics.MetricsRegistry()
        engine = pkg.rules.AlertEngine(
            pkg.rules.default_rules(slo_p99_ms=200.0, slo_ttft_ms=2000.0),
            cooldown_s=30.0, registry=reg, dump=False)
        first = _alerts(engine.evaluate(RULE_SNAPS["fire"]))
        again = _alerts(engine.evaluate(RULE_SNAPS["fire"], now=1002.0))
        later = _alerts(engine.evaluate(RULE_SNAPS["fire"], now=1040.0))
        return ([r.name for r in engine.rules], first, again, later,
                _alerts(engine.recent(100)), reg.snapshot()["counters"])

    names, first, again, later, recent, counters = both(run)
    # 40 s on, past the cooldown, what still holds re-fires (and the
    # healthy node's steps have stalled by then).
    assert again == [] and later and len(first) > 10
    assert counters["health.alerts"] == len(first) + len(later)
    assert {a["rule"] for a in first} >= {
        "slo-burn-rate", "train-stall", "straggler", "recompile-storm",
        "capacity-headroom", "slo-stage-breach", "migration-stall"}


def test_recompile_storm_rule_stays_quiet_on_a_port_snapshot():
    """A DISARMED port node publishes no ``jit.*`` (jitwatch's seams
    book nothing until it is armed): the rule stays quiet on what such
    a node publishes, and ``obs jit`` calls it disarmed."""
    reg = metrics.MetricsRegistry()
    reg.counter("train.steps").add(3)
    reg.gauge("goodput.step_ms").set(100.0)
    s = series.Sampler(registry=reg, cadence_s=0.05, memory=False)
    s.sample_once(now=990.0, now_mono=1.0)
    snap = _snap({"w": series.telemetry_endpoint(reg, s.store, "w")()})
    assert not [n for n in snap["nodes"]["w"]["series"]
                if n.startswith("jit.")]
    assert rules.RecompileStormRule().evaluate(
        rules.ClusterView(snap)) == []
    assert "no node exports jit.*" in top.render_jit(snap)


def test_alert_engine_survives_a_broken_rule():
    class Broken(rules.StragglerRule):
        def evaluate(self, view):
            raise RuntimeError("boom")

    engine = rules.AlertEngine(
        [Broken(), rules.StragglerRule(min_excess_ms=50.0)],
        registry=metrics.MetricsRegistry(), dump=False)
    found = engine.evaluate(RULE_SNAPS["fire"])
    assert [a.node for a in found] == ["stall", "strag"]


def test_alert_fires_flight_recorder_dump(tmp_path):
    rec = trace.enable("health-dump", dump_dir=str(tmp_path))
    try:
        with trace.span("ctx"):
            pass
        del rec
        engine = rules.AlertEngine(
            [rules.StragglerRule(min_excess_ms=50.0)],
            registry=metrics.MetricsRegistry())
        assert engine.evaluate(RULE_SNAPS["fire"])
        assert any(f.startswith("flight-") for f in os.listdir(tmp_path))
    finally:
        trace.disable()


def test_alert_engine_capture_hook_gets_every_kept_alert():
    """``AlertEngine(capture=...)`` — how the reconciler's
    ``observe_alert`` and ``AlertCapture`` attach; a raising hook is
    logged, never raised."""
    seen = []

    def hook(alert):
        seen.append((alert.rule, alert.node))
        raise RuntimeError("a broken hook")

    engine = rules.AlertEngine([rules.StragglerRule(min_excess_ms=50.0)],
                               registry=metrics.MetricsRegistry(),
                               dump=False, capture=hook)
    assert engine.evaluate(RULE_SNAPS["fire"])
    assert seen == [("straggler", "stall"), ("straggler", "strag")]


# --------------------------------------------------------------- renders


def _rich_snapshot():
    """One snapshot with every family the ``obs`` views read."""
    gauges = {"goodput.pct": 81.5, "goodput.step_ms": 102.4,
              "goodput.collective_ms": 12.0, "goodput.optimizer_ms": 3.5,
              "goodput.stall_ms": 1.25, "goodput.tokens_per_sec": 4096.0,
              "goodput.mfu": 0.123, "mem.device_bytes_in_use": 3 * GIB,
              "train.loss": 2.3456}
    serve = {"serve.step_ms": 14.0, "serve.queue_depth": 2.0,
             "serve.active_slots": 6.0, "kv.free_blocks": 40.0,
             "kv.util_pct": 61.5, "kv.prefix_hit_rate": 0.875,
             "serve.spec_accept_rate": 0.5, "serve.stall_ms": 3.0,
             "serve.lifecycle": 2.0, "serve.class": 2.0,
             "serve.domain": 1.0, "serve.kv_free_blocks": 40.0}
    hists = {"serve.ttft_ms": {"count": 9, "p50": 30.0, "p95": 80.0,
                               "p99": 91.0},
             "serve.tpot_ms": {"count": 9, "p50": 13.5, "p95": 20.0,
                               "p99": 22.0},
             "serve.e2e_ms": {"count": 9, "p50": 900.0, "p95": 1400.0,
                              "p99": 1500.0},
             "loadgen.ttft_ms": {"count": 20, "p50": 5.0, "p95": 9.0,
                                 "p99": 12.0}}
    counters = {"kv.evictions": 3.0, "serve.migrations": 4.0,
                "serve.migrate_bytes": 2.5e6,
                "serve.migrate_dedup_hits": 7.0,
                "gateway.llm.requests": 20.0, "gateway.llm.answered": 18.0,
                "gateway.llm.shed": 2.0,
                "gateway.llm.slo_good_requests": 15.0,
                "gateway.llm.slo_violations": 3.0,
                "loadgen.offered": 40.0, "loadgen.slo_good": 30.0,
                "loadgen.slo_bad": 2.0, "loadgen.shed": 1.0,
                "collectives.hier_launches": 4.0,
                "collectives.leg_bytes.inner": 1e6,
                "collectives.leg_bytes.outer": 2e5,
                "collectives.leg_bytes.flat_outer": 8e5,
                "serve.migrate.local_domain": 3.0,
                "serve.migrate.cross_domain": 1.0,
                "scale.decisions": 5.0, "scale.spawns": 2.0,
                "jit.compiles": 12.0, "jit.recompiles": 6.0}
    scale = {"scale.desired": 3.0, "scale.actual": 2.0, "scale.warm": 1.0,
             "scale.draining": 0.0, "scale.pending_spawns": 1.0,
             "loadgen.offered_rps": 8.0, "loadgen.knee_rps": 32.0,
             "loadgen.inflight": 2.0, "jit.fn.step": 6.0}
    node = {"pid": 7, "service": "llm",
            "metrics": {"gauges": {**gauges, **serve, **scale},
                        "counters": counters, "histograms": hists},
            "series": {"loadgen.offered.rate": [[999.0, 7.5]],
                       "loadgen.answered.rate": [[999.0, 7.0]]}}
    return {"ts": 1000.0, "nodes": {"llm/10.0.0.1:7000": node,
                                    "bare/10.0.0.2:1": {"pid": 8}},
            "errors": {"dead/10.0.0.3:9": "ConnectionRefusedError: x"}}


RENDERS = ["render_top", "render_serve", "render_scale", "render_traffic",
           "render_topo", "render_jit"]


@pytest.mark.parametrize("with_alerts", [False, True])
@pytest.mark.parametrize("name", RENDERS)
def test_obs_renders_match_the_reference(name, with_alerts):
    snap = _rich_snapshot()

    def run(pkg):
        alerts = []
        if with_alerts:
            alerts = pkg.rules.AlertEngine(
                pkg.rules.default_rules(slo_p99_ms=200.0,
                                        slo_ttft_ms=2000.0),
                registry=pkg.metrics.MetricsRegistry(), dump=False
            ).evaluate(RULE_SNAPS["fire"])
        return getattr(pkg.top, name)(snap, alerts)

    view = both(run)
    assert "UNREACHABLE" in view
    assert ("ALERTS (" in view) == with_alerts


def test_render_top_handles_empty_and_error_nodes():
    view = both(lambda pkg: pkg.top.render_top(
        {"ts": 1.0, "nodes": {}, "errors": {"x": "dead"}}))
    assert "UNREACHABLE" in view and "no alerts" in view


def test_lifecycle_names_pinned_in_sync():
    """``top``'s inline lifecycle and serving-class names match the
    serving stack's (``tests/test_reconciler.py`` mirror), and the
    reconciler's replica host's inline codes."""
    from ptype_tpu_torch import serve
    from ptype_tpu_torch.reconciler import replica
    from ptype_tpu_torch.serve_engine import SERVE_CLASSES

    assert tuple(top._LIFECYCLE_NAMES) == tuple(serve.LIFECYCLES)
    assert tuple(top._SERVE_CLASS_NAMES) == tuple(SERVE_CLASSES)
    assert replica._LIFECYCLE_CODES == serve.LIFECYCLE_CODES
    assert top._LIFECYCLE_NAMES == jtop._LIFECYCLE_NAMES


def _recsnap(nodes):
    return {"ts": "t", "nodes": nodes, "errors": {}}


def test_render_serve_lifecycle_column():
    node = {"metrics": {"gauges": {"serve.step_ms": 5.0,
                                   "serve.lifecycle": 3.0,
                                   "serve.queue_depth": 1.0},
                        "histograms": {}, "counters": {}}}
    out = both(lambda pkg: pkg.top.render_serve(
        _recsnap({"w1/1:1": node})))
    assert "draining" in out and "state" in out


def test_render_scale_shows_reconciler_and_fleet():
    rec_node = {"metrics": {"gauges": {"scale.desired": 3.0,
                                       "scale.actual": 2.0,
                                       "scale.warm": 1.0,
                                       "scale.draining": 0.0,
                                       "scale.pending_spawns": 1.0},
                            "counters": {"scale.decisions": 4,
                                         "scale.spawns": 3,
                                         "scale.drains": 1,
                                         "scale.drain_escalations": 0,
                                         "scale.deaths": 1,
                                         "scale.spawn_failures": 0},
                            "histograms": {}}}
    rep_node = {"metrics": {"gauges": {"serve.lifecycle": 2.0,
                                       "serve.queue_depth": 0.0},
                            "histograms": {}, "counters": {}}}
    out = both(lambda pkg: pkg.top.render_scale(
        _recsnap({"ctl/1:1": rec_node, "w1/2:2": rep_node})))
    assert "1 reconcilers" in out and "active" in out
    assert " 3 " in out and " 2 " in out


def test_render_scale_empty_fleet_message():
    out = both(lambda pkg: pkg.top.render_scale(_recsnap({})))
    assert "no reconciler" in out


def _fleet(service, **cfg):
    from ptype_tpu_torch.coord.core import CoordState
    from ptype_tpu_torch.coord.local import LocalCoord
    from ptype_tpu_torch.reconciler import (FakeGeneratorActor,
                                            LocalLauncher, Reconciler,
                                            ReconcilerConfig)
    from ptype_tpu_torch.registry import CoordRegistry

    state = CoordState(sweep_interval=0.05)
    registry = CoordRegistry(LocalCoord(state), lease_ttl=2.0)
    mreg = metrics.MetricsRegistry()
    launcher = LocalLauncher(registry, FakeGeneratorActor, service=service)
    rec = Reconciler(registry, service, launcher,
                     cfg=ReconcilerConfig(**cfg), metrics_registry=mreg)
    return state, registry, mreg, launcher, rec


def test_scale_series_reach_obs_scale_through_the_sampler():
    """A real port reconciler's ``scale.*`` counters and gauges go
    through the ``Sampler`` into a telemetry pull's history, and the
    pull renders in ``obs scale`` exactly as the reference renders
    it."""
    state, registry, mreg, launcher, rec = _fleet(
        "llm-top", min_replicas=2, max_replicas=3, warm_pool=1,
        vote_quorum=1)
    sampler = series.Sampler(registry=mreg, cadence_s=0.05, memory=False)
    try:
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            rec.tick()
            if len(registry.nodes("llm-top")) >= 2:
                break
            time.sleep(0.02)
        rec.tick()
        sampler.sample_once()
        node = series.telemetry_endpoint(mreg, sampler.store, "rec")()
        assert node["series"]["scale.desired"][-1][1] >= 2
        assert node["series"]["scale.spawns"][-1][1] >= 2
        assert "scale.spawns.rate" in node["series"]
        replica = {"metrics": {"gauges": {"serve.lifecycle": 2.0,
                                          "serve.queue_depth": 0.0,
                                          "serve.active_slots": 1.0}}}
        snap = {"ts": 1.0, "errors": {},
                "nodes": {"rec/h:1": node, "llm-top/h:2": replica}}
        view = both(lambda pkg: pkg.top.render_scale(snap))
        assert "1 reconcilers, 1 serving replicas" in view
    finally:
        rec.close(stop_fleet=True)
        launcher.close()
        state.close()


def test_alert_engine_capture_is_the_reconcilers_alert_vote():
    """``AlertEngine(capture=rec.observe_alert)``: a kv-pressure page
    becomes one scale-up vote; a rule outside the scale-up set
    becomes none."""
    state, registry, mreg, launcher, rec = _fleet(
        "llm-alert", min_replicas=1, max_replicas=2)
    try:
        engine = rules.AlertEngine(
            [rules.KvPressureRule(), rules.StragglerRule(min_excess_ms=50.0)],
            registry=metrics.MetricsRegistry(), dump=False,
            capture=rec.observe_alert)
        fired = engine.evaluate(RULE_SNAPS["fire"])
        assert sorted(a.rule for a in fired) == [
            "kv-pressure", "straggler", "straggler"]
        assert [v.reason for v in rec._alert_votes] == ["page:kv-pressure"]
    finally:
        rec.close(stop_fleet=True)
        launcher.close()
        state.close()


# ------------------------------------------- end-to-end straggler drill


N_WORKERS = 3
DRILL_STEPS = 8
SLOW_PUSH_S = 0.12


@pytest.fixture(scope="module")
def cpu_mesh():
    """A world-1 gloo process group and its mesh for the simulated
    workers' TensorStores (made here, torn down after the module)."""
    import torch.distributed as dist

    from ptype_tpu_torch.parallel.mesh import build_mesh, init_distributed

    own = None
    if not dist.is_initialized():
        own = tempfile.mkdtemp(prefix="health-pg-")
        init_distributed(f"file://{own}/rdv", 0, 1, device="cpu")
    yield build_mesh({"data": 1}, device="cpu")
    if own is not None:
        dist.destroy_process_group()


class _SimWorker:
    """One simulated worker node of the port: its own registry, goodput
    ledger, sampler, TensorStore on the CPU, and an ``ActorServer``
    whose ``ptype.Telemetry`` serves THAT node's state."""

    def __init__(self, name, mesh, registry):
        from ptype_tpu_torch.actor import ActorServer
        from ptype_tpu_torch.parallel.tensorstore import TensorStore

        self.name = name
        self.reg = metrics.MetricsRegistry()
        self.ledger = goodput.GoodputLedger(registry=self.reg,
                                            tokens_per_step=64 * 64)
        self.sampler = series.Sampler(registry=self.reg, cadence_s=0.02,
                                      memory=False)
        self.store = TensorStore(mesh, device="cpu")
        self.server = ActorServer("127.0.0.1", 0, device="cpu")
        self.server.register_function(
            "ptype.Telemetry",
            series.telemetry_endpoint(self.reg, self.sampler.store, name))
        self.server.serve()
        self.registration = registry.register(
            "work", name, "127.0.0.1", self.server.port)
        self.key = f"work/127.0.0.1:{self.server.port}"
        self._grads = torch.ones((1, 32, 32))

    def step(self, i: int) -> None:
        with self.ledger.region("train.step"):
            with self.ledger.region("train.data"):
                batch = self._grads + i
            with self.ledger.region(f"store.push/{self.name}"):
                self.store.push(f"grads/{self.name}", batch, op="mean")
        self.reg.gauge("train.loss").set(3.0 - 0.05 * i)

    def close(self) -> None:
        self.sampler.close()
        self.registration.close()
        self.server.close()


def run_straggler_drill(seed_fault, mesh):
    from ptype_tpu_torch import telemetry
    from ptype_tpu_torch.chaos import FaultPlan, FaultSpec
    from ptype_tpu_torch.coord.core import CoordState
    from ptype_tpu_torch.coord.local import LocalCoord
    from ptype_tpu_torch.registry import CoordRegistry

    state = CoordState(sweep_interval=0.05)
    registry = CoordRegistry(LocalCoord(state), lease_ttl=5.0)
    workers = [_SimWorker(f"w{i}", mesh, registry)
               for i in range(N_WORKERS)]
    try:
        for w in workers:   # first push outside the clock
            w.step(0)
        for w in workers:
            w.sampler.start()
        if seed_fault:
            chaos.arm(FaultPlan([FaultSpec(
                "store.push", "delay", match="w2",
                times=DRILL_STEPS + 1, delay_s=SLOW_PUSH_S)]))
        for i in range(1, DRILL_STEPS + 1):
            for w in workers:
                w.step(i)
        chaos.disarm()
        for w in workers:   # flush the final values into the series
            w.sampler.sample_once()
        snap = telemetry.cluster_snapshot(registry, include_local=False)
        engine = rules.AlertEngine(rules.default_rules(),
                                   registry=metrics.MetricsRegistry())
        return engine.evaluate(snap), workers[2].key, snap, engine
    finally:
        chaos.disarm()
        for w in workers:
            w.close()
        state.close()


def test_seeded_store_push_straggler_raises_exactly_one_alert(cpu_mesh):
    alerts, slow_key, snap, engine = run_straggler_drill(True, cpu_mesh)
    assert [a.rule for a in alerts] == ["straggler"], alerts
    assert alerts[0].node == slow_key
    telem = snap["nodes"][slow_key]
    coll = telem["metrics"]["gauges"]["goodput.collective_ms"]
    assert coll >= SLOW_PUSH_S * 1000 * 0.9
    assert telem["series"]["goodput.steps"][-1][1] >= DRILL_STEPS
    view = top.render_top(snap, engine.recent())
    assert slow_key in view and "straggler" in view
    # The reference's rules reach the same verdict on the port's pull.
    jalerts = jrules.AlertEngine(jrules.default_rules(),
                                 registry=jmetrics.MetricsRegistry(),
                                 dump=False).evaluate(snap)
    assert _alerts(jalerts) == _alerts(alerts)


def test_clean_identical_run_raises_no_alerts(cpu_mesh):
    alerts, _, snap, _ = run_straggler_drill(False, cpu_mesh)
    assert alerts == [] and len(snap["nodes"]) == N_WORKERS


def test_obs_top_loop_renders(cpu_mesh):
    from ptype_tpu_torch.coord.core import CoordState
    from ptype_tpu_torch.coord.local import LocalCoord
    from ptype_tpu_torch.health import run_top
    from ptype_tpu_torch.registry import CoordRegistry

    state = CoordState(sweep_interval=0.05)
    registry = CoordRegistry(LocalCoord(state), lease_ttl=5.0)
    worker = _SimWorker("w0", cpu_mesh, registry)
    try:
        worker.step(1)
        worker.sampler.sample_once()
        out: list[str] = []
        engine = run_top(registry, iters=1, interval_s=0.0,
                         out=out.append, clear=False)
        assert out and "ptype health @" in out[0]
        assert worker.key in out[0]
        assert isinstance(engine, rules.AlertEngine)
        out.clear()
        top.run_serve(registry, iters=1, out=out.append, clear=False)
        assert "ptype serving @" in out[0]
    finally:
        worker.close()
        state.close()


def test_loss_rule_reads_nan_as_a_page():
    nan = _snap({"w": {"series": {"train.loss": [[1.0, 2.5],
                                                 [2.0, math.nan]]}}})
    got = both(lambda pkg: _alerts(pkg.rules.LossRule().evaluate(
        pkg.rules.ClusterView(nan))))
    assert got[0]["severity"] == "page"
