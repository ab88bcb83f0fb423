"""The port's serving host surface against the JAX reference's, on the
CPU: the ServingLedger (the same lifecycle sequences through both
ledgers under one injected clock give equal records, summaries,
iteration folds, KV gauges and registry snapshots; retire reasons and
idempotence; span trees under a traceparent and none without one), the
metrics registry, chaos plans, the lock-order watchdog, the engine's
``Info()`` keys and ``_retry_after`` against the reference engine's,
its chaos seams, drain and gauges.

Exact equality is the tolerance throughout: the port's host modules are
copies of the reference's, and every stamp comes from the injected
clock."""

import json
import logging
import threading
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptype_tpu import chaos as jchaos
from ptype_tpu import lockcheck as jlockcheck
from ptype_tpu import metrics as jmetrics
from ptype_tpu import trace as jtrace
from ptype_tpu.health import serving as jserving
from ptype_tpu.models import generate as jgen
from ptype_tpu.models import transformer as jtfm
from ptype_tpu.serve_engine import PagedGeneratorActor as JPaged
from ptype_tpu.serve_engine import SpecConfig as JSpec
from ptype_tpu_torch import chaos, lockcheck, logs, metrics, trace
from ptype_tpu_torch.errors import ShedError
from ptype_tpu_torch.health import (ServingLedger, measure_seam_cost_us,
                                    serving)
from ptype_tpu_torch.models import generate as tgen
from ptype_tpu_torch.models import transformer as ttfm
from ptype_tpu_torch.models.weights import params_from_numpy
from ptype_tpu_torch.serve_engine import PagedGeneratorActor, SpecConfig

JCFG = jtfm.preset("tiny", dtype=jnp.float32)
CFG = ttfm.preset("tiny", dtype=torch.float32)


class Clock:
    """One injected clock for both packages: ``time.perf_counter`` and
    ``time.time`` read it, the test moves it."""

    def __init__(self):
        self.t = 100.0

    def perf(self):
        return self.t

    def wall(self):
        return 1.7e9 + self.t

    def __enter__(self):
        self._p = [mock.patch("time.perf_counter", self.perf),
                   mock.patch("time.time", self.wall)]
        for p in self._p:
            p.start()
        return self

    def __exit__(self, *exc):
        for p in self._p:
            p.stop()


def _lifecycles(mod_serving, mod_metrics, clock):
    """One fixed lifecycle script through a fresh ledger of one
    package; returns everything the ledger publishes."""
    reg = mod_metrics.MetricsRegistry()
    led = mod_serving.ServingLedger(registry=reg)
    a = led.enqueued(prompt_tokens=40, max_new=4)
    b = led.enqueued(prompt_tokens=8, max_new=6)
    clock.t += 0.010
    assert led.head_refused(a) == 0.0
    clock.t += 0.005
    assert led.head_refused(a) == pytest.approx(0.005)
    led.admitted(a)
    with led.iteration(active=0):
        with led.chunk(a, 32):
            clock.t += 0.002
    with led.iteration(active=1, stall_ms=1.5) as it:
        with led.chunk(a, 8):
            clock.t += 0.001
        led.first_token(a)
        clock.t += 0.003
    led.admitted(b)
    with led.chunk(b, 8):
        clock.t += 0.0007
    led.first_token(b)
    for dt in (0.004, 0.006, 0.005):
        with led.iteration(active=2) as it:
            clock.t += dt
            led.tokens_emitted((a, b))
    with led.iteration(active=2) as it:
        clock.t += 0.009
        led.tokens_emitted((a, b), (2, 1))
        led.spec_window(8, 5, 3, 0.625)
        it.decode_tokens = 3
    led.migrate_begin(b)
    clock.t += 0.02
    led.migrate_done(b, 3, 4096)
    led.kv_sample({"kv_free_blocks": 3, "kv_cached_blocks": 5,
                   "kv_used_blocks": 8, "kv_total_blocks": 16,
                   "kv_util_pct": 50.0, "kv_evictions": 4}, 0.25)
    led.kv_sample({"kv_free_blocks": 2, "kv_cached_blocks": 5,
                   "kv_used_blocks": 9, "kv_total_blocks": 16,
                   "kv_util_pct": 56.25, "kv_evictions": 9}, 0.5)
    led.retired(a, "complete")
    led.retired(b, "stop")
    led.retired(b, "error")              # idempotent
    c = led.enqueued(12, 2)
    led.retired(c, "shed")
    d = led.enqueued(12, 2)
    led.retired(d, "exploded")           # unknown → error
    led.retired(None, "complete")
    led.shed_untracked()
    return {"records": led.records(), "summary": led.summary(),
            "iterations": led.iteration_summary(),
            "ttft_recent": led.ttft_recent(),
            "spec_totals": led.spec_totals(),
            "svc_ewma_s": led.svc_ewma_s(), "snapshot": reg.snapshot()}


# -------------------------------------------------- ledger (parity)


def test_ledger_equals_the_reference_under_one_injected_clock():
    with Clock() as clock:
        got = _lifecycles(serving, metrics, clock)
    with Clock() as clock:
        want = _lifecycles(jserving, jmetrics, clock)
    assert got == want
    recs = got["records"]
    assert [r["reason"] for r in recs] == ["complete", "stop", "shed",
                                           "error"]
    a = recs[0]
    assert a["queue_wait_ms"] == pytest.approx(10.0)
    assert a["reserve_wait_ms"] == pytest.approx(5.0)
    assert a["prefill_chunks"] == 2 and a["prefill_tokens"] == 40
    assert a["tokens_out"] == 6 and len(a["decode_deltas_ms"]) == 5
    assert got["summary"]["retire_reasons"] == {
        "complete": 1, "stop": 1, "shed": 1, "error": 1}
    snap = got["snapshot"]
    assert snap["counters"]["serve.sheds"] == 2
    assert snap["counters"]["kv.evictions"] == 9
    assert snap["counters"]["serve.decode_tokens"] == 1 + 6 + 3
    assert got["spec_totals"] == (8, 5, 3)
    assert got["summary"]["migrated_requests"] == 1


def test_retire_reasons_shed_and_idempotence():
    reg = metrics.MetricsRegistry()
    led = ServingLedger(registry=reg)
    rec = led.enqueued(8, 4)
    led.retired(rec, "shed")
    assert reg.counter("serve.sheds").value == 1
    assert reg.counter("serve.retired.shed").value == 1
    assert reg.histogram("serve.e2e_ms").count == 0
    assert led.ttft_recent() == []
    led.retired(rec, "error")
    assert reg.counter("serve.retired").value == 1


def test_ledger_synthesizes_span_tree_under_traceparent():
    """The same script under a handler span in both packages, one
    clock: the same span tree (names, stamps, attributes, events), each
    a child of its handler."""

    def tree(mod_serving, mod_metrics, mod_trace, clock):
        led = mod_serving.ServingLedger(
            registry=mod_metrics.MetricsRegistry())
        store = mod_trace.enable("serve-test")
        try:
            with mod_trace.span("actor/Generator.Generate") as handler:
                rec = led.enqueued(24, 3, tp=mod_trace.traceparent())
                clock.t += 0.004
                led.admitted(rec)
                with led.chunk(rec, 16):
                    clock.t += 0.001
                with led.chunk(rec, 8):
                    clock.t += 0.0005
                led.first_token(rec)
                for _ in range(2):
                    clock.t += 0.002
                    led.tokens_emitted((rec,))
                led.retired(rec, "complete")
            spans = [s for s in store.spans() if s is not handler]
            assert all(s.parent_id == handler.span_id
                       and s.trace_id == handler.trace_id for s in spans)
            return [(s.name, s.start_s, s.dur_s, s.attrs, s.events,
                     s.status) for s in spans], led.records()[-1]
        finally:
            mod_trace.disable()

    with Clock() as clock:
        got, rec = tree(serving, metrics, trace, clock)
    with Clock() as clock:
        want, _ = tree(jserving, jmetrics, jtrace, clock)
    assert got == want
    names = [s[0] for s in got]
    assert names == ["serve.admit", "serve.prefill.chunk[0]",
                     "serve.prefill.chunk[1]", "serve.decode",
                     "actor/Generator.Generate"][:len(names)]
    dec = next(s for s in got if s[0] == "serve.decode")
    assert [e["name"] for e in dec[4]] == ["first_token"]
    assert dec[3]["tokens"] == 3
    admit = next(s for s in got if s[0] == "serve.admit")
    # Wall stamps near 1.7e9 s keep ~0.2 µs of float64 precision.
    assert (dec[1] - admit[1]) * 1e3 == pytest.approx(rec["ttft_ms"],
                                                      abs=1e-3)


def test_ledger_emits_no_spans_without_traceparent_or_tracing():
    led = ServingLedger(registry=metrics.MetricsRegistry())
    rec = led.enqueued(8, 2, tp=None)
    led.retired(rec, "complete")
    store = trace.enable("serve-test")
    try:
        rec = led.enqueued(8, 2, tp=None)
        led.admitted(rec)
        led.first_token(rec)
        led.retired(rec, "complete")
        assert store.spans() == []
    finally:
        trace.disable()


def test_seam_cost_probe_prices_one_iteration():
    out = measure_seam_cost_us(iters=500)
    assert out["iters"] == 500
    assert 0.0 < out["seam_cost_us"] < 1000.0


# ------------------------------------------ registry, chaos, locks, logs


def test_registry_families_equal_the_reference(tmp_path):
    """Counters with windowed rates, timings with percentiles,
    histograms with exemplars under a trace, flatten_snapshot and the
    JSONL writer, driven the same way in both packages."""

    def drive(mod_metrics, mod_trace, clock, path):
        reg = mod_metrics.MetricsRegistry()
        c = reg.counter("c")
        for i in range(5):
            c.add(3)
            c.sample(now=float(i))
        t = reg.timing("t")
        for v in (0.5, 0.1, 0.3, 0.9, 0.2):
            t.observe(v)
        reg.gauge("g").set(7)
        h = reg.histogram("h", window=4)
        mod_trace.enable("x")
        try:
            with mod_trace.span("req"):
                tid = mod_trace.current_trace_id()
                for v in range(12):
                    h.observe(float(v))
        finally:
            mod_trace.disable()
        w = mod_metrics.MetricsWriter(path)
        w.emit(3, reg, loss=float("nan"), lr=1e-3)
        w.close()
        with open(path) as f:
            line = json.loads(f.read())
        snap = reg.snapshot()
        for ex in snap["histograms"]["h"]["exemplars"]:
            assert ex["trace_id"] == tid
            ex["trace_id"] = "t"
        return (c.rate(now=5.0), c.rate(window_s=2.0, now=4.0),
                t.summary(), snap, mod_metrics.flatten_snapshot(snap),
                line, reg.version)

    with Clock() as clock:
        got = drive(metrics, trace, clock, str(tmp_path / "t.jsonl"))
    with Clock() as clock:
        want = drive(jmetrics, jtrace, clock, str(tmp_path / "j.jsonl"))
    assert got == want
    assert got[5]["loss"] == "nan" and got[5]["step"] == 3


def test_memory_gauges_are_empty_on_the_cpu_and_annotate_is_a_range():
    reg = metrics.MetricsRegistry()
    assert metrics.record_memory_gauges(reg, device="cpu") == {}
    assert reg.snapshot()["gauges"] == {}
    seen = []
    metrics.set_annotate_observer(lambda name, dt: seen.append(name))
    try:
        with metrics.annotate("serve.step"):
            pass
        with metrics.step_annotation(3):
            pass
    finally:
        metrics.set_annotate_observer(None)
    assert seen == ["serve.step"]


def test_chaos_plans_replay_the_reference_schedule():
    menu = [{"site": "serve.admit", "action": "shed"},
            {"site": "serve.spec", "action": "reject", "times": (1, 3)}]
    p = chaos.FaultPlan.random(7, menu, n_faults=6)
    q = jchaos.FaultPlan.random(7, menu, n_faults=6)
    assert p.to_json() == q.to_json()
    plan = chaos.FaultPlan.from_json(q.to_json())
    with chaos.armed(plan):
        fired = [chaos.hit(s.site) for s in plan.specs]
        chaos.note_ok("serve.admit")
    assert any(f is not None for f in fired)
    assert chaos.hit("serve.admit") is None  # disarmed


def test_lockcheck_finds_the_reference_cycle_and_hold():
    def run(mod):
        wd = mod.enable(hold_budget_s=10.0)
        try:
            a, b = mod.lock("x.a"), mod.lock("x.b")
            with a:
                with b:
                    pass
            with b:
                with a:
                    pass
            rep = wd.report()
            return rep["edges"], [f["cycle"] for f in rep["cycles"]]
        finally:
            mod.disable()

    assert run(lockcheck) == run(jlockcheck)
    assert run(lockcheck)[1]
    assert lockcheck.ENV_VAR == jlockcheck.ENV_VAR == "PTYPE_LOCKCHECK"


def test_kv_logger_carries_the_span_ids(caplog):
    log = logs.get_logger("t")
    logging.getLogger("ptype_tpu_torch").propagate = True
    trace.enable("x")
    try:
        with caplog.at_level(logging.INFO, logger="ptype_tpu_torch"):
            with trace.span("s") as sp:
                log.info("hello", kv={"a": 1})
        kv = caplog.records[-1].kv
        assert kv["a"] == 1 and kv["trace_id"] == sp.trace_id
        assert jtrace.parse_traceparent(
            f"00-{sp.trace_id}-{sp.span_id}-01") == (sp.trace_id,
                                                      sp.span_id)
    finally:
        trace.disable()
        logging.getLogger("ptype_tpu_torch").propagate = False


# --------------------------------------------------- engine surface


@pytest.fixture(scope="module")
def trees():
    pj = jtfm.init_params(jax.random.PRNGKey(0), JCFG)
    return pj, params_from_numpy(jax.tree_util.tree_map(np.asarray, pj),
                                 CFG)


def _prompts():
    rng = np.random.default_rng(12)
    return [rng.integers(1, CFG.vocab_size, n) for n in (20, 37)]


@pytest.mark.parametrize("spec", [False, True])
def test_engine_info_covers_the_reference_engines_keys(trees, spec):
    pj, pt = trees
    kw = dict(n_slots=2, block_tokens=16, prefill_chunk=32)
    jspec = tspec = None
    if spec:
        jd, jdc = jgen.truncated_draft_params(pj, JCFG, n_layers=1)
        td, tdc = tgen.truncated_draft_params(pt, CFG, n_layers=1)
        jspec = JSpec(jd, jdc, k=2, adaptive=False)
        tspec = SpecConfig(td, tdc, k=2, adaptive=False)
    ref = JPaged(JCFG, params=pj, spec=jspec,
                 metrics_registry=jmetrics.MetricsRegistry(), **kw)
    reg = metrics.MetricsRegistry()
    eng = PagedGeneratorActor(CFG, params=pt, device="cpu", spec=tspec,
                              metrics_registry=reg, **kw)
    try:
        for p in _prompts():
            want = np.asarray(ref.Generate(jnp.asarray(p)[None], 6))
            got = eng.Generate(torch.as_tensor(p)[None], 6)
            assert got.tolist() == want.tolist()
        ji, ti = ref.Info(), eng.Info()
        missing = set(ji) - set(ti)
        assert not missing, missing
        for k in ("requests_retired", "retire_reasons", "engine_steps",
                  "prefix_hits", "prefill_tokens", "serve_class",
                  "migrations", "spec_proposed", "spec_accepted",
                  "spec_tokens", "spec_windows"):
            if k in ji:
                assert ti[k] == ji[k], k
        assert ti["requests_retired"] == 2 and ti["ttft_p99_ms"] > 0
        assert [s for s, _ in ti["ttft_recent"]] == [1, 2]
        snap = reg.snapshot()
        assert snap["histograms"]["serve.ttft_ms"]["count"] == 2
        assert snap["gauges"]["serve.class"] == 0
        assert snap["gauges"]["kv.total_blocks"] == eng.pool.capacity
        # Every record retired complete, TPOT samples = tokens − 1.
        for r in eng.ledger.records():
            assert r["reason"] == "complete" and r["ttft_ms"] > 0
            assert len(r["decode_deltas_ms"]) == r["tokens_out"] - 1 == 5
    finally:
        ref.close()
        eng.close()


def test_retry_after_is_the_reference_formula(trees):
    """Backlog × the ledger's service EWMA (0.1 s before any request
    completed), the same number the reference engine gives from the
    same ledger state; a full queue's shed carries it."""
    pj, pt = trees
    ref = JPaged(JCFG, params=pj, n_slots=2, block_tokens=16,
                 metrics_registry=jmetrics.MetricsRegistry(), max_queue=1)
    eng = PagedGeneratorActor(CFG, params=pt, device="cpu", n_slots=2,
                              block_tokens=16, max_queue=1,
                              metrics_registry=metrics.MetricsRegistry())
    try:
        assert eng._retry_after() == ref._retry_after() == 0.1
        with pytest.raises(ShedError) as e:
            eng.Generate(torch.ones((2, 4), dtype=torch.int64), 2)
        assert e.value.retry_after_s == 0.1
        with Clock() as clock:
            for led in (eng.ledger, ref.ledger):
                rec = led.enqueued(8, 2)
                clock.t += 0.4
                led.retired(rec, "complete")
        assert eng._retry_after() == ref._retry_after() == 0.4
        assert eng.ledger.summary()["retire_reasons"] == {"shed": 2,
                                                          "complete": 1}
    finally:
        ref.close()
        eng.close()


def test_chaos_seams_shed_typed_and_reject_windows(trees):
    _, pt = trees
    td, tdc = tgen.truncated_draft_params(pt, CFG, n_layers=1)
    eng = PagedGeneratorActor(CFG, params=pt, device="cpu", n_slots=2,
                              block_tokens=16,
                              spec=SpecConfig(td, tdc, k=2,
                                              adaptive=False),
                              metrics_registry=metrics.MetricsRegistry())
    p = torch.as_tensor(_prompts()[0])[None]
    want = tgen.generate(pt, CFG, p, 8)
    plan = chaos.FaultPlan([
        chaos.FaultSpec(site="serve.admit", action="shed"),
        chaos.FaultSpec(site="serve.spec", action="reject", times=2)])
    try:
        with chaos.armed(plan):
            with pytest.raises(ShedError, match="chaos"):
                eng.Generate(p, 8)
            assert torch.equal(eng.Generate(p, 8), want)
            assert chaos.unrecovered() == {}
        info = eng.Info()
        # Two rejected windows ran as plain steps.
        assert info["engine_steps"] > info["spec_windows"]
        assert eng.ledger.summary()["retire_reasons"] == {"complete": 1}
        assert eng._reg.counter("serve.sheds").value == 1
    finally:
        eng.close()


def test_drain_sheds_new_work_and_exports_gauges(trees):
    _, pt = trees
    reg = metrics.MetricsRegistry()
    eng = PagedGeneratorActor(CFG, params=pt, device="cpu", n_slots=2,
                              block_tokens=16, metrics_registry=reg)
    try:
        p = torch.as_tensor(_prompts()[0])[None]
        eng.Generate(p, 3)
        assert not eng.drained()
        eng.begin_drain()
        assert reg.gauge("serve.lifecycle").value == 3  # draining
        with pytest.raises(ShedError, match="draining"):
            eng.Generate(p, 3)
        with pytest.raises(ShedError, match="draining"):
            eng.Prefill(p, 3)
        assert eng.drained()
        assert eng.Info()["lifecycle"] == "draining"
        assert reg.counter("serve.sheds").value == 2
    finally:
        eng.close()


def test_engine_locks_carry_the_reference_names(trees):
    _, pt = trees
    wd = lockcheck.enable()
    try:
        eng = PagedGeneratorActor(CFG, params=pt, device="cpu", n_slots=2,
                                  block_tokens=16,
                                  metrics_registry=metrics.MetricsRegistry())
        try:
            p = torch.as_tensor(_prompts()[1])[None]
            out = {}
            t = threading.Thread(
                target=lambda: out.update(o=eng.Generate(p, 4)))
            t.start()
            t.join(timeout=60)
            assert out["o"].shape == (1, 4)
        finally:
            eng.close()
        rep = wd.report()
        assert rep["cycles"] == [] and rep["acquires"] > 0
        names = {eng._lock._name, eng._load_lock._name, eng._cond._name,
                 eng.pool._lock._name}
        assert names == {"serve.actor.decode", "serve.actor.load",
                         "serve_engine.queue", "serve_engine.pool"}
    finally:
        lockcheck.disable()
