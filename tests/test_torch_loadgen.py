"""The port's load generator (``ptype_tpu_torch.loadgen``) against the
reference's (``ptype_tpu.loadgen``) on the CPU.

Traces are held bit for bit: for the same seed the port must give the
reference's arrival times, families, prefix groups, lengths, affinity
keys, ``at_rate`` rescales and prompt tokens (both draw through stdlib
``random`` seeded by SHA-256, so exact equality is the contract, not a
tolerance). The same ``Outcome`` sequence fed to both ``TrafficLedger``s
gives equal summaries, goodput and culprit counts; the frontier helpers
agree on the same points; and the open-loop drivers record the same
statuses against a deterministic fake target with the ``loadgen.issue``
seam armed to drop and to delay. Exact unless stated.
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

from ptype_tpu import chaos as jchaos
from ptype_tpu import errors as jerrors
from ptype_tpu import loadgen as jlg
from ptype_tpu_torch import chaos as tchaos
from ptype_tpu_torch import errors as terrors
from ptype_tpu_torch import loadgen as tlg
from ptype_tpu_torch.loadgen import driver as tdriver

#: Rate knobs of each arrival process (the reference tests' regimes).
PROCESSES = {
    "poisson": dict(rate_rps=40.0),
    "bursty": dict(base_rps=5.0, burst_rps=60.0, mean_on_s=0.3,
                   mean_off_s=0.6),
    "diurnal": dict(trough_rps=4.0, peak_rps=50.0, sharpness=3.0),
}


def _fields(trace):
    return [dataclasses.astuple(a) + (a.affinity_key,)
            for a in trace.arrivals]


@pytest.fixture(autouse=True)
def _disarm_port_chaos():
    yield
    tchaos.disarm()


@pytest.mark.parametrize("process", sorted(PROCESSES))
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_synth_trace_equals_the_reference_bit_for_bit(seed, process):
    kw = PROCESSES[process]
    want = jlg.synth_trace(seed, process=process, duration_s=4.0, **kw)
    got = tlg.synth_trace(seed, process=process, duration_s=4.0, **kw)
    assert len(got.arrivals) > 5
    assert (got.seed, got.process, got.duration_s) == (
        want.seed, want.process, want.duration_s)
    assert _fields(got) == _fields(want)
    assert got.offered_rps() == want.offered_rps()
    for rate in (2.0, 17.5, 300.0):
        assert _fields(got.at_rate(rate)) == _fields(want.at_rate(rate))
        assert got.at_rate(rate).duration_s == want.at_rate(rate).duration_s
    for a_got, a_want in zip(got.arrivals, want.arrivals):
        p_got, p_want = tlg.prompt_tokens(a_got), jlg.prompt_tokens(a_want)
        assert p_got.dtype == np.int32 and p_got.shape == (1, a_got.prompt_len)
        assert np.array_equal(p_got, p_want)


def test_the_cut_mix_and_a_small_vocab_match_the_reference():
    """The card phase's mix (RAG's prompt tail cut to 800) and another
    vocabulary draw the same traces and tokens in both packages."""
    tmix = tuple(dataclasses.replace(f, prompt_max=800) if f.name == "rag"
                 else f for f in tlg.DEFAULT_MIX)
    jmix = tuple(dataclasses.replace(f, prompt_max=800) if f.name == "rag"
                 else f for f in jlg.DEFAULT_MIX)
    got = tlg.synth_trace(0, process="poisson", duration_s=8.0,
                          rate_rps=5.0, mix=tmix)
    want = jlg.synth_trace(0, process="poisson", duration_s=8.0,
                           rate_rps=5.0, mix=jmix)
    assert _fields(got) == _fields(want)
    assert max(a.prompt_len + a.max_new for a in got.arrivals) <= 1024
    for a_got, a_want in zip(got.arrivals, want.arrivals):
        assert np.array_equal(tlg.prompt_tokens(a_got, vocab=512),
                              jlg.prompt_tokens(a_want, vocab=512))


def test_trace_rng_draws_equal_the_reference():
    t, j = tlg.TraceRng(7, "x"), jlg.TraceRng(7, "x")
    for _ in range(3):
        assert t.random() == j.random()
        assert t.heavy_len(3.0, 1.0, 1, 500) == j.heavy_len(3.0, 1.0, 1, 500)
        assert t.token_row(5, 100) == j.token_row(5, 100)
    assert t.fork("a").random() == j.fork("a").random()
    with pytest.raises(ValueError):
        tlg.synth_trace(0, process="nope")


def _outcomes(mod):
    """A fixed outcome sequence in ``mod``'s ``Outcome`` type: answers
    inside and past the SLOs (with and without TTFT/TPOT and stage
    splits), sheds, errors, drops and overruns."""
    O = mod.Outcome
    return [
        O(0, "chat", "ok", 0.00, 0.001, 0.081, tokens=8),
        O(1, "rag", "ok", 0.01, 0.011, 0.511, tokens=4, ttft_ms=120.0,
          tpot_ms=30.0, stages={"queue-wait": 5.0, "rpc": 480.0}),
        O(2, "chat", "ok", 0.02, 0.021, 0.421, tokens=10, ttft_ms=350.0,
          tpot_ms=8.0, stages={"queue-wait": 90.0, "prefill": 250.0}),
        O(3, "agent", "shed", 0.03, 0.031, 0.035),
        O(4, "agent", "error", 0.04, 0.041, 0.09),
        O(5, "chat", "dropped", 0.05),
        O(6, "rag", "overrun", 0.06),
        O(7, "chat", "ok", 0.07, 0.071, 0.171, tokens=1, ttft_ms=60.0),
        O(8, "rag", "ok", 0.08, 0.081, 1.481, tokens=12,
          stages={"queue-wait": 900.0, "route": 1.0, "rpc": 500.0}),
        O(9, "chat", "ok", 0.09, 0.092, 0.193, tokens=3, ttft_ms=40.0,
          tpot_ms=80.0),
    ]


@pytest.mark.parametrize("slos", [(None, None), (200.0, 25.0),
                                  (100.0, None)], ids=str)
def test_traffic_ledger_summary_equals_the_reference(slos):
    ttft, tpot = slos
    got = tlg.TrafficLedger(slo_ttft_ms=ttft, slo_tpot_ms=tpot,
                            offered_rps=12.5)
    want = jlg.TrafficLedger(slo_ttft_ms=ttft, slo_tpot_ms=tpot,
                             offered_rps=12.5)
    for led, mod in ((got, tlg), (want, jlg)):
        led.offered()
        led.issued(3.5)
        led.overrun(lag_ms=40.0)
        for o in _outcomes(mod):
            led.record(o)
        led.seal(1.5)
    assert got.summary() == want.summary()
    assert [got.good(o) for o in _outcomes(tlg)] == [
        want.good(o) for o in _outcomes(jlg)]
    assert [got.culprit_of(o) for o in _outcomes(tlg)] == [
        want.culprit_of(o) for o in _outcomes(jlg)]
    assert got.registry.snapshot() == want.registry.snapshot()


def test_frontier_helpers_agree_on_the_same_points():
    summaries = []
    for i, (good, shed) in enumerate(((99, 0), (96, 2), (90, 6), (70, 25),
                                      (40, 55))):
        summaries.append({
            "offered": 100, "answered": 100 - shed, "shed": shed,
            "overruns": i, "good": good, "goodput_pct": float(good),
            "offered_rps": 10.0 * 2 ** i, "achieved_rps": 9.0 * 2 ** i,
            "goodput_rps": good / 10.0 * 2 ** i, "ttft_p99_ms": 10.0 * i,
            "e2e_p99_ms": 20.0 * i, "errors": 0, "dropped": 0,
            "slo_bad_stages": {"queue-wait": shed},
            "culprit_stage": "queue-wait" if shed else None})
    tp = [tlg.point_from_summary(s) for s in summaries]
    jp = [jlg.point_from_summary(s) for s in summaries]
    assert [p.as_dict() for p in tp] == [p.as_dict() for p in jp]
    for pct in (95.0, 90.0, 50.0, 100.0):
        assert (tlg.locate_knee(tp, pct).as_dict()
                == jlg.locate_knee(jp, pct).as_dict())
    # Past saturation everywhere: the best absolute goodput stands in.
    assert (tlg.locate_knee(tp[3:], 95.0).as_dict()
            == jlg.locate_knee(jp[3:], 95.0).as_dict())
    assert tlg.locate_knee([]) is None
    for s in summaries:
        for budgets in ((0.001, 0.01, 0.05, 0.1), (0.02,)):
            assert (tlg.shed_burn_curve(s, budgets)
                    == jlg.shed_burn_curve(s, budgets))
    fr_t, fr_j = tlg.Frontier(tp, tlg.locate_knee(tp)), jlg.Frontier(
        jp, jlg.locate_knee(jp))
    assert fr_t.as_dict() == fr_j.as_dict()


def _fake_target(shed_error):
    """A deterministic target: a status by arrival seq, never by
    timing."""
    def target(arr):
        if arr.seq % 5 == 1:
            raise shed_error("admission queue full", retry_after_s=0.5)
        if arr.seq % 7 == 3:
            raise RuntimeError("handler failed")
        return np.zeros((1, arr.max_new), np.int32)

    return target


def _drive(lg, chaos_mod, errors_mod, trace):
    plan = chaos_mod.arm(chaos_mod.FaultPlan([
        chaos_mod.FaultSpec("loadgen.issue", "drop", after=2, times=2),
        chaos_mod.FaultSpec("loadgen.issue", "delay", after=6, times=1,
                            delay_s=0.06),
    ]))
    try:
        led = lg.OpenLoopDriver(
            trace, _fake_target(errors_mod.ShedError),
            cfg=lg.DriverConfig(overrun_tolerance_s=0.02,
                                join_timeout_s=10.0)).run()
        fired = sorted((e.site, e.action) for e in plan.fired())
        unrecovered = chaos_mod.unrecovered()
    finally:
        chaos_mod.disarm()
    return led, fired, unrecovered


def test_open_loop_driver_records_the_reference_statuses_under_chaos():
    """Arrival by arrival, the port's driver and the reference's record
    the same status (ok, shed, error, or dropped by the seam), the same
    tokens, and the same fired faults; the delayed issue shows as an
    overrun in both. Time limit: the trace is 0.5 s a driver."""
    kw = dict(process="poisson", rate_rps=60.0, duration_s=0.5)
    t0 = time.monotonic()
    got, got_fired, got_unrec = _drive(tlg, tchaos, terrors,
                                       tlg.synth_trace(11, **kw))
    want, want_fired, want_unrec = _drive(jlg, jchaos, jerrors,
                                          jlg.synth_trace(11, **kw))
    assert time.monotonic() - t0 < 30
    by_seq = lambda led: sorted(  # noqa: E731
        (o.seq, o.family, o.status, o.tokens) for o in led.outcomes())
    assert by_seq(got) == by_seq(want)
    sg, sw = got.summary(), want.summary()
    for k in ("offered", "answered", "shed", "errors", "dropped", "good"):
        assert sg[k] == sw[k], k
    assert sg["dropped"] == 2 and sg["shed"] > 0 and sg["errors"] > 0
    assert sg["overruns"] >= 1 and sw["overruns"] >= 1
    assert got_fired == want_fired == [("loadgen.issue", "delay"),
                                       ("loadgen.issue", "drop"),
                                       ("loadgen.issue", "drop")]
    assert got_unrec == want_unrec == {}


def test_closed_loop_driver_equals_the_reference_statuses():
    kw = dict(process="poisson", rate_rps=50.0, duration_s=0.4)
    got = tlg.ClosedLoopDriver(tlg.synth_trace(5, **kw),
                               _fake_target(terrors.ShedError),
                               concurrency=3).run()
    want = jlg.ClosedLoopDriver(jlg.synth_trace(5, **kw),
                                _fake_target(jerrors.ShedError),
                                concurrency=3).run()
    key = lambda led: sorted((o.seq, o.status, o.tokens)  # noqa: E731
                             for o in led.outcomes())
    assert key(got) == key(want)


def test_a_torch_reply_is_counted_from_its_shape():
    """``_parse_result`` reads a tensor's shape, wherever it lies."""
    assert tdriver._parse_result(torch.zeros(2, 7, dtype=torch.int32)) == (
        14, None, None)
    assert tdriver._parse_result(torch.zeros(1, 0)) == (0, None, None)
    assert tdriver._parse_result({"tokens": 3, "ttft_ms": 1.5}) == (
        3, 1.5, None)
    assert tdriver._parse_result(None) == (0, None, None)


def test_sweep_locates_the_knee_like_the_reference():
    """One seeded trace through both sweeps against the same
    capacity-limited fake fleet (2 slots x 20 ms; ~100 rps): both put
    their first point under the knee and their last past it. Time
    limit: ~4 s a sweep."""
    import threading

    class Fleet:
        def __init__(self):
            self.sem = threading.Semaphore(2)

        def __call__(self, arr):
            with self.sem:
                time.sleep(0.02)
            return {"tokens": arr.max_new}

    rates = [10, 40, 2000]
    frs = []
    for lg in (tlg, jlg):
        tr = lg.synth_trace(3, process="poisson", rate_rps=40.0,
                            duration_s=0.5)
        frs.append(lg.sweep(tr, Fleet(), rates, slo_ttft_ms=80.0,
                            cfg=lg.DriverConfig(max_inflight=256,
                                                join_timeout_s=10.0)))
    for fr in frs:
        assert [p.offered_rps for p in fr.points] == rates
        assert fr.points[0].goodput_pct >= 90.0, fr.as_dict()
        assert fr.points[-1].goodput_pct < 90.0, fr.as_dict()
        assert fr.knee_rps in (10, 40)
    assert frs[0].points[0].offered == frs[1].points[0].offered


# ------------------------------------------ health rule + obs views
# (the cases of tests/test_loadgen.py that read the health plane)

from ptype_tpu import health as jhealth  # noqa: E402
from ptype_tpu_torch import health as thealth  # noqa: E402


def _snap(nodes, ts=1000.0):
    return {"ts": ts, "nodes": nodes, "errors": {}}


def _driver_node(offered_pts, knee):
    series = {"loadgen.offered": offered_pts}
    if knee is not None:
        series["loadgen.knee_rps"] = [[999.0, knee]]
    return {"series": series}


@pytest.mark.parametrize("pts,knee", [
    ([[970.0, 0.0], [999.0, 2850.0]], 100.0),   # ~98 rps sustained
    ([[970.0, 0.0], [999.0, 1450.0]], 100.0),   # comfortable headroom
    ([[970.0, 0.0], [999.0, 2850.0]], None),    # no measured frontier
    ([[970.0, 0.0], [999.0, 4.0]], 1.0)])       # not "sustained"
def test_capacity_headroom_rule_warns_near_the_knee(pts, knee):
    view = _snap({"drv/a:1": _driver_node(pts, knee)})
    got = [a.to_dict() for a in thealth.CapacityHeadroomRule(
        window_s=30.0, headroom_frac=0.9, min_offered=8.0).evaluate(
        thealth.ClusterView(view))]
    want = [a.to_dict() for a in jhealth.CapacityHeadroomRule(
        window_s=30.0, headroom_frac=0.9, min_offered=8.0).evaluate(
        jhealth.ClusterView(view))]
    assert got == want
    assert len(got) == (1 if pts[-1][1] == 2850.0 and knee else 0)
    if got:
        assert got[0]["severity"] == "warn"
        assert "capacity knee" in got[0]["message"]


def test_capacity_headroom_rule_is_in_default_rules():
    assert any(r.name == "capacity-headroom"
               for r in thealth.default_rules())


def test_render_traffic_rows_and_empty_state():
    node = {
        "metrics": {
            "counters": {"loadgen.offered": 120.0,
                         "loadgen.slo_good": 90.0,
                         "loadgen.slo_bad": 30.0,
                         "loadgen.shed": 5.0,
                         "loadgen.overrun": 2.0,
                         "loadgen.dropped": 1.0},
            "gauges": {"loadgen.offered_rps": 80.0,
                       "loadgen.inflight": 3.0,
                       "loadgen.knee_rps": 100.0},
            "histograms": {"loadgen.ttft_ms": {"p99": 42.0}},
        },
        "series": {"loadgen.offered.rate": [[999.0, 80.0]],
                   "loadgen.answered.rate": [[999.0, 75.0]]},
    }
    quiet = {"metrics": {"counters": {"train.steps": 5.0}}}
    snap = _snap({"drv/a:1": node, "w/b:2": quiet})
    view = thealth.render_traffic(snap)
    assert view == jhealth.render_traffic(snap)
    assert "1 load drivers" in view and "drv/a:1" in view
    assert "w/b:2" not in view and "75.0" in view and "100" in view
    empty = thealth.render_traffic(_snap({}))
    assert empty == jhealth.render_traffic(_snap({}))
    assert "no open-loop driver" in empty


def test_render_serve_gateway_goodput_section():
    node = {"metrics": {"counters": {
        "gateway.llm.requests": 100.0,
        "gateway.llm.answered": 88.0,
        "gateway.llm.shed": 12.0,
        "gateway.llm.slo_good_requests": 80.0,
        "gateway.llm.slo_violations": 20.0}}}
    view = thealth.render_serve(_snap({"gw/a:1": node}))
    assert view == jhealth.render_serve(_snap({"gw/a:1": node}))
    assert "good%" in view and "gw/a:1" in view
    assert "80" in view and "20" in view


def test_traffic_ledger_series_reach_the_headroom_rule():
    """A port ``TrafficLedger`` publishing into a registry, that
    registry's ``Sampler``, and the knee gauge ``publish_knee`` stamps:
    the pull carries ``loadgen.offered`` history, and offered load
    sustained past 90% of the knee warns in both packages' rule."""
    from ptype_tpu_torch.metrics import MetricsRegistry

    reg = MetricsRegistry()
    led = tlg.TrafficLedger(slo_ttft_ms=100.0, registry=reg)
    sampler = thealth.Sampler(registry=reg, cadence_s=1.0, memory=False)
    tlg.publish_knee(reg, 10.0)
    for i in range(31):
        for _ in range(20):
            led.offered()
        sampler.sample_once(now=970.0 + i, now_mono=float(i))
    node = thealth.telemetry_endpoint(reg, sampler.store, "drv")()
    assert node["series"]["loadgen.knee_rps"] == [[970.0, 10.0]]
    snap = _snap({"drv/a:1": node})
    got = thealth.CapacityHeadroomRule().evaluate(thealth.ClusterView(snap))
    want = jhealth.CapacityHeadroomRule().evaluate(
        jhealth.ClusterView(snap))
    assert [a.to_dict() for a in got] == [a.to_dict() for a in want]
    assert [a.rule for a in got] == ["capacity-headroom"]
