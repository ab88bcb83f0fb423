"""The diurnal-spike drill of ``tests/test_loadgen_drills.py`` on the
port: one seeded diurnal trace replayed open-loop through the port's
gateway (``device="cpu"``), admission and scale-hint path, against a
static one-replica fleet and a fleet under the port's reconciler. The
elastic fleet must hold the TTFT p99 SLO through the spike the static
fleet fails, and the traffic ledger must publish its ``loadgen.*``
series into the registry it was given. Every wait has a deadline."""

import json
import threading
import time

from ptype_tpu_torch.coord.core import CoordState
from ptype_tpu_torch.coord.local import LocalCoord
from ptype_tpu_torch.gateway import GatewayConfig, InferenceGateway
from ptype_tpu_torch.loadgen import (DriverConfig, OpenLoopDriver,
                                     TrafficLedger, gateway_target,
                                     synth_trace)
from ptype_tpu_torch.metrics import MetricsRegistry
from ptype_tpu_torch.reconciler import (FakeGeneratorActor, LocalLauncher,
                                        Reconciler, ReconcilerConfig)
from ptype_tpu_torch.registry import CoordRegistry

SEED = 20260807
#: The SLO prices the whole run, the scale-up transient included; the
#: static fleet's sustained-overload tail sits several multiples above.
SLO_TTFT_MS = 250.0
DELAY_S = 0.02           # fake service time
INFLIGHT = 2             # per-replica concurrency: ~100 rps a replica


def _until(cond, timeout):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


def _build_fleet(service, min_r, max_r, elastic):
    state = CoordState(sweep_interval=0.1)
    registry = CoordRegistry(LocalCoord(state), lease_ttl=2.0)
    mreg = MetricsRegistry()
    launcher = LocalLauncher(
        registry, lambda: FakeGeneratorActor(delay_s=DELAY_S),
        service=service)
    rec = Reconciler(
        registry, service, launcher,
        cfg=ReconcilerConfig(min_replicas=min_r, max_replicas=max_r,
                             cooldown_s=0.2, vote_quorum=1,
                             tick_interval_s=0.02,
                             drain_deadline_s=15.0),
        metrics_registry=mreg)

    def seeded():
        rec.tick()
        return len(registry.nodes(service)) >= min_r

    assert _until(seeded, 20)
    gw = InferenceGateway(
        registry, service,
        GatewayConfig(probe_interval_s=0.05, probe_timeout_s=1.0,
                      default_deadline_s=10.0, max_queue_depth=64,
                      per_replica_inflight=INFLIGHT,
                      slo_ttft_p99_ms=SLO_TTFT_MS),
        metrics_registry=mreg, device="cpu")
    assert _until(lambda: gw.pool.n_healthy() >= min_r, 20)
    if elastic:
        rec._hints = gw.scale_hint
    rec.start()
    return state, launcher, rec, gw, mreg


def _spike_run(spike_trace, elastic):
    svc = "drill-spike-e" if elastic else "drill-spike-s"
    state, launcher, rec, gw, mreg = _build_fleet(
        svc, 1, 4 if elastic else 1, elastic=elastic)
    try:
        # Peak fleet size during the run: the trace ends in a trough,
        # so an elastic fleet has scaled back down by the end. Each
        # change of the healthy count, at its seconds into the run, is
        # what a failure reports (when replicas came and went).
        peak = [gw.pool.n_healthy()]
        t0 = time.monotonic()
        fleet = [(0.0, peak[0])]
        done = threading.Event()

        def watch():
            while not done.is_set():
                n = gw.pool.n_healthy()
                peak[0] = max(peak[0], n)
                if n != fleet[-1][1]:
                    fleet.append((round(time.monotonic() - t0, 3), n))
                done.wait(0.05)

        w = threading.Thread(target=watch, daemon=True)
        w.start()
        led = TrafficLedger(slo_ttft_ms=SLO_TTFT_MS, registry=mreg)
        OpenLoopDriver(spike_trace,
                       gateway_target(gw, deadline_s=5.0),
                       ledger=led,
                       cfg=DriverConfig(max_inflight=256)).run()
        done.set()
        w.join(timeout=1.0)
        assert not w.is_alive()
        # The driver's slip behind its schedule (ms): a host that issued
        # late offered the spike later, or in a burst.
        lag = led.h_lag
        diag = {"healthy_at_s": fleet,
                "issue_lag_ms": {"p50": lag.percentile(50),
                                 "p99": lag.percentile(99),
                                 "max": lag.percentile(100),
                                 "count": lag.count}}
        return led.summary(), peak[0], mreg, diag
    finally:
        gw.close()
        rec.close(stop_fleet=True)
        launcher.close()
        state.close()


def test_diurnal_spike_elastic_holds_slo_where_static_fails():
    spike = synth_trace(SEED, process="diurnal", duration_s=8.0,
                        trough_rps=15.0, peak_rps=180.0,
                        sharpness=2.0)
    static_sum, static_n, _, static_diag = _spike_run(spike, elastic=False)
    elastic_sum, elastic_n, mreg, elastic_diag = _spike_run(spike,
                                                            elastic=True)
    # What a failure needs for its diagnosis, whole (a string message is
    # not cut short): each fleet's healthy replicas over the run, the
    # driver's issue lag, the peak fleet.
    why = json.dumps({"elastic_n": elastic_n, "elastic": elastic_diag,
                      "static": static_diag})

    assert static_n == 1, why
    assert elastic_n >= 2, (
        "the scale-hint path should have grown the fleet through "
        f"the spike (got {elastic_n} replicas): {why}")
    assert static_sum["ttft_p99_ms"] > SLO_TTFT_MS, f"{static_sum} {why}"
    assert elastic_sum["ttft_p99_ms"] <= SLO_TTFT_MS, f"{elastic_sum} {why}"
    assert elastic_sum["goodput_pct"] > static_sum["goodput_pct"], (
        f"{elastic_sum} {static_sum} {why}")
    assert (mreg.counter("loadgen.offered").value
            == elastic_sum["offered"])
    assert mreg.counter("loadgen.slo_good").value > 0
    assert mreg.histogram("loadgen.ttft_ms").count > 0


def _staged_spike_run(spike_trace):
    """The elastic fleet through ``spike_trace`` with each stage of its
    scale-up stamped, in seconds into the run: the gateway's hint
    changing (delta, reason), the reconciler's decisions (delta, fleet),
    each spawn and activation (start, end), the registry's listing and
    the gateway's healthy count at each change (polled every 10 ms).
    Returns (the traffic summary, the stamps)."""
    svc = "drill-stages"
    state, launcher, rec, gw, mreg = _build_fleet(svc, 1, 4, elastic=True)
    st = {"hints": [], "decisions": [], "spawns": [], "activations": [],
          "listed": [], "healthy": []}
    t0 = time.monotonic()

    def now():
        return round(time.monotonic() - t0, 4)

    hint, apply, spawn = rec._hints, rec._apply_decision, launcher.spawn

    def hint_():
        h = hint()
        if h is not None and (not st["hints"]
                              or st["hints"][-1][1] != h.delta):
            st["hints"].append((now(), int(h.delta), h.reason))
        return h

    def apply_(decision, actual):
        st["decisions"].append((now(), int(decision.delta), actual))
        return apply(decision, actual)

    def spawn_(name, **kw):
        began = now()
        h = spawn(name, **kw)
        st["spawns"].append((began, now()))
        activate = h.activate

        def activate_(*a, **k):
            began = now()
            out = activate(*a, **k)
            st["activations"].append((began, now()))
            return out

        h.activate = activate_
        return h

    rec._hints, rec._apply_decision, launcher.spawn = hint_, apply_, spawn_
    done = threading.Event()

    def watch():
        while not done.is_set():
            for key, n in (("listed", len(registry.nodes(svc))),
                           ("healthy", gw.pool.n_healthy())):
                if not st[key] or st[key][-1][1] != n:
                    st[key].append((now(), n))
            done.wait(0.01)

    registry = launcher._registry
    w = threading.Thread(target=watch, daemon=True)
    try:
        w.start()
        led = TrafficLedger(slo_ttft_ms=SLO_TTFT_MS, registry=mreg)
        OpenLoopDriver(spike_trace, gateway_target(gw, deadline_s=5.0),
                       ledger=led, cfg=DriverConfig(max_inflight=256)).run()
        return led.summary(), st
    finally:
        done.set()
        w.join(timeout=1.0)
        gw.close()
        rec.close(stop_fleet=True)
        launcher.close()
        state.close()


def test_diurnal_scale_up_follows_the_hint_within_ticks():
    """The elastic fleet's scale-up stage by stage: the hint asks for
    more, the reconciler decides within a few of its 20 ms ticks, and
    the spawned replicas are listed and probed healthy well inside a
    second of the hint, in that order. No stage waits on more than the
    reconciler's tick and the gateway's 50 ms probe."""
    spike = synth_trace(SEED, process="diurnal", duration_s=8.0,
                        trough_rps=15.0, peak_rps=180.0, sharpness=2.0)
    _, st = _staged_spike_run(spike)
    why = json.dumps(st)
    hint = next(t for t, d, _ in st["hints"] if d > 0)
    decided = next(t for t, d, _ in st["decisions"] if d > 0)
    listed = next(t for t, n in st["listed"] if n >= 2)
    healthy = next(t for t, n in st["healthy"] if n >= 2)
    assert hint <= decided <= hint + 0.5, why
    assert st["spawns"] and st["activations"], why
    assert decided <= st["spawns"][0][0] <= listed <= healthy, why
    assert healthy - hint < 1.0, why


if __name__ == "__main__":
    # PYTHONPATH=. python tests/test_torch_loadgen_drills.py [RUNS]:
    # one JSON line of stage stamps and TTFT tails a staged elastic run.
    import sys

    spike = synth_trace(SEED, process="diurnal", duration_s=8.0,
                        trough_rps=15.0, peak_rps=180.0, sharpness=2.0)
    for _ in range(int(sys.argv[1]) if len(sys.argv) > 1 else 1):
        summary, stamps = _staged_spike_run(spike)
        print(json.dumps({**{k: summary[k] for k in (
            "ttft_p50_ms", "ttft_p99_ms", "goodput_pct", "slo_bad_stages")},
            **stamps}), flush=True)
