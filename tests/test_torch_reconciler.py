"""The port's elastic replica lifecycle (``ptype_tpu_torch.reconciler``)
on the CPU: every case of ``tests/test_reconciler.py`` that the port can
run, on the port's in-process coordinator, and the port held against the
reference (``ptype_tpu.reconciler``).

Mirrored cases: the eight ``HysteresisPolicy`` units; the reconciler's
drills over in-process replica hosts (``LocalLauncher``, real sockets,
the port's registry) — bootstrap, a traffic spike, kill-and-replace,
flapping hints, a graceful drain, the warm pool, an alert's vote, drain
escalation, ``scale.spawn`` chaos, the pool's lifecycle column,
``Replica.*`` over the wire — and the paged engine's drain seam
(``device="cpu"``). The reference's four ``health/top`` render cases
wait for the port's health plane.

Held against the reference: both packages' policies decide the same on
seeded hint streams; both reconcilers, scripted by one hint stream on
one fake clock with one replica killed at the same tick, pass through
the same (decision, desired, active, warm, draining) states and end with
the same ``scale.*`` counters; both paged engines, the port's carrying
the reference's tiny f32 weights, finish in-flight requests through a
drain with the same greedy tokens and shed new work typed.

Every wait is a condition with a deadline; threads are joined with a
time limit.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptype_tpu import reconciler as jrec
from ptype_tpu.coord.core import CoordState as JCoordState
from ptype_tpu.coord.local import LocalCoord as JLocalCoord
from ptype_tpu.errors import ShedError as JShedError
from ptype_tpu.metrics import MetricsRegistry as JMetrics
from ptype_tpu.models import transformer as jtfm
from ptype_tpu.registry import CoordRegistry as JCoordRegistry
from ptype_tpu.serve_engine import PagedGeneratorActor as JPaged
from ptype_tpu_torch import chaos
from ptype_tpu_torch import lockcheck as tlockcheck
from ptype_tpu_torch import reconciler as trec
from ptype_tpu_torch.chaos import FaultPlan, FaultSpec
from ptype_tpu_torch.coord.core import CoordState
from ptype_tpu_torch.coord.local import LocalCoord
from ptype_tpu_torch.errors import ShedError
from ptype_tpu_torch.gateway import GatewayConfig, InferenceGateway
from ptype_tpu_torch.metrics import MetricsRegistry
from ptype_tpu_torch.models import transformer as ttfm
from ptype_tpu_torch.models.weights import params_from_numpy
from ptype_tpu_torch.reconciler import (FakeGeneratorActor, HysteresisPolicy,
                                        LocalLauncher, Reconciler,
                                        ReconcilerConfig)
from ptype_tpu_torch.registry import CoordRegistry

PROMPT = np.zeros((1, 4), np.int32)


@pytest.fixture(autouse=True)
def _port_lock_order_watchdog():
    """The port's lock-order watchdog armed for every test (a cycle in
    the acquisition graph fails the test); the port's chaos plan
    disarmed after it."""
    was = tlockcheck.active()
    wd = tlockcheck.enable()
    yield
    cycles = wd.cycles()
    tlockcheck._watchdog = was
    chaos.disarm()
    assert not cycles, f"lock-order cycles: {cycles}"


@pytest.fixture
def coord():
    """A fresh in-process coordinator of the port (fast lease sweep)."""
    state = CoordState(sweep_interval=0.05)
    yield LocalCoord(state)
    state.close()


def _until(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return cond()


class _Hint:
    def __init__(self, delta, reason="steady"):
        self.delta = delta
        self.reason = reason


# ------------------------------------------------- policy (pure units)


def test_policy_symmetric_flap_holds_steady():
    p = HysteresisPolicy(min_replicas=1, max_replicas=8,
                         cooldown_s=10.0, window=4, quorum=2)
    t = 0.0
    for i in range(40):
        d = p.observe(_Hint(1 if i % 2 == 0 else -1,
                            "queue" if i % 2 == 0 else "idle"),
                      n_replicas=2, now=t)
        assert d is None, (i, d)
        t += 1.0


def test_policy_biased_flap_one_transition_per_cooldown():
    p = HysteresisPolicy(min_replicas=1, max_replicas=8,
                         cooldown_s=5.0, window=5, quorum=3)
    decisions = []
    t = 0.0
    seq = [1, 1, -1, 1, 1]
    for i in range(100):
        d = p.observe(_Hint(seq[i % 5], "queue depth"),
                      n_replicas=2, now=t)
        if d is not None:
            decisions.append((t, d))
        t += 0.1
    assert len(decisions) == 2, decisions
    assert all(d.delta > 0 for _, d in decisions)
    assert decisions[1][0] - decisions[0][0] >= 5.0


def test_policy_shed_burst_outranks_idle_shrink():
    p = HysteresisPolicy(min_replicas=1, max_replicas=8,
                         cooldown_s=10.0, window=5, quorum=5)
    for i in range(3):
        assert p.observe(_Hint(-1, "fleet under a third utilized"),
                         n_replicas=4, now=float(i)) is None
    d = p.observe(_Hint(2, "shedding load"), n_replicas=4, now=3.0)
    assert d is not None and d.delta == 2 and d.urgent, d
    assert d.votes["down"] == 3 and d.votes["urgent"] == 1


def test_policy_cooldown_binds_urgent_votes_too():
    p = HysteresisPolicy(min_replicas=1, max_replicas=8,
                         cooldown_s=5.0, window=3, quorum=1)
    assert p.observe(_Hint(1, "shedding load"), 2, now=0.0) is not None
    for t in (0.5, 2.0, 4.9):
        assert p.observe(_Hint(1, "shedding load"), 3, now=t) is None
    assert p.observe(_Hint(1, "shedding load"), 3, now=5.1) is not None


def test_policy_bounds_clamp_and_swallow():
    p = HysteresisPolicy(min_replicas=2, max_replicas=4,
                         cooldown_s=0.0, window=3, quorum=1)
    assert p.observe(_Hint(3, "shedding load"), 4, now=0.0) is None
    d = p.observe(_Hint(5, "shedding load"), 3, now=1.0)
    assert d is not None and d.delta == 1
    p2 = HysteresisPolicy(min_replicas=2, max_replicas=4,
                          cooldown_s=0.0, window=3, quorum=3)
    for t in range(2):
        assert p2.observe(_Hint(-1, "idle"), 2, now=float(t)) is None
    assert p2.observe(_Hint(-1, "idle"), 2, now=2.0) is None


def test_policy_shrinks_one_replica_at_a_time():
    p = HysteresisPolicy(min_replicas=1, max_replicas=8,
                         cooldown_s=0.0, window=3, quorum=3)
    for t in range(2):
        assert p.observe(_Hint(-3, "idle"), 6, now=float(t)) is None
    d = p.observe(_Hint(-3, "idle"), 6, now=2.0)
    assert d is not None and d.delta == -1, d


def test_policy_quorum_gates_non_urgent():
    p = HysteresisPolicy(min_replicas=1, max_replicas=8,
                         cooldown_s=0.0, window=5, quorum=3)
    assert p.observe(_Hint(1, "queue"), 2, now=0.0) is None
    assert p.observe(_Hint(1, "queue"), 2, now=1.0) is None
    assert p.observe(_Hint(1, "queue"), 2, now=2.0) is not None


def test_policy_stale_votes_expire():
    p = HysteresisPolicy(min_replicas=1, max_replicas=8,
                         cooldown_s=2.0, window=5, quorum=3,
                         vote_ttl_s=2.0)
    assert p.observe(_Hint(1, "queue"), 2, now=0.0) is None
    assert p.observe(_Hint(1, "queue"), 2, now=0.5) is None
    assert p.observe(_Hint(1, "queue"), 2, now=10.0) is None


# ----------------------------------------------------- fleet fixtures


def _fleet(coord, service="llm", delay_s=0.02, warm_pool=0,
           min_replicas=1, max_replicas=4, cooldown_s=0.3,
           drain_deadline_s=10.0, hints=None, quorum=1, window=3):
    registry = CoordRegistry(coord, lease_ttl=2.0)
    mreg = MetricsRegistry()
    launcher = LocalLauncher(
        registry, lambda: FakeGeneratorActor(delay_s=delay_s),
        service=service)
    cfg = ReconcilerConfig(
        min_replicas=min_replicas, max_replicas=max_replicas,
        warm_pool=warm_pool, cooldown_s=cooldown_s,
        vote_window=window, vote_quorum=quorum,
        tick_interval_s=0.05, drain_deadline_s=drain_deadline_s)
    rec = Reconciler(registry, service, launcher, hints=hints,
                     cfg=cfg, metrics_registry=mreg)
    return registry, launcher, rec, mreg


def _n_active(rec):
    return sum(1 for r in rec.status()["replicas"].values()
               if r["lifecycle"] == "active")


def _settle(rec, n, timeout=8.0):
    """Tick until the fleet holds ``n`` ACTIVE replicas."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        rec.tick()
        st = rec.status()
        active = sum(1 for r in st["replicas"].values()
                     if r["lifecycle"] == "active")
        if active == n and not st["pending_spawns"]:
            return True
        time.sleep(0.03)
    return False


def _gateway(registry, service, **over):
    cfg = GatewayConfig(probe_interval_s=0.1, probe_timeout_s=1.0,
                        eviction_threshold=3, default_deadline_s=10.0)
    for k, v in over.items():
        setattr(cfg, k, v)
    return InferenceGateway(registry, service, cfg,
                            metrics_registry=MetricsRegistry(),
                            device="cpu")


def _join_all(threads, timeout):
    t0 = time.monotonic()
    for t in threads:
        t.join(timeout=max(0.1, timeout - (time.monotonic() - t0)))
    assert not any(t.is_alive() for t in threads)


# ------------------------------------------------- reconciler (drills)


def test_bootstrap_to_min_replicas(coord):
    registry, launcher, rec, mreg = _fleet(coord, min_replicas=2)
    try:
        assert _settle(rec, 2)
        assert mreg.counter("scale.spawns").value == 2
        assert rec.desired == 2
        assert len(registry.nodes("llm")) == 2
    finally:
        rec.close(stop_fleet=True)
        launcher.close()


def test_traffic_spike_scales_up_before_slo_burn(coord):
    """A burst a 1-replica fleet sheds on triggers an URGENT scale-up
    from the gateway's own hint stream; the burst is fully answered and
    a second wave at the same concurrency sheds nothing."""
    registry, launcher, rec, mreg = _fleet(
        coord, delay_s=0.08, min_replicas=1, max_replicas=3,
        cooldown_s=0.2)
    gw = None
    try:
        assert _settle(rec, 1)
        gw = _gateway(registry, "llm", max_queue_depth=4,
                      per_replica_inflight=1)
        assert _until(lambda: gw.pool.n_healthy() >= 1)
        rec._hints = gw.scale_hint
        rec.start()
        results, errors, lock = [], [], threading.Lock()

        def worker():
            deadline = time.monotonic() + 15
            while time.monotonic() < deadline:
                try:
                    out = gw.generate(PROMPT, 4, deadline_s=5.0)
                    with lock:
                        results.append(out)
                    return
                except ShedError as e:
                    time.sleep(min(0.2, e.retry_after_s))
            with lock:
                errors.append("deadline")

        threads = [threading.Thread(target=worker) for _ in range(10)]
        for t in threads:
            t.start()
        _join_all(threads, 30)
        assert not errors and len(results) == 10
        assert all(r.dtype == torch.int32 and (r == 7).all()
                   for r in results)
        assert mreg.counter("scale.up").value >= 1
        assert _until(lambda: gw.pool.n_healthy() >= 2, 5)
        sheds_before = int(gw.slo.c_shed.value)
        wave2 = [threading.Thread(target=worker) for _ in range(6)]
        results.clear()
        for t in wave2:
            t.start()
        _join_all(wave2, 30)
        assert not errors and len(results) == 6
        assert int(gw.slo.c_shed.value) == sheds_before
    finally:
        if gw is not None:
            gw.close()
        rec.close(stop_fleet=True)
        launcher.close()


def test_replica_kill_replaced_with_zero_lost_on_survivors(coord):
    registry, launcher, rec, mreg = _fleet(
        coord, delay_s=0.05, min_replicas=2, max_replicas=4)
    gw = None
    try:
        assert _settle(rec, 2)
        gw = _gateway(registry, "llm", max_queue_depth=32,
                      per_replica_inflight=2, max_reroutes=3)
        assert _until(lambda: gw.pool.n_healthy() == 2, 5)
        rec.start()
        results, errors, lock = [], [], threading.Lock()
        stop = threading.Event()

        def worker():
            while not stop.is_set():
                try:
                    out = gw.generate(PROMPT, 4, deadline_s=8.0)
                    with lock:
                        results.append(out)
                except ShedError as e:
                    time.sleep(min(0.2, e.retry_after_s))
                except Exception as e:  # noqa: BLE001 — zero-lost bar
                    with lock:
                        errors.append(repr(e))

        threads = [threading.Thread(target=worker) for _ in range(4)]
        for t in threads:
            t.start()
        assert _until(lambda: len(results) >= 4, 5)   # traffic flowing
        victim = rec._pick_victim()
        assert victim is not None
        victim.kill()
        assert _until(lambda: _n_active(rec) == 2 and mreg.counter(
            "scale.replacements").value >= 1, 10)
        n = len(results)
        assert _until(lambda: len(results) >= n + 4, 5)  # through it too
        stop.set()
        _join_all(threads, 10)
        assert not errors, errors
        assert len(results) > 10
        assert mreg.counter("scale.deaths").value == 1
        assert mreg.counter("scale.replacements").value == 1
        assert _n_active(rec) == 2
    finally:
        if gw is not None:
            gw.close()
        rec.close(stop_fleet=True)
        launcher.close()


def test_flapping_hint_stream_holds_count_steady(coord):
    flip = [0]

    def hints():
        flip[0] += 1
        return _Hint(1 if flip[0] % 2 else -1,
                     "queue depth" if flip[0] % 2 else
                     "fleet under a third utilized")

    registry, launcher, rec, mreg = _fleet(
        coord, min_replicas=2, cooldown_s=0.1, hints=hints,
        quorum=2, window=4)
    try:
        assert _settle(rec, 2)
        for _ in range(40):
            rec.tick()
        assert mreg.counter("scale.decisions").value == 0
        assert _n_active(rec) == 2
        assert rec.desired == 2
    finally:
        rec.close(stop_fleet=True)
        launcher.close()


def test_a_reaped_drain_is_not_counted_as_foreign_capacity(coord):
    """Shrinking 2 → 1: once the victim's drain is reaped but the
    failure detector still lists it (its deregistration not yet
    delivered), the victim is an expected departure, not foreign
    capacity — the next ticks drain nothing more. Counted as foreign
    (the reference's ``_actual``), it made the reconciler drain the
    replica that stays, then respawn one (seen under load in
    ``test_graceful_drain_finishes_in_flight_zero_lost``)."""
    from unittest import mock

    registry, launcher, rec, mreg = _fleet(coord, min_replicas=1)
    try:
        rec.desired = 2
        assert _settle(rec, 2)
        stale = list(rec._fd.current())
        assert len(stale) == 2
        victim = rec._pick_victim()
        rec.desired = 1
        rec.tick()
        assert mreg.counter("scale.drains").value == 1
        assert _until(lambda: victim.lifecycle in ("drained", "dead"), 5)
        # The detector has not seen the deregistration yet: its view and
        # its change buffer both still hold the victim.
        with mock.patch.object(rec._fd, "current", lambda: stale), \
                mock.patch.object(rec._fd, "drain_changes",
                                  lambda: ([], [])):
            for _ in range(3):
                rec.tick()
            assert victim.name not in rec.status()["replicas"]
        assert mreg.counter("scale.drains").value == 1
        for _ in range(3):  # the loss delivered: an expected departure
            rec.tick()
        assert mreg.counter("scale.deaths").value == 0
        assert _n_active(rec) == 1
        assert mreg.counter("scale.spawns").value == 2
    finally:
        rec.close(stop_fleet=True)
        launcher.close()


def test_graceful_drain_finishes_in_flight_zero_lost(coord):
    registry, launcher, rec, mreg = _fleet(
        coord, delay_s=0.25, min_replicas=2, drain_deadline_s=10.0)
    try:
        assert _settle(rec, 2)
        victim = rec._pick_victim()
        host = next(h for h in launcher.hosts
                    if h.node_name == victim.name)
        results, errors, lock = [], [], threading.Lock()

        def inflight():
            try:
                out = host.actor.Generate(PROMPT, 4)
                with lock:
                    results.append(out)
            except Exception as e:  # noqa: BLE001 — the zero-lost bar
                with lock:
                    errors.append(repr(e))

        threads = [threading.Thread(target=inflight)
                   for _ in range(3)]
        for t in threads:
            t.start()
        assert _until(lambda: host.actor.Info()["in_flight"] == 3, 5)
        rec.desired = 1
        rec.tick()
        assert victim.name in rec.status()["replicas"]
        with pytest.raises(ShedError):
            host.actor.Generate(PROMPT, 4)
        _join_all(threads, 10)
        assert not errors, errors
        assert len(results) == 3
        assert all(r.dtype == np.int32 and (r == 7).all()
                   for r in results)

        def gone():
            rec.tick()
            return (victim.name not in rec.status()["replicas"]
                    and len(registry.nodes("llm")) == 1)

        assert _until(gone, 8)
        assert mreg.counter("scale.drains").value == 1
        assert mreg.counter("scale.drain_escalations").value == 0
        rec.tick()
        assert mreg.counter("scale.deaths").value == 0
    finally:
        rec.close(stop_fleet=True)
        launcher.close()


def test_warm_pool_activates_instead_of_spawning(coord):
    registry, launcher, rec, mreg = _fleet(
        coord, min_replicas=1, warm_pool=1, cooldown_s=0.1, quorum=1)
    try:
        assert _settle(rec, 1)

        def has_warm():
            rec.tick()
            return any(r["lifecycle"] == "warm"
                       for r in rec.status()["replicas"].values())

        assert _until(has_warm, 5)
        assert len(registry.nodes("llm")) == 1
        rec._alert_votes.append(_Hint(1, "shedding load"))

        def activated():
            rec.tick()
            return mreg.counter("scale.activations").value >= 1

        assert _until(activated, 5)
        assert mreg.counter("scale.activations").value == 1
        assert _until(lambda: len(registry.nodes("llm")) == 2, 5)
        assert _n_active(rec) == 2
    finally:
        rec.close(stop_fleet=True)
        launcher.close()


def test_alert_firing_votes_for_scale_up(coord):
    """Anything with ``.rule`` and ``.node`` (the port has no
    AlertEngine yet) lands as a policy vote: urgent for the burn-rate
    rule; a rule outside SCALE_UP_RULES is ignored."""

    class _Alert:
        rule = "slo-burn-rate"
        node = "w1"

    registry, launcher, rec, mreg = _fleet(
        coord, min_replicas=1, cooldown_s=0.1)
    try:
        assert _settle(rec, 1)
        rec.observe_alert(_Alert())

        class _Other:
            rule = "loss"
            node = "w1"

        rec.observe_alert(_Other())
        assert _settle(rec, 2)
        assert mreg.counter("scale.up").value == 1
    finally:
        rec.close(stop_fleet=True)
        launcher.close()


def test_drain_deadline_escalation_kills_wedged_victim(coord):
    registry, launcher, rec, mreg = _fleet(
        coord, min_replicas=2, drain_deadline_s=0.4)
    try:
        assert _settle(rec, 2)
        plan = chaos.arm(FaultPlan([
            FaultSpec("scale.drain", "wedge", delay_s=30.0)],
            name="wedged-drain"))
        rec.desired = 1
        rec.tick()

        def escalated():
            rec.tick()
            return mreg.counter("scale.drain_escalations").value >= 1

        assert _until(escalated, 8)
        assert mreg.counter("scale.drain_escalations").value == 1
        assert len(plan.fired()) == 1
        assert plan.unrecovered() == {}

        def one_left():
            rec.tick()
            return len(registry.nodes("llm")) == 1

        assert _until(one_left, 5)
    finally:
        chaos.disarm()
        rec.close(stop_fleet=True)
        launcher.close()


def test_scale_spawn_chaos_fails_then_retries_and_pairs(coord):
    registry = CoordRegistry(coord, lease_ttl=2.0)
    mreg = MetricsRegistry()
    launcher = LocalLauncher(registry, FakeGeneratorActor, service="llm")
    rec = Reconciler(registry, "llm", launcher,
                     cfg=ReconcilerConfig(min_replicas=2,
                                          tick_interval_s=0.05),
                     metrics_registry=mreg)
    plan = chaos.arm(FaultPlan([
        FaultSpec("scale.spawn", "fail", times=1),
        FaultSpec("scale.spawn", "delay", after=1, delay_s=0.05)],
        name="spawn-chaos"))
    try:
        def two_active():
            rec.tick()
            return _n_active(rec) == 2

        assert _until(two_active, 8)
        assert mreg.counter("scale.spawn_failures").value == 1
        fired = [(e.site, e.action) for e in plan.fired()]
        assert ("scale.spawn", "fail") in fired
        assert ("scale.spawn", "delay") in fired
        assert plan.unrecovered() == {}
    finally:
        chaos.disarm()
        rec.close(stop_fleet=True)
        launcher.close()


# ------------------------------------------------- lifecycle surfaces


def test_pool_snapshot_lifecycle_column_and_draining_routing(coord):
    registry, launcher, rec, _mreg = _fleet(
        coord, min_replicas=2, drain_deadline_s=10.0)
    gw = None
    try:
        assert _settle(rec, 2)
        gw = _gateway(registry, "llm")
        assert _until(lambda: gw.pool.n_healthy() == 2, 5)
        gw.pool.probe_now()
        snaps = gw.pool.status()["replicas"]
        assert all(s.get("lifecycle") == "active" for s in snaps)
        victim = rec._pick_victim()
        host = next(h for h in launcher.hosts
                    if h.node_name == victim.name)
        host.actor.begin_drain()
        gw.pool.probe_now()
        snaps = {s["key"]: s for s in gw.pool.status()["replicas"]}
        assert snaps[victim.addr]["lifecycle"] == "draining"
        survivor = next(k for k in snaps if k != victim.addr)
        for _ in range(8):
            assert gw.pool.pick().key == survivor
        for i in range(8):
            assert gw.pool.pick(affinity_key=f"k{i}").key == survivor
    finally:
        if gw is not None:
            gw.close()
        rec.close(stop_fleet=True)
        launcher.close()


def test_replica_ctl_endpoints_over_the_wire(coord):
    """Replica.* over a real TCP socket (the in-process short-circuit is
    bypassed), dialed on the CPU device as the reconciler dials."""
    from unittest import mock

    from ptype_tpu_torch import actor as tactor
    from ptype_tpu_torch import rpc as rpc_mod
    from ptype_tpu_torch.registry import Node

    registry = CoordRegistry(coord, lease_ttl=2.0)
    launcher = LocalLauncher(registry, FakeGeneratorActor, service="llm")
    handle = launcher.spawn("wire-r0", warm_hold=True)
    conn = None
    try:
        host, port = handle.addr.split(":")
        with mock.patch.object(tactor, "lookup_local", lambda a, p: None):
            conn = rpc_mod._dial(Node(address=host, port=int(port)), 2.0,
                                 device="cpu")
        assert type(conn).__name__ == "_Conn"

        def call(method, *args):
            return conn.call_async(method, args).result(timeout=5)

        st = call("Replica.Status")
        assert st["lifecycle"] == "warm" and not st["registered"]
        assert len(registry.nodes("llm")) == 0
        st = call("Replica.Activate")
        assert st["lifecycle"] == "active" and st["registered"]
        assert len(registry.nodes("llm")) == 1
        out = call("Generator.Generate", PROMPT, 3)
        assert out.dtype == np.int32 and out.tolist() == [[7, 7, 7]]
        st = call("Replica.Drain", 5.0)
        assert st["lifecycle"] in ("draining", "drained")
        assert _until(lambda: not handle.alive(), 5)
        assert len(registry.nodes("llm")) == 0
    finally:
        if conn is not None:
            conn.close()
        launcher.close()


def test_paged_engine_drain_seam():
    from ptype_tpu_torch.serve import LIFECYCLE_CODES
    from ptype_tpu_torch.serve_engine import PagedGeneratorActor

    cfg = ttfm.preset("tiny", dtype=torch.float32)
    eng = PagedGeneratorActor(cfg, n_slots=2, max_len=128,
                              block_tokens=16, device="cpu",
                              metrics_registry=MetricsRegistry())
    try:
        assert eng.Info()["lifecycle"] == "active"
        prompt = torch.ones((1, 8), dtype=torch.int32)
        out_box = {}

        def inflight():
            out_box["out"] = eng.Generate(prompt, 24)

        t = threading.Thread(target=inflight)
        t.start()
        assert _until(lambda: eng._active.any(), 20), \
            "request never reached a slot"
        eng.begin_drain()
        assert not eng.drained()
        with pytest.raises(ShedError):
            eng.Generate(prompt, 4)
        t.join(timeout=30)
        assert not t.is_alive()
        assert tuple(out_box["out"].shape) == (1, 24)
        assert _until(eng.drained, 10)
        assert eng.Info()["lifecycle"] == "draining"
        assert (eng._reg.gauge("serve.lifecycle").value
                == LIFECYCLE_CODES["draining"])
    finally:
        eng.close()


def test_lifecycle_codes_equal_serve_and_the_reference():
    """The replica host's torch-free copy of the lifecycle codes equals
    ``serve.LIFECYCLE_CODES`` and the reference's."""
    from ptype_tpu.serve import LIFECYCLE_CODES as JCODES
    from ptype_tpu_torch.reconciler import replica
    from ptype_tpu_torch.serve import LIFECYCLE_CODES

    assert replica._LIFECYCLE_CODES == LIFECYCLE_CODES == JCODES


def test_exports_and_names_equal_the_reference():
    """The package exports the reference's names; the reconciler's locks
    carry the reference's lockcheck names."""
    assert sorted(trec.__all__) == sorted(jrec.__all__)
    for name in trec.__all__:
        getattr(trec, name)
    assert trec.SCALE_UP_RULES == jrec.SCALE_UP_RULES
    assert trec.URGENT_REASONS == jrec.URGENT_REASONS
    names = [FakeGeneratorActor()._lock._name,
             trec.ProcessReplicaHandle("n", "127.0.0.1", 1,
                                       None)._lock._name]
    assert names == ["reconciler.fake_actor", "reconciler.proc_handle"]


# ----------------------------------------- held against the reference


def _policy_decisions(mod, settings, stream):
    p = mod.HysteresisPolicy(**settings)
    out = []
    for delta, reason, n, now in stream:
        d = p.observe(_Hint(delta, reason), n, now)
        out.append(None if d is None else
                   (d.delta, d.reason, d.urgent, sorted(d.votes.items())))
    return out


POLICY_SETTINGS = [
    dict(min_replicas=1, max_replicas=8, cooldown_s=2.0, window=5,
         quorum=3),
    dict(min_replicas=2, max_replicas=4, cooldown_s=0.0, window=3,
         quorum=1, margin=1),
    dict(min_replicas=1, max_replicas=16, cooldown_s=5.0, window=7,
         quorum=2, margin=3, vote_ttl_s=3.0),
    dict(min_replicas=3, max_replicas=3, cooldown_s=1.0, window=4,
         quorum=4),
]


@pytest.mark.parametrize("settings", POLICY_SETTINGS,
                         ids=lambda s: "-".join(map(str, s.values())))
def test_policy_decisions_equal_the_reference(settings):
    """Both packages' policies fed one seeded stream of mixed deltas,
    urgent and plain reasons, fleet sizes and a fake clock (with gaps
    past the vote TTL) decide identically: delta, reason, urgency and
    the tally."""
    rng = np.random.default_rng(11)
    reasons = ("queue depth", "shedding load", "idle", "steady",
               "fleet under a third utilized", "shed burst")
    stream, now = [], 0.0
    for _ in range(400):
        now += float(rng.choice([0.05, 0.3, 1.0, 4.0],
                                p=[0.4, 0.3, 0.2, 0.1]))
        stream.append((int(rng.integers(-3, 4)),
                       reasons[int(rng.integers(len(reasons)))],
                       int(rng.integers(1, 10)), now))
    want = _policy_decisions(jrec, settings, stream)
    got = _policy_decisions(trec, settings, stream)
    assert got == want
    assert sum(d is not None for d in got) >= 5


#: The scripted hint stream of the reconciler trace: (delta, reason)
#: a tick; the kill lands before tick KILL_AT.
HINT_SCRIPT = ([(0, "steady")] * 3 + [(1, "queue depth")] * 3
               + [(0, "steady")] * 2 + [(2, "shedding load")] * 2
               + [(0, "steady")] * 4 + [(-1, "idle")] * 6
               + [(0, "steady")] * 3 + [(-1, "idle")] * 6
               + [(0, "steady")] * 3)
KILL_AT = 12


def _quiesce(rec, registry, service, timeout=10.0):
    """Wait until no spawn is pending, every ordered drain has finished
    (its replica exited), and the failure detector sees what the
    registry holds — so a tick reads a settled fleet."""
    def settled():
        with rec._lock:
            pending = bool(rec._spawning)
            draining = [rec._handles.get(n) for n in rec._draining]
        if pending or any(h is not None and h.alive() for h in draining):
            return False
        seen = {f"{n.address}:{n.port}" for n in rec._fd.current()}
        return seen == {f"{n.address}:{n.port}"
                        for n in registry.nodes(service)}

    assert _until(settled, timeout), rec.status()


def _reconciler_trace(mod, launcher_cls, fake_cls, registry, mreg):
    """One scripted run of a package's reconciler over in-process fake
    replicas on a fake clock: the per-tick fleet state and the final
    ``scale.*`` counters."""
    script = iter(HINT_SCRIPT)
    box = {}

    def hints():
        delta, reason = box["hint"]
        return _Hint(delta, reason)

    launcher = launcher_cls(registry, fake_cls, service="llm-trace")
    rec = mod.Reconciler(
        registry, "llm-trace", launcher, hints=hints,
        cfg=mod.ReconcilerConfig(min_replicas=2, max_replicas=4,
                                 warm_pool=1, cooldown_s=2.0,
                                 vote_window=3, vote_quorum=2,
                                 drain_deadline_s=30.0),
        metrics_registry=mreg)
    rows = []
    try:
        for i, box["hint"] in enumerate(script):
            if i == KILL_AT:
                victim = rec._pick_victim()
                victim.kill()
                assert _until(lambda: not victim.alive(), 5)
            d = rec.tick(now=float(i))
            _quiesce(rec, registry, "llm-trace")
            st = rec.status()
            lcs = [(r["lifecycle"], r["draining"])
                   for r in st["replicas"].values()]
            rows.append((None if d is None else (d.delta, d.reason),
                         rec.desired,
                         sum(lc == "active" and not dr for lc, dr in lcs),
                         sum(lc == "warm" and not dr for lc, dr in lcs),
                         sum(dr for _, dr in lcs)))
    finally:
        rec.close(stop_fleet=True)
        launcher.close()
    counters = {k: v for k, v in mreg.snapshot()["counters"].items()
                if k.startswith("scale.")}
    return rows, counters


def test_reconciler_tick_trace_equals_the_reference(coord):
    """Each package's reconciler, each on its own in-process coordinator
    and registry, scripted by one hint stream on one fake clock with the
    newest active replica killed before the same tick, passes through
    the same states and counts the same ``scale.*`` events."""
    jstate = JCoordState(sweep_interval=0.05)
    try:
        want = _reconciler_trace(
            jrec, jrec.LocalLauncher, jrec.FakeGeneratorActor,
            JCoordRegistry(JLocalCoord(jstate), lease_ttl=2.0), JMetrics())
    finally:
        jstate.close()
    got = _reconciler_trace(
        trec, LocalLauncher, FakeGeneratorActor,
        CoordRegistry(coord, lease_ttl=2.0), MetricsRegistry())
    assert got == want
    rows, counters = got
    assert counters["scale.deaths"] == 1
    assert counters["scale.replacements"] == 1
    assert counters["scale.drains"] >= 1
    assert max(r[1] for r in rows) == 4 and rows[-1][1] == 2


@pytest.fixture(scope="module")
def tiny_params_np():
    cfg = jtfm.preset("tiny", dtype=jnp.float32)
    pj = jtfm.init_params(jax.random.PRNGKey(0), cfg)
    return jax.tree_util.tree_map(np.asarray, pj)


def _drain_seam_run(eng, prompts, max_new, shed_type, as_prompt):
    """Start the prompts in flight, drain once both hold a slot, and
    collect: the in-flight tokens, whether new work shed typed, and
    whether the engine reports drained."""
    outs, errs = [None] * len(prompts), []

    def run(i):
        try:
            outs[i] = np.asarray(eng.Generate(as_prompt(prompts[i]),
                                              max_new)).tolist()
        except Exception as e:  # noqa: BLE001 — asserted empty below
            errs.append(repr(e))

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    assert _until(lambda: int(np.asarray(eng._active).sum())
                  == len(prompts), 60), "requests never reached slots"
    eng.begin_drain()
    assert not eng.drained()
    with pytest.raises(shed_type):
        eng.Generate(as_prompt(prompts[0]), 2)
    _join_all(threads, 120)
    assert not errs, errs
    assert _until(eng.drained, 10)
    return outs, eng.Info()["lifecycle"]


def test_paged_drain_seam_tokens_equal_the_reference(tiny_params_np):
    """The reference's engine on JAX's CPU and the port's on
    ``device="cpu"``, the same tiny f32 weights: requests in flight
    through a drain finish with identical greedy tokens, new work sheds
    typed in both, and both report drained."""
    from ptype_tpu_torch.serve_engine import PagedGeneratorActor

    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 256, n).astype(np.int32)[None]
               for n in (9, 21)]
    kw = dict(n_slots=2, max_len=128, block_tokens=16)
    jcfg = jtfm.preset("tiny", dtype=jnp.float32)
    jeng = JPaged(jcfg, params=tiny_params_np, metrics_registry=JMetrics(),
                  **kw)
    try:
        want = _drain_seam_run(jeng, prompts, 16, JShedError,
                               jnp.asarray)
    finally:
        jeng.close()
    cfg = ttfm.preset("tiny", dtype=torch.float32)
    eng = PagedGeneratorActor(cfg, params=params_from_numpy(tiny_params_np,
                                                            cfg),
                              device="cpu", metrics_registry=MetricsRegistry(),
                              **kw)
    try:
        got = _drain_seam_run(eng, prompts, 16, ShedError, torch.as_tensor)
    finally:
        eng.close()
    assert got == want
    assert got[1] == "draining"
    assert all(np.asarray(o).shape == (1, 16) for o in got[0])
