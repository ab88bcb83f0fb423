"""The reconciler: desired-vs-actual replica count, closed-loop — the
port's copy of ``ptype_tpu/reconciler/core.py``.

Everything upstream already exists — the gateway ranks a
:class:`~ptype_tpu_torch.gateway.slo.ScaleHint` from shed rate / queue
depth / TTFT+e2e tails, a health plane pages on ``ttft-p99`` /
``kv-pressure`` / ``serve-stall`` (the port has no ``AlertEngine`` yet:
anything with ``.rule`` and ``.node`` feeds :meth:`Reconciler.
observe_alert`), the registry streams membership, and the engine
drains typed — this module is the loop that ACTS: per tick it

1. refreshes the fleet view (registry watch via
   :class:`~ptype_tpu_torch.elastic.FailureDetector` + the handles it
   owns),
2. folds the hint stream and any alert-derived votes through the
   :class:`~ptype_tpu_torch.reconciler.policy.HysteresisPolicy` (cooldown +
   majority voting + min/max bounds — flapping hints cannot thrash),
3. REPLACES dead replicas (a registration lost without a drain the
   reconciler ordered = a death; actual fell below desired, so the
   gap respawns — the gateway's re-routes cover the survivors'
   in-flight in the meantime),
4. scales UP by activating a warm-standby first (params loaded,
   server answering, one ``Activate`` from serving — the fast path a
   spike needs) and spawning fresh replicas for the rest,
5. scales DOWN by draining the newest active replica it owns (stop
   admitting → finish in-flight → deregister → exit; zero lost), with
   a DEADLINE: a drain wedged past it is escalated — the replica is
   killed and the gateway's typed re-routes absorb the tail,
6. refills the warm pool.

Every decision lands three ways: a ``scale.*`` metrics series, a
traced ``reconcile.*`` span (the flight recorder + Perfetto view), and
a KVLogger line — the loop is debuggable with the observability planes
that already exist.
"""

from __future__ import annotations

import inspect
import threading
import time
from dataclasses import dataclass

from ptype_tpu_torch import chaos, lockcheck, logs
from ptype_tpu_torch import metrics as metrics_mod
from ptype_tpu_torch import trace
from ptype_tpu_torch.elastic import FailureDetector
from ptype_tpu_torch.reconciler.policy import (HysteresisPolicy,
                                               ScaleDecision)
from ptype_tpu_torch.registry import Registry

log = logs.get_logger("reconciler")

#: Health-plane rules whose firing counts as a scale-up vote: the
#: pages that mean "serving capacity is the problem". ``slo-burn-rate``
#: is shed-driven, so its vote is URGENT (outranks down-votes, skips
#: the quorum) — the others vote like any other hint and still need
#: the window's majority.
SCALE_UP_RULES = ("ttft-p99", "kv-pressure", "serve-stall",
                  "slo-p99", "slo-burn-rate")
_URGENT_RULES = ("slo-burn-rate",)


@dataclass
class _AlertVote:
    """A ScaleHint-shaped vote synthesized from a health alert."""

    delta: int
    reason: str


@dataclass
class ReconcilerConfig:
    """Knobs of the reconcile loop."""

    #: Fleet bounds: the availability floor and the budget ceiling.
    min_replicas: int = 1
    max_replicas: int = 8
    #: Warm standbys to keep (process up, params loaded, NOT
    #: registered): scale-up activates these instantly instead of
    #: paying a spawn. 0 = no warm pool.
    warm_pool: int = 0
    #: Hysteresis: at most one transition per cooldown window.
    cooldown_s: float = 30.0
    #: Voting window / quorum for non-urgent decisions.
    vote_window: int = 5
    vote_quorum: int = 3
    #: Reconcile cadence (run()'s tick interval).
    tick_interval_s: float = 1.0
    #: Drain budget before escalation (kill + let the gateway
    #: re-route): a wedged drain must not hold a scale-down hostage.
    drain_deadline_s: float = 30.0
    #: Bound on one spawn attempt (the launcher enforces its own).
    spawn_timeout_s: float = 60.0


class Reconciler:
    """The control loop over one service's replica fleet.

    ``launcher`` owns HOW replicas exist (LocalLauncher in-process,
    ProcessLauncher as real OS processes); ``hints`` is a callable
    returning the current :class:`ScaleHint` (in practice
    ``gateway.scale_hint`` — the reconciler polls it once per tick);
    health alerts arrive through :meth:`observe_alert` (wire it as an
    ``AlertEngine`` capture hook, or call it from the watch loop).
    ``tick()`` is synchronous and reentrant-free — tests drive it
    directly with a fake clock; ``run()``/``start()`` wrap it in the
    background cadence loop.
    """

    def __init__(self, registry: Registry, service: str, launcher,
                 hints=None, cfg: ReconcilerConfig | None = None,
                 policy: HysteresisPolicy | None = None,
                 metrics_registry=None):
        self.cfg = cfg or ReconcilerConfig()
        self.service = service
        self.launcher = launcher
        self._hints = hints
        self.policy = policy or HysteresisPolicy(
            min_replicas=self.cfg.min_replicas,
            max_replicas=self.cfg.max_replicas,
            cooldown_s=self.cfg.cooldown_s,
            window=self.cfg.vote_window,
            quorum=self.cfg.vote_quorum)
        self._reg = (metrics_registry if metrics_registry is not None
                     else metrics_mod.metrics)
        self._fd = FailureDetector(registry, service)
        self._fd.wait_seeded()
        self._lock = lockcheck.lock("reconciler.state")
        #: name -> handle, every replica this reconciler owns
        #: (warm + active + draining).
        self._handles: dict[str, object] = {}
        #: name -> escalation deadline (monotonic) for active drains.
        self._draining: dict[str, float] = {}
        #: addrs whose registry departure the reconciler ORDERED
        #: (drain complete / deliberate exit): losing them is not a
        #: death.
        self._expected_departures: set[str] = set()
        #: addrs whose HANDLE is known dead but whose registration
        #: has not expired yet: they must not count as serving
        #: capacity (a zombie lease is not a replica), or the
        #: replacement stalls up to a full lease TTL.
        self._dead_addrs: set[str] = set()
        #: names with a spawn thread in flight -> "active"|"warm".
        self._spawning: dict[str, str] = {}
        #: name -> the spawn Thread itself, for close()'s bounded
        #: join (daemonized AND joined).
        self._spawn_threads: dict[str, threading.Thread] = {}
        #: name -> last-read lifecycle. Refreshed ONCE per tick
        #: outside the main lock (for OS-process fleets a lifecycle
        #: read is a control RPC; a wedged worker must stall at most
        #: the refresh, never the lock observe_alert shares) and
        #: updated by spawn threads as their replica transitions.
        self._lc: dict[str, str] = {}
        #: Deaths awaiting a replacement: consumed (and counted as
        #: ``scale.replacements``) when a grow actually lands — never
        #: at death time, where no replacement exists yet.
        self._replace_credits = 0
        self._alert_votes: list[_AlertVote] = []
        #: Topology placement preference from the hint stream's
        #: ``spawn_domain`` signal: passed to
        #: ``launcher.spawn(domain=...)`` when the launcher takes it,
        #: so scale-ups fill the gateway's local domain first.
        self._spawn_domain: int | None = None
        self.desired: int | None = None
        self._seq = 0
        self._closed = threading.Event()
        self._thread: threading.Thread | None = None
        self._tick_lock = lockcheck.lock("reconciler.tick")

    # -------------------------------------------------------------- input

    def observe_alert(self, alert) -> None:
        """Health-plane firing → scale vote (rules → actions). Usable
        directly as an ``AlertEngine(capture=...)`` hook; rules
        outside :data:`SCALE_UP_RULES` are ignored, so wiring the
        whole engine through is safe."""
        rule = getattr(alert, "rule", "")
        if rule not in SCALE_UP_RULES:
            return
        reason = f"page:{rule}"
        if rule in _URGENT_RULES:
            reason += " (shedding over budget)"
        with self._lock:
            self._alert_votes.append(_AlertVote(delta=1, reason=reason))
        log.info("scale vote from health alert",
                 kv={"service": self.service, "rule": rule,
                     "node": getattr(alert, "node", "")})

    # ----------------------------------------------------------- the tick

    def tick(self, now: float | None = None) -> ScaleDecision | None:
        """One reconcile pass; returns the decision it applied (if
        any). Serialized — a slow spawn in a previous tick never
        overlaps state mutation with the next."""
        with self._tick_lock:
            return self._tick_locked(
                time.monotonic() if now is None else now)

    def _tick_locked(self, now: float) -> ScaleDecision | None:
        self._seq += 1
        self._refresh_lifecycles()
        self._note_deaths()
        self._prune_dead_handles()
        self._check_drains(now)
        actual = self._actual()
        if self.desired is None:
            self.desired = max(self.cfg.min_replicas, actual)
        decision = self._consume_votes(actual, now)
        if decision is not None:
            self._apply_decision(decision, actual)
        self._converge(now)
        self._refill_warm_pool()
        self._export(actual)
        return decision

    # ------------------------------------------------------- fleet view

    def _addr_handles(self) -> dict[str, object]:
        with self._lock:
            return {h.addr: h for h in self._handles.values()}

    def _refresh_lifecycles(self) -> None:
        """One status read per handle per tick, OUTSIDE the main
        lock. Every lock-held accounting section reads this cache —
        a wedged OS-process worker (status RPC blocking to its
        timeout) stalls at most this refresh, never the lock."""
        with self._lock:
            items = list(self._handles.items())
        cache = {}
        for name, h in items:
            cache[name] = h.lifecycle
        with self._lock:
            self._lc = cache

    def _actual(self) -> int:
        """Serving capacity now + capacity already committed: active
        registrations (mine and foreign) plus spawns in flight
        destined for active — counting the committed ones is what
        stops one hint from triggering a spawn per tick while the
        first spawn is still coming up. A replica whose spawn thread
        is still running counts ONLY as pending (never also as
        foreign/active — spawns are warm-held until the handle is
        installed, so it cannot be registry-visible before the
        reconciler owns it). A replica this reconciler drained and has
        already reaped is not foreign while the registry still lists it:
        its address stays an expected departure until the failure
        detector reports it gone (counted as foreign capacity, it made
        the next tick drain the replica that stays; the reference's
        ``_actual`` has that race)."""
        mine = self._addr_handles()
        with self._lock:
            dead = set(self._dead_addrs) | self._expected_departures
        foreign = [n for n in self._fd.current()
                   if f"{n.address}:{n.port}" not in mine
                   and f"{n.address}:{n.port}" not in dead]
        with self._lock:
            active_mine = sum(
                1 for name in self._handles
                if name not in self._draining
                and name not in self._spawning
                and self._lc.get(name) == "active")
            pending = sum(1 for dest in self._spawning.values()
                          if dest == "active")
        return len(foreign) + active_mine + pending

    def _warm_handles(self) -> list:
        with self._lock:
            return [h for name, h in self._handles.items()
                    if name not in self._draining
                    and name not in self._spawning
                    and self._lc.get(name) == "warm"]

    def _note_deaths(self) -> None:
        lost, _joined = self._fd.drain_changes()
        if not lost:
            return
        mine = self._addr_handles()
        for addr in lost:
            with self._lock:
                expected = addr in self._expected_departures
                self._expected_departures.discard(addr)
                self._dead_addrs.discard(addr)  # registry caught up
            if expected:
                continue
            h = mine.get(addr)
            name = getattr(h, "name", addr)
            self._reg.counter("scale.deaths").add(1)
            log.warning("replica lost (not a reconciler-ordered "
                        "departure); will replace",
                        kv={"service": self.service, "replica": name,
                            "addr": addr})
            with trace.span("reconcile.replace", service=self.service,
                            replica=name, addr=addr):
                if h is not None:
                    try:
                        h.kill()  # reap the corpse (proc/server)
                    except Exception:  # noqa: BLE001 — already dead
                        pass
                    with self._lock:
                        self._handles.pop(name, None)
                        self._draining.pop(name, None)
            # actual is now below desired (if it isn't, _converge
            # zeroes the credit): the NEXT grow that lands consumes
            # this credit and counts as the replacement — never here,
            # where no replacement exists yet.
            with self._lock:
                self._replace_credits += 1

    def _prune_dead_handles(self) -> None:
        with self._lock:
            items = list(self._handles.items())
        for name, h in items:
            try:
                gone = not h.alive()
            except Exception:  # noqa: BLE001 — unreachable = gone
                gone = True
            if gone:
                with self._lock:
                    self._handles.pop(name, None)
                    was_draining = self._draining.pop(name, None)
                with self._lock:
                    was_active = self._lc.get(name) == "active"
                if (was_draining is None and was_active
                        and h.lifecycle not in ("drained", "dead")):
                    # An unexpected ACTIVE corpse: this IS the death,
                    # found via the handle before (or racing) the
                    # registry loss. Count it HERE and mark the
                    # departure expected, so whichever path sees the
                    # death first credits the replacement exactly
                    # once — otherwise a loss landing mid-tick (after
                    # _note_deaths, before _converge) reaps the
                    # handle creditless, _converge spawns an
                    # UNCREDITED replacement, and the next tick's
                    # credit is zeroed by actual >= desired: the
                    # replacement happened but was never counted.
                    # ACTIVE-only on purpose: a warm/spawning replica
                    # was never registered, so no loss event would
                    # ever clear these dedup entries — a stale entry
                    # at a reused addr would swallow a FUTURE real
                    # death as "expected" and leak forever.
                    with self._lock:
                        self._expected_departures.add(h.addr)
                        self._dead_addrs.add(h.addr)
                        self._replace_credits += 1
                    self._reg.counter("scale.deaths").add(1)
                    log.warning("replica handle dead outside a drain; "
                                "will replace",
                                kv={"service": self.service,
                                    "replica": name})
                elif was_draining is None and h.lifecycle not in (
                        "drained", "dead"):
                    # Warm/spawning corpse: reaped without death
                    # accounting — it held no registration and served
                    # no traffic; _refill_warm_pool replaces it.
                    log.warning("replica handle dead outside a drain",
                                kv={"service": self.service,
                                    "replica": name})

    # ------------------------------------------------------------ voting

    def _consume_votes(self, actual: int,
                       now: float) -> ScaleDecision | None:
        with self._lock:
            votes, self._alert_votes = self._alert_votes, []
        decision = None
        for v in votes:
            d = self.policy.observe(v, actual, now)
            decision = decision or d
        if self._hints is not None:
            try:
                hint = self._hints()
            except Exception as e:  # noqa: BLE001 — a broken hint
                # source must not kill the loop that replaces deaths.
                log.warning("hint source failed",
                            kv={"service": self.service,
                                "err": repr(e)})
                hint = None
            if hint is not None:
                self._note_spawn_domain(hint)
                d = self.policy.observe(hint, actual, now)
                decision = decision or d
        return decision

    def _note_spawn_domain(self, hint) -> None:
        """Fold the hint's placement signal (``signals["spawn_
        domain"]``, the gateway's fill-local-first choice). Sticky:
        a hint without the signal keeps the last preference rather
        than resetting placement to topology-blind mid-scale."""
        sig = getattr(hint, "signals", None)
        if not isinstance(sig, dict):
            return
        dom = sig.get("spawn_domain")
        if dom is None:
            return
        try:
            dom = int(dom)
        except (TypeError, ValueError):
            return
        with self._lock:
            self._spawn_domain = dom
        self._reg.gauge("scale.spawn_domain").set(float(dom))

    def _spawn_kwargs(self) -> dict:
        """Launcher spawn kwargs: always warm-held; plus the domain
        placement preference when one is known AND the launcher's
        spawn accepts it (launchers are duck-typed — a pre-topology
        launcher must keep working unchanged)."""
        kw: dict = {"warm_hold": True}
        with self._lock:
            dom = self._spawn_domain
        if dom is None:
            return kw
        try:
            params = inspect.signature(
                self.launcher.spawn).parameters
        except (TypeError, ValueError):
            return kw
        if "domain" in params or any(
                p.kind is inspect.Parameter.VAR_KEYWORD
                for p in params.values()):
            kw["domain"] = dom
        return kw

    def _apply_decision(self, decision: ScaleDecision,
                        actual: int) -> None:
        target = max(self.cfg.min_replicas,
                     min(self.cfg.max_replicas,
                         (self.desired or actual) + decision.delta))
        kind = "up" if decision.delta > 0 else "down"
        with trace.span(f"reconcile.scale_{kind}",
                        service=self.service, delta=decision.delta,
                        reason=decision.reason, desired=target,
                        actual=actual, urgent=decision.urgent):
            self.desired = target
        self._reg.counter("scale.decisions").add(1)
        self._reg.counter(f"scale.{kind}").add(1)
        log.info("scale decision",
                 kv={"service": self.service, "delta": decision.delta,
                     "desired": target, "actual": actual,
                     "reason": decision.reason,
                     "urgent": decision.urgent,
                     **{f"votes_{k}": v
                        for k, v in decision.votes.items()}})

    # --------------------------------------------------------- actuation

    def _converge(self, now: float) -> None:
        actual = self._actual()
        desired = self.desired or actual
        if actual >= desired:
            # No deficit: any death credits were for surplus capacity
            # nothing will (or should) replace — a later legitimate
            # scale-up must not be mislabeled a replacement.
            with self._lock:
                self._replace_credits = 0
        while actual < desired:
            if not self._grow_one():
                break
            actual = self._actual()
        # Shrink: drain the newest active replica the reconciler owns
        # (LIFO — the oldest replicas carry the warmest caches).
        # One drain ordered per tick: drains overlap tick boundaries
        # anyway, and sequential victims keep the in-flight surface
        # small if the hint reverses.
        if actual > desired:
            victim = self._pick_victim()
            if victim is not None:
                self._drain_one(victim, now)

    def _take_replace_credit(self) -> bool:
        with self._lock:
            if self._replace_credits > 0:
                self._replace_credits -= 1
                return True
        return False

    def _return_replace_credit(self, taken: bool) -> None:
        if taken:
            with self._lock:
                self._replace_credits += 1

    def _grow_one(self) -> bool:
        replacement = self._take_replace_credit()
        warm = self._warm_handles()
        if warm:
            h = warm[0]
            with trace.span("reconcile.activate",
                            service=self.service, replica=h.name,
                            replacement=replacement):
                try:
                    h.activate()
                except Exception as e:  # noqa: BLE001 — activation
                    # failure = the warm replica is broken: drop it.
                    log.warning("warm activation failed",
                                kv={"replica": h.name,
                                    "err": repr(e)})
                    with self._lock:
                        self._handles.pop(h.name, None)
                        self._lc.pop(h.name, None)
                    try:
                        h.kill()
                    except Exception:  # noqa: BLE001
                        pass
                    self._return_replace_credit(replacement)
                    return True  # retry loop: spawn instead
            with self._lock:
                self._lc[h.name] = "active"
            self._reg.counter("scale.activations").add(1)
            if replacement:
                self._reg.counter("scale.replacements").add(1)
            log.info("warm replica activated",
                     kv={"service": self.service, "replica": h.name,
                         "addr": h.addr, "replacement": replacement})
            return True
        return self._spawn_async("active", replacement=replacement)

    def _spawn_async(self, dest: str,
                     replacement: bool = False) -> bool:
        with self._lock:
            name = (f"{self.service}-r{self._seq}-"
                    f"{len(self._handles) + len(self._spawning)}")
            if name in self._spawning or name in self._handles:
                self._return_replace_credit(replacement)
                return False
            self._spawning[name] = dest

        def run():
            installed = False
            try:
                with trace.span("reconcile.spawn",
                                service=self.service, replica=name,
                                dest=dest, replacement=replacement):
                    # Spawn WARM always — the worker must not
                    # register itself before the reconciler holds its
                    # handle (a registry-visible, handle-less replica
                    # would double-count as foreign + pending and
                    # could trigger a spurious drain). Activation is
                    # the reconciler's move, after the handle lands.
                    h = self.launcher.spawn(name,
                                            **self._spawn_kwargs())
                self._reg.counter("scale.spawns").add(1)
                with self._lock:
                    self._handles[name] = h
                    self._lc[name] = "warm"
                installed = True
                if dest == "active":
                    h.activate()
                    with self._lock:
                        self._lc[name] = "active"
                if replacement:
                    self._reg.counter("scale.replacements").add(1)
                log.info("replica spawned",
                         kv={"service": self.service, "replica": name,
                             "addr": h.addr, "dest": dest,
                             "replacement": replacement})
            except Exception as e:  # noqa: BLE001 — spawn failures
                # are expected under chaos; the next tick retries.
                self._reg.counter("scale.spawn_failures").add(1)
                self._return_replace_credit(replacement)
                broken = None
                if installed:
                    # Activation failed after install: the replica is
                    # up but broken — drop and kill it.
                    with self._lock:
                        broken = self._handles.pop(name, None)
                        self._lc.pop(name, None)
                if broken is not None:
                    try:
                        broken.kill()
                    except Exception:  # noqa: BLE001 — best effort
                        pass
                log.warning("replica spawn failed",
                            kv={"service": self.service,
                                "replica": name, "err": repr(e)})
            finally:
                with self._lock:
                    self._spawning.pop(name, None)
                    self._spawn_threads.pop(name, None)

        t = threading.Thread(target=run, name=f"spawn-{name}",
                             daemon=True)
        with self._lock:
            self._spawn_threads[name] = t
        t.start()
        return True

    def _pick_victim(self):
        with self._lock:
            active = [(name, h) for name, h in self._handles.items()
                      if name not in self._draining
                      and name not in self._spawning
                      and self._lc.get(name) == "active"]
        if not active:
            return None  # only foreign replicas left: not ours to drain
        return active[-1][1]

    def _drain_one(self, h, now: float) -> None:
        with trace.span("reconcile.drain", service=self.service,
                        replica=h.name,
                        deadline_s=self.cfg.drain_deadline_s):
            with self._lock:
                self._draining[h.name] = (now
                                          + self.cfg.drain_deadline_s)
                self._expected_departures.add(h.addr)
            try:
                h.drain(self.cfg.drain_deadline_s)
            except Exception as e:  # noqa: BLE001 — an unreachable
                # victim is handled as a wedged drain (escalation).
                log.warning("drain order failed",
                            kv={"replica": h.name, "err": repr(e)})
        self._reg.counter("scale.drains").add(1)
        log.info("replica draining",
                 kv={"service": self.service, "replica": h.name,
                     "addr": h.addr,
                     "deadline_s": self.cfg.drain_deadline_s})

    def _check_drains(self, now: float) -> None:
        with self._lock:
            draining = list(self._draining.items())
        for name, deadline in draining:
            with self._lock:
                h = self._handles.get(name)
            if h is None:
                with self._lock:
                    self._draining.pop(name, None)
                continue
            lc = h.lifecycle
            if lc in ("drained", "dead") or not h.alive():
                with self._lock:
                    self._draining.pop(name, None)
                    self._handles.pop(name, None)
                close = getattr(h, "close", None)
                if callable(close):
                    try:
                        close()
                    except Exception:  # noqa: BLE001 — best effort
                        pass
                log.info("drain complete",
                         kv={"service": self.service, "replica": name})
            elif now > deadline:
                # Escalation: the drain wedged past its budget. Kill
                # the replica — its registration vanishes, the
                # gateway re-routes any tail it was still holding
                # (typed, within caller deadlines), and the fleet
                # reaches the desired size NOW instead of never.
                with trace.span("reconcile.escalate",
                                service=self.service, replica=name):
                    try:
                        h.kill()
                    except Exception:  # noqa: BLE001 — already gone
                        pass
                with self._lock:
                    self._draining.pop(name, None)
                    self._handles.pop(name, None)
                self._reg.counter("scale.drain_escalations").add(1)
                chaos.note_ok("scale.drain", name)
                log.warning("drain escalated past deadline; replica "
                            "killed",
                            kv={"service": self.service,
                                "replica": name})

    def _refill_warm_pool(self) -> None:
        if self.cfg.warm_pool <= 0:
            return
        with self._lock:
            warm = sum(1 for name in self._handles
                       if name not in self._draining
                       and name not in self._spawning
                       and self._lc.get(name) == "warm")
            pending = sum(1 for d in self._spawning.values()
                          if d == "warm")
        while warm + pending < self.cfg.warm_pool:
            if not self._spawn_async("warm"):
                break
            pending += 1

    # ------------------------------------------------------------- export

    def _export(self, actual: int) -> None:
        with self._lock:
            warm = sum(1 for name in self._handles
                       if name not in self._draining
                       and name not in self._spawning
                       and self._lc.get(name) == "warm")
            draining = len(self._draining)
            pending = len(self._spawning)
        self._reg.gauge("scale.desired").set(self.desired or 0)
        self._reg.gauge("scale.actual").set(actual)
        self._reg.gauge("scale.warm").set(warm)
        self._reg.gauge("scale.draining").set(draining)
        self._reg.gauge("scale.pending_spawns").set(pending)

    def status(self) -> dict:
        """One structured readout (the ``scale.*`` gauges are its
        metric twin; tests and the runbook read it directly)."""
        with self._lock:
            handles = {name: {"addr": h.addr,
                              "lifecycle": self._lc.get(name,
                                                        "unknown"),
                              "draining": name in self._draining}
                       for name, h in self._handles.items()}
            pending = dict(self._spawning)
        return {"service": self.service, "desired": self.desired,
                "actual": self._actual(),
                "replicas": handles, "pending_spawns": pending,
                "in_cooldown": self.policy.in_cooldown(
                    time.monotonic())}

    # --------------------------------------------------------------- run

    def start(self) -> "Reconciler":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._run_loop, name=f"reconciler-{self.service}",
            daemon=True)
        self._thread.start()
        return self

    def _run_loop(self) -> None:
        while not self._closed.is_set():
            try:
                self.tick()
            except Exception as e:  # noqa: BLE001 — the loop that
                # replaces dead replicas must not die of one bad tick.
                log.warning("reconcile tick failed",
                            kv={"service": self.service,
                                "err": repr(e)})
            self._closed.wait(self.cfg.tick_interval_s)

    def close(self, stop_fleet: bool = False) -> None:
        """Stop the loop (the fleet keeps serving unless
        ``stop_fleet`` — the reconciler is a controller, not the
        fleet's lifeline)."""
        self._closed.set()
        if self._thread is not None:
            self._thread.join(timeout=self.cfg.tick_interval_s + 5)
        # Bounded join of in-flight spawn threads:
        # a spawn mid-flight at close is daemonized, but a test
        # tearing the reconciler down must not leak a worker that
        # wakes later against a dead registry. ONE shared deadline
        # across all of them — k wedged spawns must not stack k full
        # timeouts — and a registered-but-not-yet-started thread
        # (ident is None: the tick thread was preempted between
        # install and start) is skipped, not joined (joining an
        # unstarted thread raises out of close()).
        with self._lock:
            spawns = list(self._spawn_threads.values())
        deadline = time.monotonic() + self.cfg.spawn_timeout_s
        for t in spawns:
            if t.ident is None or t is threading.current_thread():
                continue
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        self._fd.close()
        if stop_fleet:
            with self._lock:
                handles = list(self._handles.values())
                self._handles.clear()
                self._draining.clear()
            for h in handles:
                close = getattr(h, "close", None)
                try:
                    (close or h.kill)()
                except Exception:  # noqa: BLE001 — teardown
                    pass
