"""Deterministic fault injection — the port's copy of
``ptype_tpu/chaos.py``.

A seeded :class:`FaultPlan` (a schedule of :class:`FaultSpec`: what to
inject, where, when, how many times) is armed process-wide, and narrow
hooks in the real seams fire it. Every firing and every observed
recovery lands in a trace a test asserts against. Plans have the
reference's format, so one ``PTYPE_CHAOS_PLAN`` drives both packages.

Injection sites of the port (the seams that call :func:`hit`):

======================  =====================================================
site                    actions
======================  =====================================================
``serve.admit``         ``shed`` (typed ShedError + retry_after, the
                        pool-exhausted path) / ``delay`` (serve_engine)
``serve.spec``          ``reject`` (poison a speculation window — that
                        iteration falls back to the plain decode step:
                        correct tokens, just slower) / ``delay`` (stall
                        the draft forward) (serve_engine)
``store.push``          ``delay`` (straggler) / ``timeout``
                        (parallel/tensorstore)
``store.pull``          ``delay`` (straggler) (parallel/tensorstore)
``train.reshard``       ``drop`` (abort the live reshard at one bucket;
                        decided on rank 0 for every rank, the old plan
                        kept everywhere) / ``delay`` (parallel/zero)
``checkpoint.shard``    ``corrupt`` — flip bytes in one shard on disk
                        after its crc32 was taken (checkpoint)
``checkpoint.commit``   ``crash`` — between the shard writes and the
                        commit marker (checkpoint)
``rpc.dial``            ``drop`` / ``timeout`` / ``delay`` (rpc.py ``_dial``)
``rpc.send``            ``drop`` / ``truncate`` / ``delay`` (socket send)
``rpc.recv``            ``delay`` — slow reply (rpc.py read loop)
``coord.wire_send``     ``drop`` / ``truncate`` / ``delay`` (coord/wire)
``coord.wire_recv``     ``drop`` / ``delay`` (coord/wire)
``coord.keepalive``     ``revoke`` — lease-revoke a member (coord/core)
``coord.wal_append``    ``delay`` — wedge the coordinator under its lock
                        (coord/core)
``coord.put``           ``kill_primary`` — die mid-write (coord/service)
``gateway.admit``       ``shed`` (force-refuse) / ``delay`` (gateway/admission)
``gateway.route``       ``drop`` (veto the picked replica) / ``delay``
``gateway.probe``       ``drop`` / ``timeout`` / ``delay`` (gateway/pool)
``serve.migrate``       ``drop`` (abort the KV-block transfer outright) /
                        ``delay`` (stall it mid-flight) / ``truncate``
                        (ship a wire missing blocks — the decode side
                        refuses it). All three fall back to local
                        prefill on the decode replica — correct tokens,
                        never lost (gateway/frontdoor
                        ``_dispatch_disagg``)
``loadgen.issue``       ``drop`` (swallow one scheduled arrival — a
                        ``dropped`` outcome goodput accounts) /
                        ``delay`` (stall the issue — surfaces as
                        ``loadgen.overrun`` + issue lag). Keyed by
                        arrival ``seq``; answered requests pair the
                        recovery (loadgen/driver)
``scale.spawn``         ``fail`` (the replica process/host dies before it
                        comes up — the reconciler retries next tick) /
                        ``delay`` (slow spawn) (reconciler/replica)
``scale.drain``         ``wedge`` (hold a drain open past ``delay_s`` —
                        drive it past its deadline so the reconciler's
                        escalation path fires) / ``delay``
                        (reconciler/replica)
======================  =====================================================

Zero-cost contract: every seam calls ``chaos.hit(site, key)``, which is
a single attribute load + ``None`` check when no plan is armed — no
locks, no allocation. Arm per-test with :func:`arm` / the
:class:`armed` context manager, or set ``PTYPE_CHAOS_PLAN`` (inline
JSON or a path to a JSON file) so multiprocess workers arm themselves
at import.

Recovery pairing: seams report health on their success paths via
:func:`note_ok`. A note is recorded in the trace only while a fault of
the same class (the site prefix before the first dot) is outstanding,
so :func:`unrecovered` returning ``{}`` means every injected fault was
followed by a successful operation of its class.

This module imports only the stdlib (the seams it hooks include the
lowest layers of the package; it must never create an import cycle).
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from dataclasses import asdict, dataclass

__all__ = [
    "FaultSpec", "FaultPlan", "FaultEvent", "Fault",
    "arm", "disarm", "current", "armed", "pause", "resume",
    "hit", "note_ok", "trace", "fired", "unrecovered",
    "set_observer",
]

#: Env var carrying a plan for workers spawned as separate processes:
#: inline JSON, or a path to a JSON file (handy for shells).
PLAN_ENV = "PTYPE_CHAOS_PLAN"


@dataclass
class FaultSpec:
    """One scheduled fault: fire ``action`` at ``site`` on the
    ``after+1``-th matching pass, ``times`` times in a row."""

    site: str
    action: str
    #: Substring filter on the seam-provided key (node address, wire
    #: op, store key, shard filename ...). Empty matches everything.
    match: str = ""
    #: Matching passes to skip before the first firing.
    after: int = 0
    #: Consecutive matching passes that fire (then the spec is spent).
    times: int = 1
    #: Sleep length for ``delay`` actions.
    delay_s: float = 0.05


@dataclass
class FaultEvent:
    """One trace entry — an injected fault or an observed recovery."""

    seq: int
    kind: str  # "fault" | "recovery"
    site: str
    action: str
    key: str
    t: float


class Fault:
    """What a seam gets back from :func:`hit` when a spec fires."""

    __slots__ = ("spec",)

    def __init__(self, spec: FaultSpec):
        self.spec = spec

    @property
    def action(self) -> str:
        return self.spec.action

    @property
    def delay_s(self) -> float:
        return self.spec.delay_s

    def sleep(self) -> None:
        time.sleep(self.spec.delay_s)

    def __repr__(self) -> str:  # shows up in seam error messages
        return f"Fault({self.spec.site}:{self.spec.action})"


def _cls(site: str) -> str:
    """Fault class = site prefix: ``rpc`` / ``coord`` / ``store`` /
    ``checkpoint`` — the granularity recovery pairing runs at."""
    return site.split(".", 1)[0]


class FaultPlan:
    """A seeded, replayable schedule of faults plus its firing trace.

    The plan object owns all mutable chaos state (counters, trace,
    outstanding-fault ledger) under one lock, so arming a fresh plan
    fully resets the world and a test can hold the plan after
    :func:`disarm` to inspect what happened.
    """

    def __init__(self, specs: list[FaultSpec], seed: int | None = None,
                 name: str = "plan"):
        self.specs = list(specs)
        self.seed = seed
        self.name = name
        self._lock = threading.Lock()
        self._seen = [0] * len(self.specs)
        self._fired = [0] * len(self.specs)
        self._trace: list[FaultEvent] = []
        self._pending: dict[str, int] = {}
        self._t0 = time.monotonic()

    # ------------------------------------------------------ construction

    @classmethod
    def random(cls, seed: int, menu: list[dict],
               n_faults: int = 8, name: str | None = None) -> "FaultPlan":
        """Deterministic random schedule: ``n_faults`` draws from
        ``menu``. Each menu entry is a dict with ``site``/``action``
        and optional ``match``, plus ``(lo, hi)`` ranges for ``after``,
        ``times`` and ``delay_s``. Same seed + same menu = identical
        specs, which is what makes a failing soak replayable."""
        rng = random.Random(seed)
        specs = []
        for _ in range(n_faults):
            m = rng.choice(menu)
            lo, hi = m.get("after", (0, 10))
            tl, th = m.get("times", (1, 1))
            dl, dh = m.get("delay_s", (0.01, 0.05))
            specs.append(FaultSpec(
                site=m["site"], action=m["action"],
                match=m.get("match", ""),
                after=rng.randint(lo, hi),
                times=rng.randint(tl, th),
                delay_s=round(rng.uniform(dl, dh), 4),
            ))
        return cls(specs, seed=seed, name=name or f"random-{seed}")

    def to_json(self) -> str:
        return json.dumps({
            "name": self.name, "seed": self.seed,
            "specs": [asdict(s) for s in self.specs],
        }, separators=(",", ":"))

    @classmethod
    def from_json(cls, raw: str) -> "FaultPlan":
        d = json.loads(raw)
        return cls([FaultSpec(**s) for s in d["specs"]],
                   seed=d.get("seed"), name=d.get("name", "plan"))

    # ----------------------------------------------------------- firing

    def _hit(self, site: str, key: str) -> Fault | None:
        with self._lock:
            winner: FaultSpec | None = None
            for i, spec in enumerate(self.specs):
                if spec.site != site:
                    continue
                if spec.match and spec.match not in key:
                    continue
                self._seen[i] += 1
                if (winner is None
                        and self._seen[i] > spec.after
                        and self._fired[i] < spec.times):
                    # At most one spec fires per pass, but every
                    # matching spec still counts the pass — schedules
                    # stay deterministic whichever spec wins.
                    self._fired[i] += 1
                    winner = spec
            if winner is None:
                return None
            self._record("fault", site, winner.action, key)
            self._pending[_cls(site)] = self._pending.get(_cls(site), 0) + 1
            return Fault(winner)

    def _note_ok(self, site: str, key: str) -> bool:
        """Returns True when a recovery was recorded (a fault of this
        class was outstanding) — the module-level beacon forwards those
        to the trace observer."""
        with self._lock:
            c = _cls(site)
            if self._pending.get(c, 0) <= 0:
                return False
            self._pending[c] -= 1
            self._record("recovery", site, "ok", key)
            return True

    def _record(self, kind: str, site: str, action: str, key: str) -> None:
        self._trace.append(FaultEvent(
            seq=len(self._trace), kind=kind, site=site, action=action,
            key=key, t=round(time.monotonic() - self._t0, 4)))

    # ------------------------------------------------------- inspection

    def trace(self) -> list[FaultEvent]:
        with self._lock:
            return list(self._trace)

    def fired(self) -> list[FaultEvent]:
        """Injected faults only, in firing order."""
        return [e for e in self.trace() if e.kind == "fault"]

    def unrecovered(self) -> dict[str, int]:
        """Fault classes with more injections than subsequent
        successes — ``{}`` is the soak harness's paired invariant."""
        with self._lock:
            return {c: n for c, n in self._pending.items() if n > 0}

    def exhausted(self) -> bool:
        """True once every spec has fired all its times."""
        with self._lock:
            return all(f >= s.times for s, f in zip(self.specs, self._fired))


# -------------------------------------------------------------- module API

_plan: FaultPlan | None = None
_paused: bool = False
#: Optional ``cb(kind, site, action, key)`` notified on every recorded
#: firing/recovery OUTSIDE the plan lock — how the trace plane
#: (ptype_tpu_torch.trace) attaches chaos events to the afflicted request's
#: span without this module importing anything above the stdlib.
_observer = None


def set_observer(cb) -> None:
    """Install (or clear, with None) the firing/recovery observer."""
    global _observer
    _observer = cb


def _notify(kind: str, site: str, action: str, key: str) -> None:
    obs = _observer
    if obs is None:
        return
    try:
        obs(kind, site, action, key)
    except Exception:  # noqa: BLE001 — observers must never break a seam
        pass


def arm(plan: FaultPlan) -> FaultPlan:
    """Arm ``plan`` process-wide (replaces any armed plan)."""
    global _plan, _paused
    _paused = False
    _plan = plan
    return plan


def disarm() -> None:
    global _plan, _paused
    _plan = None
    _paused = False


def current() -> FaultPlan | None:
    return _plan


def pause() -> None:
    """Stop injecting but keep recording recoveries — the drain phase
    of a soak (outstanding faults can still be paired)."""
    global _paused
    _paused = True


def resume() -> None:
    global _paused
    _paused = False


class armed:
    """``with chaos.armed(plan):`` — arm for a scope, always disarm."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan

    def __enter__(self) -> FaultPlan:
        return arm(self.plan)

    def __exit__(self, *exc) -> None:
        disarm()


def hit(site: str, key: str = "") -> Fault | None:
    """The seam hook: returns the Fault to inject, or None (the
    overwhelmingly common case — one load + compare when disarmed)."""
    plan = _plan
    if plan is None or _paused:
        return None
    f = plan._hit(site, key)
    if f is not None:
        _notify("fault", site, f.action, key)
    return f


def note_ok(site: str, key: str = "") -> None:
    """Success-path beacon: records a recovery if a fault of this
    site's class is outstanding; free no-op otherwise."""
    plan = _plan
    if plan is not None and plan._note_ok(site, key):
        _notify("recovery", site, "ok", key)


def trace() -> list[FaultEvent]:
    plan = _plan
    return plan.trace() if plan is not None else []


def fired() -> list[FaultEvent]:
    plan = _plan
    return plan.fired() if plan is not None else []


def unrecovered() -> dict[str, int]:
    plan = _plan
    return plan.unrecovered() if plan is not None else {}


def _maybe_arm_from_env() -> None:
    """Arm from ``PTYPE_CHAOS_PLAN`` (inline JSON or a file path) —
    how subprocess workers join a drill without code changes."""
    raw = os.environ.get(PLAN_ENV)
    if not raw or _plan is not None:
        return
    if os.path.exists(raw):
        with open(raw, encoding="utf-8") as f:
            raw = f.read()
    arm(FaultPlan.from_json(raw))


_maybe_arm_from_env()
