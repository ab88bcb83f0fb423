"""``obs top``: the live cluster health view — the port's copy of
``ptype_tpu/health/top.py``.

:func:`render_top` turns one cluster snapshot + the alert engine's
history into the operator one-pager (per-node goodput, step
breakdown, throughput, memory, and the active alert list);
:func:`run_top` is the refresh loop behind ``obs top`` (the
reference's ``python -m ptype_tpu obs top``; the port's CLI is not
ported yet) — snapshot, evaluate the rules, repaint.
:func:`render_serve` / :func:`run_serve` are the serving-plane
siblings behind ``obs serve``: per-replica TTFT/TPOT/e2e
tails, queue/batch occupancy, and KV-pool pressure from the serving
ledger's metrics. Pure string rendering here; the CLI owns stdout
(PT004: framework code never prints).
"""

from __future__ import annotations

import sys
import threading
import time

from ptype_tpu_torch.health.rules import AlertEngine

#: ANSI clear-screen + home, prefixed per repaint by the live loop.
CLEAR = "\x1b[2J\x1b[H"


def _fmt_bytes(n) -> str:
    if n is None:
        return "-"
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if n < 1024 or unit == "TiB":
            return f"{n:.0f}{unit}" if unit == "B" else f"{n:.1f}{unit}"
        n /= 1024
    return "?"


def _gauge(telem: dict, name: str):
    return telem.get("metrics", {}).get("gauges", {}).get(name)


def render_top(snapshot: dict, alerts=(), max_nodes: int = 32) -> str:
    """One repaint: header, per-node health table, alert tail."""
    nodes = snapshot.get("nodes", {})
    errors = snapshot.get("errors", {})
    lines = [
        f"ptype health @ {snapshot.get('ts')} — {len(nodes)} nodes, "
        f"{len(errors)} unreachable",
        f"{'node':<28} {'good%':>6} {'step':>8} {'coll':>8} "
        f"{'opt':>8} {'stall':>8} {'tok/s':>9} {'mfu':>7} {'mem':>9} "
        f"{'loss':>8}",
    ]
    for key in sorted(nodes)[:max_nodes]:
        t = nodes[key]
        good = _gauge(t, "goodput.pct")
        step = _gauge(t, "goodput.step_ms")
        coll = _gauge(t, "goodput.collective_ms")
        opt = _gauge(t, "goodput.optimizer_ms")
        stall = _gauge(t, "goodput.stall_ms")
        tps = _gauge(t, "goodput.tokens_per_sec")
        mfu = _gauge(t, "goodput.mfu")
        mem = (_gauge(t, "mem.device_bytes_in_use")
               or _gauge(t, "mem.rss_bytes"))
        loss = _gauge(t, "train.loss")

        def num(v, fmt="{:.1f}", dash="-"):
            return fmt.format(v) if v is not None else dash

        lines.append(
            f"{key[:28]:<28} {num(good):>6} {num(step):>7}m "
            f"{num(coll):>7}m {num(opt):>7}m {num(stall):>7}m "
            f"{num(tps):>9} {num(mfu, '{:.3f}'):>7} "
            f"{_fmt_bytes(mem):>9} {num(loss, '{:.3f}'):>8}")
    for key in sorted(errors)[:8]:
        lines.append(f"{key[:28]:<28} UNREACHABLE ({errors[key]})")
    lines.append("")
    alerts = list(alerts)
    if alerts:
        lines.append(f"ALERTS ({len(alerts)} recent):")
        for a in alerts[-12:]:
            ts = time.strftime("%H:%M:%S", time.localtime(a.ts))
            lines.append(
                f"  {ts} [{a.severity:<4}] {a.rule:<14} "
                f"{a.node[:28]:<28} {a.message}")
    else:
        lines.append("no alerts")
    return "\n".join(lines)


def _hist(telem: dict, name: str) -> dict:
    return telem.get("metrics", {}).get("histograms", {}).get(name) \
        or {}


#: Code → name for the ``serve.lifecycle`` gauge (metric series carry
#: floats; the reconciler's state machine carries names). Mirrors
#: ``ptype_tpu_torch.serve.LIFECYCLES`` — kept inline so the operator views
#: stay importable without the serving stack; a test pins the two in
#: sync.
_LIFECYCLE_NAMES = ("spawning", "warm", "active", "draining",
                    "drained")


def _lifecycle_name(code) -> str | None:
    if code is None:
        return None
    i = int(code)
    return (_LIFECYCLE_NAMES[i] if 0 <= i < len(_LIFECYCLE_NAMES)
            else "?")


#: Code → name for the ``serve.class`` gauge (disaggregated serving).
#: Mirrors ``ptype_tpu_torch.serve_engine.SERVE_CLASSES`` — same
#: inline-copy contract as ``_LIFECYCLE_NAMES``; a test pins the two
#: in sync.
_SERVE_CLASS_NAMES = ("unified", "prefill", "decode")


def _serve_class_name(code) -> str | None:
    if code is None:
        return None
    i = int(code)
    return (_SERVE_CLASS_NAMES[i] if 0 <= i < len(_SERVE_CLASS_NAMES)
            else "?")


def render_serve(snapshot: dict, alerts=(),
                 max_nodes: int = 32) -> str:
    """``obs serve``: the serving-plane one-pager — per-replica
    TTFT/TPOT/e2e tails from the serving ledger's histograms, queue
    and batch occupancy, KV-pool pressure (free blocks, utilization,
    prefix hit rate, evictions), the co-batched prefill stall, and —
    on a disaggregated fleet — each replica's serving
    class plus its migration counters (completed transfers, wire
    bytes, dedup hits).
    Replicas are rows; nodes with no serving metrics (trainers, the
    coordinator) are skipped — this is the serving view, ``obs top``
    is the fleet view."""
    nodes = snapshot.get("nodes", {})
    errors = snapshot.get("errors", {})
    serving = {k: t for k, t in nodes.items()
               if _hist(t, "serve.ttft_ms")
               or _gauge(t, "serve.step_ms") is not None}
    lines = [
        f"ptype serving @ {snapshot.get('ts')} — "
        f"{len(serving)} serving replicas "
        f"({len(nodes)} nodes, {len(errors)} unreachable)",
        f"{'replica':<28} {'state':>9} {'class':>8} {'ttft99':>8} "
        f"{'tpot':>7} {'e2e99':>8} {'q':>4} {'live':>5} "
        f"{'kvfree':>7} {'util%':>6} {'hit%':>6} {'spec%':>6} "
        f"{'evic':>6} {'stall':>7} {'mig':>5} {'migMB':>7} "
        f"{'dedup':>6}",
    ]

    def num(v, fmt="{:.1f}", dash="-"):
        return fmt.format(v) if v is not None else dash

    for key in sorted(serving)[:max_nodes]:
        t = serving[key]
        ttft = _hist(t, "serve.ttft_ms").get("p99")
        tpot = _hist(t, "serve.tpot_ms").get("p50")
        e2e = _hist(t, "serve.e2e_ms").get("p99")
        q = _gauge(t, "serve.queue_depth")
        live = _gauge(t, "serve.active_slots")
        free = _gauge(t, "kv.free_blocks")
        util = _gauge(t, "kv.util_pct")
        hit = _gauge(t, "kv.prefix_hit_rate")
        # Speculative-decoding accept rate: absent on
        # replicas that never ran a window — "-" means no speculation,
        # a number near 0 means a collapsed draft.
        spec = _gauge(t, "serve.spec_accept_rate")
        evic = (t.get("metrics", {}).get("counters", {})
                .get("kv.evictions"))
        stall = _gauge(t, "serve.stall_ms")
        # Lifecycle column: the fleet view matches the
        # reconciler's state machine; "-" = the replica predates the
        # lifecycle story (no serve.lifecycle gauge).
        state = _lifecycle_name(_gauge(t, "serve.lifecycle")) or "-"
        # Serving class + migration counters: a
        # disaggregated fleet reads its split and its wire traffic
        # here first (the migration-stall runbook starts at this
        # view); "-" class = a replica predating the disagg story.
        cls = _serve_class_name(_gauge(t, "serve.class")) or "-"
        counters = t.get("metrics", {}).get("counters", {})
        mig = counters.get("serve.migrations")
        mig_mb = counters.get("serve.migrate_bytes")
        mig_mb = mig_mb / 1e6 if mig_mb is not None else None
        dedup = counters.get("serve.migrate_dedup_hits")
        lines.append(
            f"{key[:28]:<28} {state:>9} {cls:>8} "
            f"{num(ttft, '{:.0f}'):>7}m "
            f"{num(tpot):>6}m {num(e2e, '{:.0f}'):>7}m "
            f"{num(q, '{:.0f}'):>4} {num(live, '{:.0f}'):>5} "
            f"{num(free, '{:.0f}'):>7} {num(util):>6} "
            f"{num(hit * 100 if hit is not None else None):>6} "
            f"{num(spec * 100 if spec is not None else None):>6} "
            f"{num(evic, '{:.0f}'):>6} {num(stall):>6}m "
            f"{num(mig, '{:.0f}'):>5} {num(mig_mb, '{:.2f}'):>7} "
            f"{num(dedup, '{:.0f}'):>6}")
    if not serving:
        lines.append("  (no serving replicas report serve.* metrics)")
    # Gateway goodput: the SLO-attributed good/violation
    # split per gateway service — the series the capacity frontier
    # reads, surfaced where the serving tails already live.
    gateways: list[tuple[str, str, dict]] = []
    for key, t in sorted(nodes.items()):
        counters = t.get("metrics", {}).get("counters", {})
        for cname in sorted(counters):
            if (cname.startswith("gateway.")
                    and cname.endswith(".requests")):
                gateways.append(
                    (key, cname[len("gateway."):-len(".requests")],
                     counters))
    if gateways:
        lines.append("")
        lines.append(f"{'gateway':<28} {'svc':>10} {'req':>7} "
                     f"{'ans':>7} {'shed':>6} {'good':>7} "
                     f"{'viol':>6} {'good%':>6}")
        for key, svc, counters in gateways[:max_nodes]:
            g = counters.get(f"gateway.{svc}.slo_good_requests")
            v = counters.get(f"gateway.{svc}.slo_violations")
            pct = (100.0 * g / (g + v) if g is not None
                   and v is not None and (g + v) > 0 else None)
            lines.append(
                f"{key[:28]:<28} {svc[:10]:>10} "
                f"{num(counters.get(f'gateway.{svc}.requests'), '{:.0f}'):>7} "
                f"{num(counters.get(f'gateway.{svc}.answered'), '{:.0f}'):>7} "
                f"{num(counters.get(f'gateway.{svc}.shed'), '{:.0f}'):>6} "
                f"{num(g, '{:.0f}'):>7} {num(v, '{:.0f}'):>6} "
                f"{num(pct):>6}")
    for key in sorted(errors)[:8]:
        lines.append(f"{key[:28]:<28} UNREACHABLE ({errors[key]})")
    lines.append("")
    alerts = list(alerts)
    if alerts:
        lines.append(f"ALERTS ({len(alerts)} recent):")
        for a in alerts[-12:]:
            ts = time.strftime("%H:%M:%S", time.localtime(a.ts))
            lines.append(
                f"  {ts} [{a.severity:<4}] {a.rule:<14} "
                f"{a.node[:28]:<28} {a.message}")
    else:
        lines.append("no alerts")
    return "\n".join(lines)


def render_scale(snapshot: dict, alerts=(),
                 max_nodes: int = 32) -> str:
    """``obs scale``: the elastic-fleet one-pager. Top:
    every node exporting ``scale.*`` gauges (the reconcilers) with
    desired vs actual, warm/draining/pending counts, and the
    lifetime decision/spawn/drain/escalation counters. Below: every
    serving replica with its lifecycle state and queue/live occupancy
    — the same fleet the reconciler is steering, so a scale decision
    and its effect sit in one screen."""
    nodes = snapshot.get("nodes", {})
    errors = snapshot.get("errors", {})
    recs = {k: t for k, t in nodes.items()
            if _gauge(t, "scale.desired") is not None}
    serving = {k: t for k, t in nodes.items()
               if _gauge(t, "serve.lifecycle") is not None
               or _hist(t, "serve.ttft_ms")}

    def num(v, fmt="{:.0f}", dash="-"):
        return fmt.format(v) if v is not None else dash

    def cnt(t, name):
        return t.get("metrics", {}).get("counters", {}).get(name)

    lines = [
        f"ptype scale @ {snapshot.get('ts')} — {len(recs)} "
        f"reconcilers, {len(serving)} serving replicas "
        f"({len(nodes)} nodes, {len(errors)} unreachable)",
        f"{'reconciler':<28} {'want':>5} {'have':>5} {'warm':>5} "
        f"{'drng':>5} {'pend':>5} {'dec':>5} {'spawn':>6} "
        f"{'drain':>6} {'esc':>4} {'dead':>5} {'fail':>5}",
    ]
    for key in sorted(recs)[:max_nodes]:
        t = recs[key]
        lines.append(
            f"{key[:28]:<28} {num(_gauge(t, 'scale.desired')):>5} "
            f"{num(_gauge(t, 'scale.actual')):>5} "
            f"{num(_gauge(t, 'scale.warm')):>5} "
            f"{num(_gauge(t, 'scale.draining')):>5} "
            f"{num(_gauge(t, 'scale.pending_spawns')):>5} "
            f"{num(cnt(t, 'scale.decisions')):>5} "
            f"{num(cnt(t, 'scale.spawns')):>6} "
            f"{num(cnt(t, 'scale.drains')):>6} "
            f"{num(cnt(t, 'scale.drain_escalations')):>4} "
            f"{num(cnt(t, 'scale.deaths')):>5} "
            f"{num(cnt(t, 'scale.spawn_failures')):>5}")
    if not recs:
        lines.append("  (no node exports scale.* — no reconciler "
                     "running, or its telemetry is not registered)")
    lines.append("")
    lines.append(f"{'replica':<28} {'state':>9} {'q':>4} {'live':>5} "
                 f"{'kvfree':>7} {'ttft99':>8}")
    for key in sorted(serving)[:max_nodes]:
        t = serving[key]
        state = _lifecycle_name(_gauge(t, "serve.lifecycle")) or "-"
        lines.append(
            f"{key[:28]:<28} {state:>9} "
            f"{num(_gauge(t, 'serve.queue_depth')):>4} "
            f"{num(_gauge(t, 'serve.active_slots')):>5} "
            f"{num(_gauge(t, 'serve.kv_free_blocks')):>7} "
            f"{num(_hist(t, 'serve.ttft_ms').get('p99')):>7}m")
    for key in sorted(errors)[:8]:
        lines.append(f"{key[:28]:<28} UNREACHABLE ({errors[key]})")
    lines.append("")
    alerts = list(alerts)
    if alerts:
        lines.append(f"ALERTS ({len(alerts)} recent):")
        for a in alerts[-12:]:
            ts = time.strftime("%H:%M:%S", time.localtime(a.ts))
            lines.append(
                f"  {ts} [{a.severity:<4}] {a.rule:<14} "
                f"{a.node[:28]:<28} {a.message}")
    else:
        lines.append("no alerts")
    return "\n".join(lines)


def _srate(telem: dict, name: str):
    """Last sampled value of a series (the sampler's ``<ctr>.rate`` /
    ``<hist>.p99`` stamps) — None when the node publishes no series
    store or the series has no points yet."""
    pts = telem.get("series", {}).get(name)
    return pts[-1][1] if pts else None


def render_traffic(snapshot: dict, alerts=(),
                   max_nodes: int = 32) -> str:
    """``obs traffic``: the traffic-plane one-pager. One
    row per node driving open-loop load (anything exporting
    ``loadgen.*``): the schedule's target rate, the live offered /
    achieved rates off the sampler, SLO-attributed goodput, the
    shed/overrun/chaos-drop split, the open-loop TTFT tail, and the
    last measured capacity knee with live headroom against it — the
    same numbers the ``capacity-headroom`` rule warns on, so the
    operator and the rule read one surface."""
    nodes = snapshot.get("nodes", {})
    errors = snapshot.get("errors", {})
    drivers = {k: t for k, t in nodes.items()
               if _gauge(t, "loadgen.offered_rps") is not None
               or (t.get("metrics", {}).get("counters", {})
                   .get("loadgen.offered")) is not None}

    def num(v, fmt="{:.0f}", dash="-"):
        return fmt.format(v) if v is not None else dash

    def cnt(t, name):
        return t.get("metrics", {}).get("counters", {}).get(name)

    lines = [
        f"ptype traffic @ {snapshot.get('ts')} — {len(drivers)} "
        f"load drivers ({len(nodes)} nodes, "
        f"{len(errors)} unreachable)",
        f"{'driver':<28} {'target':>7} {'off/s':>7} {'ach/s':>7} "
        f"{'good%':>6} {'shed':>6} {'ovrn':>6} {'drop':>5} "
        f"{'infl':>5} {'ttft99':>8} {'knee':>7} {'head%':>6}",
    ]
    for key in sorted(drivers)[:max_nodes]:
        t = drivers[key]
        good = cnt(t, "loadgen.slo_good")
        bad = cnt(t, "loadgen.slo_bad")
        pct = (100.0 * good / (good + bad)
               if good is not None and bad is not None
               and (good + bad) > 0 else None)
        off_rate = _srate(t, "loadgen.offered.rate")
        knee = _gauge(t, "loadgen.knee_rps")
        head = (100.0 * off_rate / knee
                if off_rate is not None and knee else None)
        lines.append(
            f"{key[:28]:<28} "
            f"{num(_gauge(t, 'loadgen.offered_rps')):>7} "
            f"{num(off_rate, '{:.1f}'):>7} "
            f"{num(_srate(t, 'loadgen.answered.rate'), '{:.1f}'):>7} "
            f"{num(pct, '{:.1f}'):>6} "
            f"{num(cnt(t, 'loadgen.shed')):>6} "
            f"{num(cnt(t, 'loadgen.overrun')):>6} "
            f"{num(cnt(t, 'loadgen.dropped')):>5} "
            f"{num(_gauge(t, 'loadgen.inflight')):>5} "
            f"{num(_hist(t, 'loadgen.ttft_ms').get('p99')):>7}m "
            f"{num(knee):>7} {num(head, '{:.0f}'):>6}")
    if not drivers:
        lines.append("  (no node exports loadgen.* — no open-loop "
                     "driver is running, or its registry is not "
                     "published; see docs/OBSERVABILITY.md "
                     "'Traffic plane')")
    for key in sorted(errors)[:8]:
        lines.append(f"{key[:28]:<28} UNREACHABLE ({errors[key]})")
    lines.append("")
    alerts = list(alerts)
    if alerts:
        lines.append(f"ALERTS ({len(alerts)} recent):")
        for a in alerts[-12:]:
            ts = time.strftime("%H:%M:%S", time.localtime(a.ts))
            lines.append(
                f"  {ts} [{a.severity:<4}] {a.rule:<14} "
                f"{a.node[:28]:<28} {a.message}")
    else:
        lines.append("no alerts")
    return "\n".join(lines)


def render_topo(snapshot: dict, alerts=(),
                max_nodes: int = 32) -> str:
    """``obs topo``: the topology one-pager. Top:
    per-domain replica counts — every node exporting the
    ``serve.domain`` gauge (stamped by ReplicaHost from its
    placement) grouped by domain ordinal, with lifecycle and
    queue/live occupancy folded per domain. Middle: per-leg
    collective wire traffic from the ``collectives.leg_bytes.*``
    counters (fast inner leg vs slow outer leg vs the flat-baseline
    footprint) on every node that launched hierarchical buckets.
    Bottom: the gateway's KV-migration locality split
    (``serve.migrate.local_domain`` vs ``.cross_domain``) — the
    cross-domain-pressure runbook row lands here after ``obs
    serve``."""
    nodes = snapshot.get("nodes", {})
    errors = snapshot.get("errors", {})

    def cnt(t, name):
        return t.get("metrics", {}).get("counters", {}).get(name)

    def num(v, fmt="{:.0f}", dash="-"):
        return fmt.format(v) if v is not None else dash

    domains: dict = {}
    for key, t in sorted(nodes.items()):
        d = _gauge(t, "serve.domain")
        if d is None:
            continue
        domains.setdefault(int(d), []).append((key, t))
    lines = [
        f"ptype topology @ {snapshot.get('ts')} — "
        f"{sum(len(v) for v in domains.values())} placed replicas "
        f"in {len(domains)} domains ({len(nodes)} nodes, "
        f"{len(errors)} unreachable)",
        f"{'domain':<7} {'replicas':>9} {'active':>7} {'drng':>5} "
        f"{'q':>4} {'live':>5}",
    ]
    for d in sorted(domains):
        rows = domains[d]
        states = [_lifecycle_name(_gauge(t, "serve.lifecycle"))
                  for _, t in rows]
        q = sum(_gauge(t, "serve.queue_depth") or 0 for _, t in rows)
        live = sum(_gauge(t, "serve.active_slots") or 0
                   for _, t in rows)
        names = " ".join(k[:24] for k, _ in rows[:4])
        lines.append(
            f"{d:<7} {len(rows):>9} "
            f"{states.count('active'):>7} "
            f"{states.count('draining'):>5} {q:>4.0f} {live:>5.0f}  "
            f"{names}")
    if not domains:
        lines.append("  (no node exports serve.domain — flat fleet, "
                     "or replicas predate the topology story)")

    lines.append("")
    lines.append(f"{'node':<28} {'launches':>9} {'innerB':>9} "
                 f"{'outerB':>9} {'flatB':>9} {'slow%':>6}")
    any_legs = False
    for key in sorted(nodes)[:max_nodes]:
        t = nodes[key]
        launches = cnt(t, "collectives.hier_launches")
        if not launches:
            continue
        any_legs = True
        inner = cnt(t, "collectives.leg_bytes.inner") or 0
        outer = cnt(t, "collectives.leg_bytes.outer") or 0
        flat = cnt(t, "collectives.leg_bytes.flat_outer") or 0
        pct = 100.0 * outer / flat if flat else None
        lines.append(
            f"{key[:28]:<28} {launches:>9.0f} "
            f"{_fmt_bytes(inner):>9} {_fmt_bytes(outer):>9} "
            f"{_fmt_bytes(flat):>9} {num(pct, '{:.1f}'):>6}")
    if not any_legs:
        lines.append("  (no hierarchical collective launches — flat "
                     "axis everywhere)")

    lines.append("")
    loc = sum(cnt(t, "serve.migrate.local_domain") or 0
              for t in nodes.values())
    x = sum(cnt(t, "serve.migrate.cross_domain") or 0
            for t in nodes.values())
    tot = loc + x
    tail = (f" ({100.0 * x / tot:.1f}% crossing the slow leg)"
            if tot else "")
    lines.append(f"KV migrations: {loc:.0f} local-domain, "
                 f"{x:.0f} cross-domain{tail}")
    for key in sorted(errors)[:8]:
        lines.append(f"{key[:28]:<28} UNREACHABLE ({errors[key]})")
    lines.append("")
    alerts = list(alerts)
    if alerts:
        lines.append(f"ALERTS ({len(alerts)} recent):")
        for a in alerts[-12:]:
            ts = time.strftime("%H:%M:%S", time.localtime(a.ts))
            lines.append(
                f"  {ts} [{a.severity:<4}] {a.rule:<14} "
                f"{a.node[:28]:<28} {a.message}")
    else:
        lines.append("no alerts")
    return "\n".join(lines)


def render_jit(snapshot: dict, alerts=(), max_nodes: int = 32,
               max_fns: int = 12) -> str:
    """``obs jit``: the dispatch-discipline one-pager —
    per-node compile/recompile totals from the jitwatch seam (the
    kernel build cache: ``jit.compiles``/``jit.recompiles`` counters,
    sampled into series) plus the per-function ``jit.fn.*`` recompile books, worst
    offender first. A node with no ``jit.*`` families is disarmed
    (``PTYPE_JITWATCH=1`` arms it) — shown so an operator chasing a
    recompile-storm page can tell 'quiet' from 'blind'."""
    nodes = snapshot.get("nodes", {})
    errors = snapshot.get("errors", {})

    def cnt(t, name):
        return t.get("metrics", {}).get("counters", {}).get(name)

    armed = {k: t for k, t in nodes.items()
             if cnt(t, "jit.compiles") is not None
             or (t.get("series") or {}).get("jit.recompiles")}
    lines = [
        f"ptype jit @ {snapshot.get('ts')} — {len(armed)} armed "
        f"nodes ({len(nodes)} nodes, {len(errors)} unreachable)",
        f"{'node':<28} {'compiles':>9} {'recomp':>7} {'sanct':>6} "
        f"{'worst offender':<32}",
    ]

    def num(v, fmt="{:.0f}", dash="-"):
        return fmt.format(v) if v is not None else dash

    for key in sorted(armed)[:max_nodes]:
        t = armed[key]
        fns = []
        for name, val in (t.get("metrics", {})
                          .get("gauges", {})).items():
            if name.startswith("jit.fn."):
                fns.append((name[len("jit.fn."):], val))
        for name, pts in (t.get("series") or {}).items():
            if name.startswith("jit.fn.") and pts:
                fn = name[len("jit.fn."):]
                if not any(f == fn for f, _ in fns):
                    fns.append((fn, pts[-1][1]))
        fns.sort(key=lambda kv: -kv[1])
        worst = (f"{fns[0][0]} ({fns[0][1]:.0f}x)" if fns else "-")
        lines.append(
            f"{key[:28]:<28} {num(cnt(t, 'jit.compiles')):>9} "
            f"{num(cnt(t, 'jit.recompiles')):>7} "
            f"{num(cnt(t, 'jit.sanctioned_transfers')):>6} "
            f"{worst[:32]:<32}")
        for fn, val in fns[1:max_fns]:
            lines.append(f"  {fn[:40]:<40} {val:>6.0f}x")
    if not armed:
        lines.append("  (no node exports jit.* — arm the watchdog "
                     "with PTYPE_JITWATCH=1 or jitwatch.enable())")
    for key in sorted(errors)[:8]:
        lines.append(f"{key[:28]:<28} UNREACHABLE ({errors[key]})")
    lines.append("")
    alerts = list(alerts)
    if alerts:
        lines.append(f"ALERTS ({len(alerts)} recent):")
        for a in alerts[-12:]:
            ts = time.strftime("%H:%M:%S", time.localtime(a.ts))
            lines.append(
                f"  {ts} [{a.severity:<4}] {a.rule:<14} "
                f"{a.node[:28]:<28} {a.message}")
    else:
        lines.append("no alerts")
    return "\n".join(lines)


def run_jit(registry, iters: int = 0, interval_s: float = 2.0,
            engine: AlertEngine | None = None,
            services: list[str] | None = None,
            include_local: bool = False, out=None,
            clear: bool = True) -> AlertEngine:
    """The ``obs jit`` loop: :func:`run_top`'s poll contract with the
    dispatch-discipline rendering (the recompile-storm rule fires off
    the same snapshot)."""
    return run_top(registry, iters=iters, interval_s=interval_s,
                   engine=engine, services=services,
                   include_local=include_local, out=out, clear=clear,
                   render=render_jit)


def run_scale(registry, iters: int = 0, interval_s: float = 2.0,
              engine: AlertEngine | None = None,
              services: list[str] | None = None,
              include_local: bool = False, out=None,
              clear: bool = True) -> AlertEngine:
    """The ``obs scale`` loop: :func:`run_top`'s poll contract with
    the elastic-fleet rendering."""
    return run_top(registry, iters=iters, interval_s=interval_s,
                   engine=engine, services=services,
                   include_local=include_local, out=out, clear=clear,
                   render=render_scale)


def run_traffic(registry, iters: int = 0, interval_s: float = 2.0,
                engine: AlertEngine | None = None,
                services: list[str] | None = None,
                include_local: bool = False, out=None,
                clear: bool = True) -> AlertEngine:
    """The ``obs traffic`` loop: :func:`run_top`'s poll contract with
    the traffic-plane rendering (the capacity-headroom rule fires off
    the same snapshot)."""
    return run_top(registry, iters=iters, interval_s=interval_s,
                   engine=engine, services=services,
                   include_local=include_local, out=out, clear=clear,
                   render=render_traffic)


def run_topo(registry, iters: int = 0, interval_s: float = 2.0,
             engine: AlertEngine | None = None,
             services: list[str] | None = None,
             include_local: bool = False, out=None,
             clear: bool = True) -> AlertEngine:
    """The ``obs topo`` loop: :func:`run_top`'s poll contract with
    the topology rendering (domain placement, per-leg wire traffic,
    migration locality)."""
    return run_top(registry, iters=iters, interval_s=interval_s,
                   engine=engine, services=services,
                   include_local=include_local, out=out, clear=clear,
                   render=render_topo)


def run_serve(registry, iters: int = 0, interval_s: float = 2.0,
              engine: AlertEngine | None = None,
              services: list[str] | None = None,
              include_local: bool = False, out=None,
              clear: bool = True) -> AlertEngine:
    """The ``obs serve`` loop: :func:`run_top`'s poll contract with
    the serving-plane rendering (the serving rules fire off the same
    snapshot either way)."""
    return run_top(registry, iters=iters, interval_s=interval_s,
                   engine=engine, services=services,
                   include_local=include_local, out=out, clear=clear,
                   render=render_serve)


def run_top(registry, iters: int = 0, interval_s: float = 2.0,
            engine: AlertEngine | None = None,
            services: list[str] | None = None,
            include_local: bool = False, out=None,
            clear: bool = True, render=None) -> AlertEngine:
    """The ``obs top`` loop: pull, evaluate, repaint. ``iters=0``
    runs until KeyboardInterrupt (the caller catches it); tests pass
    ``iters=1`` and a capture ``out``. ``render`` swaps the view
    (:func:`render_serve` for ``obs serve``) without forking the
    loop. Returns the engine so callers can inspect the alert
    history."""
    from ptype_tpu_torch import telemetry as telemetry_mod

    render = render if render is not None else render_top
    write = out if out is not None else sys.stdout.write
    engine = engine if engine is not None else AlertEngine()
    tick = threading.Event()
    n = 0
    while True:
        snap = telemetry_mod.cluster_snapshot(
            registry, services=services, include_local=include_local)
        engine.evaluate(snap)
        prefix = CLEAR if clear else ""
        write(prefix + render(snap, engine.recent()) + "\n")
        n += 1
        if iters and n >= iters:
            return engine
        tick.wait(interval_s)
