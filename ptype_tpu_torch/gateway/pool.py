"""Replica pool: the gateway's live map of the serving fleet — the
port's copy of ``ptype_tpu/gateway/pool.py``.

One :class:`Replica` per registry node of the fronted service, each
owning its own multiplexed connection (dialed through the same
``rpc._dial`` seam the balancer uses, so the in-process zero-copy fast
path and the ``rpc.dial`` chaos site both apply). Every connection
decodes its replies onto the pool's ``device`` (``resolve_device``:
``cuda`` unless named). Two background threads keep the map honest:

- the **watch thread** consumes the registry's snapshot stream
  (``watch_service`` → :meth:`NodeWatch.latest`, so churn bursts
  collapse to the final membership) and adds/removes replicas;
- the **probe thread** runs active health checks: an ``Info()``
  round-trip per replica per interval, feeding a per-replica EWMA
  latency and the replica-reported ``in_flight``/``queue_depth``
  (the engines export them). ``eviction_threshold`` consecutive probe
  failures evict the replica (connection closed, no traffic routed);
  every later round re-dials, so a recovered replica is revived
  without operator action. Probes also drain the paged engine's
  recent per-request TTFT samples (``ttft_recent`` in ``Info()``,
  sequence-tagged) into the ``on_ttft`` callback — the gateway's SLO
  tracker folds them, so its fleet-level TTFT percentiles are fed
  from real per-request samples rather than a replica percentile of
  percentiles; the high-water mark per replica keeps overlapping
  probe windows from double-counting.

Routing (:meth:`pick`) replaces the RPC plane's blind round-robin:

- **least-loaded** — lowest estimated completion time: (locally
  tracked in-flight + replica-reported backlog + 1) × EWMA service
  latency, so a slow OR backed-up replica sheds traffic to its healthy
  siblings instead of serializing callers behind it;
- **prefix-affinity** (optional) — requests carrying an affinity key
  hash (FNV-1a, the balancer's own function) to a stable replica so
  its KV/prefix caches stay warm, UNLESS that replica's load exceeds
  the least-loaded choice by more than ``affinity_slack`` — affinity
  must never pin traffic to a wedged node.

Chaos seams: ``gateway.probe`` (``drop``/``timeout`` — fail this probe,
``delay`` — slow it) and ``gateway.route`` (``drop`` — veto the picked
replica, forcing the route elsewhere; ``delay``).
"""

from __future__ import annotations

import threading

from ptype_tpu_torch import chaos, lockcheck, logs, retry, threadpool
from ptype_tpu_torch import rpc as rpc_mod
from ptype_tpu_torch.gateway.slo import Stopwatch
from ptype_tpu_torch.registry import Node, Registry

log = logs.get_logger("gateway.pool")


class Replica:
    """One fleet member: connection, load estimate, health state."""

    def __init__(self, node: Node):
        self.node = node
        self.key = f"{node.address}:{node.port}"
        self.conn = None
        self.inflight = 0          # locally dispatched, not yet done
        #: EWMA of CALL latencies only. 0.0 = never called.
        self.ewma_ms = 0.0
        #: EWMA of probe (Info) round-trips, kept SEPARATE: probes are
        #: cheap control-plane calls, and folding their ~1 ms RTTs into
        #: the call EWMA would decay a degraded replica's slow-call
        #: signal back to "fast" between requests.
        self.probe_ms = 0.0
        self.reported: dict = {}   # last Info() payload
        #: High-water ``ttft_recent`` sequence already drained — the
        #: replica's ledger tags samples so probes never double-count.
        self.ttft_seen = 0
        self.fails = 0             # consecutive probe failures
        self.up = False
        self.dialing = False       # one (re)dial in flight at a time
        self.calls = 0
        self.lock = lockcheck.lock("gateway.pool.replica")

    def score(self) -> float:
        """Estimated ms until this replica would finish MY request:
        (backlog ahead of me + me) × EWMA service time. Lower =
        preferred. A scalar, not (backlog, latency) lexicographic — a
        tuple would route to an idle-but-slow replica over a
        busy-but-fast one, which is exactly the slow-replica trap
        least-loaded routing exists to avoid. The latency estimate is
        the WORSE of the call and probe EWMAs: calls catch a replica
        whose compute degraded but whose Info stays fast; probes catch
        one that is slow before it has served any call."""
        with self.lock:
            backlog = self.inflight + int(
                self.reported.get("queue_depth", 0) or 0)
            return (backlog + 1) * max(self.ewma_ms, self.probe_ms, 1.0)

    def observe_ms(self, ms: float, alpha: float) -> None:
        with self.lock:
            self.ewma_ms = (ms if self.ewma_ms == 0.0
                            else alpha * ms + (1 - alpha) * self.ewma_ms)

    def observe_probe_ms(self, ms: float, alpha: float) -> None:
        with self.lock:
            self.probe_ms = (ms if self.probe_ms == 0.0
                             else alpha * ms + (1 - alpha) * self.probe_ms)

    def kv_free_blocks(self) -> int | None:
        """Replica-reported paged-KV admission headroom (None: the
        replica doesn't run the paged engine / hasn't been probed).
        The affinity router yields past an exhausted pool — an
        affinity hit that sheds is worse than a cold miss elsewhere."""
        with self.lock:
            v = self.reported.get("kv_free_blocks")
            return None if v is None else int(v)

    def lifecycle(self) -> str | None:
        """Replica-reported lifecycle (spawning/warm/active/draining,
        surfaced through ``Info()``). None until a probe observes it. A draining
        replica sheds every new request typed, so routing sorts it
        last and affinity yields past it — the same treatment as an
        exhausted KV pool."""
        with self.lock:
            v = self.reported.get("lifecycle")
            return None if v is None else str(v)

    def serve_class(self) -> str | None:
        """Replica-reported serving class (``prefill`` / ``decode`` /
        ``unified``). None until a probe observes it —
        the two-stage router treats an unclassed replica as unified
        (it serves every endpoint, classes are advisory)."""
        with self.lock:
            v = self.reported.get("serve_class")
            return None if v is None else str(v)

    def domain(self) -> int | None:
        """Topology domain this replica lives in (the fast-link island,
        parallel/topology.py). The registry advertisement
        (``node.metadata["domain"]``, stamped by the launcher) wins;
        else the probe-reported value; None when neither side is
        topology-aware — the whole fleet then shares one implicit
        domain and every locality preference is a no-op."""
        meta = getattr(self.node, "metadata", None) or {}
        v = meta.get("domain")
        if v is None:
            with self.lock:
                v = self.reported.get("domain")
        try:
            return None if v is None else int(v)
        except (TypeError, ValueError):
            return None

    def kv_evictions(self) -> int | None:
        """Replica-reported cumulative LRU eviction count
        (``kv_evictions`` in ``BlockPool.stats``): the prefix
        directory's coherence signal — any movement drops the
        replica's directory entries before the router trusts them."""
        with self.lock:
            v = self.reported.get("kv_evictions")
            return None if v is None else int(v)

    def reported_float(self, key: str) -> float | None:
        """One probe-reported numeric field, or None (absent replica
        surface / malformed value) — the per-class scale hints read
        ledger tails (``tpot_p99_ms``) through this."""
        with self.lock:
            v = self.reported.get(key)
        try:
            return None if v is None else float(v)
        except (TypeError, ValueError):
            return None

    def snapshot(self) -> dict:
        dom = self.domain()  # resolved before taking the lock
        with self.lock:
            snap = {"key": self.key, "up": self.up,
                    "inflight": self.inflight, "calls": self.calls,
                    "ewma_ms": round(max(self.ewma_ms, self.probe_ms),
                                     3),
                    "call_ewma_ms": round(self.ewma_ms, 3),
                    "probe_ewma_ms": round(self.probe_ms, 3),
                    "fails": self.fails,
                    "reported_queue_depth":
                        int(self.reported.get("queue_depth", 0) or 0),
                    "reported_in_flight":
                        int(self.reported.get("in_flight", 0) or 0)}
            # Lifecycle column: only when reported, so a bare actor
            # with no lifecycle story stays distinguishable.
            if "lifecycle" in self.reported:
                snap["lifecycle"] = str(self.reported["lifecycle"])
            # Serving class + migration counters: the
            # disaggregated-fleet view — only when reported, same as
            # lifecycle, so pre-disagg replicas render "-".
            if "serve_class" in self.reported:
                snap["serve_class"] = str(self.reported["serve_class"])
            for k in ("migrations", "migrate_bytes",
                      "migrate_dedup_hits", "migrate_inflight"):
                if k in self.reported:
                    snap[k] = int(self.reported[k] or 0)
            # Paged-engine load signal: pool headroom and
            # prefix-cache effectiveness, when the replica reports it.
            if "kv_free_blocks" in self.reported:
                snap["kv_free_blocks"] = int(
                    self.reported["kv_free_blocks"] or 0)
            if "prefix_hit_rate" in self.reported:
                snap["prefix_hit_rate"] = float(
                    self.reported["prefix_hit_rate"] or 0.0)
            # Speculative-decoding accept rate: reported
            # only by spec-armed replicas, so a collapsed rate is
            # visible fleet-wide without faking 0.0 on the rest.
            if "spec_accept_rate" in self.reported:
                snap["spec_accept_rate"] = float(
                    self.reported["spec_accept_rate"] or 0.0)
            # Topology domain: per-domain replica counts — only when
            # advertised.
            if dom is not None:
                snap["domain"] = dom
            return snap


class ReplicaPool:
    """Watch + probe + route over every replica of one service."""

    def __init__(self, registry: Registry, service: str,
                 info_method: str = "Generator.Info",
                 probe_interval: float = 1.0,
                 probe_timeout: float = 2.0,
                 eviction_threshold: int = 3,
                 ewma_alpha: float = 0.3,
                 dial_timeout: float = 2.0,
                 affinity_slack: float = 3.0,
                 on_change=None, on_ttft=None, device=None):
        self.service = service
        #: Where every connection's reply tensors land (the gateway's
        #: device; resolved at the first reply that holds a tensor).
        self.device = device
        self.info_method = info_method
        self.probe_interval = probe_interval
        self.probe_timeout = probe_timeout
        self.eviction_threshold = int(eviction_threshold)
        self.ewma_alpha = ewma_alpha
        self.dial_timeout = dial_timeout
        self.affinity_slack = float(affinity_slack)
        self._on_change = on_change or (lambda: None)
        #: ``on_ttft(ttft_ms)`` per NEW replica-reported per-request
        #: TTFT sample (the gateway wires SLOTracker.record_ttft).
        self._on_ttft = on_ttft
        self._lock = lockcheck.lock("gateway.pool.fleet")
        self._replicas: dict[str, Replica] = {}
        self._closed = threading.Event()
        self._watch = registry.watch_service(service)
        # First snapshot synchronously (the registry pushes one
        # immediately): the gateway is routable the moment it
        # constructs, instead of racing its first request against the
        # watch thread.
        initial = self._watch.latest(timeout=2.0)
        if initial:
            self._sync(initial)
            self.probe_now()
        self._watch_thread = threading.Thread(
            target=self._watch_loop, name=f"gw-watch-{service}",
            daemon=True)
        self._watch_thread.start()
        self._probe_thread = threading.Thread(
            target=self._probe_loop, name=f"gw-probe-{service}",
            daemon=True)
        self._probe_thread.start()

    # --------------------------------------------------------- membership

    def _watch_loop(self) -> None:
        while not self._closed.is_set():
            snap = self._watch.latest(timeout=0.5)
            if snap is None:
                if self._watch.closed:
                    return
                continue
            self._sync(snap)
            self.probe_now()

    def _sync(self, nodes: list[Node]) -> None:
        wanted = {f"{n.address}:{n.port}": n for n in nodes}
        dropped: list[Replica] = []
        with self._lock:
            for key in list(self._replicas):
                if key not in wanted:
                    dropped.append(self._replicas.pop(key))
            for key, node in wanted.items():
                if key not in self._replicas:
                    self._replicas[key] = Replica(node)
        for r in dropped:
            self._close_conn(r)
            log.info("replica left the fleet", kv={"replica": r.key})
        self._on_change()

    # ------------------------------------------------------------- probes

    def _probe_loop(self) -> None:
        bo = retry.Backoff(base=self.probe_interval,
                           cap=self.probe_interval, jitter=0.25)
        while not self._closed.is_set():
            bo.wait(self._closed)
            if self._closed.is_set():
                return
            self.probe_now()

    def probe_now(self) -> None:
        """One probe round over the whole fleet (also the re-dial
        path: an evicted replica that answers again is revived).
        Probes run CONCURRENTLY — one blackholed node must not stretch
        the whole fleet's round by its dial timeout, staling the load
        data routing depends on. The bounded join keeps rounds from
        stacking; a straggler past it finishes in the background
        (per-replica ``dialing`` serializes re-dials, and a probe that
        loses the race with close() discards its connection)."""
        reps = [r for r in self._snapshot_replicas()]
        if not reps or self._closed.is_set():
            return
        if len(reps) == 1:
            self._probe_one(reps[0])
            return
        probes = threadpool.Group()
        for r in reps:
            probes.spawn(self._probe_one, r)
        probes.wait(self.dial_timeout + self.probe_timeout + 1.0)

    def _probe_one(self, r: Replica) -> None:
        f = chaos.hit("gateway.probe", r.key)
        if f is not None:
            if f.action == "delay":
                f.sleep()
            elif f.action in ("drop", "timeout"):
                self._probe_failed(r, f"chaos: probe {f.action}")
                return
        conn = self._ensure_conn(r)
        if conn is None:
            self._probe_failed(r, "dial failed")
            return
        sw = Stopwatch()
        fut = None
        try:
            fut = conn.call_async(self.info_method, ())
            info = fut.result(timeout=self.probe_timeout)
        except Exception as e:  # noqa: BLE001 — any failure = unhealthy
            if fut is not None:
                conn.forget(fut)
            self._probe_failed(r, str(e))
            return
        ms = sw.ms()
        was_down = not r.up
        fresh: list[float] = []
        with r.lock:
            r.reported = dict(info) if isinstance(info, dict) else {}
            r.fails = 0
            r.up = True
            if self._on_ttft is not None:
                fresh = self._drain_ttft_locked(r)
        r.observe_probe_ms(ms, self.ewma_alpha)
        for sample_ms in fresh:
            try:
                self._on_ttft(sample_ms)
            except Exception:  # noqa: BLE001 — observer must not
                pass           # poison the probe loop
        if was_down:
            chaos.note_ok("gateway.probe", r.key)
            log.info("replica healthy", kv={"replica": r.key,
                                            "probe_ms": round(ms, 1)})
            self._on_change()

    def _drain_ttft_locked(self, r: Replica) -> list[float]:
        """NEW (seq > high-water) per-request TTFT samples from the
        replica's just-stored ``Info()``; caller holds ``r.lock``."""
        raw = r.reported.get("ttft_recent")
        if not isinstance(raw, (list, tuple)):
            return []
        pairs: list[tuple[int, float]] = []
        for item in raw:
            try:
                pairs.append((int(item[0]), float(item[1])))
            except Exception:  # noqa: BLE001 — any malformed item
                continue       # (wrong shape/type) is just skipped
        if pairs and max(s for s, _ in pairs) < r.ttft_seen:
            # Every reported seq is BELOW the high-water mark: the
            # replica restarted with a fresh ledger (same registry
            # key, seq counter back at 1). Reset, or its post-restart
            # samples would be dropped until the new seq caught up.
            r.ttft_seen = 0
        fresh: list[float] = []
        for seq, sample_ms in pairs:
            if seq > r.ttft_seen:
                r.ttft_seen = seq
                fresh.append(sample_ms)
        return fresh

    def _probe_failed(self, r: Replica, why: str) -> None:
        with r.lock:
            r.fails += 1
            evict = r.up and r.fails >= self.eviction_threshold
            if evict:
                r.up = False
        if evict:
            self._close_conn(r)
            log.warning("replica evicted",
                        kv={"replica": r.key, "fails": r.fails,
                            "err": why})
            self._on_change()

    def _ensure_conn(self, r: Replica):
        conn = r.conn
        if conn is not None and conn.healthy:
            return conn
        with r.lock:
            if r.dialing:
                return None  # a concurrent probe owns the re-dial
            r.dialing = True
        try:
            self._close_conn(r)
            try:
                conn = rpc_mod._dial(r.node, self.dial_timeout,
                                     self.device)
            except OSError:
                return None
            with r.lock:
                r.conn = conn
        finally:
            with r.lock:
                r.dialing = False
        if self._closed.is_set():
            # Lost the race with close(): its sweep may already have
            # run — never leave a live socket + reader thread behind.
            self._close_conn(r)
            return None
        return conn

    def _close_conn(self, r: Replica) -> None:
        with r.lock:
            conn, r.conn = r.conn, None
        if conn is not None:
            conn.close()

    # ------------------------------------------------------------ routing

    def _snapshot_replicas(self) -> list[Replica]:
        with self._lock:
            return list(self._replicas.values())

    def healthy(self) -> list[Replica]:
        return [r for r in self._snapshot_replicas()
                if r.up and r.conn is not None and r.conn.healthy]

    def n_healthy(self) -> int:
        return len(self.healthy())

    def healthy_class(self, serve_class: str) -> list[Replica]:
        """Healthy replicas of one serving class. Falls
        back to ALL healthy replicas when none report the class —
        classes are advisory (every engine serves every endpoint), so
        a unified fleet keeps serving when the operator asks for a
        class it never deployed."""
        reps = self.healthy()
        cls = [r for r in reps if r.serve_class() == serve_class]
        return cls or reps

    def pick(self, affinity_key: str | None = None,
             exclude=(),
             serve_class: str | None = None,
             prefer_domain: int | None = None) -> Replica | None:
        """Route one request: affinity first (when sane), else least
        loaded. None when the fleet has no healthy replica.

        ``exclude`` (replica keys) steers a RE-route away from
        replicas that already failed this request — when every healthy
        replica has failed it, exclusion lapses (retrying someone
        beats shedding with survivors idle).

        ``serve_class`` narrows to one serving class —
        softly, via :meth:`healthy_class`: the two-stage router's
        prefill/decode picks, degrading to the whole fleet when no
        replica reports the class.

        ``prefer_domain`` is the locality preference: a
        replica in that topology domain beats any out-of-domain score
        (its KV/prefix traffic stays on the fast intra-domain leg),
        but never a replica that can't serve — draining and
        KV-exhausted still sort last, and a domain with no healthy
        member degrades to the whole fleet. Affinity hashing is
        likewise restricted to the in-domain stable set when one
        exists, so a key's pinned replica is local when it can be."""
        candidates = (self.healthy() if serve_class is None
                      else self.healthy_class(serve_class))
        if not candidates:
            return None
        if exclude:
            fresh = [r for r in candidates if r.key not in exclude]
            if fresh:
                candidates = fresh
        # A DRAINING replica (lifecycle) and an exhausted KV
        # pool (kv_free_blocks == 0) both sort LAST: any request
        # routed there earns a typed shed, so a replica that can
        # actually serve wins at any latency score; replicas that
        # report neither signal are unaffected.
        candidates.sort(key=lambda r: (r.lifecycle() == "draining",
                                       r.kv_free_blocks() == 0,
                                       prefer_domain is not None
                                       and r.domain() is not None
                                       and r.domain() != prefer_domain,
                                       r.score(), r.key))
        chosen = candidates[0]
        if affinity_key is not None and len(candidates) > 1:
            stable = sorted(candidates, key=lambda r: r.key)
            if prefer_domain is not None:
                local = [r for r in stable
                         if r.domain() == prefer_domain]
                if local:
                    stable = local
            pinned = stable[rpc_mod.fnv32a(affinity_key) % len(stable)]
            # Affinity yields to load: a warm prefix cache is worth a
            # bounded cost multiple, not a wedged replica. It also
            # yields when the pinned replica's KV block pool is
            # EXHAUSTED (kv_free_blocks == 0, the paged engine's
            # admission headroom): routing there earns a typed shed,
            # not a cache hit — a cold miss on a replica with room
            # strictly beats it.
            # ... and when the pinned replica is DRAINING: its warm
            # prefix cache is about to be freed anyway, and every
            # request routed there sheds.
            exhausted = (pinned.kv_free_blocks() == 0
                         or pinned.lifecycle() == "draining")
            if (not exhausted
                    and pinned.score()
                    <= chosen.score() * self.affinity_slack + 10.0):
                chosen = pinned
        f = chaos.hit("gateway.route", chosen.key)
        if f is not None:
            if f.action == "delay":
                f.sleep()
            elif f.action == "drop":
                rest = [r for r in candidates if r is not chosen]
                return rest[0] if rest else None
        return chosen

    def begin(self, r: Replica) -> None:
        with r.lock:
            r.inflight += 1
            r.calls += 1

    def done(self, r: Replica, ms: float | None = None,
             ok: bool = True) -> None:
        with r.lock:
            r.inflight = max(0, r.inflight - 1)
        if ok and ms is not None:
            r.observe_ms(ms, self.ewma_alpha)

    def fail(self, r: Replica, why: str = "") -> None:
        """A dispatch failed on transport: count it like a probe
        failure so repeated call failures evict without waiting for
        ``eviction_threshold`` probe rounds."""
        with r.lock:
            r.inflight = max(0, r.inflight - 1)
        self._probe_failed(r, why or "call transport failure")

    # --------------------------------------------------------- inspection

    def min_ewma_ms(self) -> float:
        obs = [r.ewma_ms for r in self.healthy() if r.ewma_ms > 0]
        return min(obs) if obs else 0.0

    def status(self) -> dict:
        reps = [r.snapshot() for r in self._snapshot_replicas()]
        return {"service": self.service,
                "replicas": sorted(reps, key=lambda d: d["key"]),
                "healthy": sum(1 for d in reps if d["up"])}

    def close(self) -> None:
        if self._closed.is_set():
            return
        self._closed.set()
        self._watch.cancel()
        # Join the loops (bounded) BEFORE sweeping connections: a
        # probe mid-dial could otherwise install a fresh conn (and its
        # reader thread) after the sweep — the wedged-thread leak the
        # chaos soak's teardown invariant exists to catch. A straggler
        # that outlives the join is covered by _ensure_conn's
        # closed-check, which discards its connection.
        for t in (self._probe_thread, self._watch_thread):
            if t is not threading.current_thread():
                t.join(timeout=self.dial_timeout + self.probe_timeout
                       + 2.0)
        for r in self._snapshot_replicas():
            self._close_conn(r)
