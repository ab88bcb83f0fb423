"""The inference gateway: one frontdoor for a fleet of generator actors
— the port's copy of ``ptype_tpu/gateway/frontdoor.py``.

``N`` :class:`~ptype_tpu_torch.serve.GeneratorActor` (or paged engine)
replicas registered under one service name are independent processes
to the RPC plane; the gateway turns them into ONE service (a frontdoor
that queues and dispatches while the accelerator engines stay
saturated):

- requests pass **admission control** (bounded queue, per-request
  deadlines, SLO-aware shedding with typed
  :class:`~ptype_tpu_torch.errors.ShedError` + retry-after) before any
  replica is touched;
- the **replica pool** routes each admitted request least-loaded (or
  prefix-affine), retries transport failures on surviving replicas
  within the deadline, and evicts/revives the dead;
- every outcome feeds the **SLO tracker**: p50/p95/p99, tokens/sec,
  shed rate, and a :meth:`scale_hint` the elastic layer can consume.

Deployment shapes:

- **library**: construct in the caller's process over any Registry
  (``InferenceGateway(cluster.registry)``), call
  :meth:`generate`/:meth:`call`;
- **service**: wrap in :class:`GatewayActor`, register it on an
  ActorServer under e.g. ``llm-gw`` — thin clients then speak plain
  actor RPC to the gateway tier, and sheds ride the wire typed
  (actor.py marshalling, rpc.py no-retry contract);
- **picker injection**: a process that must keep its plain
  :class:`~ptype_tpu_torch.rpc.Client` can still route load-aware by
  plugging :func:`least_loaded_picker` into ``ConnConfig.picker``.

Device rules of the port: the gateway runs on ``device``
(``resolve_device``: ``cuda`` unless named, raising with no card and
none named). Every connection its pool dials decodes replies onto that
device, and ``generate`` answers an int32 tensor of shape
``(rows, max_new)`` on it from both paths. The gateway reads the host
once a reply (to count its tokens) and takes a prompt's shape from
``.shape`` alone; the disaggregated path builds its answer from the
decode replica's token list on the host and uploads it once.
"""

from __future__ import annotations

import time
from concurrent.futures import TimeoutError as FuturesTimeoutError
from dataclasses import dataclass

import numpy as np
import torch

from ptype_tpu_torch import chaos, logs, retry, trace
from ptype_tpu_torch import metrics as metrics_mod
from ptype_tpu_torch.device import resolve_device
from ptype_tpu_torch.errors import (NoClientAvailableError, RemoteError,
                                    RPCError, ShedError)
from ptype_tpu_torch.gateway.admission import AdmissionQueue
from ptype_tpu_torch.gateway.directory import PrefixDirectory
from ptype_tpu_torch.gateway.pool import ReplicaPool
from ptype_tpu_torch.gateway.slo import ScaleHint, SLOTracker, Stopwatch
from ptype_tpu_torch.registry import Registry

log = logs.get_logger("gateway")


@dataclass
class GatewayConfig:
    """SLO and fleet knobs."""

    #: Waiting-room bound; arrivals past it are shed with retry-after.
    max_queue_depth: int = 64
    #: Deadline applied when the caller passes none.
    default_deadline_s: float = 30.0
    #: Concurrent dispatches allowed per healthy replica. 1 matches the
    #: lock-serialized GeneratorActor; raise it for the batching /
    #: continuous engines, which turn concurrency into batch occupancy.
    per_replica_inflight: int = 1
    #: Active health probe cadence / budget (Info round-trips).
    probe_interval_s: float = 1.0
    probe_timeout_s: float = 2.0
    #: Consecutive probe failures before a replica is evicted.
    eviction_threshold: int = 3
    #: EWMA weight for per-replica latency observations.
    ewma_alpha: float = 0.3
    #: Dial budget for (re)connecting to a replica.
    dial_timeout_s: float = 2.0
    #: Transport-failure re-routes allowed per request (each lands on a
    #: different replica when one exists; all bounded by the deadline).
    max_reroutes: int = 2
    #: Prefix-affinity: how many times costlier (estimated completion
    #: ms) the affine replica may be than the least-loaded choice
    #: before affinity yields to load.
    affinity_slack: float = 3.0
    #: Endpoint names on the replica actors.
    generate_method: str = "Generator.Generate"
    info_method: str = "Generator.Info"
    #: Optional p99 target feeding the scale hint (None = no SLO term).
    slo_p99_ms: float | None = None
    #: Optional TTFT p99 target (ms). Fed from replica-reported
    #: per-request samples (the serving ledger's ``ttft_recent``,
    #: drained by the pool's probes); a breach outranks the e2e p99
    #: term in the scale hint — prompt-heavy overload blows the first
    #: token long before the e2e tail moves.
    slo_ttft_p99_ms: float | None = None
    #: Rolling window for shed-rate / tokens-per-sec readouts.
    stats_window_s: float = 30.0
    #: Disaggregated serving: route single-row generates
    #: through the two-stage prefill→decode path — prefill-class pick
    #: fills the KV blocks, a decode-class pick (steered by the
    #: prefix directory) imports them over the quantized wire and
    #: owns the decode lifetime. Any migration failure falls back to
    #: plain Generate on the decode replica (local prefill): slower,
    #: never lost.
    disagg: bool = False
    #: KV wire encoding for migrations: ``q8`` (int8 + error-feedback
    #: residuals, ~4x less wire) or ``exact`` (raw dtype — the
    #: bit-exactness escape hatch parity tests pin against).
    kv_wire: str = "q8"
    #: Per-replica entry bound in the global prefix directory.
    directory_blocks: int = 4096
    #: Optional decode-side TPOT p99 target (ms) feeding the
    #: decode-class scale hint (prefill scales on queue/TTFT, decode
    #: on KV headroom and inter-token tail).
    slo_tpot_p99_ms: float | None = None
    #: This gateway's own topology domain (parallel/topology.py): the
    #: locality preference carried into every routing pick — replicas
    #: advertising the same domain win over out-of-domain scores,
    #: affinity hashes within the local stable set, and the per-class
    #: scale hints ask for this domain to fill first. None =
    #: topology-blind routing.
    domain: int | None = None


def _host(x) -> np.ndarray:
    """A reply or prompt as a host array: one device-to-host read for a
    tensor (wherever it lies), none for host data."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _count_generated(result, stop_token: int) -> int:
    """Generated tokens in one ``Generate`` reply ``(B, max_new)``:
    each row ends at its first ``stop_token`` (inclusive — the engine
    emits it) or runs the full width; the pad tail after an early stop
    is NOT generated throughput. Reads the host once a reply, and
    counts every row at once."""
    shape = getattr(result, "shape", None)
    shape = tuple(np.shape(result) if shape is None else shape)
    size = int(np.prod(shape))
    if len(shape) != 2 or stop_token < 0 or size == 0:
        return size
    hit = _host(result) == stop_token
    first = hit.argmax(axis=1) + 1
    return int(np.where(hit.any(axis=1), first, shape[1]).sum())


class InferenceGateway:
    """Admission → routing → dispatch for one generator service."""

    def __init__(self, registry: Registry, service: str = "llm",
                 cfg: GatewayConfig | None = None,
                 metrics_registry: metrics_mod.MetricsRegistry | None = None,
                 device=None):
        self.cfg = cfg or GatewayConfig()
        self.service = service
        #: Where replies land and answers are returned: ``cuda`` unless
        #: the caller names another device; raises with no card.
        self.device = resolve_device(device)
        self.slo = SLOTracker(service, registry=metrics_registry,
                              window_s=self.cfg.stats_window_s,
                              slo_p99_ms=self.cfg.slo_p99_ms,
                              slo_ttft_p99_ms=self.cfg.slo_ttft_p99_ms,
                              slo_tpot_p99_ms=self.cfg.slo_tpot_p99_ms)
        self.pool = ReplicaPool(
            registry, service,
            info_method=self.cfg.info_method,
            probe_interval=self.cfg.probe_interval_s,
            probe_timeout=self.cfg.probe_timeout_s,
            eviction_threshold=self.cfg.eviction_threshold,
            ewma_alpha=self.cfg.ewma_alpha,
            dial_timeout=self.cfg.dial_timeout_s,
            affinity_slack=self.cfg.affinity_slack,
            on_change=self._on_fleet_change,
            on_ttft=self.slo.record_ttft,
            device=self.device)
        self.admission = AdmissionQueue(
            self.cfg.max_queue_depth,
            capacity=self._capacity,
            est_service_s=self.slo.est_service_s)
        #: Fleet-wide KV residency index: chain hash →
        #: holders, content-verified; steers the decode pick so shared
        #: prefixes migrate once and dedup after.
        self.directory = PrefixDirectory(self.cfg.directory_blocks)
        self._mreg = (metrics_registry if metrics_registry is not None
                      else metrics_mod.metrics)
        self._closed = False

    # ----------------------------------------------------------- capacity

    def _capacity(self) -> int:
        return max(1, self.pool.n_healthy()) * self.cfg.per_replica_inflight

    def _on_fleet_change(self) -> None:
        # Revived/arrived replicas may have grown capacity: grant
        # queued waiters now rather than at the next release(). The
        # pool's own construction fires this before the admission
        # queue exists — nothing can be waiting yet, so skipping is
        # correct, not a race.
        admission = getattr(self, "admission", None)
        if admission is not None:
            admission.poke()
        pool = getattr(self, "pool", None)
        if pool is not None:
            self.slo.g_replicas.set(pool.n_healthy())

    # ------------------------------------------------------------- public

    def generate(self, prompt, max_new_tokens: int = 16, *,
                 deadline_s: float | None = None,
                 affinity_key: str | None = None, **gen_kwargs):
        """The serving call: admit, route, dispatch, account.

        Raises :class:`ShedError` (typed, with ``retry_after_s``) when
        overloaded or out of deadline; :class:`RemoteError` when the
        replica's handler itself failed. Transport failures re-route to
        surviving replicas inside the deadline.

        With ``cfg.disagg`` set, eligible requests (single row, no
        kwargs the migration endpoints don't carry) take the two-stage
        prefill→migrate→decode path instead; everything else keeps the
        interleaved path unchanged. Both answer an int32 tensor on the
        gateway's device.
        """
        if self.cfg.disagg and self._disagg_eligible(prompt,
                                                     gen_kwargs):
            return self._tokens(self._generate_disagg(
                prompt, int(max_new_tokens), deadline_s=deadline_s,
                affinity_key=affinity_key, **gen_kwargs))
        args = (prompt, int(max_new_tokens))
        stop_token = int(gen_kwargs.get("stop_token", -1))
        if gen_kwargs:
            # Positional tail matching GeneratorActor.Generate.
            order = ("temperature", "seed", "top_k", "top_p",
                     "stop_token", "pad_token", "repetition_penalty")
            defaults = {"temperature": 0.0, "seed": 0, "top_k": 0,
                        "top_p": 1.0, "stop_token": -1, "pad_token": 0,
                        "repetition_penalty": 1.0}
            unknown = set(gen_kwargs) - set(order)
            if unknown:
                raise TypeError(f"unknown generate kwargs: {unknown}")
            defaults.update(gen_kwargs)
            args = args + tuple(defaults[k] for k in order)
        return self._tokens(self.call(
            self.cfg.generate_method, *args,
            deadline_s=deadline_s, affinity_key=affinity_key,
            count_tokens=lambda out: _count_generated(out, stop_token)))

    def _tokens(self, out) -> torch.Tensor:
        """A Generate answer as the gateway returns it: int32 on the
        gateway's device (a replica's reply already lies there; a host
        array is uploaded once)."""
        return torch.as_tensor(out).to(self.device, torch.int32)

    def call(self, method: str, *args,
             deadline_s: float | None = None,
             affinity_key: str | None = None,
             count_tokens=None):
        """Generic gateway dispatch (Generate is sugar over this).

        The whole request runs inside a ``gateway.request`` span with
        ``gateway.admit`` / ``gateway.route`` / ``rpc.call`` children —
        one stitched trace from frontdoor to replica handler (served as
        a GatewayActor, the span parents under the caller's actor RPC
        trace automatically)."""
        deadline = time.monotonic() + (deadline_s if deadline_s is not None
                                       else self.cfg.default_deadline_s)
        with trace.span("gateway.request", service=self.service,
                        method=method):
            self.slo.arrived()
            qsw = Stopwatch()
            try:
                with trace.span("gateway.admit"):
                    self.admission.admit(key=affinity_key or method,
                                         deadline=deadline)
            except ShedError:
                self.slo.shed()
                self._export_gauges()
                trace.maybe_dump(f"shed at admission ({self.service})")
                raise
            queue_ms = qsw.ms()
            try:
                return self._dispatch(method, args, deadline,
                                      affinity_key, count_tokens,
                                      queue_ms=queue_ms)
            finally:
                self.admission.release()
                self._export_gauges()

    def _dispatch(self, method: str, args, deadline: float,
                  affinity_key: str | None, count_tokens=None,
                  queue_ms: float = 0.0):
        last_err: Exception | None = None
        reroutes = 0
        tried: set[str] = set()
        route_ms = 0.0
        bo = retry.Backoff(base=0.05, cap=0.5)
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            rsw = Stopwatch()
            with trace.span("gateway.route") as rsp:
                r = self.pool.pick(affinity_key, exclude=tried,
                                   prefer_domain=self.cfg.domain)
                rsp.set_attr("replica", r.key if r is not None else None)
            route_ms += rsw.ms()
            if r is None:
                # Fleet momentarily empty (mass eviction / churn):
                # wait a beat for probes to revive someone — the
                # deadline bounds the patience.
                last_err = NoClientAvailableError(
                    f"no healthy replicas for {self.service!r}")
                bo.sleep(min(bo.next_delay(), max(0.0, remaining)))
                continue
            conn = r.conn
            if conn is None or not conn.healthy:
                continue
            self.pool.begin(r)
            rpc_sw = Stopwatch()
            fut = None
            # The dispatch span: the traceparent injected by
            # call_async is this span, so the replica's handler span
            # parents under the exact attempt that carried it (the
            # gateway bypasses Client's retry loop, where the rpc.call
            # span normally lives).
            dsp = trace.span("rpc.call", method=method, replica=r.key)
            try:
                with dsp:
                    fut = conn.call_async(method, args)
                    result = fut.result(timeout=remaining)
            except ShedError as e:
                # The REPLICA shed (paged-engine backlog / KV pool
                # exhausted — serve.admit). It is healthy and answered
                # typed: don't evict (pool.fail would count it toward
                # eviction), re-route to a sibling with headroom; when
                # every option sheds, propagate the replica's typed
                # shed with its retry hint intact. Skip the EWMA
                # sample (ms=None): a ~1 ms shed round-trip would
                # collapse the replica's latency score and the base
                # least-loaded pick would PREFER the exhausted replica
                # until the next probe refresh.
                self.pool.done(r, None, ok=True)
                last_err = e
                tried.add(r.key)
                reroutes += 1
                if reroutes > self.cfg.max_reroutes:
                    self.slo.shed()
                    trace.add_event("gateway.shed",
                                    last_error=str(e)[:200])
                    raise
                continue
            except RemoteError as e:
                # The replica RAN the handler and it raised: an
                # application error, not a routing problem. The replica
                # is healthy (it answered) — account and propagate.
                self.pool.done(r, rpc_sw.ms(), ok=True)
                self.slo.errored()
                raise e
            except FuturesTimeoutError:
                conn.forget(fut)
                self.pool.fail(r, "deadline expired in flight")
                last_err = RPCError(
                    f"call {method!r} exceeded its deadline on {r.key}")
                break  # remaining is spent; no budget to re-route
            except Exception as e:  # noqa: BLE001 — transport failure
                if fut is not None:
                    conn.forget(fut)
                self.pool.fail(r, str(e))
                last_err = e
                tried.add(r.key)
                reroutes += 1
                if reroutes > self.cfg.max_reroutes:
                    break
                continue
            ms = rpc_sw.ms()
            self.pool.done(r, ms, ok=True)
            # Real generated-token count (not B × max_new with the
            # pad tail charged as throughput): Generate supplies a
            # stop-token-aware counter; generic calls keep the shape
            # heuristic so tokens_per_sec never lies upward.
            tokens = 0
            try:
                if count_tokens is not None:
                    tokens = int(count_tokens(result))
                else:
                    tokens = int(result.shape[0]) * int(result.shape[1])
            except (AttributeError, IndexError, TypeError, ValueError):
                pass
            # Stage split: the interleaved path cannot see
            # inside the replica, so the whole service leg is one
            # "rpc" stage; queue-wait and route are the gateway's own.
            self.slo.answered(ms, tokens,
                              stages={"queue-wait": queue_ms,
                                      "route": route_ms, "rpc": ms})
            chaos.note_ok("gateway.call", r.key)
            # The dispatch rode the rpc transport: its success also
            # pairs rpc-class faults (the gateway bypasses Client's
            # retry loop, where that beacon normally lives).
            chaos.note_ok("rpc.call", method)
            return result
        # Out of deadline or out of re-routes: a typed shed, not a
        # timeout — the caller gets a retry hint and the request is
        # accounted, never silently lost.
        self.slo.shed()
        trace.add_event("gateway.shed", last_error=str(last_err)[:200])
        trace.maybe_dump(f"shed in dispatch ({self.service})")
        raise ShedError(
            f"request not served within its deadline "
            f"(last error: {last_err})",
            retry_after_s=self.slo.est_service_s())

    # ------------------------------------------------- disaggregated

    #: Generate kwargs the migration endpoints carry; the rest
    #: (pad_token, repetition_penalty) force the interleaved path
    #: unless left at their defaults.
    _DISAGG_KW = frozenset(("temperature", "seed", "top_k", "top_p",
                            "stop_token"))
    _DISAGG_KW_DEFAULTS = {"pad_token": 0, "repetition_penalty": 1.0}

    def _disagg_eligible(self, prompt, gen_kwargs) -> bool:
        """Single-row requests with migration-expressible kwargs ride
        the disaggregated path; everything else stays interleaved."""
        for k, v in gen_kwargs.items():
            if k in self._DISAGG_KW:
                continue
            if (k in self._DISAGG_KW_DEFAULTS
                    and v == self._DISAGG_KW_DEFAULTS[k]):
                continue
            return False
        # The shape alone: a prompt on the card is not read here.
        shape = getattr(prompt, "shape", None)
        if shape is None:
            try:
                shape = np.shape(prompt)
            except Exception:  # noqa: BLE001 — let generate() raise it
                return False
        return len(shape) == 2 and shape[0] == 1

    def _mig_method(self, name: str) -> str:
        """Migration endpoint beside ``generate_method`` (same actor:
        ``Generator.Generate`` → ``Generator.<name>``)."""
        prefix = self.cfg.generate_method.rsplit(".", 1)[0]
        return f"{prefix}.{name}"

    def _rcall(self, r, method: str, args, deadline: float):
        """One TARGETED dispatch (no re-route — migration legs name
        their replica), with the same pool accounting and failure
        taxonomy as :meth:`_dispatch`: replica sheds and handler
        errors leave the replica healthy, transport failures feed
        eviction."""
        conn = r.conn
        if conn is None or not conn.healthy:
            raise RPCError(f"replica {r.key} not connected")
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise ShedError(
                f"out of deadline before {method!r} on {r.key}",
                retry_after_s=self.slo.est_service_s())
        self.pool.begin(r)
        sw = Stopwatch()
        fut = None
        try:
            with trace.span("rpc.call", method=method, replica=r.key):
                fut = conn.call_async(method, args)
                result = fut.result(timeout=remaining)
        except ShedError:
            self.pool.done(r, None, ok=True)
            raise
        except RemoteError:
            self.pool.done(r, sw.ms(), ok=True)
            raise
        except FuturesTimeoutError:
            conn.forget(fut)
            self.pool.fail(r, f"{method} exceeded deadline in flight")
            raise RPCError(
                f"call {method!r} exceeded its deadline on {r.key}")
        except Exception as e:  # noqa: BLE001 — transport failure
            if fut is not None:
                conn.forget(fut)
            self.pool.fail(r, str(e))
            raise
        self.pool.done(r, sw.ms(), ok=True)
        chaos.note_ok("rpc.call", method)
        return result

    def _generate_disagg(self, prompt, max_new: int, *,
                         deadline_s: float | None = None,
                         affinity_key: str | None = None,
                         **gen_kwargs):
        """The two-stage serving call: admit once, then prefill-pick →
        ``Prefill`` → decode-pick (prefix-directory-steered) →
        ``MigratePlan``/``ExportBlocks``/``ImportBlocks``/
        ``MigrateDecode``. Output is shaped and padded exactly like
        :meth:`generate`'s interleaved path."""
        gen = {"temperature": 0.0, "seed": 0, "top_k": 0,
               "top_p": 1.0, "stop_token": -1}
        gen.update({k: v for k, v in gen_kwargs.items() if k in gen})
        deadline = time.monotonic() + (deadline_s
                                       if deadline_s is not None
                                       else self.cfg.default_deadline_s)
        with trace.span("gateway.request", service=self.service,
                        method="disagg") as rq:
            self.slo.arrived()
            qsw = Stopwatch()
            try:
                with trace.span("gateway.admit"):
                    self.admission.admit(
                        key=affinity_key or "disagg",
                        deadline=deadline)
            except ShedError:
                self.slo.shed()
                self._export_gauges()
                trace.maybe_dump(f"shed at admission ({self.service})")
                raise
            queue_ms = qsw.ms()
            try:
                return self._dispatch_disagg(prompt, int(max_new),
                                             gen, deadline,
                                             affinity_key, rq,
                                             queue_ms)
            finally:
                self.admission.release()
                self._export_gauges()

    def _dispatch_disagg(self, prompt, max_new, gen, deadline,
                         affinity_key, rq, queue_ms=0.0):
        req_sw = Stopwatch()
        stages = {"queue-wait": queue_ms}
        stop_token = int(gen["stop_token"])
        counter = lambda out: _count_generated(out, stop_token)  # noqa: E731
        gen_args = (prompt, max_new, gen["temperature"], gen["seed"],
                    gen["top_k"], gen["top_p"], gen["stop_token"])
        mig_args = gen_args
        # ---- stage 1: prefill-class pick + Prefill
        rsw = Stopwatch()
        with trace.span("gateway.route", serve_class="prefill") as rsp:
            pre = self.pool.pick(affinity_key, serve_class="prefill",
                                 prefer_domain=self.cfg.domain)
            rsp.set_attr("replica", pre.key if pre is not None else None)
        stages["route"] = rsw.ms()
        if pre is None or pre.conn is None or not pre.conn.healthy:
            return self._dispatch(self.cfg.generate_method, gen_args,
                                  deadline, affinity_key, counter,
                                  queue_ms=queue_ms)
        # The request span names its replica pair and their topology
        # domains, so a stitched trace shows which domain pair served a
        # slow request.
        rq.set_attr("prefill_replica", pre.key)
        rq.set_attr("prefill_domain", pre.domain())
        psw = Stopwatch()
        try:
            with trace.span("gateway.prefill", replica=pre.key):
                rep = self._rcall(pre, self._mig_method("Prefill"),
                                  (prompt, 1, gen["temperature"],
                                   gen["seed"], gen["top_k"],
                                   gen["top_p"], gen["stop_token"]),
                                  deadline)
        except Exception as e:  # noqa: BLE001 — shed, handler error,
            # or transport alike: Prefill never started owning
            # state, so a plain re-routed dispatch IS the recovery
            # (it accounts itself).
            log.info("disagg prefill failed; interleaved fallback",
                     kv={"replica": pre.key, "err": repr(e)[:200]})
            return self._dispatch(self.cfg.generate_method, gen_args,
                                  deadline, affinity_key, counter,
                                  queue_ms=queue_ms)
        stages["prefill"] = psw.ms()
        # Prefill returned the first token: the disagg path knows its
        # real per-request TTFT (goodput attribution).
        ttft_ms = req_sw.ms()
        export_id = rep["export_id"]
        first = int(rep["first_token"])
        bt = int(rep["block_tokens"])
        hashes = [int(h) for h in rep["hashes"]]
        toks = _host(prompt)[0]
        contents = [tuple(int(t) for t in toks[i * bt:(i + 1) * bt])
                    for i in range(len(hashes))]
        if max_new <= 1 or (stop_token >= 0 and first == stop_token):
            # Decode budget spent inside prefill: no migration leg.
            self._release_export(pre, export_id)
            self.directory.publish(pre.key, zip(hashes, contents))
            out = np.zeros((1, max_new), np.int32)
            out[0, 0] = first
            self.slo.answered(req_sw.ms(), counter(out),
                              ttft_ms=ttft_ms, stages=stages)
            return out
        # ---- stage 2: decode-class pick, steered by the directory
        rsw = Stopwatch()
        with trace.span("gateway.route", serve_class="decode") as rsp:
            dec = self._pick_decode(pre, hashes, contents)
            rsp.set_attr("replica", dec.key if dec is not None else None)
        stages["route"] += rsw.ms()
        if dec is None:
            # One-replica fleet (or nothing else healthy): nowhere to
            # migrate — finish where the blocks already live.
            self._release_export(pre, export_id)
            return self._disagg_fallback(pre, gen_args, deadline,
                                         counter, req_sw)
        rq.set_attr("decode_replica", dec.key)
        rq.set_attr("decode_domain", dec.domain())
        # Locality ledger: every migration attempt counts as intra- or
        # cross-domain. Only when
        # both sides advertise a domain: a topology-blind fleet has
        # nothing meaningful to count.
        pre_dom, dec_dom = pre.domain(), dec.domain()
        if pre_dom is not None and dec_dom is not None:
            self._mreg.counter(
                "serve.migrate.local_domain" if dec_dom == pre_dom
                else "serve.migrate.cross_domain").add(1)
        ticket = None
        truncate = False
        msw = Stopwatch()  # migrate stage (and its trace span) open
        #                    BEFORE the chaos seam: an injected wire
        #                    delay is exactly what stage attribution —
        #                    histogram and waterfall alike — must catch.
        try:
            with trace.span("gateway.migrate", prefill=pre.key,
                            decode=dec.key) as msp:
                # The migration chaos seam: drop kills the transfer
                # outright, delay stalls it mid-flight, truncate
                # ships a wire missing blocks (the decode side
                # detects and refuses it) — every action lands on the
                # fallback path: local prefill on the decode replica,
                # correct tokens, never lost.
                f = chaos.hit("serve.migrate", dec.key)
                if f is not None:
                    if f.action == "drop":
                        raise RPCError("chaos: serve.migrate drop")
                    if f.action == "delay":
                        f.sleep()
                    elif f.action == "truncate":
                        truncate = True
                plan = self._rcall(dec,
                                   self._mig_method("MigratePlan"),
                                   mig_args, deadline)
                ticket = plan["ticket"]
                wire = self._rcall(
                    pre, self._mig_method("ExportBlocks"),
                    (export_id, plan["need"], self.cfg.kv_wire),
                    deadline)
                if truncate and wire.get("blocks"):
                    wire = dict(wire)
                    wire["blocks"] = wire["blocks"][:-1]
                imp = self._rcall(dec,
                                  self._mig_method("ImportBlocks"),
                                  (ticket, wire), deadline)
                msp.set_attr("blocks", len(wire.get("blocks", ())))
                msp.set_attr("bytes", int(imp.get("nbytes", 0)))
                msp.set_attr("resident", int(plan.get("resident", 0)))
            stages["migrate"] = msw.ms()
            self._release_export(pre, export_id)
            export_id = None
            dsw = Stopwatch()
            tokens = self._rcall(dec,
                                 self._mig_method("MigrateDecode"),
                                 (ticket, first), deadline)
            stages["decode"] = dsw.ms()
            ticket = None
        except ShedError:
            # The decode replica refused the plan typed (KV pool
            # exhausted / draining): nothing migrated, nothing owed —
            # unwind and re-route like any replica shed.
            if ticket is not None:
                self._abort_migration(dec, ticket)
            if export_id is not None:
                self._release_export(pre, export_id)
            trace.add_event("gateway.migrate_shed", decode=dec.key)
            return self._dispatch(self.cfg.generate_method, gen_args,
                                  deadline, affinity_key, counter)
        except Exception as e:  # noqa: BLE001 — any mid-transfer
            # failure (chaos drop/truncate, transport, handler): the
            # request falls back to LOCAL prefill on the decode
            # replica. Unwind first — the abort releases the decode
            # side's reservation so the fallback's own admission has
            # the blocks the plan was holding.
            log.info("migration failed; local-prefill fallback",
                     kv={"prefill": pre.key, "decode": dec.key,
                         "err": repr(e)[:200]})
            trace.add_event("gateway.migrate_failed",
                            decode=dec.key, err=str(e)[:200])
            if ticket is not None:
                self._abort_migration(dec, ticket)
            if export_id is not None:
                self._release_export(pre, export_id)
            out = self._disagg_fallback(dec, gen_args, deadline,
                                        counter, req_sw)
            # The decode replica prefilled locally: it now holds the
            # prompt's sealed blocks — publish them, and pair the
            # injected fault (the request completed; the seam
            # recovered by falling back).
            self.directory.publish(dec.key, zip(hashes, contents))
            chaos.note_ok("serve.migrate", dec.key)
            return out
        # ---- success: account, publish, pair the seam
        out = np.zeros((1, max_new), np.int32)
        emitted = [int(t) for t in tokens][:max_new]
        out[0, :len(emitted)] = emitted
        self.directory.publish(dec.key, zip(hashes, contents))
        e2e_ms = req_sw.ms()
        n_out = counter(out)
        self.slo.answered(e2e_ms, n_out, ttft_ms=ttft_ms,
                          tpot_ms=((e2e_ms - ttft_ms) / (n_out - 1)
                                   if n_out > 1 else None),
                          stages=stages)
        chaos.note_ok("serve.migrate", dec.key)
        chaos.note_ok("gateway.call", dec.key)
        return out

    def _pick_decode(self, pre, hashes, contents):
        """The decode pick: healthy decode-class replicas (minus the
        prefill pick), scored by content-verified directory overlap
        first (blocks NOT shipped), load second. Eviction counters
        are folded in before the directory is trusted — a replica
        whose pool churned drops its entries here, not after a
        mis-route.

        Locality: the migration wire rides the fast
        intra-domain leg only when the decode pick shares the prefill
        replica's topology domain — so when ANY in-domain candidate
        exists, out-of-domain ones (even directory holders) are
        dropped: re-shipping blocks inside the domain beats a
        cross-domain hit on the slow leg. A domain-blind fleet (no
        advertised domains) is unaffected."""
        cands = [r for r in self.pool.healthy_class("decode")
                 if r.key != pre.key
                 and r.conn is not None and r.conn.healthy
                 and r.lifecycle() != "draining"]
        if not cands:
            return None
        pre_dom = pre.domain()
        if pre_dom is not None:
            local = [r for r in cands if r.domain() == pre_dom]
            if local:
                cands = local
        for r in cands:
            self.directory.note_evictions(r.key, r.kv_evictions())
        best, best_ov = None, -1
        for r in sorted(cands, key=lambda r: (r.score(), r.key)):
            ov = self.directory.overlap(r.key, hashes, contents)
            if ov > best_ov:
                best, best_ov = r, ov
        return best

    def _disagg_fallback(self, dec, gen_args, deadline, counter,
                         req_sw):
        """Local prefill on the decode replica — the migration
        failure path. The replica re-prefills from the prompt (its
        prefix cache may still shortcut it) and owns the decode; only
        if IT fails too does the request re-enter the general
        re-routed dispatch."""
        if dec is not None and dec.conn is not None \
                and dec.conn.healthy:
            try:
                out = self._rcall(dec, self.cfg.generate_method,
                                  gen_args, deadline)
                self.slo.answered(req_sw.ms(), counter(out))
                return out
            except Exception as e:  # noqa: BLE001 — fall through to
                # the re-routed dispatch, which sheds typed if no one
                # can serve.
                log.info("decode-replica fallback failed; re-routing",
                         kv={"replica": dec.key,
                             "err": repr(e)[:200]})
        return self._dispatch(self.cfg.generate_method, gen_args,
                              deadline, None, counter)

    def _release_export(self, pre, export_id) -> None:
        """Best-effort: free the prefill side's parked blocks (they
        re-enter its LRU, still content-addressed for local reuse)."""
        try:
            self._rcall(pre, self._mig_method("ReleaseExport"),
                        (export_id,),
                        time.monotonic() + self.cfg.probe_timeout_s)
        except Exception:  # noqa: BLE001 — the engine's drained()
            # gate and Info() surface any leak; a failed release must
            # not fail the request.
            pass

    def _abort_migration(self, dec, ticket) -> None:
        """Best-effort: unwind the decode side's plan (derefs +
        reservation release + ledger retire as ``cancelled``)."""
        try:
            self._rcall(dec, self._mig_method("AbortMigration"),
                        (ticket,),
                        time.monotonic() + self.cfg.probe_timeout_s)
        except Exception:  # noqa: BLE001 — same contract as release
            pass

    def class_hint(self, serve_class: str) -> ScaleHint:
        """Per-class autoscale signal for a disaggregated fleet: the
        prefill pool scales on queue depth and the TTFT tail (prompt
        bursts), the decode pool on KV-block headroom and the TPOT
        tail (long decodes). An autoscaler runs one loop per class on
        ``gw.class_hint("prefill")`` etc.; the combined
        :meth:`scale_hint` stays the unified-fleet signal."""
        reps = [r for r in self.pool.healthy()
                if r.serve_class() == serve_class]
        n = len(reps)
        queue = self.admission.depth
        inflight = sum(r.inflight for r in reps)
        signals = {"serve_class": serve_class, "n_replicas": n,
                   "queue_depth": queue, "inflight": inflight}
        # The domain dimension: per-domain replica counts for this
        # class, plus where the NEXT replica should land
        # (``spawn_domain``), so scale-ups fill the local domain before
        # spilling across the slow leg. Only when topology is in play (a configured
        # gateway domain or any advertising replica).
        doms: dict[str, int] = {}
        for r in reps:
            d = r.domain()
            if d is not None:
                doms[str(d)] = doms.get(str(d), 0) + 1
        if doms or self.cfg.domain is not None:
            signals["domains"] = doms
            signals["spawn_domain"] = self._spawn_domain(doms)
        if serve_class == "prefill":
            ttft = self.slo.h_ttft.percentile(99)
            signals["ttft_p99_ms"] = round(ttft, 2)
            if (self.cfg.max_queue_depth
                    and queue >= self.cfg.max_queue_depth // 2):
                return ScaleHint(1, "prefill queue above half depth",
                                 signals)
            if (self.cfg.slo_ttft_p99_ms is not None
                    and self.slo.h_ttft.count >= 20
                    and ttft > self.cfg.slo_ttft_p99_ms):
                return ScaleHint(
                    1, f"ttft p99 {ttft:.0f}ms over SLO "
                       f"{self.cfg.slo_ttft_p99_ms:.0f}ms", signals)
            if n > 1 and queue == 0 and inflight == 0:
                return ScaleHint(-1, "prefill pool idle", signals)
            return ScaleHint(0, "steady", signals)
        if serve_class == "decode":
            frees = [v for v in (r.kv_free_blocks() for r in reps)
                     if v is not None]
            signals["min_kv_free_blocks"] = (min(frees) if frees
                                             else None)
            tpots = [v for v in
                     (r.reported_float("tpot_p99_ms") for r in reps)
                     if v is not None]
            signals["tpot_p99_ms"] = (round(max(tpots), 2) if tpots
                                      else None)
            if frees and min(frees) == 0:
                return ScaleHint(1, "decode kv pool exhausted",
                                 signals)
            if (self.cfg.slo_tpot_p99_ms is not None and tpots
                    and max(tpots) > self.cfg.slo_tpot_p99_ms):
                return ScaleHint(
                    1, f"tpot p99 {max(tpots):.0f}ms over SLO "
                       f"{self.cfg.slo_tpot_p99_ms:.0f}ms", signals)
            if n > 1 and inflight == 0 and queue == 0:
                return ScaleHint(-1, "decode pool idle", signals)
            return ScaleHint(0, "steady", signals)
        return ScaleHint(0, f"unknown class {serve_class!r}", signals)

    def _spawn_domain(self, doms: dict[str, int]) -> int | None:
        """Where the next replica of a class should land: the
        gateway's own domain while it is no fuller than the emptiest
        populated domain ("fill the local domain first"), else the
        least-populated advertised domain (lowest ordinal on ties —
        deterministic, so repeated hints don't oscillate)."""
        local = self.cfg.domain
        if not doms:
            return local
        least = min(doms.values())
        if local is not None and doms.get(str(local), 0) <= least:
            return int(local)
        return min((int(k) for k, v in doms.items() if v == least))

    def disagg_hints(self) -> dict:
        """Both per-class hints at once (``GatewayActor.Info`` /
        operator surface)."""
        return {cls: self.class_hint(cls)
                for cls in ("prefill", "decode")}

    # --------------------------------------------------------- inspection

    def _export_gauges(self) -> None:
        self.slo.g_queue.set(self.admission.depth)
        self.slo.g_replicas.set(self.pool.n_healthy())

    def stats(self) -> dict:
        """One structured readout: SLO surface + fleet + queue — what
        ``GatewayActor.Info`` serves and the runbook reads."""
        hint = self.scale_hint()
        return {
            "service": self.service,
            "queue_depth": self.admission.depth,
            "inflight": self.admission.inflight,
            "capacity": self._capacity(),
            "admitted": self.admission.admitted,
            "shed": {"full": self.admission.shed_full,
                     "slo": self.admission.shed_slo,
                     "deadline": self.admission.shed_deadline},
            "latency": self.slo.percentiles(),
            "tokens_per_sec": round(self.slo.tokens_per_sec(), 1),
            "shed_rate": round(self.slo.shed_rate(), 4),
            "scale_hint": {"delta": hint.delta, "reason": hint.reason},
            "tail": self.slo.worst(),
            "pool": self.pool.status(),
        }

    def scale_hint(self):
        """The autoscale signal (gateway/slo.py): advisory fleet-size
        delta from queue depth, shed rate, tail latency, utilization."""
        return self.slo.scale_hint(
            queue_depth=self.admission.depth,
            max_depth=self.cfg.max_queue_depth,
            n_replicas=self.pool.n_healthy(),
            inflight=self.admission.inflight,
            capacity=self._capacity())

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self.admission.close()
        self.pool.close()


class GatewayActor:
    """Actor-RPC face of a gateway: register on an ActorServer under
    e.g. ``llm-gw`` and thin clients get admission control, shedding
    and load-aware routing through plain ``client.call`` — ShedError
    rides the wire typed. It answers on the gateway's device (``cuda``
    unless the gateway was built with another)."""

    def __init__(self, gateway: InferenceGateway):
        self._gw = gateway

    def Generate(self, prompt, max_new_tokens: int = 16,
                 temperature: float = 0.0, seed: int = 0,
                 top_k: int = 0, top_p: float = 1.0,
                 stop_token: int = -1, pad_token: int = 0,
                 repetition_penalty: float = 1.0,
                 affinity_key: str = ""):
        return self._gw.generate(
            prompt, max_new_tokens, temperature=float(temperature),
            seed=int(seed), top_k=int(top_k), top_p=float(top_p),
            stop_token=int(stop_token), pad_token=int(pad_token),
            repetition_penalty=float(repetition_penalty),
            affinity_key=str(affinity_key) or None)

    def Info(self) -> dict:
        return self._gw.stats()


def least_loaded_picker(pool: ReplicaPool):
    """A :class:`~ptype_tpu_torch.rpc.ConnConfig` ``picker`` backed by a
    pool's load map: processes that keep a plain Client route to the
    least-loaded replica the pool knows about. Unknown connections (the
    pool hasn't probed that node) defer to round-robin by returning
    None."""

    def picker(conns):
        scores = {r.key: r.score() for r in pool.healthy()}
        best, best_score = None, None
        for c in conns:
            key = f"{c.node.address}:{c.node.port}"
            s = scores.get(key)
            if s is None:
                continue
            if best_score is None or s < best_score:
                best, best_score = c, s
        return best

    return picker
