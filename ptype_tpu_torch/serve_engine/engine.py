"""The paged continuous-batching engine — the port of
``ptype_tpu/serve_engine/engine.py``: the plain path, speculative
decoding, the serving ledger and its seams, and disaggregated
prefill/decode (KV-block migration).

:class:`PagedGeneratorActor` decodes every live slot in one batched
step through per-sequence block tables over a shared
:class:`~ptype_tpu_torch.serve_engine.blocks.BlockPool`
(``models/generate.decode_step_paged``), admits prompts in bounded
``prefill_chunk``-token chunks interleaved with decode steps, and
reuses resident prompt blocks by their content hash. Greedy rows match
their solo ``generate`` token for token; single-row sampled requests
ride the engine with their own ``torch.Generator``, drawing exactly
what the solo path draws. Repetition-penalty and multi-row sampled
requests take the solo path (``GeneratorActor.Generate``).

``attn="kernel"`` sends decode attention through
``ops.paged_attention`` — the hand-written Hopper kernel on CUDA; the
engine checks at construction that the kernel takes the geometry.
``attn="gather"`` (default) gathers the table's blocks in plain
PyTorch.

Admission: the waiting room is bounded (``max_queue``) and each request
reserves its worst-case block count; a request the queue cannot hold,
or one that waited longer than ``admit_timeout_s`` at the queue head
for a reservation, sheds with a typed
:class:`~ptype_tpu_torch.errors.ShedError` whose ``retry_after_s`` is
the backlog times the ledger's service-time EWMA. The ``serve.admit``
chaos seam forces sheds and delays.

Observability: every latency stamp rides a seam on the engine's
:class:`~ptype_tpu_torch.health.serving.ServingLedger` — per-request
lifecycle records with TTFT/TPOT/e2e histograms, per-iteration batch
composition and ``kv.*`` pressure gauges. The seams take host ints the
engine already has and never read a device tensor: the TTFT stamp
follows the first token's host read, and a step keeps its one host
read. Steps and prefill chunks run inside ``metrics.annotate`` ranges
(``serve.step``, ``serve.prefill``). With :mod:`~ptype_tpu_torch.jitwatch`
armed, the decode step, the speculation window and the KV export and
import run in hot regions that refuse an unsanctioned host
synchronisation; the step's read, the slot-state uploads of a mirror
build and the wire hop are the sanctioned transfers on the books.

Device-resident slot state: both steps read one device mirror of the
slot state (tables, allocation bounds, active lanes, tokens, positions
and sampling filters), static buffers allocated once and refilled from
the host arrays only after an admission, a retire, a block allocation
or a speculation window. A plain step routes its KV writes from the
mirror and advances the mirror's tokens and positions on the device,
as the reference's does in-graph: a steady step uploads nothing. The
host arrays stay authoritative.

Compiled programs: the engine decodes with its parameters cast to the
compute dtype once (``tfm.compute_params``; bitwise the same logits). A
plain step and each speculation window width are bodies that read and
write only that tree, the banks and the mirror; on CUDA each is
captured once as a CUDA graph and replayed
(``serve_engine/programs.py``), one program a sampling mode (keyed
``sampled=False`` or ``sampled=True``), as the reference jits one
program a sampling mode and one a ``(W, sampled)`` window. A sampled
body draws on the device from per-slot generators made once with the
engine (a sampling one a slot, and under speculation a draft and an
acceptance one): admission copies a row's generator states into its
slot's in place, so a request's stream goes on in the slot, and the
rows' temperatures and filters are read from the mirror. Every prefill
chunk, the target's and the draft's, is padded to its bucket ``C =
max(16, pow2(n))`` and runs as the program of that bucket
(``serve.prefill_chunk``, ``serve.draft_chunk``) over one static input
buffer that a single pinned upload fills: a chunk that is not a
prompt's last reads nothing back, and the last reads its logits for
the first token (a sampled row draws it eagerly).

Speculative decoding (``spec=SpecConfig(...)``): a draft model with
its own block tables in a second :class:`BlockPool` proposes ``k``
tokens a live slot, the target scores all ``k + 1`` positions in one
batched forward on the gather path, and acceptance commits each row's
accepted prefix plus one token — greedy output identical to the plain
engine's. A window's write routing is computed from device tensors and
the window reads the host back once (its tokens and accept counts).
Rejected positions roll back by rewinding the position; no block is
reallocated. Admission reserves a request's worst case in both pools.
The ``serve.spec`` chaos seam can reject a window (that iteration
takes the plain step) or delay it.

Disaggregated serving: a ``prefill``-class engine runs ``Prefill``
(chunked prefill, the first token) and parks the prompt's blocks under
an export id; a ``decode``-class engine plans the import
(``MigratePlan``: worst-case reservation before any bytes move,
chain-hash dedup of resident blocks), lands the wire
(``ImportBlocks``, q8 or exact, written into the banks in place) and
owns the decode (``MigrateDecode``). Draft KV never rides the wire:
the decode side prefills its draft locally. The class is advisory:
every engine answers every endpoint.

The device dispatch of the engine thread (prefill chunks, steps,
windows) and the migration's block copies run under the dispatch lock
(``self._lock``) on the stream the engine launches on, so a pack reads
a finished bank and an import never interleaves with a step.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
from dataclasses import dataclass
from functools import partial

import numpy as np
import torch

from ptype_tpu_torch import chaos, jitwatch, lockcheck, logs, trace
from ptype_tpu_torch import metrics as metrics_mod
from ptype_tpu_torch.device import device_work
from ptype_tpu_torch.errors import ShedError
from ptype_tpu_torch.health.serving import ServingLedger
from ptype_tpu_torch.models import generate as gen
from ptype_tpu_torch.models import transformer as tfm
from ptype_tpu_torch.serve import (LIFECYCLE_CODES, GeneratorActor,
                                   _norm_prompt, _pow2)
from ptype_tpu_torch.serve_engine.blocks import BlockPool, block_hashes
from ptype_tpu_torch.serve_engine.migrate import WIRE_MODES, KVMigrator
from ptype_tpu_torch.serve_engine.programs import Programs

log = logs.get_logger("serve_engine")

#: Replica classes for disaggregated serving: a "prefill" replica fills
#: KV blocks and exports them; a "decode" replica imports migrated
#: block sets and owns the decode lifetime; "unified" does both.
SERVE_CLASSES = ("unified", "prefill", "decode")
#: Numeric codes for the ``serve.class`` gauge.
SERVE_CLASS_CODES = {"unified": 0, "prefill": 1, "decode": 2}


@dataclass
class SpecConfig:
    """Speculative decoding on the paged engine (the reference's
    ``SpecConfig``).

    A small same-family draft (``generate.truncated_draft_params``
    builds the layer-truncated one, with no extra memory) proposes
    ``k`` tokens a live slot; the target verifies them in one batched
    forward; acceptance commits the accepted prefix plus one token.

    ``adaptive``: while the accept-rate EWMA sits under
    ``accept_floor`` the depth sheds one a window; at depth 1 and under
    ``accept_floor / 2`` speculation turns off and re-probes with one
    k=1 window every ``probe_every`` plain iterations. Above
    ``accept_floor + 0.15`` the depth climbs back toward ``k``.
    """

    #: Draft parameters (same family: embed/blocks/head).
    draft_params: dict
    #: Draft config; its vocab must equal the target's.
    draft_cfg: tfm.TransformerConfig
    #: Proposal depth a window (the most tokens drafted a slot).
    k: int = 4
    #: Back off and re-probe on the measured accept rate.
    adaptive: bool = True
    #: Accept-rate EWMA under which the depth backs off.
    accept_floor: float = 0.35
    #: Plain iterations between re-probes once speculation is off.
    probe_every: int = 32
    #: Accept-rate EWMA smoothing.
    ewma_alpha: float = 0.2


class _PagedRow:
    """One prompt row: queued → admitting (chunked prefill) → active
    slot → done."""

    __slots__ = ("prompt", "max_new", "stop_token", "temperature",
                 "top_k", "top_p", "generator", "emitted", "done", "err",
                 "table", "hashes", "reused", "prefill_pos",
                 "reserve_left", "rec", "cancelled", "draft_table",
                 "draft_reserve_left", "draft_gen", "accept_gen",
                 "export_id", "migrated")

    def __init__(self, prompt, max_new, stop_token, temperature, top_k,
                 top_p, generator, draft_gen=None, accept_gen=None):
        self.prompt = prompt          # 1-D int64 np array
        self.max_new = max_new
        self.stop_token = stop_token
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.generator = generator    # torch.Generator, sampled rows only
        self.emitted: list[int] = []
        self.done = threading.Event()
        self.err = None
        self.table: list[int] = []    # block ids, position order
        self.hashes: list[int] = []
        self.reused = 0
        self.prefill_pos = -1         # -1: reuse walk not yet run
        self.reserve_left = 0
        #: Lifecycle record (health/serving.RequestRecord): every stamp
        #: the engine needs comes through its ledger's seams.
        self.rec = None
        self.cancelled = False
        #: The draft model's block table and reservation in the draft
        #: pool (speculative decoding only).
        self.draft_table: list[int] = []
        self.draft_reserve_left = 0
        #: Sampled rows under speculation: the draft-draw and the
        #: acceptance-draw generators.
        self.draft_gen = draft_gen
        self.accept_gen = accept_gen
        #: Disaggregated serving: a non-None export_id marks a
        #: prefill-class row — at prompt completion its block refs park
        #: under the id for ExportBlocks instead of taking a slot;
        #: ``migrated`` marks a decode-class row whose prompt KV arrived
        #: over the wire (admission skips reservation and prefill).
        self.export_id: int | None = None
        self.migrated = False


class PagedGeneratorActor(GeneratorActor):
    """Continuous batching over the paged KV block pool.

    Knobs as in the reference: ``n_slots`` live sequences;
    ``block_tokens`` block size (a multiple of 8, also the prefix
    sharing granularity); ``n_blocks`` pool size (default
    ``n_slots × reach/block_tokens + 1``); ``prefill_chunk`` prompt
    tokens per engine iteration (``None``: whole prompts);
    ``max_queue``; ``admit_timeout_s`` (0: wait forever); ``attn``
    "gather" or "kernel" (plain decode steps; speculation windows run
    the gather path); ``spec`` a :class:`SpecConfig` arming speculative
    decoding; ``metrics_registry`` the registry the engine's ledger and
    gauges publish into (default: the process-global one);
    ``serve_class`` one of :data:`SERVE_CLASSES`.
    """

    def __init__(self, cfg: tfm.TransformerConfig, params=None,
                 generator: torch.Generator | None = None, device=None,
                 n_slots: int = 8, max_len: int | None = None,
                 block_tokens: int = 16, n_blocks: int | None = None,
                 prefill_chunk: int | None = 64, max_queue: int = 64,
                 admit_timeout_s: float = 10.0, attn: str = "gather",
                 spec: SpecConfig | None = None,
                 metrics_registry: metrics_mod.MetricsRegistry | None
                 = None, serve_class: str = "unified"):
        super().__init__(cfg, params, generator, device)
        #: Registry the engine's gauges and histograms land in.
        self._reg = (metrics_registry if metrics_registry is not None
                     else metrics_mod.metrics)
        #: The serving ledger: request lifecycle records, TTFT/TPOT/e2e
        #: histograms, engine-iteration composition, KV pressure.
        self.ledger = ServingLedger(registry=self._reg)
        if attn not in ("gather", "kernel"):
            raise ValueError(f"attn must be 'gather'|'kernel', "
                             f"got {attn!r}")
        if serve_class not in SERVE_CLASSES:
            raise ValueError(f"serve_class must be one of "
                             f"{SERVE_CLASSES}, got {serve_class!r}")
        if attn == "kernel" and self.device.type == "cuda":
            from ptype_tpu_torch.ops.paged_attention import (
                kernel_geometry_problems)

            bad = kernel_geometry_problems(cfg.n_heads, cfg.kv_heads,
                                           cfg.head_dim, cfg.dtype)
            if bad:
                raise ValueError("paged-attention kernel cannot take "
                                 "this config: " + "; ".join(bad))
        self.attn = attn
        #: Disaggregated-serving class (advisory: every endpoint answers).
        self.serve_class = serve_class
        self.n_slots = int(n_slots)
        bt = int(block_tokens)
        reach = min(int(max_len) if max_len else cfg.max_seq, cfg.max_seq)
        self.reach = -(-reach // bt) * bt
        self.block_tokens = bt
        self.nb = self.reach // bt
        n_blocks = (int(n_blocks) if n_blocks
                    else self.n_slots * self.nb + 1)
        self.pool = BlockPool(cfg, n_blocks, bt, device=self.device)
        self.prefill_chunk = (int(prefill_chunk) if prefill_chunk
                              else self.reach)
        self.max_queue = int(max_queue)
        self.admit_timeout_s = float(admit_timeout_s)
        #: The KV wire: pack/unpack and the prefill-side error-feedback
        #: residuals, keyed by chain hash (they follow block content).
        self._migrator = KVMigrator(
            (cfg.n_layers, bt, cfg.kv_heads, cfg.head_dim), cfg.dtype)
        #: export_id -> finished prefill row whose block refs are parked
        #: for migration (released by ReleaseExport).
        self._exports: dict[int, _PagedRow] = {}
        #: ticket -> decode-side migration state (reserved blocks,
        #: resident refs, the ledger record with the migration leg).
        self._tickets: dict[int, dict] = {}
        self._mig_ids = itertools.count(1)
        self._migrations = 0
        self._migrate_bytes = 0
        self._migrate_dedup_hits = 0
        #: The stream the engine launches on; migration copies join it.
        self._stream = (torch.cuda.current_stream(self.device)
                        if self.device.type == "cuda" else None)

        # Speculative decoding: the draft's KV lives in a second pool of
        # the same geometry, with its own reservations.
        self._spec = spec
        self._dpool: BlockPool | None = None
        if spec is not None:
            if spec.draft_cfg.vocab_size != cfg.vocab_size:
                raise ValueError(
                    f"spec draft vocab {spec.draft_cfg.vocab_size} != "
                    f"target vocab {cfg.vocab_size}")
            if int(spec.k) < 1:
                raise ValueError(f"spec.k must be >= 1, got {spec.k}")
            self._dpool = BlockPool(spec.draft_cfg, n_blocks, bt,
                                    device=self.device)
        #: Current proposal depth (0: off until the next re-probe).
        self._k_cur = int(spec.k) if spec is not None else 0
        self._spec_ewma = 0.0
        self._spec_windows = 0
        self._spec_probe_left = 0
        #: Tokens the last window committed over its live rows.
        self._window_emitted = 0
        #: The device mirror of the slot state both steps read
        #: (``_mirror``): the static buffers ``_sbuf`` once filled; None
        #: = refill them from the host arrays (set at admission, retire,
        #: block allocation and after a speculation window).
        self._sdev: dict | None = None
        #: The trees the engine's programs read: each leaf the forward
        #: casts to the compute dtype, cast once.
        self._cparams = tfm.compute_params(self.params, cfg)
        self._dparams = (tfm.compute_params(spec.draft_params,
                                            spec.draft_cfg)
                         if spec is not None else None)
        #: Steps and windows of each sampling mode and prefill chunk
        #: buckets, each captured once on CUDA.
        self._programs = Programs(self.device)

        ns = self.n_slots
        #: Each slot's generators, made once: a sampled program draws
        #: from them and registers them at its capture, so an admission
        #: copies its row's streams into them in place.
        self._slot_gens = self._generators()
        self._slot_dgens = self._generators() if spec is not None else ()
        self._slot_agens = self._generators() if spec is not None else ()
        self._tables = np.zeros((ns, self.nb), np.int32)
        self._nalloc = np.zeros(ns, np.int32)
        self._tok = np.zeros(ns, np.int64)
        self._pos = np.zeros(ns, np.int32)
        self._active = np.zeros(ns, bool)
        self._temps = np.zeros(ns, np.float32)
        self._topk = np.zeros(ns, np.int32)
        self._topp = np.ones(ns, np.float32)
        self._dtables = np.zeros((ns, self.nb), np.int32)
        self._dnalloc = np.zeros(ns, np.int32)
        #: First position whose draft KV is not written yet: plain steps
        #: advance the target alone, and the next window catches the
        #: draft up from here.
        self._dpos = np.zeros(ns, np.int32)
        #: The mirror's device buffers, allocated once: a capture reads
        #: their addresses, so a refill copies into them.
        self._sbuf = {name: self._upload(arr)
                      for name, arr in self._slot_arrays().items()}
        #: The prefill chunks' static inputs, one packed int32 buffer
        #: (:meth:`_chunk`): start, length, the block table, then the
        #: tokens padded to the bucket; sized for the largest bucket.
        self._cbuf = torch.zeros(2 + self.nb + max(16, _pow2(self.reach)),
                                 dtype=torch.int32, device=self.device)
        self._slot_state: dict[int, _PagedRow] = {}
        self._queue: list[_PagedRow] = []
        self._admitting: _PagedRow | None = None
        self._cond = lockcheck.condition("serve_engine.queue")
        self._closed = False
        self._steps = 0
        self._max_live = 0
        self._prefix_hits = 0
        self._prefix_misses = 0
        self._prefill_chunks = 0
        self._prefill_tokens = 0
        self._max_stall_ms = 0.0
        self._last_stall_ms = 0.0
        self._thread = threading.Thread(
            target=self._engine, name="paged-engine", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------ public

    def _generators(self) -> tuple:
        """One generator a slot on the engine's device."""
        return tuple(torch.Generator(device=self.device)
                     for _ in range(self.n_slots))

    def _row_rngs(self, seed: int, temperature: float,
                  drawn: int = 0):
        """A sampled row's generators: its sampling generator seeded
        with ``seed`` and advanced past ``drawn`` token draws (a
        migrated row's first token was drawn on the prefill replica),
        and under speculation its draft and acceptance generators.
        Greedy rows get none."""
        if float(temperature) == 0.0:
            return None, None, None
        g = torch.Generator(device=self.device).manual_seed(int(seed))
        for _ in range(drawn):
            # The draw sample_token_rows makes for one row.
            torch.rand((1, self.cfg.vocab_size), generator=g,
                       device=self.device, dtype=torch.float32)
        dg = ag = None
        if self._spec is not None:
            dg = gen.folded_generator(seed, gen._DRAFT_FOLD, self.device)
            ag = gen.folded_generator(seed, gen._ACCEPT_FOLD, self.device)
        return g, dg, ag

    def _shed_if_draining(self) -> None:
        """The drain seam: a draining replica refuses NEW work typed
        while the engine runs admitted rows to completion. Called
        inside ``_enter_request`` (a request is counted in in_flight
        before it passes the gate)."""
        if self._draining:
            self.ledger.shed_untracked()
            raise ShedError("replica draining (scale-down in "
                            "progress); route elsewhere",
                            retry_after_s=0.05)

    def _admit_chaos(self, key: str) -> None:
        """The ``serve.admit`` chaos seam: a forced shed or delay."""
        f = chaos.hit("serve.admit", key)
        if f is not None:
            if f.action == "delay":
                f.sleep()
            elif f.action == "shed":
                self.ledger.shed_untracked()
                raise ShedError("chaos: serve.admit shed",
                                retry_after_s=self._retry_after())

    def Generate(self, prompt, max_new_tokens: int = 16,
                 temperature: float = 0.0, seed: int = 0,
                 top_k: int = 0, top_p: float = 1.0,
                 stop_token: int = -1, pad_token: int = 0,
                 repetition_penalty: float = 1.0):
        prompt = _norm_prompt(prompt, self.device)
        if (float(repetition_penalty) != 1.0
                or (float(temperature) != 0.0 and prompt.shape[0] > 1)):
            # Seen-set state and batch-shaped RNG: the solo path.
            return super().Generate(prompt, max_new_tokens, temperature,
                                    seed, top_k, top_p, stop_token,
                                    pad_token, repetition_penalty)
        if not 0.0 < float(top_p) <= 1.0:
            raise ValueError(
                f"generate: top_p must be in (0, 1], got {top_p}")
        max_new = int(max_new_tokens)
        if max_new <= 0:
            return torch.zeros((prompt.shape[0], 0), dtype=torch.int64,
                               device=self.device)
        if prompt.shape[1] + max_new > self.reach:
            raise ValueError(
                f"prompt {prompt.shape[1]} + max_new {max_new} exceeds "
                f"engine reach {self.reach}")
        blocks_per_row = -(-(prompt.shape[1] + max_new) // self.block_tokens)
        if blocks_per_row > self.pool.capacity:
            raise ValueError(
                f"request needs {blocks_per_row} blocks; pool holds "
                f"{self.pool.capacity}")
        self._enter_request()
        try:
            self._shed_if_draining()
            self._admit_chaos(f"rows={prompt.shape[0]}")
            host = prompt.cpu().numpy()
            rows = []
            for i in range(prompt.shape[0]):
                g, dg, ag = self._row_rngs(seed, temperature)
                rows.append(_PagedRow(host[i], max_new, int(stop_token),
                                      float(temperature), int(top_k),
                                      float(top_p), g, dg, ag))
            # One traceparent a call: the synthesized admit/prefill/
            # decode span tree parents under the caller's span.
            tp = trace.traceparent()
            for r in rows:
                r.rec = self.ledger.enqueued(len(r.prompt), max_new, tp=tp)
            self._enqueue(rows)
            out = np.full((len(rows), max_new), int(pad_token), np.int64)
            for i, r in enumerate(rows):
                r.done.wait()
                if r.err is not None:
                    # The caller gets the error for the whole request:
                    # withdraw the sibling rows, freeing their blocks.
                    self._cancel_rows(rows)
                    raise r.err
                out[i, :len(r.emitted)] = r.emitted
            return torch.as_tensor(out, device=self.device)
        finally:
            self._exit_request()

    def _enqueue(self, rows: list[_PagedRow]) -> None:
        """Queue a call's rows (ledger records open) for admission, or
        retire them as shed when the waiting room cannot hold them."""
        with self._load_lock:
            self._calls += 1
        with self._cond:
            if self._closed:
                raise RuntimeError("generator actor is closed")
            if (self.max_queue
                    and len(self._queue) + len(rows) > self.max_queue):
                for r in rows:
                    self.ledger.retired(r.rec, "shed")
                raise ShedError(
                    f"serving backlog full ({len(self._queue)} "
                    f"queued, cap {self.max_queue})",
                    retry_after_s=self._retry_after())
            self._queue.extend(rows)
            # From the caller thread: a wedged engine thread would never
            # export the depth.
            self._reg.gauge("serve.queue_depth").set(len(self._queue))
            self._cond.notify()
        chaos.note_ok("serve.admit")

    def _cancel_rows(self, rows) -> None:
        """Withdraw a request's unfinished rows: queued ones leave the
        queue now; admitting/active ones retire at the next boundary."""
        with self._cond:
            live = set()
            for r in rows:
                if not r.done.is_set():
                    r.cancelled = True
                    live.add(id(r))
            if live:
                kept = []
                for q in self._queue:
                    if id(q) in live:
                        q.err = RuntimeError("request cancelled")
                        self.ledger.retired(q.rec, "cancelled")
                        q.done.set()
                    else:
                        kept.append(q)
                self._queue = kept

    def _retry_after(self) -> float:
        """A shed's retry hint: the backlog times the ledger's
        service-time EWMA (0.1 s before any request completed)."""
        with self._cond:
            backlog = len(self._queue) + len(self._slot_state) + 1
        per = self.ledger.svc_ewma_s() or 0.1
        return round(max(0.05, backlog * per), 3)

    # --------------------------------------------------------- migration

    def _on_engine_stream(self):
        """A scope on the engine's stream (CUDA), where the engine
        thread launches and migration copies join it; else a no-op
        scope."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def Prefill(self, prompt, max_new_tokens: int = 16,
                temperature: float = 0.0, seed: int = 0,
                top_k: int = 0, top_p: float = 1.0,
                stop_token: int = -1) -> dict:
        """Disaggregated prefill: run the prompt through chunked
        prefill (prefix reuse and all), emit the FIRST token, and park
        the prompt's KV blocks under an export id instead of taking a
        decode slot. ``max_new_tokens`` is advisory here (the decode
        side reserves for it) — this replica only computes token one."""
        prompt = _norm_prompt(prompt, self.device)
        if prompt.shape[0] != 1:
            raise ValueError("Prefill is single-row (one request "
                             "migrates at a time)")
        L = int(prompt.shape[1])
        if L + 1 > self.reach:
            raise ValueError(f"prompt {L} exceeds engine reach "
                             f"{self.reach}")
        self._enter_request()
        try:
            self._shed_if_draining()
            self._admit_chaos("prefill")
            g, _, _ = self._row_rngs(seed, temperature)
            row = _PagedRow(prompt[0].cpu().numpy(), 1, int(stop_token),
                            float(temperature), int(top_k), float(top_p),
                            g)
            row.export_id = next(self._mig_ids)
            row.rec = self.ledger.enqueued(L, 1, tp=trace.traceparent())
            self._enqueue([row])
            row.done.wait()
            if row.err is not None:
                raise row.err
            return {"export_id": int(row.export_id),
                    "first_token": int(row.emitted[0]),
                    "n_tokens": L,
                    "block_tokens": self.block_tokens,
                    "reused": int(row.reused),
                    "hashes": [int(h) for h in row.hashes]}
        finally:
            self._exit_request()

    def ExportBlocks(self, export_id: int, need_idx=None,
                     kv_wire: str = "q8") -> dict:
        """Pack an export's blocks for the wire: the full blocks in
        ``need_idx`` (None = all of them) plus the unsealed partial
        tail — only what the decode side does not already hold rides
        the transfer (the dedup MigratePlan computed)."""
        if kv_wire not in WIRE_MODES:
            raise ValueError(f"kv_wire must be one of {WIRE_MODES}, "
                             f"got {kv_wire!r}")
        with self._cond:
            row = self._exports.get(int(export_id))
        if row is None:
            raise RuntimeError(f"unknown export {export_id}")
        L = len(row.prompt)
        bt = self.block_tokens
        nfull = L // bt
        want = sorted(set(int(i) for i in need_idx)
                      if need_idx is not None else range(nfull))
        if any(i < 0 or i >= nfull for i in want):
            raise ValueError(f"need_idx out of range for {nfull} "
                             f"full blocks: {want}")
        if L % bt:
            want.append(nfull)  # the partial tail always ships
        blocks: list[dict] = []
        nbytes = 0
        # Under the dispatch lock, on the engine's stream: the pack's
        # device-to-host copy (the one sanctioned sync) reads a
        # finished bank.
        with device_work(), self._lock, self._on_engine_stream(), \
                jitwatch.hot_region("serve.migrate", self.device):
            for i in want:
                h = row.hashes[i] if i < nfull else None
                payload, nb = self._migrator.pack_block(
                    self.pool.k, self.pool.v, row.table[i], h, kv_wire)
                entry = {"idx": int(i),
                         "hash": int(h) if h is not None else None}
                entry.update(payload)
                blocks.append(entry)
                nbytes += nb
        return {"mode": kv_wire, "block_tokens": bt, "n_tokens": L,
                "nbytes": int(nbytes), "blocks": blocks}

    def ReleaseExport(self, export_id: int) -> bool:
        """Drop an export's parked block refs (after migration, or on
        abort). Sealed full blocks park in the LRU: the next request
        sharing the prefix still reuses them here."""
        with self._cond:
            row = self._exports.pop(int(export_id), None)
        if row is None:
            return False
        for bid in row.table:
            self.pool.deref(bid)
        row.table = []
        self._export_gauges()
        return True

    def MigratePlan(self, prompt, max_new_tokens: int = 16,
                    temperature: float = 0.0, seed: int = 0,
                    top_k: int = 0, top_p: float = 1.0,
                    stop_token: int = -1) -> dict:
        """Decode-side admission for a migrating request: reserve the
        worst-case block count BEFORE any bytes move, then walk the
        chain-hash manifest and take refs on every block already
        resident — those are never re-sent. Returns the ticket plus
        ``need`` (full-block indices to ship), ``resident`` and
        ``tail``; a pool that cannot cover the worst case sheds typed."""
        prompt = _norm_prompt(prompt, self.device)
        if prompt.shape[0] != 1:
            raise ValueError("MigratePlan is single-row")
        toks = prompt[0].cpu().numpy()
        L = int(toks.shape[0])
        max_new = int(max_new_tokens)
        if max_new <= 0:
            raise ValueError("max_new_tokens must be >= 1")
        if L + max_new > self.reach:
            raise ValueError(
                f"prompt {L} + max_new {max_new} exceeds engine "
                f"reach {self.reach}")
        bt = self.block_tokens
        need_total = -(-(L + max_new) // bt)
        if need_total > self.pool.capacity:
            raise ValueError(
                f"request needs {need_total} blocks; pool holds "
                f"{self.pool.capacity}")
        self._enter_request()
        try:
            self._shed_if_draining()
            reserved = self.pool.try_reserve(need_total)
            if (reserved and self._dpool is not None
                    and not self._dpool.try_reserve(need_total)):
                self.pool.unreserve(need_total)
                reserved = False
            if not reserved:
                self.ledger.shed_untracked()
                raise ShedError(
                    f"kv pool cannot cover migration: need "
                    f"{need_total} blocks, free "
                    f"{self.pool.free_blocks()}",
                    retry_after_s=self._retry_after())
            hashes = block_hashes(toks, bt)
            nfull = L // bt
            table: dict[int, int] = {}
            for i in range(nfull):
                bid = self.pool.lookup(hashes[i],
                                       toks[i * bt:(i + 1) * bt])
                if bid is not None:
                    self.pool.ref(bid)  # consumes one reserved unit
                    table[i] = bid
            resident = len(table)
            self._prefix_hits += resident
            self._prefix_misses += nfull - resident
            self._migrate_dedup_hits += resident
            self._reg.counter("serve.migrate_dedup_hits").add(resident)
            rec = self.ledger.enqueued(L, max_new, tp=trace.traceparent())
            rec.reused_blocks = resident
            self.ledger.migrate_begin(rec)
            need = [i for i in range(nfull) if i not in table]
            tail = L % bt
            ticket = next(self._mig_ids)
            with self._cond:
                if self._closed:
                    raise RuntimeError("generator actor is closed")
                self._tickets[ticket] = {
                    "toks": toks, "hashes": hashes, "table": table,
                    "need": set(need), "tail": tail,
                    "max_new": max_new, "stop_token": int(stop_token),
                    "temperature": float(temperature),
                    "top_k": int(top_k), "top_p": float(top_p),
                    "seed": int(seed), "rec": rec, "resident": resident,
                    "reserve_left": need_total - resident,
                    "draft_reserve_left": (need_total
                                           if self._dpool is not None
                                           else 0),
                    "imported": not need and not tail,
                }
            self._export_gauges()
            return {"ticket": int(ticket), "need": need,
                    "resident": resident, "tail": int(tail),
                    "block_tokens": bt}
        finally:
            self._exit_request()

    def ImportBlocks(self, ticket: int, wire: dict) -> dict:
        """Land a migration wire in the pool: allocate from the
        ticket's reservation, write each block into the banks in place
        (under the dispatch lock, between engine iterations), then seal
        the full blocks so later requests reuse them. A wire missing
        planned blocks raises; AbortMigration unwinds the ticket."""
        with self._cond:
            t = self._tickets.get(int(ticket))
        if t is None:
            raise RuntimeError(f"unknown migration ticket {ticket}")
        mode = wire.get("mode")
        if mode not in WIRE_MODES:
            raise RuntimeError(f"bad kv_wire mode on wire: {mode!r}")
        bt = self.block_tokens
        if int(wire.get("block_tokens", -1)) != bt:
            raise RuntimeError(
                f"wire block_tokens {wire.get('block_tokens')} != "
                f"engine {bt}")
        toks = t["toks"]
        nfull = len(toks) // bt
        entries = {}
        for b in wire.get("blocks", ()):
            i = int(b["idx"])
            if i not in t["table"]:  # resident blocks never re-land
                entries[i] = b
        expected = set(t["need"]) | ({nfull} if t["tail"] else set())
        missing = expected - set(entries)
        if missing:
            raise RuntimeError(
                f"migration wire truncated: missing blocks "
                f"{sorted(missing)} of {sorted(expected)}")
        for i in sorted(entries):
            bid = self.pool.alloc()  # consumes one reserved unit
            t["reserve_left"] -= 1
            t["table"][i] = bid
        with device_work(), self._lock, self._on_engine_stream(), \
                jitwatch.hot_region("serve.migrate", self.device):
            for i in sorted(entries):
                self._migrator.unpack_block(self.pool.k, self.pool.v,
                                            entries[i], t["table"][i],
                                            mode)
        for i in sorted(entries):
            if i < nfull:
                self.pool.seal(t["table"][i], t["hashes"][i],
                               toks[i * bt:(i + 1) * bt])
        nbytes = int(wire.get("nbytes", 0))
        t["imported"] = True
        self._migrations += 1
        self._migrate_bytes += nbytes
        self._reg.counter("serve.migrations").add(1)
        self._reg.counter("serve.migrate_bytes").add(nbytes)
        self.ledger.migrate_done(t["rec"], len(entries), nbytes)
        self._export_gauges()
        return {"imported": len(entries), "nbytes": nbytes}

    def MigrateDecode(self, ticket: int, first_token: int):
        """Own the decode lifetime of a migrated request: build the row
        from the ticket's imported table, ride the normal admission and
        decode path (slot activation runs the LOCAL draft prefill when
        speculation is armed), and return the full emitted token list,
        ``first_token`` (computed by the prefill replica) included."""
        self._enter_request()
        try:
            self._shed_if_draining()
            with self._cond:
                t = self._tickets.get(int(ticket))
                if t is not None and not t["imported"]:
                    t = None  # leave it for AbortMigration
                else:
                    self._tickets.pop(int(ticket), None)
            if t is None:
                raise RuntimeError(
                    f"migration ticket {ticket} unknown or not imported")
            g, dg, ag = self._row_rngs(t["seed"], t["temperature"],
                                       drawn=1)
            row = _PagedRow(t["toks"], t["max_new"], t["stop_token"],
                            t["temperature"], t["top_k"], t["top_p"],
                            g, dg, ag)
            row.migrated = True
            row.hashes = t["hashes"]
            row.reused = t["resident"]
            row.table = [t["table"][i] for i in range(len(t["table"]))]
            row.prefill_pos = len(t["toks"])
            row.reserve_left = t["reserve_left"]
            row.draft_reserve_left = t["draft_reserve_left"]
            row.emitted = [int(first_token)]
            row.rec = t["rec"]
            with self._cond:
                if self._closed:
                    raise RuntimeError("generator actor is closed")
                # No max_queue gate: this request was admitted (and its
                # blocks committed) at MigratePlan time.
                self._queue.append(row)
                self._reg.gauge("serve.queue_depth").set(len(self._queue))
                self._cond.notify()
            row.done.wait()
            if row.err is not None:
                raise row.err
            return [int(x) for x in row.emitted]
        finally:
            self._exit_request()

    def AbortMigration(self, ticket: int) -> bool:
        """Unwind a ticket whose transfer failed: drop refs, return the
        reservation, retire the ledger record. Idempotent."""
        with self._cond:
            t = self._tickets.pop(int(ticket), None)
        if t is None:
            return False
        for bid in t["table"].values():
            self.pool.deref(bid)
        if t["reserve_left"] > 0:
            self.pool.unreserve(t["reserve_left"])
        if self._dpool is not None and t["draft_reserve_left"] > 0:
            self._dpool.unreserve(t["draft_reserve_left"])
        self.ledger.retired(t["rec"], "cancelled")
        self._export_gauges()
        return True

    # ------------------------------------------------------------ engine

    def _engine(self) -> None:
        """Any escape — clean close or an engine error — fails every
        pending row, so no caller hangs in ``done.wait()``."""
        err: Exception | None = None
        try:
            with torch.no_grad(), self._on_engine_stream():
                self._engine_loop()
        except Exception as e:  # noqa: BLE001 — delivered to callers
            err = e
            log.exception("paged engine died", kv={"err": repr(e)})
        with self._cond:
            self._closed = True
            stragglers, self._queue = self._queue, []
            if self._admitting is not None:
                stragglers.append(self._admitting)
                self._admitting = None
        for slot in list(self._slot_state):
            stragglers.append(self._slot_state.pop(slot))
        for r in stragglers:
            if not r.done.is_set():
                r.err = err or RuntimeError("generator actor closed")
                self.ledger.retired(r.rec, "error")
                r.done.set()

    def _engine_loop(self) -> None:
        pending_stall = 0.0
        while True:
            with self._cond:
                while (not self._queue and self._admitting is None
                       and not self._active.any() and not self._closed):
                    self._cond.wait()
                    pending_stall = 0.0  # idle time is not stall
                if self._closed:
                    return
            with device_work():
                pending_stall = self._iteration(pending_stall)

    def _iteration(self, pending_stall: float) -> float:
        """One engine iteration: retire cancelled rows, an admission
        round, and a decode step when a slot is live. Returns the
        prefill stall still owed to the next step."""
        # Cancelled rows retire before admission: their blocks are the
        # headroom the queue head may be waiting on.
        for slot in list(self._slot_state):
            if self._active[slot] and self._slot_state[slot].cancelled:
                self._retire(slot, "cancelled")
        # The admission round is bounded by prefill_chunk prompt tokens:
        # that budget is the stall a co-batched decode sees, charged
        # only when a decode was live to wait on it.
        if self._active.any():
            pending_stall += self._admission_round()
        else:
            # A prefill-only iteration is still metered, so serve.steps
            # advances and its chunks land on their own iteration record.
            with self.ledger.iteration(active=0, stall_ms=0.0):
                self._admission_round()
            pending_stall = 0.0
        if not self._active.any():
            return pending_stall
        stall_ms = pending_stall * 1e3
        self._record_stall(stall_ms)
        with metrics_mod.annotate("serve.step"):
            with self.ledger.iteration(int(self._active.sum()),
                                       stall_ms) as it:
                self._step(it)
        return 0.0

    def _admission_round(self) -> float:
        """Prefill up to ``prefill_chunk`` prompt tokens; returns the
        seconds spent (the stall charged to the next step)."""
        budget = self.prefill_chunk
        spent = 0.0
        while budget > 0:
            with self._cond:
                self._maybe_start_admission_locked()
                row = self._admitting
                if row is not None and row.cancelled:
                    self._admitting = None
            if row is not None and row.cancelled:
                self._finish_row(row, "cancelled")
                continue
            if row is None:
                break
            with metrics_mod.annotate("serve.prefill"):
                n, dur_s = self._prefill_one_chunk(row, budget)
            budget -= n
            spent += dur_s
        return spent

    def _maybe_start_admission_locked(self) -> None:
        """(under _cond) Move the queue head into admission when a slot
        is free and the pool can cover its worst case; FIFO."""
        if self._admitting is not None or not self._queue:
            return
        if self._active.all():
            return
        row = self._queue[0]
        if row.migrated:
            # Reserved at MigratePlan, prompt KV imported: admission is
            # just taking the slot.
            self._queue.pop(0)
            self.ledger.admitted(row.rec)
            self._admitting = row
            return
        need = -(-(len(row.prompt) + row.max_new) // self.block_tokens)
        reserved = self.pool.try_reserve(need)
        if (reserved and self._dpool is not None
                and not self._dpool.try_reserve(need)):
            # Both pools or neither: a row admitted against the target
            # pool alone would dead-end at its first draft write.
            self.pool.unreserve(need)
            reserved = False
        if not reserved:
            # A bounded wait at the queue HEAD only (time behind other
            # requests does not count): past admit_timeout_s the pool is
            # exhausted for this request and it sheds typed.
            head_wait = self.ledger.head_refused(row.rec)
            if (self.admit_timeout_s > 0
                    and head_wait > self.admit_timeout_s):
                self._queue.pop(0)
                row.err = ShedError(
                    f"kv pool exhausted: need {need} blocks, free "
                    f"{self.pool.free_blocks()} after "
                    f"{self.admit_timeout_s:g}s at queue head",
                    retry_after_s=self._retry_after())
                self.ledger.retired(row.rec, "shed")
                row.done.set()
            return
        row.reserve_left = need
        if self._dpool is not None:
            row.draft_reserve_left = need
        self._queue.pop(0)
        self.ledger.admitted(row.rec)
        self._admitting = row

    def _prefill_one_chunk(self, row: _PagedRow,
                           budget: int) -> tuple[int, float]:
        """Prefill one bounded chunk of the admitting ``row``; returns
        (prompt tokens written, the chunk's seconds)."""
        if row.migrated:
            return self._activate_migrated(row)
        toks = row.prompt
        L = len(toks)
        bt = self.block_tokens
        if row.prefill_pos < 0:
            # Reuse walk: ref every leading resident full block, never
            # through the last prompt token (its logits give token one).
            row.hashes = block_hashes(toks, bt)
            cap = min(len(row.hashes), (L - 1) // bt)
            for i in range(cap):
                bid = self.pool.lookup(row.hashes[i],
                                       toks[i * bt:(i + 1) * bt])
                if bid is None:
                    break
                self.pool.ref(bid)
                row.reserve_left -= 1
                row.table.append(bid)
                row.reused += 1
            self._prefix_hits += row.reused
            self._prefix_misses += len(row.hashes) - row.reused
            row.prefill_pos = row.reused * bt
            row.rec.reused_blocks = row.reused
        start = row.prefill_pos
        n = max(1, min(self.prefill_chunk, L - start, budget))
        while len(row.table) * bt < start + n:
            row.table.append(self.pool.alloc())
            row.reserve_left -= 1
        # The meter stays open through the final chunk's first-token
        # host read: on an asynchronous device that read is where the
        # chunk's compute is paid.
        cm = self.ledger.chunk(row.rec, n)
        with cm:
            logits = self._chunk(False, toks[start:start + n], start,
                                 row.table)
            row.prefill_pos += n
            done = row.prefill_pos >= L
            if done:
                # Prompt resident: seal the freshly computed full
                # blocks, emit the first token.
                for i in range(row.reused, len(row.hashes)):
                    self.pool.seal(row.table[i], row.hashes[i],
                                   toks[i * bt:(i + 1) * bt])
                first = self._first_token(row, logits)
                if (self._dpool is not None and row.max_new > 1
                        and not (row.stop_token >= 0
                                 and first == row.stop_token)):
                    # The row takes a slot: the draft's prompt KV, inside
                    # this chunk's meter (a charged stall, not free).
                    self._draft_prefill(row, toks, L)
        self._prefill_chunks += 1
        self._prefill_tokens += n
        if not done:
            return n, cm.dur_s
        # The TTFT stamp: the first token is on the host here.
        self.ledger.first_token(row.rec)
        row.emitted.append(first)
        with self._cond:
            self._admitting = None
        self._export_gauges()
        if row.export_id is not None:
            self._stash_export(row)
            return n, cm.dur_s
        stopped = row.stop_token >= 0 and first == row.stop_token
        if row.max_new == 1 or stopped:
            self._finish_row(row, "stop" if stopped else "complete")
        else:
            self._take_slot(row, first, L)
        return n, cm.dur_s

    def _first_token(self, row: _PagedRow, logits: torch.Tensor) -> int:
        """The token after the prompt, from the last chunk's logits (1,
        V): the argmax, or a sampled row's draw from its own generator,
        eager (once a request, as the reference's ``_sample_first``
        program is)."""
        if row.temperature == 0.0:
            return int(torch.argmax(logits[0]))
        return int(gen.sample_token_rows(
            logits, [row.generator], [row.temperature], [row.top_k],
            [row.top_p])[0])

    def _chunk(self, draft: bool, toks, start: int,
               table: list[int]) -> torch.Tensor:
        """One prefill chunk of ``toks`` at positions ``start..`` through
        the block table ``table``, in the target's pool or (``draft``)
        the draft's: padded to its bucket ``C = max(16, pow2(n))`` (the
        reference's chunk programs' key), its inputs staged into the
        static buffer ``_cbuf`` in one pinned, non-blocking upload, and
        :meth:`_chunk_body` run as the program ``serve.prefill_chunk``
        (``serve.draft_chunk``) of ``C``. Under the dispatch lock, which
        orders the chunk's bank writes against ``ExportBlocks``' reads.
        Returns the chunk's logits (1, V) at its last real token, valid
        until the bucket's next chunk; nothing is read back."""
        n, nb = len(toks), self.nb
        C = max(16, _pow2(n))
        host = np.zeros(2 + nb + C, np.int32)
        host[0], host[1] = start, n
        host[2:2 + len(table)] = table
        host[2 + nb:2 + nb + n] = toks
        fn = "serve.draft_chunk" if draft else "serve.prefill_chunk"
        cfg = self._spec.draft_cfg if draft else self.cfg
        dt = str(cfg.dtype).removeprefix("torch.")
        with self._lock:
            self._upload(host, self._cbuf[:host.size])
            with jitwatch.hot_region(fn, self.device):
                return self._programs.run(
                    fn, f"C={C},dtype={dt}",
                    partial(self._chunk_body, draft, C))

    def _chunk_body(self, draft: bool, C: int) -> torch.Tensor:
        """A chunk of bucket ``C`` on the device: reads the compute tree,
        the static chunk inputs and the banks, writes the banks. Returns
        the logits (1, V)."""
        buf, nb = self._cbuf, self.nb
        if draft:
            params, cfg, pool = self._dparams, self._spec.draft_cfg, \
                self._dpool
        else:
            params, cfg, pool = self._cparams, self.cfg, self.pool
        logits, _, _ = gen.prefill_paged_chunk(
            params, buf[2 + nb:2 + nb + C][None], buf[0], buf[1], cfg,
            pool.k, pool.v, buf[2:2 + nb])
        return logits

    def _take_slot(self, row: _PagedRow, first: int, L: int) -> None:
        slot = int(np.flatnonzero(~self._active)[0])
        self._slot_state[slot] = row
        self._tables[slot] = 0
        self._tables[slot, :len(row.table)] = row.table
        self._nalloc[slot] = len(row.table)
        self._tok[slot] = first
        self._pos[slot] = L
        self._active[slot] = True
        self._temps[slot] = row.temperature
        self._topk[slot] = row.top_k
        self._topp[slot] = row.top_p
        # The row's streams go on in the slot's generators, copied in
        # place: the objects a sampled program registered stay, and its
        # next replay draws from the new state.
        for gens, g in ((self._slot_gens, row.generator),
                        (self._slot_dgens, row.draft_gen),
                        (self._slot_agens, row.accept_gen)):
            if g is not None:
                gens[slot].set_state(g.get_state())
        if self._dpool is not None:
            self._dtables[slot] = 0
            self._dtables[slot, :len(row.draft_table)] = row.draft_table
            self._dnalloc[slot] = len(row.draft_table)
            self._dpos[slot] = L  # the draft prefill wrote 0..L-1
        self._sdev = None

    def _activate_migrated(self, row: _PagedRow) -> tuple[int, float]:
        """Land an imported migration in a slot: no prefill (the prompt
        KV arrived over the wire), but with speculation armed the DRAFT
        prefills locally from the prompt tokens — draft KV is specific
        to the draft's parameters and never rides the wire. The TTFT
        stamp here is the decode replica's own: plan → activation, the
        migration leg included."""
        toks = row.prompt
        L = len(toks)
        first = row.emitted[0]
        stopped = row.stop_token >= 0 and first == row.stop_token
        cm = self.ledger.chunk(row.rec, 0)
        with cm:
            if self._dpool is not None and row.max_new > 1 and not stopped:
                self._draft_prefill(row, toks, L)
        self.ledger.first_token(row.rec)
        with self._cond:
            self._admitting = None
        self._export_gauges()
        if row.max_new == 1 or stopped:
            self._finish_row(row, "stop" if stopped else "complete")
        else:
            self._take_slot(row, first, L)
        return 0, cm.dur_s

    def _stash_export(self, row: _PagedRow) -> None:
        """Disaggregated prefill complete: park the prompt's block refs
        under the export id and return every unused reservation unit
        now — an export row never decodes here."""
        if row.reserve_left > 0:
            self.pool.unreserve(row.reserve_left)
            row.reserve_left = 0
        if self._dpool is not None and row.draft_reserve_left > 0:
            self._dpool.unreserve(row.draft_reserve_left)
            row.draft_reserve_left = 0
        with self._cond:
            self._exports[row.export_id] = row
        self.ledger.retired(row.rec, "complete")
        row.done.set()

    def _step(self, meter=None) -> None:
        """One engine iteration over the live slots: a speculation
        window when speculation is armed and earns its depth, else the
        plain one-token step."""
        if self._spec is not None:
            k_eff = self._spec_k_eff()
            if k_eff >= 1:
                # The speculation chaos seam: "reject" poisons the
                # window (this iteration takes the plain step), "delay"
                # stalls it; the next committed window beacons recovery.
                f = chaos.hit("serve.spec", f"k={k_eff}")
                if f is not None and f.action == "delay":
                    f.sleep()
                    f = None
                if f is None:
                    self._spec_step(k_eff)
                    if meter is not None:
                        # The window's ragged emitted total, not one
                        # token a live slot.
                        meter.decode_tokens = self._window_emitted
                    return
        self._plain_step()

    def _plain_step(self) -> None:
        """One batched decode step over every slot (inactive lanes write
        to the trash block and are ignored): :meth:`_decode_body` on the
        device mirror, greedy as its program (``serve.decode``). A step
        after no admission, retire or block allocation uploads nothing,
        and the step reads the host back once."""
        bt = self.block_tokens
        for slot in np.flatnonzero(self._active):
            if self._pos[slot] == self._nalloc[slot] * bt:
                # Boundary crossing: one block from the reservation.
                row = self._slot_state[slot]
                bid = self.pool.alloc()
                row.reserve_left -= 1
                row.table.append(bid)
                self._tables[slot, self._nalloc[slot]] = bid
                self._nalloc[slot] += 1
                self._sdev = None
        self._mirror()
        with self._lock, jitwatch.hot_region("serve.decode", self.device):
            _, nxt = self._dispatch("serve.decode", self._decode_body)
        with jitwatch.sanctioned_transfer("serve.decode_read"):
            nxt = nxt.cpu().numpy()  # the step's one host read
        self._steps += 1
        self._max_live = max(self._max_live, int(self._active.sum()))
        self._pos[self._active] += 1
        self._tok = np.where(self._active, nxt, 0)
        live = [(slot, self._slot_state[slot])
                for slot in list(self._slot_state) if self._active[slot]]
        # One shared stamp for every row that just emitted: the
        # per-token trail behind the TPOT histogram.
        self.ledger.tokens_emitted([row.rec for _, row in live])
        for slot, row in live:
            t = int(nxt[slot])
            row.emitted.append(t)
            if row.stop_token >= 0 and t == row.stop_token:
                self._retire(slot, "stop")
            elif len(row.emitted) >= row.max_new:
                self._retire(slot, "complete")
        if self._steps % 32 == 0:
            self._export_gauges()

    def _dispatch(self, fn: str, body, W: int | None = None):
        """Run ``body(sampled)`` for the live slots as the program of
        ``fn`` at this engine's signature: the sampled one when a live
        row samples, else the greedy one (the reference's test of the
        live slots picks its program the same way). A sampled program
        draws from the slots' generators (a window's acceptance and
        draft ones), which its capture registers."""
        sampled = bool((self._temps[self._active] > 0.0).any())
        dt = str(self.cfg.dtype).removeprefix("torch.")
        sig = (f"B={self.n_slots},W={W},dtype={dt},sampled={sampled}" if W
               else f"B={self.n_slots},dtype={dt},attn={self.attn},"
                    f"sampled={sampled}")
        if not sampled:
            return self._programs.run(fn, sig, lambda: body(False))
        gens = self._slot_agens + self._slot_dgens if W else self._slot_gens
        return self._programs.run(fn, sig, lambda: body(True), gens)

    def _decode_body(self, sampled: bool):
        """The plain step on the device: the write routing from the
        mirror, the decode forward, the next tokens, and the mirror's
        tokens and positions advanced in place. It reads and writes
        only the compute tree, the banks and the mirror's buffers.
        Returns (logits (B, V), next tokens (B,))."""
        sd, bt = self._sdev, self.block_tokens
        pos, active = sd["pos"], sd["active"]
        blk = torch.clamp(pos // bt, max=self.nb - 1).long()[:, None]
        wr_b = torch.where(active, sd["tables"].gather(1, blk)[:, 0], 0)
        logits, _, _ = gen.decode_step_paged(
            self._cparams, sd["tok"], pos, self.cfg, self.pool.k,
            self.pool.v, sd["tables"], wr_b, pos % bt, attn_impl=self.attn)
        if sampled:
            nxt = gen.sample_token_rows(logits, self._slot_gens,
                                        sd["temps"], sd["topk"], sd["topp"])
        else:
            nxt = torch.argmax(logits, dim=-1)
        nxt = torch.where(active, nxt, 0)
        sd["tok"].copy_(nxt)
        pos.copy_(torch.where(active, pos + 1, pos))
        return logits, nxt

    def _slot_arrays(self) -> dict:
        """The host arrays the mirror holds: int32 tables, allocation
        bounds and positions (the kernel's type), int64 tokens, the
        active lanes, the sampling filters (f32 temperatures and top-p,
        int32 top-k), and under speculation the draft's tables and
        bounds."""
        arrays = {"tables": self._tables, "nalloc": self._nalloc,
                  "active": self._active, "tok": self._tok,
                  "pos": self._pos, "temps": self._temps,
                  "topk": self._topk, "topp": self._topp}
        if self._dpool is not None:
            arrays.update(dtables=self._dtables, dnalloc=self._dnalloc)
        return arrays

    def _mirror(self) -> dict:
        """The device mirror of the slot state, refilled from the host
        arrays when it was dropped: each array one pinned, non-blocking
        upload into its static buffer, on the books as
        ``serve.slot_state``."""
        if self._sdev is None:
            for name, arr in self._slot_arrays().items():
                with jitwatch.sanctioned_transfer("serve.slot_state"):
                    self._upload(arr, self._sbuf[name])
            self._sdev = self._sbuf
        return self._sdev

    def _upload(self, arr: np.ndarray,
                out: torch.Tensor | None = None) -> torch.Tensor:
        """A host array into ``out`` (a new tensor on the engine's
        device when None) without a host wait: on CUDA staged in pinned
        memory and copied non-blocking (a pageable host-to-device copy
        synchronizes the stream). ``pin_memory`` stages each call in a
        fresh block of the caching host allocator, which holds the block
        until the copy has run."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if out is None:
            out = torch.empty(t.shape, dtype=t.dtype, device=self.device)
        if self.device.type == "cuda":
            t = t.pin_memory()
        return out.copy_(t, non_blocking=True)

    def _retire(self, slot: int, reason: str = "complete") -> None:
        self._active[slot] = False
        self._temps[slot] = 0.0
        self._sdev = None
        self._finish_row(self._slot_state.pop(slot), reason)
        self._export_gauges()

    def _finish_row(self, row: _PagedRow, reason: str = "complete") -> None:
        for bid in row.table:
            self.pool.deref(bid)
        row.table = []
        if row.reserve_left > 0:
            self.pool.unreserve(row.reserve_left)
        row.reserve_left = 0
        if self._dpool is not None:
            for bid in row.draft_table:
                self._dpool.deref(bid)
            row.draft_table = []
            if row.draft_reserve_left > 0:
                self._dpool.unreserve(row.draft_reserve_left)
            row.draft_reserve_left = 0
        self.ledger.retired(row.rec, reason)
        row.done.set()

    # ------------------------------------------------------ speculation

    def _draft_prefill(self, row: _PagedRow, toks, L: int) -> None:
        """Whole-prompt draft prefill into the row's draft table when
        it takes a slot (no prefix reuse: draft KV is specific to the
        draft's parameters, and the draft is the cheap model)."""
        bt = self.block_tokens
        while len(row.draft_table) * bt < L:
            row.draft_table.append(self._dpool.alloc())
            row.draft_reserve_left -= 1
        self._chunk(True, toks, 0, row.draft_table)

    def _draft_catch_up(self, slot: int, row: _PagedRow) -> None:
        """Write the draft's KV for positions the row committed through
        plain steps (k=0 stretches, one-token tails): without it a later
        window's draft attends through stale KV there, and the accept
        rate falls with nothing failing."""
        start, end = int(self._dpos[slot]), int(self._pos[slot])
        if start >= end:
            return
        seq = np.concatenate([row.prompt, np.asarray(row.emitted,
                                                     np.int64)])
        self._chunk(True, seq[start:end], start, row.draft_table)
        self._dpos[slot] = end

    def _spec_k_eff(self) -> int:
        """This iteration's proposal depth: the adaptive depth, capped
        at the deepest live row's remaining budget less one, so every
        write stays inside the reservation its row was admitted with.
        0 = a plain step; while speculation is off, a k=1 probe window
        runs every ``probe_every`` plain iterations."""
        if self._k_cur == 0:
            self._spec_probe_left -= 1
            if self._spec_probe_left > 0:
                return 0
            self._k_cur = 1
            # The probe's own accept rate decides: park the EWMA at the
            # floor.
            self._spec_ewma = self._spec.accept_floor
        live = [self._slot_state[s] for s in np.flatnonzero(self._active)]
        if not live:
            return 0
        max_r = max(r.max_new - len(r.emitted) for r in live)
        return max(0, min(self._k_cur, max_r - 1))

    def _spec_adapt(self) -> None:
        """Adaptive k: shed a depth a window while the accept EWMA is
        under the floor, turn speculation off at depth 1 under half the
        floor, climb back a depth at a time above the floor + 0.15."""
        sp, ew = self._spec, self._spec_ewma
        if ew < sp.accept_floor:
            if self._k_cur > 1:
                self._k_cur -= 1
            elif self._k_cur == 1 and ew < sp.accept_floor / 2:
                self._k_cur = 0
                self._spec_probe_left = int(sp.probe_every)
        elif ew > sp.accept_floor + 0.15 and self._k_cur < sp.k:
            self._k_cur += 1

    def _spec_window(self, W: int, sampled: bool, tok: torch.Tensor,
                     pos: torch.Tensor):
        """Draft ``W`` steps, verify ``W`` positions, accept — all on
        the device, the write routing computed from the device copies of
        the slot state: inactive lanes and positions past a row's
        allocated blocks write to trash block 0. Returns (out (B, W),
        n_acc (B,)) on the device."""
        sd, sp = self._sdev, self._spec
        bt = self.block_tokens
        ap = pos.long()[:, None] + torch.arange(W, device=pos.device)
        blk = torch.clamp(ap // bt, max=self.nb - 1)
        wr_o = ap % bt
        ok_t = sd["active"][:, None] & (ap // bt < sd["nalloc"][:, None])
        wr_b = torch.where(ok_t, sd["tables"].gather(1, blk), 0)
        ok_d = sd["active"][:, None] & (ap // bt < sd["dnalloc"][:, None])
        dwr_b = torch.where(ok_d, sd["dtables"].gather(1, blk), 0)
        # The sampling filters: a greedy window reads none.
        filters = ([sd["temps"], sd["topk"], sd["topp"]] if sampled
                   else [None] * 3)
        prop, dlg, _, _ = gen.draft_propose_paged(
            self._dparams, tok, pos, sp.draft_cfg, self._dpool.k,
            self._dpool.v, sd["dtables"], dwr_b, wr_o, self._slot_dgens,
            *filters, n_steps=W, sampled=sampled)
        toks_w = torch.cat([tok[:, None], prop[:, :W - 1]], dim=1)
        tlg, _, _ = gen.verify_step_paged(
            self._cparams, toks_w, pos, self.cfg, self.pool.k, self.pool.v,
            sd["tables"], wr_b, wr_o)
        return gen.spec_accept_rows(
            prop[:, :W - 1], dlg[:, :W - 1], tlg, self._slot_agens,
            *filters, sampled=sampled)

    def _window_body(self, W: int, sampled: bool) -> torch.Tensor:
        """One window from the mirror (:meth:`_spec_window`): its
        tokens and accept counts as one (B, W + 1) tensor, the window's
        one read."""
        sd = self._sdev
        out, n_acc = self._spec_window(W, sampled, sd["tok"], sd["pos"])
        return torch.cat([out, n_acc[:, None]], dim=1)

    def _spec_step(self, k_eff: int) -> None:
        """One speculation window over the live slots: ``k_eff``
        proposals a slot, one batched verify of ``k_eff + 1`` positions,
        acceptance — and ONE host read (tokens and accept counts) for
        the whole window."""
        W = k_eff + 1
        bt = self.block_tokens
        live = [int(s) for s in np.flatnonzero(self._active)]
        # Blocks for the window in both pools, from each row's
        # reservation: capped at the row's span (prompt + max_new), so
        # a reservation can never run out mid-window.
        for slot in live:
            row = self._slot_state[slot]
            need = min(int(self._pos[slot]) + W,
                       len(row.prompt) + row.max_new)
            while self._nalloc[slot] * bt < need:
                bid = self.pool.alloc()
                row.reserve_left -= 1
                row.table.append(bid)
                self._tables[slot, self._nalloc[slot]] = bid
                self._nalloc[slot] += 1
                self._sdev = None
            while self._dnalloc[slot] * bt < need:
                bid = self._dpool.alloc()
                row.draft_reserve_left -= 1
                row.draft_table.append(bid)
                self._dtables[slot, self._dnalloc[slot]] = bid
                self._dnalloc[slot] += 1
                self._sdev = None
            self._draft_catch_up(slot, row)
        self._mirror()
        self._steps += 1
        self._max_live = max(self._max_live, len(live))
        with self._lock, jitwatch.hot_region("serve.spec_window",
                                             self.device):
            host = self._dispatch("serve.spec_window", partial(
                self._window_body, W), W)
        with jitwatch.sanctioned_transfer("serve.spec_read"):
            host = host.cpu().numpy()  # the window's one host read
        # Ragged advances, committed on the host: the mirror goes stale.
        self._sdev = None
        emit_recs, emit_counts = [], []
        retires: list[tuple[int, str]] = []
        total_acc = total_emit = 0
        for slot in live:
            row = self._slot_state[slot]
            remaining = row.max_new - len(row.emitted)
            a = int(host[slot, W])
            toks = [int(t) for t in host[slot, :min(a + 1, remaining)]]
            reason = None
            if row.stop_token >= 0 and row.stop_token in toks:
                # Stop mid-window: commit through the stop token only.
                toks = toks[:toks.index(row.stop_token) + 1]
                reason = "stop"
            row.emitted.extend(toks)
            self._pos[slot] += len(toks)
            self._tok[slot] = toks[-1]
            # Draft KV is right through the accepted prefix; the new
            # last token's is written by the next window's first step.
            self._dpos[slot] = self._pos[slot]
            total_acc += a
            total_emit += len(toks)
            emit_recs.append(row.rec)
            emit_counts.append(len(toks))
            if reason is None and len(row.emitted) >= row.max_new:
                reason = "complete"
            if reason is not None:
                retires.append((slot, reason))
        self.ledger.tokens_emitted(emit_recs, emit_counts)
        rate = total_acc / max(1, k_eff * len(live))
        al = self._spec.ewma_alpha
        self._spec_ewma = (rate if self._spec_windows == 0
                           else al * rate + (1 - al) * self._spec_ewma)
        self._spec_windows += 1
        self.ledger.spec_window(k_eff * len(live), total_acc, total_emit,
                                self._spec_ewma)
        self._window_emitted = total_emit
        chaos.note_ok("serve.spec")
        for slot, reason in retires:
            self._retire(slot, reason)
        if self._spec.adaptive:
            self._spec_adapt()
        if self._steps % 32 == 0:
            self._export_gauges()

    def check_spec_reservations(self) -> list[str]:
        """Audit both pools' reservations against every live row's
        worst-case speculative advance. Call from the engine thread
        (tests wrap ``_spec_step``): row state is mid-mutation on any
        other."""
        if self._spec is None:
            return []
        rows_t, rows_d = [], []
        for slot in np.flatnonzero(self._active):
            row = self._slot_state.get(int(slot))
            if row is None:
                continue
            remaining = row.max_new - len(row.emitted)
            adv = min(self._k_cur, max(0, remaining - 1)) + 1
            rows_t.append((int(self._pos[slot]), int(self._nalloc[slot]),
                           row.reserve_left, adv))
            rows_d.append((int(self._pos[slot]), int(self._dnalloc[slot]),
                           row.draft_reserve_left, adv))
        bad = self.pool.check_invariants(spec_rows=rows_t)
        bad += [f"draft: {b}"
                for b in self._dpool.check_invariants(spec_rows=rows_d)]
        return bad

    # -------------------------------------------------------- telemetry

    def _record_stall(self, stall_ms: float) -> None:
        self._last_stall_ms = stall_ms
        self._max_stall_ms = max(self._max_stall_ms, stall_ms)

    def begin_drain(self) -> None:
        """Flip the admission gate — new requests shed typed from here
        on — and let the engine run the queue and live slots dry. The
        lifecycle lands in Info() and the ``serve.lifecycle`` gauge."""
        super().begin_drain()
        self._export_gauges()

    def drained(self) -> bool:
        """Draining, and nothing in flight, queued, admitting, live, or
        held by a migration (an export's parked refs on the prefill
        side, a planned ticket on the decode side)."""
        if not self._draining:
            return False
        with self._load_lock:
            if self._in_flight:
                return False
        with self._cond:
            if self._queue or self._admitting is not None:
                return False
            if self._exports or self._tickets:
                return False
        return not self._active.any()

    def _export_gauges(self) -> None:
        reg = self._reg
        reg.gauge("serve.lifecycle").set(
            LIFECYCLE_CODES.get(self.lifecycle, 2))
        reg.gauge("serve.class").set(
            SERVE_CLASS_CODES.get(self.serve_class, 0))
        # Open migration legs on this replica.
        reg.gauge("serve.migrate_inflight").set(
            len(self._tickets) + len(self._exports))
        st = self.pool.stats()
        reg.gauge("serve.kv_free_blocks").set(st["kv_free_blocks"])
        reg.gauge("serve.kv_util_pct").set(st["kv_util_pct"])
        reg.gauge("serve.prefix_hit_rate").set(self.prefix_hit_rate())
        reg.gauge("serve.prefill_stall_ms").set(
            round(self._max_stall_ms, 3))
        # A point-in-time gauge: read without _cond, so the engine
        # thread never contends admission for a sample.
        reg.gauge("serve.queue_depth").set(len(self._queue))
        # The kv.* pressure sample.
        self.ledger.kv_sample(st, self.prefix_hit_rate())

    def prefix_hit_rate(self) -> float:
        total = self._prefix_hits + self._prefix_misses
        return round(self._prefix_hits / total, 4) if total else 0.0

    def Info(self) -> dict:
        info = super().Info()
        with self._cond:
            info["queue_depth"] = len(self._queue)
            info["migrate_inflight"] = (len(self._tickets)
                                        + len(self._exports))
        info.update(self.pool.stats())
        info.update({
            "n_slots": self.n_slots,
            "attn": self.attn,
            "engine_steps": self._steps,
            "max_live_slots": self._max_live,
            "live_slots": int(self._active.sum()),
            "serve_class": self.serve_class,
            "migrations": self._migrations,
            "migrate_bytes": self._migrate_bytes,
            "migrate_dedup_hits": self._migrate_dedup_hits,
            "block_tokens": self.block_tokens,
            "prefill_chunk": self.prefill_chunk,
            "admit_timeout_s": self.admit_timeout_s,
            "prefix_hits": self._prefix_hits,
            "prefix_misses": self._prefix_misses,
            "prefix_hit_rate": self.prefix_hit_rate(),
            "prefill_chunks": self._prefill_chunks,
            "prefill_tokens": self._prefill_tokens,
            "prefill_stall_ms": round(self._max_stall_ms, 3),
            "prefill_stall_last_ms": round(self._last_stall_ms, 3),
        })
        # The ledger's TTFT/TPOT/e2e tails and the recent per-request
        # TTFT samples (sequence-tagged, so a probe never double-counts).
        info.update(self.ledger.summary())
        info["ttft_recent"] = self.ledger.ttft_recent()
        if self._spec is not None:
            # Speculation totals come from the ledger, their one home.
            prop, acc, toks = self.ledger.spec_totals()
            info.update({
                "spec_k": int(self._spec.k),
                "spec_k_cur": self._k_cur,
                "spec_windows": self._spec_windows,
                "spec_proposed": prop,
                "spec_accepted": acc,
                "spec_tokens": toks,
                "spec_accept_ewma": round(self._spec_ewma, 4),
                "kv_draft_free_blocks": self._dpool.free_blocks(),
            })
            if prop:
                # Only once speculation ran: absent (never speculated)
                # stays distinct from a rate that collapsed to 0.
                info["spec_accept_rate"] = round(acc / prop, 4)
        return info

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._thread.join(timeout=10)
        if not self._thread.is_alive():
            self._programs.close()
