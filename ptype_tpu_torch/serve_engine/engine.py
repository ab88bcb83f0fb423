"""The paged continuous-batching engine — the port of
``ptype_tpu/serve_engine/engine.py``: the plain path and speculative
decoding.

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
:class:`~ptype_tpu_torch.errors.ShedError`. The head-of-line wait is a
``time.monotonic()`` stamp on the row.

Speculative decoding (``spec=SpecConfig(...)``): a draft model with
its own block tables in a second :class:`BlockPool` proposes ``k``
tokens a live slot, the target scores all ``k + 1`` positions in one
batched forward on the gather path, and acceptance commits each row's
accepted prefix plus one token — greedy output identical to the plain
engine's. A window's write routing is computed from device tensors and
the window reads the host back once (its tokens and accept counts).
Rejected positions roll back by rewinding the position; no block is
reallocated. Admission reserves a request's worst case in both pools.

Not ported yet (ROADMAP): the serving ledger, chaos/jitwatch/trace
seams (``serve.spec`` among them), KV migration (disaggregated serving)
and migration with speculation.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from ptype_tpu_torch.errors import ShedError
from ptype_tpu_torch.models import generate as gen
from ptype_tpu_torch.models import transformer as tfm
from ptype_tpu_torch.serve import GeneratorActor, _norm_prompt
from ptype_tpu_torch.serve_engine.blocks import BlockPool, block_hashes

log = logging.getLogger("ptype_tpu_torch.serve_engine")


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
                 "reserve_left", "cancelled", "head_since", "draft_table",
                 "draft_reserve_left", "draft_gen", "accept_gen")

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
        self.cancelled = False
        #: When the row was first refused a reservation at the queue
        #: head (None: not refused yet).
        self.head_since: float | None = None
        #: The draft model's block table and reservation in the draft
        #: pool (speculative decoding only).
        self.draft_table: list[int] = []
        self.draft_reserve_left = 0
        #: Sampled rows under speculation: the draft-draw and the
        #: acceptance-draw generators.
        self.draft_gen = draft_gen
        self.accept_gen = accept_gen


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
    decoding.
    """

    def __init__(self, cfg: tfm.TransformerConfig, params=None,
                 generator: torch.Generator | None = None, device=None,
                 n_slots: int = 8, max_len: int | None = None,
                 block_tokens: int = 16, n_blocks: int | None = None,
                 prefill_chunk: int | None = 64, max_queue: int = 64,
                 admit_timeout_s: float = 10.0, attn: str = "gather",
                 spec: SpecConfig | None = None):
        super().__init__(cfg, params, generator, device)
        if attn not in ("gather", "kernel"):
            raise ValueError(f"attn must be 'gather'|'kernel', "
                             f"got {attn!r}")
        if attn == "kernel" and self.device.type == "cuda":
            from ptype_tpu_torch.ops.paged_attention import (
                kernel_geometry_problems)

            bad = kernel_geometry_problems(cfg.n_heads, cfg.kv_heads,
                                           cfg.head_dim, cfg.dtype)
            if bad:
                raise ValueError("paged-attention kernel cannot take "
                                 "this config: " + "; ".join(bad))
        self.attn = attn
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
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._spec_tokens = 0
        #: Device copies of the slot state a window routes with
        #: (tables, allocation bounds, active lanes); None = upload
        #: again (set at admission, retire and block allocation).
        self._sdev: dict | None = None

        ns = self.n_slots
        self._tables = np.zeros((ns, self.nb), np.int32)
        self._nalloc = np.zeros(ns, np.int32)
        self._tok = np.zeros(ns, np.int64)
        self._pos = np.zeros(ns, np.int32)
        self._active = np.zeros(ns, bool)
        self._temps = np.zeros(ns, np.float32)
        self._topk = np.zeros(ns, np.int32)
        self._topp = np.ones(ns, np.float32)
        self._gens: list[torch.Generator | None] = [None] * ns
        self._draft_gens: list[torch.Generator | None] = [None] * ns
        self._accept_gens: list[torch.Generator | None] = [None] * ns
        self._dtables = np.zeros((ns, self.nb), np.int32)
        self._dnalloc = np.zeros(ns, np.int32)
        #: First position whose draft KV is not written yet: plain steps
        #: advance the target alone, and the next window catches the
        #: draft up from here.
        self._dpos = np.zeros(ns, np.int32)
        self._slot_state: dict[int, _PagedRow] = {}
        self._queue: list[_PagedRow] = []
        self._admitting: _PagedRow | None = None
        self._cond = threading.Condition()
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
            self._check_draining()
            host = prompt.cpu().numpy()
            rows = []
            for i in range(prompt.shape[0]):
                g = dg = ag = None
                if float(temperature) != 0.0:
                    g = torch.Generator(device=self.device).manual_seed(
                        int(seed))
                    if self._spec is not None:
                        dg = gen.folded_generator(seed, gen._DRAFT_FOLD,
                                                  self.device)
                        ag = gen.folded_generator(seed, gen._ACCEPT_FOLD,
                                                  self.device)
                rows.append(_PagedRow(host[i], max_new, int(stop_token),
                                      float(temperature), int(top_k),
                                      float(top_p), g, dg, ag))
            with self._load_lock:
                self._calls += 1
            with self._cond:
                if self._closed:
                    raise RuntimeError("generator actor is closed")
                if (self.max_queue
                        and len(self._queue) + len(rows) > self.max_queue):
                    raise ShedError(
                        f"serving backlog full ({len(self._queue)} "
                        f"queued, cap {self.max_queue})",
                        retry_after_s=self._retry_after_locked())
                self._queue.extend(rows)
                self._cond.notify()
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
                        q.done.set()
                    else:
                        kept.append(q)
                self._queue = kept

    def _retry_after_locked(self) -> float:
        """(under _cond) A backlog-proportional retry hint."""
        backlog = len(self._queue) + len(self._slot_state) + 1
        return round(max(0.05, backlog * 0.1), 3)

    # ------------------------------------------------------------ engine

    def _engine(self) -> None:
        """Any escape — clean close or an engine error — fails every
        pending row, so no caller hangs in ``done.wait()``."""
        err: Exception | None = None
        try:
            with torch.no_grad():
                self._engine_loop()
        except Exception as e:  # noqa: BLE001 — delivered to callers
            err = e
            log.exception("paged engine died")
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
                r.done.set()

    def _engine_loop(self) -> None:
        while True:
            with self._cond:
                while (not self._queue and self._admitting is None
                       and not self._active.any() and not self._closed):
                    self._cond.wait()
                if self._closed:
                    return
            for slot in list(self._slot_state):
                if self._active[slot] and self._slot_state[slot].cancelled:
                    self._retire(slot)
            # The admission round is bounded by prefill_chunk prompt
            # tokens: that budget is the stall a co-batched decode sees.
            waiting = self._active.any()
            t0 = time.monotonic()
            self._admission_round()
            if waiting:
                self._record_stall((time.monotonic() - t0) * 1e3)
            if self._active.any():
                self._step()

    def _admission_round(self) -> None:
        budget = self.prefill_chunk
        while budget > 0:
            with self._cond:
                self._maybe_start_admission_locked()
                row = self._admitting
                if row is not None and row.cancelled:
                    self._admitting = None
            if row is not None and row.cancelled:
                self._finish_row(row)
                continue
            if row is None:
                break
            budget -= self._prefill_one_chunk(row, budget)

    def _maybe_start_admission_locked(self) -> None:
        """(under _cond) Move the queue head into admission when a slot
        is free and the pool can cover its worst case; FIFO."""
        if self._admitting is not None or not self._queue:
            return
        if self._active.all():
            return
        row = self._queue[0]
        need = -(-(len(row.prompt) + row.max_new) // self.block_tokens)
        reserved = self.pool.try_reserve(need)
        if (reserved and self._dpool is not None
                and not self._dpool.try_reserve(need)):
            # Both pools or neither: a row admitted against the target
            # pool alone would dead-end at its first draft write.
            self.pool.unreserve(need)
            reserved = False
        if not reserved:
            now = time.monotonic()
            if row.head_since is None:
                row.head_since = now
            if (self.admit_timeout_s > 0
                    and now - row.head_since > self.admit_timeout_s):
                self._queue.pop(0)
                row.err = ShedError(
                    f"kv pool exhausted: need {need} blocks, free "
                    f"{self.pool.free_blocks()} after "
                    f"{self.admit_timeout_s:g}s at queue head",
                    retry_after_s=self._retry_after_locked())
                row.done.set()
            return
        row.reserve_left = need
        if self._dpool is not None:
            row.draft_reserve_left = need
        self._queue.pop(0)
        self._admitting = row

    def _prefill_one_chunk(self, row: _PagedRow, budget: int) -> int:
        """Prefill one bounded chunk of the admitting ``row``; returns
        the prompt tokens written."""
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
        start = row.prefill_pos
        n = max(1, min(self.prefill_chunk, L - start, budget))
        while len(row.table) * bt < start + n:
            row.table.append(self.pool.alloc())
            row.reserve_left -= 1
        table = np.zeros(self.nb, np.int32)
        table[:len(row.table)] = row.table
        dev = self.device
        logits, _, _ = gen.prefill_paged_chunk(
            self.params, torch.as_tensor(toks[None, start:start + n],
                                         device=dev),
            start, n, self.cfg, self.pool.k, self.pool.v,
            torch.as_tensor(table, device=dev))
        row.prefill_pos += n
        self._prefill_chunks += 1
        self._prefill_tokens += n
        if row.prefill_pos < L:
            return n
        # Prompt resident: seal the freshly computed full blocks, emit
        # the first token.
        for i in range(row.reused, len(row.hashes)):
            self.pool.seal(row.table[i], row.hashes[i],
                           toks[i * bt:(i + 1) * bt])
        first = int(gen.sample_token_rows(
            logits, [row.generator], [row.temperature], [row.top_k],
            [row.top_p])[0])
        row.emitted.append(first)
        with self._cond:
            self._admitting = None
        stopped = row.stop_token >= 0 and first == row.stop_token
        if row.max_new == 1 or stopped:
            self._finish_row(row)
        else:
            if self._dpool is not None:
                self._draft_prefill(row, toks, L)
            self._take_slot(row, first, L)
        return n

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
        self._gens[slot] = row.generator
        if self._dpool is not None:
            self._dtables[slot] = 0
            self._dtables[slot, :len(row.draft_table)] = row.draft_table
            self._dnalloc[slot] = len(row.draft_table)
            self._dpos[slot] = L  # the draft prefill wrote 0..L-1
            self._draft_gens[slot] = row.draft_gen
            self._accept_gens[slot] = row.accept_gen
        self._sdev = None

    def _step(self) -> None:
        """One engine iteration over the live slots: a speculation
        window when speculation is armed and earns its depth, else the
        plain one-token step."""
        if self._spec is not None:
            k_eff = self._spec_k_eff()
            if k_eff >= 1:
                self._spec_step(k_eff)
                return
        self._plain_step()

    def _plain_step(self) -> None:
        """One batched decode step over every slot (inactive lanes write
        to the trash block and are ignored)."""
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
        rows = np.arange(self.n_slots)
        blk = np.minimum(self._pos // bt, self.nb - 1)
        wr_b = np.where(self._active, self._tables[rows, blk], 0)
        dev = self.device
        logits, _, _ = gen.decode_step_paged(
            self.params, torch.as_tensor(self._tok, device=dev),
            torch.as_tensor(self._pos, device=dev), self.cfg,
            self.pool.k, self.pool.v,
            torch.as_tensor(self._tables, device=dev),
            torch.as_tensor(wr_b, device=dev),
            torch.as_tensor(self._pos % bt, device=dev),
            attn_impl=self.attn)
        if (self._temps[self._active] > 0.0).any():
            nxt = gen.sample_token_rows(logits, self._gens, self._temps,
                                        self._topk, self._topp)
        else:
            nxt = torch.argmax(logits, dim=-1)
        nxt = nxt.cpu().numpy()
        self._steps += 1
        self._max_live = max(self._max_live, int(self._active.sum()))
        self._pos[self._active] += 1
        self._tok = np.where(self._active, nxt, 0)
        for slot in list(self._slot_state):
            if not self._active[slot]:
                continue
            row = self._slot_state[slot]
            t = int(nxt[slot])
            row.emitted.append(t)
            if ((row.stop_token >= 0 and t == row.stop_token)
                    or len(row.emitted) >= row.max_new):
                self._retire(slot)

    def _retire(self, slot: int) -> None:
        self._active[slot] = False
        self._temps[slot] = 0.0
        self._gens[slot] = None
        self._draft_gens[slot] = None
        self._accept_gens[slot] = None
        self._sdev = None
        self._finish_row(self._slot_state.pop(slot))

    def _finish_row(self, row: _PagedRow) -> None:
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
        row.done.set()

    # ------------------------------------------------------ speculation

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device without a host wait: on
        CUDA through pinned memory with a non-blocking copy (a pageable
        host-to-device copy synchronizes the stream)."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type != "cuda":
            return t.clone()
        return t.pin_memory().to(self.device, non_blocking=True)

    def _draft_chunk(self, toks, start: int, table: list[int]) -> None:
        """Write the draft's KV for ``toks`` at positions ``start..``
        through the draft table ``table`` (one paged prefill chunk)."""
        tarr = np.zeros(self.nb, np.int32)
        tarr[:len(table)] = table
        dev = self.device
        gen.prefill_paged_chunk(
            self._spec.draft_params,
            torch.as_tensor(np.asarray(toks)[None], device=dev), start,
            len(toks), self._spec.draft_cfg, self._dpool.k, self._dpool.v,
            torch.as_tensor(tarr, device=dev))

    def _draft_prefill(self, row: _PagedRow, toks, L: int) -> None:
        """Whole-prompt draft prefill into the row's draft table when
        it takes a slot (no prefix reuse: draft KV is specific to the
        draft's parameters, and the draft is the cheap model)."""
        bt = self.block_tokens
        while len(row.draft_table) * bt < L:
            row.draft_table.append(self._dpool.alloc())
            row.draft_reserve_left -= 1
        self._draft_chunk(toks, 0, row.draft_table)

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
        self._draft_chunk(seq[start:end], start, row.draft_table)
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
        prop, dlg, _, _ = gen.draft_propose_paged(
            sp.draft_params, tok, pos, sp.draft_cfg, self._dpool.k,
            self._dpool.v, sd["dtables"], dwr_b, wr_o, self._draft_gens,
            self._temps, self._topk, self._topp, n_steps=W,
            sampled=sampled)
        toks_w = torch.cat([tok[:, None], prop[:, :W - 1]], dim=1)
        tlg, _, _ = gen.verify_step_paged(
            self.params, toks_w, pos, self.cfg, self.pool.k, self.pool.v,
            sd["tables"], wr_b, wr_o)
        return gen.spec_accept_rows(
            prop[:, :W - 1], dlg[:, :W - 1], tlg, self._accept_gens,
            self._temps, self._topk, self._topp, sampled=sampled)

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
        if self._sdev is None:
            self._sdev = {
                "tables": self._upload(self._tables),
                "dtables": self._upload(self._dtables),
                "nalloc": self._upload(self._nalloc),
                "dnalloc": self._upload(self._dnalloc),
                "active": self._upload(self._active),
            }
        sampled = bool((self._temps[self._active] > 0.0).any())
        self._steps += 1
        self._max_live = max(self._max_live, len(live))
        out, n_acc = self._spec_window(W, sampled, self._upload(self._tok),
                                       self._upload(self._pos))
        # The window's one host read.
        host = torch.cat([out, n_acc[:, None]], dim=1).cpu().numpy()
        retire = []
        total_acc = total_emit = 0
        for slot in live:
            row = self._slot_state[slot]
            remaining = row.max_new - len(row.emitted)
            a = int(host[slot, W])
            toks = [int(t) for t in host[slot, :min(a + 1, remaining)]]
            if row.stop_token >= 0 and row.stop_token in toks:
                # Stop mid-window: commit through the stop token only.
                toks = toks[:toks.index(row.stop_token) + 1]
                retire.append(slot)
            elif len(row.emitted) + len(toks) >= row.max_new:
                retire.append(slot)
            row.emitted.extend(toks)
            self._pos[slot] += len(toks)
            self._tok[slot] = toks[-1]
            # Draft KV is right through the accepted prefix; the new
            # last token's is written by the next window's first step.
            self._dpos[slot] = self._pos[slot]
            total_acc += a
            total_emit += len(toks)
        rate = total_acc / max(1, k_eff * len(live))
        al = self._spec.ewma_alpha
        self._spec_ewma = (rate if self._spec_windows == 0
                           else al * rate + (1 - al) * self._spec_ewma)
        self._spec_windows += 1
        self._spec_proposed += k_eff * len(live)
        self._spec_accepted += total_acc
        self._spec_tokens += total_emit
        for slot in retire:
            self._retire(slot)
        if self._spec.adaptive:
            self._spec_adapt()

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

    def drained(self) -> bool:
        """Draining, and nothing in flight, queued, admitting or live."""
        if not self._draining:
            return False
        with self._load_lock:
            if self._in_flight:
                return False
        with self._cond:
            if self._queue or self._admitting is not None:
                return False
        return not self._active.any()

    def prefix_hit_rate(self) -> float:
        total = self._prefix_hits + self._prefix_misses
        return round(self._prefix_hits / total, 4) if total else 0.0

    def Info(self) -> dict:
        info = super().Info()
        with self._cond:
            info["queue_depth"] = len(self._queue)
        info.update(self.pool.stats())
        info.update({
            "n_slots": self.n_slots,
            "attn": self.attn,
            "engine_steps": self._steps,
            "max_live_slots": self._max_live,
            "live_slots": int(self._active.sum()),
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
        if self._spec is not None:
            # The reference's spec_* keys, from the engine's own counters
            # until the serving ledger is ported.
            info.update({
                "spec_k": int(self._spec.k),
                "spec_k_cur": self._k_cur,
                "spec_windows": self._spec_windows,
                "spec_proposed": self._spec_proposed,
                "spec_accepted": self._spec_accepted,
                "spec_tokens": self._spec_tokens,
                "spec_accept_ewma": round(self._spec_ewma, 4),
                "kv_draft_free_blocks": self._dpool.free_blocks(),
            })
            if self._spec_proposed:
                # Only once speculation ran: absent (never speculated)
                # stays distinct from a rate that collapsed to 0.
                info["spec_accept_rate"] = round(
                    self._spec_accepted / self._spec_proposed, 4)
        return info

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._thread.join(timeout=10)
