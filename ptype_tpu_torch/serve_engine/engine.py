"""The paged continuous-batching engine — the port of
``ptype_tpu/serve_engine/engine.py`` (its plain path).

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

Not ported yet (ROADMAP): the serving ledger, chaos/jitwatch/trace
seams, speculative decoding, KV migration (disaggregated serving).
"""

from __future__ import annotations

import logging
import threading
import time

import numpy as np
import torch

from ptype_tpu_torch.errors import ShedError
from ptype_tpu_torch.models import generate as gen
from ptype_tpu_torch.models import transformer as tfm
from ptype_tpu_torch.serve import GeneratorActor, _norm_prompt
from ptype_tpu_torch.serve_engine.blocks import BlockPool, block_hashes

log = logging.getLogger("ptype_tpu_torch.serve_engine")


class _PagedRow:
    """One prompt row: queued → admitting (chunked prefill) → active
    slot → done."""

    __slots__ = ("prompt", "max_new", "stop_token", "temperature",
                 "top_k", "top_p", "generator", "emitted", "done", "err",
                 "table", "hashes", "reused", "prefill_pos",
                 "reserve_left", "cancelled", "head_since")

    def __init__(self, prompt, max_new, stop_token, temperature, top_k,
                 top_p, generator):
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


class PagedGeneratorActor(GeneratorActor):
    """Continuous batching over the paged KV block pool.

    Knobs as in the reference: ``n_slots`` live sequences;
    ``block_tokens`` block size (a multiple of 8, also the prefix
    sharing granularity); ``n_blocks`` pool size (default
    ``n_slots × reach/block_tokens + 1``); ``prefill_chunk`` prompt
    tokens per engine iteration (``None``: whole prompts);
    ``max_queue``; ``admit_timeout_s`` (0: wait forever); ``attn``
    "gather" or "kernel".
    """

    def __init__(self, cfg: tfm.TransformerConfig, params=None,
                 generator: torch.Generator | None = None, device=None,
                 n_slots: int = 8, max_len: int | None = None,
                 block_tokens: int = 16, n_blocks: int | None = None,
                 prefill_chunk: int | None = 64, max_queue: int = 64,
                 admit_timeout_s: float = 10.0, attn: str = "gather"):
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
                g = None
                if float(temperature) != 0.0:
                    g = torch.Generator(device=self.device).manual_seed(
                        int(seed))
                rows.append(_PagedRow(host[i], max_new, int(stop_token),
                                      float(temperature), int(top_k),
                                      float(top_p), g))
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
                self._plain_step()

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
        if not self.pool.try_reserve(need):
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
        self._finish_row(self._slot_state.pop(slot))

    def _finish_row(self, row: _PagedRow) -> None:
        for bid in row.table:
            self.pool.deref(bid)
        row.table = []
        if row.reserve_left > 0:
            self.pool.unreserve(row.reserve_left)
        row.reserve_left = 0
        row.done.set()

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
        return info

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._thread.join(timeout=10)
