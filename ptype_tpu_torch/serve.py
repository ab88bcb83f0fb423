"""Model serving — the port of ``ptype_tpu/serve.py``.

A :class:`GeneratorActor` serves ``Generate`` (the contiguous KV-cache
decode of ``models/generate.py``), ``Logits`` and ``Info`` over a
parameter dict, one request at a time, with the reference's drain
contract. :class:`BatchingGeneratorActor` coalesces concurrent greedy
requests into one decode loop (dynamic batching). Both run on ``cuda``
unless ``device`` names another; with no CUDA device and none named,
construction raises.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from ptype_tpu_torch import lockcheck, logs
from ptype_tpu_torch import metrics as metrics_mod
from ptype_tpu_torch.device import device_work, resolve_device
from ptype_tpu_torch.errors import ShedError
from ptype_tpu_torch.models import generate as gen
from ptype_tpu_torch.models import transformer as tfm
from ptype_tpu_torch.models.weights import init_params

log = logs.get_logger("serve")

#: Replica lifecycle states, reported through ``Info()``; numeric codes
#: back the ``serve.lifecycle`` gauge.
LIFECYCLES = ("spawning", "warm", "active", "draining", "drained")
LIFECYCLE_CODES = {name: i for i, name in enumerate(LIFECYCLES)}


def _norm_prompt(prompt, device) -> torch.Tensor:
    """Tokens → (B, S) int64 on ``device`` (a bare (S,) gets a batch
    dim)."""
    with device_work():
        prompt = torch.as_tensor(prompt).to(device=device,
                                            dtype=torch.int64)
    return prompt[None] if prompt.dim() == 1 else prompt


def _pow2(n: int) -> int:
    """Smallest power of two >= n (the reference's compile-cache
    bucketing; the batching actor keeps it, so both packages batch the
    same rows to the same shapes)."""
    return 1 << max(n - 1, 0).bit_length()


class GeneratorActor:
    """Generation endpoint over a parameter dict.

    Serializes requests (one decode loop at a time). ``params`` default
    to :func:`init_params` drawn from ``generator`` (a CPU generator
    seeded 0 when None), placed on ``device``.
    """

    def __init__(self, cfg: tfm.TransformerConfig, params=None,
                 generator: torch.Generator | None = None, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if params is None:
            generator = (generator if generator is not None
                         else torch.Generator().manual_seed(0))
            params = init_params(generator, cfg, device=self.device)
        self.params = params
        #: The decode (dispatch) lock: held for a whole solo decode loop.
        self._lock = lockcheck.lock("serve.actor.decode")
        self._calls = 0
        #: Requests inside Generate/Logits; its own lock, since _lock is
        #: held for a whole decode loop and Info must answer meanwhile.
        self._load_lock = lockcheck.lock("serve.actor.load")
        self._in_flight = 0
        self.lifecycle = "active"
        self._draining = False

    def _enter_request(self) -> None:
        with self._load_lock:
            self._in_flight += 1

    def _exit_request(self) -> None:
        with self._load_lock:
            self._in_flight -= 1

    # ------------------------------------------------------------- drain

    def _check_draining(self) -> None:
        """Refuse NEW work with a typed shed while draining. Called
        after ``_enter_request`` so a request is counted before it
        passes the gate (``drained()`` can never miss it)."""
        with self._load_lock:
            draining = self._draining
        if draining:
            raise ShedError("replica draining (scale-down in "
                            "progress); route elsewhere",
                            retry_after_s=0.05)

    def begin_drain(self) -> None:
        with self._load_lock:
            self._draining = True
            in_flight = self._in_flight
        self.lifecycle = "draining"
        log.info("replica draining", kv={"in_flight": in_flight})

    def drained(self) -> bool:
        with self._load_lock:
            return self._draining and self._in_flight == 0

    # --------------------------------------------------------- endpoints

    def Generate(self, prompt, max_new_tokens: int = 16,
                 temperature: float = 0.0, seed: int = 0,
                 top_k: int = 0, top_p: float = 1.0,
                 stop_token: int = -1, pad_token: int = 0,
                 repetition_penalty: float = 1.0):
        """prompt: (B, S) tokens → (B, max_new_tokens) int64. Sampling
        draws from a generator seeded with ``seed``."""
        prompt = _norm_prompt(prompt, self.device)
        self._enter_request()
        try:
            self._check_draining()
            with self._load_lock:
                self._calls += 1
            with device_work(), self._lock:
                generator = torch.Generator(
                    device=self.device).manual_seed(int(seed))
                return gen.generate(
                    self.params, self.cfg, prompt, int(max_new_tokens),
                    float(temperature), generator, top_k=int(top_k),
                    top_p=float(top_p), stop_token=int(stop_token),
                    pad_token=int(pad_token),
                    repetition_penalty=float(repetition_penalty))
        finally:
            self._exit_request()

    @torch.no_grad()
    def Logits(self, tokens):
        """Full-sequence logits (B, S, V) f32 — the eval endpoint."""
        tokens = _norm_prompt(tokens, self.device)
        self._enter_request()
        try:
            self._check_draining()
            with device_work(), self._lock:
                return tfm.forward(self.params, tokens, self.cfg)
        finally:
            self._exit_request()

    def Info(self) -> dict:
        with self._load_lock:
            in_flight = self._in_flight
            calls = self._calls
        return {
            "n_params": tfm.count_params(self.params),
            "d_model": self.cfg.d_model,
            "n_layers": self.cfg.n_layers,
            "vocab_size": self.cfg.vocab_size,
            "max_seq": self.cfg.max_seq,
            "calls": calls,
            "lifecycle": self.lifecycle,
            "in_flight": in_flight,
            "queue_depth": max(0, in_flight - 1),
            "device": str(self.device),
            # Device memory watermarks, also refreshed into the mem.*
            # gauges.
            "memory": metrics_mod.record_memory_gauges(device=self.device),
        }


class _Pending:
    __slots__ = ("prompt", "max_new", "done", "out", "err")

    def __init__(self, prompt, max_new):
        self.prompt = prompt          # (b_i, S) int64 tokens
        self.max_new = max_new
        self.done = threading.Event()
        self.out = None
        self.err = None


class BatchingGeneratorActor(GeneratorActor):
    """GeneratorActor with dynamic request batching.

    Concurrent GREEDY requests that share ``max_new_tokens`` coalesce
    into one decode loop, mixed prompt lengths included: the batcher
    thread takes the first queued request, drains more for up to
    ``window_ms``, and buckets rows and padded length to powers of two
    as the reference does, so both packages batch the same requests to
    the same shapes. A group of equal-length rows that needs no length
    padding runs the uniform prefill — the path the flash kernel serves
    when S is a multiple of 128; any other group is left-padded and
    runs the ragged path (``generate(prompt_lens=...)``), which the
    kernel does not take (it has no key mask). The reference sends
    every group down the ragged path to keep its compile cache to one
    program a bucket; eager PyTorch compiles nothing. Greedy rows are
    independent, so batched results match solo results. Sampled,
    repetition-penalty and stop-token requests run through the solo
    path, keeping their exact per-request semantics.

    This is dynamic batching, not continuous batching: requests join
    at loop boundaries, not mid-decode.
    """

    def __init__(self, cfg: tfm.TransformerConfig, params=None,
                 generator: torch.Generator | None = None, device=None,
                 window_ms: float = 5.0, max_batch: int = 32):
        super().__init__(cfg, params, generator, device)
        self.window_s = window_ms / 1000.0
        self.max_batch = max_batch
        self._queue: list[_Pending] = []
        self._cond = lockcheck.condition("serve.batcher")
        self._closed = False
        self._batches = 0
        self._batched_requests = 0
        self._thread = threading.Thread(
            target=self._worker, name="generate-batcher", daemon=True)
        self._thread.start()

    def Generate(self, prompt, max_new_tokens: int = 16,
                 temperature: float = 0.0, seed: int = 0,
                 top_k: int = 0, top_p: float = 1.0,
                 stop_token: int = -1, pad_token: int = 0,
                 repetition_penalty: float = 1.0):
        if (float(temperature) != 0.0
                or float(repetition_penalty) != 1.0
                or int(stop_token) >= 0):
            # Per-request sampling and stop masking: the solo path.
            return super().Generate(prompt, max_new_tokens, temperature,
                                    seed, top_k, top_p, stop_token,
                                    pad_token, repetition_penalty)
        req = _Pending(_norm_prompt(prompt, self.device),
                       int(max_new_tokens))
        self._enter_request()
        try:
            self._check_draining()
            with self._cond:
                if self._closed:
                    raise RuntimeError("generator actor is closed")
                self._queue.append(req)
                self._cond.notify()
            req.done.wait()
            if req.err is not None:
                raise req.err
            return req.out
        finally:
            self._exit_request()

    # ------------------------------------------------------------ worker

    def _worker(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._closed:
                    self._cond.wait()
                if self._closed and not self._queue:
                    return
                # The first request opens a window; arrivals within it
                # join this round.
                deadline = time.monotonic() + self.window_s
                rows = sum(p.prompt.shape[0] for p in self._queue)
                while rows < self.max_batch and not self._closed:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    got = self._cond.wait(timeout=remaining)
                    rows = sum(p.prompt.shape[0] for p in self._queue)
                    if not got:
                        break
                # Take at most max_batch rows (a burst can overshoot the
                # cap); a single request larger than max_batch runs
                # alone, uncapped.
                batch, rows = [], 0
                while self._queue:
                    nxt_rows = self._queue[0].prompt.shape[0]
                    if batch and rows + nxt_rows > self.max_batch:
                        break
                    batch.append(self._queue.pop(0))
                    rows += nxt_rows
            with device_work():
                self._run_round(batch)

    def _run_round(self, batch: list[_Pending]) -> None:
        """Group by max_new only: mixed prompt lengths coalesce through
        the left-padded ragged path. Rows and padded lengths bucket to
        powers of two (the row pad repeats the first row)."""
        groups: dict[int, list[_Pending]] = {}
        for p in batch:
            groups.setdefault(p.max_new, []).append(p)
        for max_new, reqs in groups.items():
            try:
                rows = [r for p in reqs for r in p.prompt.cpu().numpy()]
                n = len(rows)
                rows += [rows[0]] * (_pow2(n) - n)
                S = max(len(r) for r in rows)
                # Bucket the padded length too (further left-pad; lens
                # stay exact), capped so bucketing never pushes a group
                # past max_seq that its members fit in one by one.
                S_b = max(S, min(_pow2(S), self.cfg.max_seq - max_new))
                if S_b == S and all(len(r) == S for r in rows):
                    prompts = torch.as_tensor(np.stack(rows),
                                              device=self.device)
                    lens = None
                else:
                    prompts, lens = gen.pad_prompts(rows,
                                                    device=self.device)
                    if S_b > S:
                        prompts = torch.nn.functional.pad(prompts,
                                                          (S_b - S, 0))
                with self._load_lock:
                    self._calls += len(reqs)
                    self._batches += 1
                    self._batched_requests += len(reqs)
                with self._lock:
                    out = gen.generate(self.params, self.cfg, prompts,
                                       max_new, 0.0, prompt_lens=lens)
                row = 0
                for p in reqs:
                    b = p.prompt.shape[0]
                    p.out = out[row:row + b]
                    row += b
                    p.done.set()
            except Exception as e:  # noqa: BLE001 — deliver to callers
                for p in reqs:
                    if not p.done.is_set():
                        p.err = e
                        p.done.set()

    def Info(self) -> dict:
        info = super().Info()
        with self._load_lock:
            info["batches"] = self._batches
            info["batched_requests"] = self._batched_requests
        with self._cond:
            # Requests queued for a batching round, not lock-waiters.
            info["queue_depth"] = len(self._queue)
        return info

    def close(self) -> None:
        with self._cond:
            self._closed = True
            # Claim not-yet-taken requests under the lock: whatever the
            # worker already took it will finish serving.
            stragglers, self._queue = self._queue, []
            self._cond.notify_all()
        for p in stragglers:
            if not p.done.is_set():
                p.err = RuntimeError("generator actor closed")
                p.done.set()
        self._thread.join(timeout=5)


def __getattr__(name: str):
    """Lazy re-exports (PEP 562), as the reference's ``serve`` has: the
    continuous engine lives in :mod:`ptype_tpu_torch.serve_engine` (the
    paged KV cache with prefix reuse and chunked prefill), and
    ``ContinuousGeneratorActor`` is that engine under its older name.
    Importing it here eagerly would cycle (the engine subclasses
    ``GeneratorActor``)."""
    if name in ("ContinuousGeneratorActor", "PagedGeneratorActor"):
        from ptype_tpu_torch.serve_engine.engine import PagedGeneratorActor

        return PagedGeneratorActor
    raise AttributeError(f"module {__name__!r} has no attribute "
                         f"{name!r}")
