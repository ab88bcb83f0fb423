"""Model serving — the port of ``ptype_tpu/serve.py`` (``GeneratorActor``).

A :class:`GeneratorActor` serves ``Generate`` (the contiguous KV-cache
decode of ``models/generate.py``), ``Logits`` and ``Info`` over a
parameter dict, one request at a time, with the reference's drain
contract. It runs on ``cuda`` unless ``device`` names another; with no
CUDA device and none named, construction raises.

Not ported yet (ROADMAP): ``BatchingGeneratorActor``.
"""

from __future__ import annotations

import logging
import threading

import torch

from ptype_tpu_torch.device import resolve_device
from ptype_tpu_torch.errors import ShedError
from ptype_tpu_torch.models import generate as gen
from ptype_tpu_torch.models import transformer as tfm
from ptype_tpu_torch.models.weights import init_params

log = logging.getLogger("ptype_tpu_torch.serve")


def _norm_prompt(prompt, device) -> torch.Tensor:
    """Tokens → (B, S) int64 on ``device`` (a bare (S,) gets a batch
    dim)."""
    prompt = torch.as_tensor(prompt).to(device=device, dtype=torch.int64)
    return prompt[None] if prompt.dim() == 1 else prompt


def _pow2(n: int) -> int:
    """Smallest power of two >= n (the reference's compile-cache
    bucketing; kept for the batching actor of a later slice)."""
    return 1 << max(n - 1, 0).bit_length()


def memory_info(device: torch.device) -> dict:
    """Device memory watermarks (bytes) for ``Info``."""
    if device.type != "cuda":
        return {}
    return {"device_bytes_in_use": torch.cuda.memory_allocated(device),
            "device_peak_bytes": torch.cuda.max_memory_allocated(device)}


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
        self._lock = threading.Lock()
        self._calls = 0
        #: Requests inside Generate/Logits; its own lock, since _lock is
        #: held for a whole decode loop and Info must answer meanwhile.
        self._load_lock = threading.Lock()
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
        log.info("replica draining, in_flight=%d", in_flight)

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
            with self._lock:
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
            with self._lock:
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
            "memory": memory_info(self.device),
        }
