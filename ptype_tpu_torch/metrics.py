"""Throughput and MFU for training loops — the port's own copy of
``StepStats`` and ``mfu`` from ``ptype_tpu/metrics.py``.

The peak table names the card. A device it does not know has no peak,
and then :func:`mfu` is ``None``: the port never credits a run against
another chip's rate (the reference falls back to the TPU v5e peak).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

#: Dense bf16 tensor-core peak, TFLOP/s, by a substring of the device
#: name. H100 SXM: 989 TFLOP/s (NVIDIA's H100 data sheet), at its full
#: 700 W power limit.
PEAK_TFLOPS = {"H100": 989.0}


def device_peak_tflops(device=None) -> float | None:
    """The bf16 peak of ``device`` (a CUDA device; the current one when
    None), or None for a device the table does not name — the CPU
    included."""
    device = torch.device(device if device is not None else "cuda")
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(device)
    for key, tf in PEAK_TFLOPS.items():
        if key in name:
            return tf
    return None


def mfu(tokens_per_sec: float, flops_per_token: float, n_chips: int,
        peak_tflops: float | None) -> float | None:
    """Model FLOPs utilization, achieved over peak; None without a
    peak."""
    if not peak_tflops:
        return None
    return tokens_per_sec * flops_per_token / (peak_tflops * 1e12 * n_chips)


@dataclass
class StepStats:
    """Rolling per-step throughput tracker for training loops."""

    flops_per_token: float
    n_chips: int
    peak_tflops: float | None = None
    tokens: int = 0
    seconds: float = 0.0
    steps: int = 0
    _t0: float = field(default=0.0, repr=False)

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def step(self, n_tokens: int, n_steps: int = 1) -> None:
        """Fold ``n_tokens`` of COMPLETED work (``n_steps`` train steps)
        into the rolling rates. Callers that dispatch asynchronously call
        this only at drain boundaries: crediting tokens at dispatch time
        measures the queueing rate, not compute."""
        now = time.perf_counter()
        self.seconds += now - self._t0
        self._t0 = now
        self.tokens += n_tokens
        self.steps += n_steps

    @property
    def tokens_per_sec(self) -> float:
        return self.tokens / self.seconds if self.seconds else 0.0

    @property
    def tokens_per_sec_per_chip(self) -> float:
        return self.tokens_per_sec / max(self.n_chips, 1)

    @property
    def mfu(self) -> float | None:
        return mfu(self.tokens_per_sec, self.flops_per_token, self.n_chips,
                   self.peak_tflops)
