"""Token streams for training — the port of ``ptype_tpu/train/data.py``.

:func:`synthetic_batches` draws on the device from a seeded
``torch.Generator``, so the input pipeline never holds a step back.
:class:`TokenFileDataset` reads a memory-mapped flat corpus and moves
batches to the device from a prefetch thread, one step ahead. The
multi-process slice of the reference (``local_row_range``) waits for
the mesh (ROADMAP).
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from ptype_tpu_torch.device import resolve_device


def synthetic_batches(vocab_size: int, batch: int, seq: int, seed: int = 0,
                      device=None):
    """Infinite iterator of {"tokens", "targets"} int64 tensors on
    ``device`` (cuda unless named). targets = tokens shifted by one
    (next-token LM); the stream is reproducible per seed."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    while True:
        toks = torch.randint(0, vocab_size, (batch, seq + 1), generator=gen,
                             device=device)
        yield {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def write_token_file(path: str, tokens, dtype=None) -> None:
    """Write a flat token array as a raw binary corpus file."""
    arr = np.asarray(tokens)
    arr.astype(dtype or arr.dtype).tofile(path)


class TokenFileDataset:
    """Memory-mapped flat token corpus → prefetched device batches.

    The corpus is ``np.memmap``-ed (no RAM copy, any size). A background
    thread gathers random windows and moves them to the device one step
    ahead, so the host→device copy overlaps the current step."""

    def __init__(self, path: str, dtype="uint16", device=None):
        self._data = np.memmap(path, dtype=np.dtype(dtype), mode="r")
        self.n_tokens = int(self._data.shape[0])
        self.device = resolve_device(device)

    def batches(self, batch: int, seq: int, seed: int = 0,
                prefetch: int = 2):
        """Infinite iterator of {"tokens", "targets"} int64 tensors on
        the device; random windows, reproducible per seed."""
        if self.n_tokens < seq + 2:
            raise ValueError(
                f"corpus has {self.n_tokens} tokens; need > {seq + 1}")
        rng = np.random.default_rng(seed)
        q: queue.Queue = queue.Queue(maxsize=prefetch)
        stop = threading.Event()
        err = object()

        def put(item) -> None:
            # Bounded put, so the thread exits promptly once the consumer
            # abandons the iterator (no thread left pinning device
            # memory, and an error is never stuck behind a full queue).
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return
                except queue.Full:
                    continue

        def producer():
            try:
                while not stop.is_set():
                    starts = rng.integers(0, self.n_tokens - seq - 1,
                                          size=batch)
                    rows = np.stack([np.asarray(self._data[s:s + seq + 1])
                                     for s in starts]).astype(np.int64)
                    t = torch.from_numpy(rows).to(self.device)
                    put({"tokens": t[:, :-1], "targets": t[:, 1:]})
            except Exception as e:  # noqa: BLE001 — surfaced to consumer
                put((err, e))

        t = threading.Thread(target=producer, name="token-prefetch",
                             daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if isinstance(item, tuple) and item[0] is err:
                    raise RuntimeError("token prefetch failed") from item[1]
                yield item
        finally:
            stop.set()  # generator closed or collected → producer exits
