"""ptype_tpu_torch — the PyTorch + CUDA port of ptype_tpu's serving path.

A second package beside ``ptype_tpu`` (the JAX reference, which it never
imports). It mirrors the reference's layout and names so each module's
counterpart is easy to find:

- :mod:`ptype_tpu_torch.models.transformer` — config, presets, forward;
- :mod:`ptype_tpu_torch.models.weights` — the reference parameter tree
  carried across as tensors, and a seeded ``init_params``;
- :mod:`ptype_tpu_torch.models.generate` — contiguous and paged
  KV-cache generation;
- :mod:`ptype_tpu_torch.ops.flash_attention` and
  :mod:`ptype_tpu_torch.ops.paged_attention` — the two hand-written
  Hopper kernels (CUDA C++ under ``ops/csrc/``) with their plain
  PyTorch versions;
- :mod:`ptype_tpu_torch.serve` — ``GeneratorActor``;
- :mod:`ptype_tpu_torch.serve_engine` — the paged continuous-batching
  ``PagedGeneratorActor`` and its ``BlockPool``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no CUDA device and no device named they raise.
"""

__all__ = ["errors", "device"]
