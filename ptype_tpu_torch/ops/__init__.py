"""The port's kernels: each a CUDA C++ source under ``csrc/`` for
Hopper, a wrapper that launches it on CUDA tensors and counts the
launches, and its plain PyTorch version for CPU tensors —
:mod:`~ptype_tpu_torch.ops.flash_attention` (forward, dq, dk/dv) and
:mod:`~ptype_tpu_torch.ops.paged_attention`."""
