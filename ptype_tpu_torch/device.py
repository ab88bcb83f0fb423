"""Device selection for the port's entry points."""

from __future__ import annotations


def resolve_device(device=None) -> "torch.device":  # noqa: F821
    """The device an entry point runs on: ``cuda`` unless the caller
    names another. With no CUDA device and none named this raises —
    the port never drops to the CPU on its own. (torch is imported
    here, not with the module, so the control plane can import this
    without it.)"""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "on the CPU")
        return torch.device("cuda")
    return torch.device(device)
