"""The Calculator actor — the port's twin of
``examples/calculator/calculator.py`` (ref: example/calculator/
calculator.go:9-12).

``Multiply`` takes scalars or tensors: tensor arguments arrive on the
server's device (the actor codec decodes them there), the multiply runs
there, and each tensor multiply prints the device it ran on.
"""

from __future__ import annotations

import torch


class Calculator:
    def __init__(self, device):
        self.device = torch.device(device)

    def Multiply(self, a, b):
        if torch.is_tensor(a) or torch.is_tensor(b):
            a = torch.as_tensor(a, device=self.device)
            b = torch.as_tensor(b, device=self.device)
            print(f"tensor multiply on {a.device} and {b.device}",
                  flush=True)
            return a * b
        return a * b
