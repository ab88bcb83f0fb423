"""The Prime actor — the port's twin of ``examples/optimus/prime.py``
(ref: example/optimus/prime.go:15-25).

``Check(lo, hi, target)`` scans ``[lo, hi)`` for a factor of ``target``
and returns the first one, or ``target`` when none divides it. The
reference runs the scan as a jitted ``lax.while_loop``; here it is one
vectorised int64 pass over the chunk on the worker's device —
``target % arange(lo, hi) == 0``, then the first hit — read back once.
Targets exceed int32 (600851475143), so every value stays int64.
"""

from __future__ import annotations

import torch


class Prime:
    def __init__(self, device):
        self.device = torch.device(device)

    def Check(self, lo: int, hi: int, target: int) -> int:
        lo, hi, target = max(int(lo), 2), int(hi), int(target)
        if hi <= lo:
            return target
        cand = torch.arange(lo, hi, dtype=torch.int64, device=self.device)
        hit = torch.remainder(
            torch.tensor(target, dtype=torch.int64, device=self.device),
            cand) == 0
        first = cand[torch.argmax(hit.to(torch.uint8))]
        found = int(torch.where(hit.any(), first, 0))
        return found if found else target
