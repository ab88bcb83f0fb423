"""Calculator client — the port's twin of ``examples/calculator/client.py``
(ref: example/calculator/client.go:14-45).

Join → ``new_client("calculator")`` → call: the scalar call the
reference made, and a tensor call whose operands are made on
``$PTYPE_DEVICE`` (``cuda`` when unset) and whose reply lands there.

Run:  CONFIG=examples/calculator/client.yaml \\
      python -m ptype_tpu_torch.examples.calculator.client
"""

from __future__ import annotations

import os

import torch

from ptype_tpu_torch.cluster import join
from ptype_tpu_torch.config import config_from_env
from ptype_tpu_torch.device import resolve_device


def main() -> None:
    device = resolve_device(os.environ.get("PTYPE_DEVICE") or None)
    cluster = join(config_from_env(), device=device)
    try:
        client = cluster.new_client("calculator")
        print("3 * 7 =", client.call("Calculator.Multiply", 3, 7))

        a = torch.arange(4, dtype=torch.float32, device=device)
        b = torch.full((4,), 2.0, dtype=torch.float32, device=device)
        out = client.call("Calculator.Multiply", a, b)
        print("tensor multiply:", torch.as_tensor(out).cpu().numpy())
        client.close()
    finally:
        cluster.close()


if __name__ == "__main__":
    main()
