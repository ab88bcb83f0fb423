"""Calculator server — the port's twin of ``examples/calculator/server.py``
(ref: example/calculator/server.go:15-41).

Register handlers → join → serve. ``$CONFIG`` selects the YAML (the
reference's files are data for both packages), ``$PTYPE_DEVICE`` the
device tensor arguments land and multiply on (``cuda`` when unset).

Run:  CONFIG=examples/calculator/server.yaml \\
      python -m ptype_tpu_torch.examples.calculator.server
"""

from __future__ import annotations

import os
import threading

from ptype_tpu_torch.actor import ActorServer
from ptype_tpu_torch.cluster import join
from ptype_tpu_torch.config import config_from_env
from ptype_tpu_torch.device import resolve_device
from ptype_tpu_torch.examples.calculator.calculator import Calculator


def main() -> None:
    cfg = config_from_env()
    device = resolve_device(os.environ.get("PTYPE_DEVICE") or None)
    server = ActorServer(port=cfg.port, device=device)
    server.register(Calculator(device))
    server.serve()
    cfg.port = server.port  # port 0 → advertise the bound port

    cluster = join(cfg, device=device)
    print(f"calculator server {cfg.node_name} serving on :{server.port} "
          f"({device})", flush=True)
    try:
        threading.Event().wait()  # serve forever (ref blocked on ListenAndServe)
    except KeyboardInterrupt:
        pass
    finally:
        cluster.close()
        server.close()


if __name__ == "__main__":
    main()
