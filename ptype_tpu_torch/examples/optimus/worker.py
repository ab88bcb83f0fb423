"""Prime worker — the port's twin of ``examples/optimus/worker.py`` (ref:
example/optimus/worker.go:15-41).

``$CONFIG`` selects the YAML, ``$PTYPE_DEVICE`` the device the scans run
on (``cuda`` when unset).

Run:  CONFIG=examples/optimus/worker.yaml \\
      python -m ptype_tpu_torch.examples.optimus.worker
"""

from __future__ import annotations

import os
import threading

from ptype_tpu_torch.actor import ActorServer
from ptype_tpu_torch.cluster import join
from ptype_tpu_torch.config import config_from_env
from ptype_tpu_torch.device import resolve_device
from ptype_tpu_torch.examples.optimus.prime import Prime


def main() -> None:
    cfg = config_from_env()
    device = resolve_device(os.environ.get("PTYPE_DEVICE") or None)
    server = ActorServer(port=cfg.port, device=device)
    server.register(Prime(device))
    server.serve()
    cfg.port = server.port

    cluster = join(cfg, device=device)
    print(f"prime worker {cfg.node_name} serving on :{server.port} "
          f"({device})", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        cluster.close()
        server.close()


if __name__ == "__main__":
    main()
