"""Replica worker: the OS process a :class:`ProcessLauncher` spawns —
the port's copy of ``ptype_tpu/reconciler/worker.py``.

``python -m ptype_tpu_torch.reconciler.worker`` reads its whole
configuration from the environment (the multiprocess-worker idiom the
chaos plan already uses — ``PTYPE_CHAOS_PLAN`` arms faults here with
zero code changes):

========================== ==========================================
``PTYPE_REPLICA_COORD``    coordinator address (host:port) to join
``PTYPE_REPLICA_SERVICE``  public service name (default ``llm``)
``PTYPE_REPLICA_NODE``     this replica's node name
``PTYPE_REPLICA_KIND``     ``fake`` | ``paged`` | ``custom``
                           (default ``paged``)
``PTYPE_REPLICA_PRESET``   model preset for ``paged`` (default tiny)
``PTYPE_REPLICA_FACTORY``  for ``custom``: ``module:function`` whose
                           call builds the actor — trainer replicas
                           and future engines ride the same
                           lifecycle with zero worker changes
                           (an optional ``warmup`` attribute on the
                           function is the warm-up hook)
``PTYPE_REPLICA_SERVE_CLASS`` ``unified`` | ``prefill`` | ``decode``
                           — the disaggregated-serving role stamped
                           on a ``paged`` engine; the gateway's
                           two-stage router reads it back from
                           ``Info()``
``PTYPE_REPLICA_DEVICE``   where a ``paged`` engine runs and where the
                           server decodes tensor arguments (``cpu``,
                           ``cuda:1``...). Unset: ``cuda``, and with no
                           card a ``paged`` worker raises before it
                           reports ready — it never serves on the CPU
                           unasked
``PTYPE_REPLICA_DOMAIN``   topology domain ordinal (optional) —
                           advertised in the registration metadata for
                           the gateway's locality-aware routing
``PTYPE_REPLICA_WARM``     ``1`` = hold warm (spawn + load params +
                           warm up, but do NOT register — the
                           standby-pool state; the reconciler's
                           ``Replica.Activate`` registers it later)
``PTYPE_REPLICA_READY_FILE`` path the worker writes
                           ``{"host","port","pid"}`` to once its
                           server answers — the spawn handshake
========================== ==========================================

The worker serves ``Generator.*`` plus the ``Replica.*`` control
endpoints and then parks until the host's exit event fires (drain
complete, ``Replica.Exit``, or SIGTERM), deregistering on the way
out; the replies already running (the order that ended it among them)
are written before its server shuts their connections. Lifecycle —
spawn, warm-up, activate, drain, exit — lives entirely in
:class:`~ptype_tpu_torch.reconciler.replica.ReplicaHost`; this file is
only the process skin around it.
"""

from __future__ import annotations

import json
import os
import signal

from ptype_tpu_torch import logs

log = logs.get_logger("reconciler.worker")


def _actor_factory(kind: str, preset: str, device):
    if kind == "fake":
        from ptype_tpu_torch.reconciler.replica import FakeGeneratorActor

        delay_s = float(os.environ.get("PTYPE_REPLICA_DELAY_S", "0"))
        return (lambda: FakeGeneratorActor(delay_s=delay_s)), None
    if kind == "paged":
        def make():
            from ptype_tpu_torch.models import transformer as tfm
            from ptype_tpu_torch.serve_engine.engine import (
                PagedGeneratorActor)

            serve_class = os.environ.get("PTYPE_REPLICA_SERVE_CLASS",
                                         "unified")
            return PagedGeneratorActor(tfm.preset(preset),
                                       serve_class=serve_class,
                                       device=device)

        def warmup(actor):
            import torch

            # One 1-token generate, read back to the host: the first
            # prefill and decode step (and their kernels' loads) run
            # NOW, so activation never pays them in a scale-up's
            # critical path.
            out = actor.Generate(torch.ones((1, 4), dtype=torch.int32,
                                            device=actor.device), 1)
            out.cpu()

        return make, warmup
    if kind == "custom":
        # Any actor — a trainer, an eval server, a future engine —
        # rides the same lifecycle: PTYPE_REPLICA_FACTORY names a
        # ``module:function`` whose call returns the actor (an
        # optional ``warmup`` attribute on the function is the
        # warm-up hook). This is how elastic trainers plug into the
        # reconciler without new worker code.
        spec = os.environ.get("PTYPE_REPLICA_FACTORY", "")
        mod_name, _, fn_name = spec.partition(":")
        if not mod_name or not fn_name:
            raise SystemExit(
                "worker: kind=custom needs "
                "PTYPE_REPLICA_FACTORY=module:function")
        import importlib

        fn = getattr(importlib.import_module(mod_name), fn_name)
        return fn, getattr(fn, "warmup", None)
    raise SystemExit(f"unknown PTYPE_REPLICA_KIND {kind!r} "
                     f"(fake|paged|custom)")


def main() -> None:
    coord_addr = os.environ.get("PTYPE_REPLICA_COORD")
    if not coord_addr:
        raise SystemExit("worker: set PTYPE_REPLICA_COORD=host:port")
    service = os.environ.get("PTYPE_REPLICA_SERVICE", "llm")
    node = os.environ.get("PTYPE_REPLICA_NODE", f"replica-{os.getpid()}")
    kind = os.environ.get("PTYPE_REPLICA_KIND", "paged")
    preset = os.environ.get("PTYPE_REPLICA_PRESET", "tiny")
    warm_hold = os.environ.get("PTYPE_REPLICA_WARM") == "1"
    ready_file = os.environ.get("PTYPE_REPLICA_READY_FILE")
    dom_raw = os.environ.get("PTYPE_REPLICA_DOMAIN", "")
    domain = int(dom_raw) if dom_raw else None
    device = os.environ.get("PTYPE_REPLICA_DEVICE") or None

    from ptype_tpu_torch.coord.remote import RemoteCoord
    from ptype_tpu_torch.reconciler.replica import ReplicaHost
    from ptype_tpu_torch.registry import CoordRegistry

    coord = RemoteCoord([coord_addr])
    registry = CoordRegistry(coord)
    factory, warmup = _actor_factory(kind, preset, device)
    host = ReplicaHost(registry, service, node, factory,
                       warmup=warmup, warm_hold=warm_hold,
                       domain=domain, device=device)

    def _term(*_):
        host.request_exit()

    signal.signal(signal.SIGTERM, _term)

    if ready_file:
        tmp = ready_file + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"host": host.host, "port": host.port,
                       "pid": os.getpid()}, f)
        os.replace(tmp, ready_file)  # atomic: spawn never reads half
    log.info("replica worker serving",
             kv={"service": service, "node": node,
                 "addr": host.key, "kind": kind,
                 "warm_hold": warm_hold})
    try:
        host.wait_exit()
    except KeyboardInterrupt:
        pass
    finally:
        host.close()
        coord.close()


if __name__ == "__main__":
    main()
