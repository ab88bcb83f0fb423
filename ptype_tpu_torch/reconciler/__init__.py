"""Elastic replica lifecycle — the port of ``ptype_tpu/reconciler/``.

The control loop that ACTS on the cluster's serving signals: the
gateway's :class:`~ptype_tpu_torch.gateway.slo.ScaleHint` stream and
health pages drive a reconciler that spawns, drains, and replaces
serving replicas — with hysteresis (cooldown + hint-majority voting),
min/max bounds, warm standbys, and a drain-deadline escalation path.

- :mod:`~ptype_tpu_torch.reconciler.policy` — the pure decision math;
- :mod:`~ptype_tpu_torch.reconciler.replica` — replica lifecycle's one
  home (host, control endpoints, launchers);
- :mod:`~ptype_tpu_torch.reconciler.worker` — the OS-process replica
  entry (``python -m ptype_tpu_torch.reconciler.worker``);
- :mod:`~ptype_tpu_torch.reconciler.core` — the reconcile loop.

The names below are imported at first use (PEP 562), so a ``fake``
worker process that imports only ``replica`` never loads ``core`` and
torch with it.
"""

import importlib

#: Exported name → the module that defines it.
_EXPORTS = {
    "Reconciler": "core",
    "ReconcilerConfig": "core",
    "SCALE_UP_RULES": "core",
    "HysteresisPolicy": "policy",
    "ScaleDecision": "policy",
    "URGENT_REASONS": "policy",
    "ReplicaHost": "replica",
    "ReplicaCtl": "replica",
    "ReplicaHandle": "replica",
    "LocalReplicaHandle": "replica",
    "ProcessReplicaHandle": "replica",
    "LocalLauncher": "replica",
    "ProcessLauncher": "replica",
    "FakeGeneratorActor": "replica",
    "serve_actor": "replica",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        value = getattr(importlib.import_module(
            f"{__name__}.{_EXPORTS[name]}"), name)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
