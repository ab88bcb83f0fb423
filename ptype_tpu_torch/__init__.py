"""ptype_tpu_torch — the PyTorch + CUDA port of ptype_tpu's serving and
training paths.

A second package beside ``ptype_tpu`` (the JAX reference, which it never
imports). It mirrors the reference's layout and names so each module's
counterpart is easy to find:

- :mod:`ptype_tpu_torch.models.transformer` — config, presets, forward,
  and the loss with its fused chunked head;
- :mod:`ptype_tpu_torch.models.weights` — the reference parameter tree
  carried across as tensors, and a seeded ``init_params``;
- :mod:`ptype_tpu_torch.models.generate` — contiguous and paged
  KV-cache generation;
- :mod:`ptype_tpu_torch.ops.flash_attention` — differentiable flash
  attention: the forward, dq and dk/dv kernels under a
  ``torch.autograd.Function``;
- :mod:`ptype_tpu_torch.ops.paged_attention` — paged decode attention;
  each kernel is hand-written CUDA C++ for Hopper under ``ops/csrc/``,
  beside its plain PyTorch version;
- :mod:`ptype_tpu_torch.serve` — ``GeneratorActor`` and the dynamic
  batching ``BatchingGeneratorActor``;
- :mod:`ptype_tpu_torch.serve_engine` — the paged continuous-batching
  ``PagedGeneratorActor``, its ``BlockPool``, and the KV wire of
  disaggregated prefill/decode (``KVMigrator``);
- :mod:`ptype_tpu_torch.health` — the ``ServingLedger`` (TTFT, TPOT,
  e2e, iteration composition, KV pressure) and tail forensics;
- :mod:`ptype_tpu_torch.gateway` — the ``InferenceGateway``: admission,
  the replica pool, prefix-affine and two-stage disaggregated routing
  over RPC, the SLO tracker, and ``GatewayActor``;
- :mod:`ptype_tpu_torch.loadgen` — seeded traffic traces, the
  open-loop driver, the ``TrafficLedger`` and the capacity frontier;
- :mod:`ptype_tpu_torch.reconciler` — the elastic replica lifecycle:
  the ``HysteresisPolicy``, ``ReplicaHost`` and its launchers (in
  process, or ``python -m ptype_tpu_torch.reconciler.worker``
  processes), and the ``Reconciler`` loop that spawns, warms,
  activates, drains and replaces replicas on the gateway's scale hints;
- :mod:`ptype_tpu_torch.parallel` — the data plane on
  ``torch.distributed``: meshes, collectives with the int8+EF wire and
  the bucket planner, the ``TensorStore``, the ZeRO ladder;
- :mod:`ptype_tpu_torch.checkpoint` — sharded, async checkpoints in
  the reference's step-directory layout (``Checkpointer``,
  ``ZeroCheckpoint``, ``StoreCheckpoint``);
- :mod:`ptype_tpu_torch.elastic` — the ``FailureDetector`` and
  ``ElasticZeroTrainer``'s live reshard onto survivors;
- the cluster plane, copied from the reference: ``join`` and
  :class:`Cluster` (``cluster``), the TCP coordinator and its client
  (``coord/``), ``ActorServer`` (``actor``), the balanced RPC
  ``Client`` (``rpc``) over the native wire (``native``), the two-level
  ``Config`` (``config``), the ``registry`` and the ``store``;
- host modules copied from the reference: ``lockcheck``, ``chaos``,
  ``trace``, ``logs``, ``codec``, ``retry``;
- :mod:`ptype_tpu_torch.train` — the AdamW ``Trainer``, its train and
  eval steps, token streams, and ``store_dp.StoreDPTrainer``
  (data-parallel training through the Store);
- :mod:`ptype_tpu_torch.metrics` — throughput and MFU against the card's
  peak, the metrics registry, memory gauges and profiler ranges.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no CUDA device and no device named they raise.

The names the reference exports at its top level are exported here too,
each imported at its first use (PEP 562), so ``import ptype_tpu_torch``
loads nothing and a control-plane-only process never imports torch.
"""

import importlib

#: Exported name → the module that defines it.
_EXPORTS = {
    "ActorServer": "actor",
    "Client": "rpc",
    "ConnConfig": "rpc",
    "DEFAULT_CONN_CONFIG": "rpc",
    "Cluster": "cluster",
    "join": "cluster",
    "Config": "config",
    "PlatformConfig": "config",
    "config_from_env": "config",
    "config_from_file": "config",
    "ClusterError": "errors",
    "ConfigError": "errors",
    "ErrNoClientAvailable": "errors",
    "ErrNoKey": "errors",
    "NoClientAvailableError": "errors",
    "NoKeyError": "errors",
    "RPCError": "errors",
    "KVStore": "store",
    "Node": "registry",
    "Registry": "registry",
}

__all__ = sorted(_EXPORTS) + ["errors", "device"]


def __getattr__(name):
    if name in _EXPORTS:
        value = getattr(importlib.import_module(
            f"{__name__}.{_EXPORTS[name]}"), name)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
