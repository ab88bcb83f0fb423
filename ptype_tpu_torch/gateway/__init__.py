"""Inference gateway — the cluster frontdoor for generator fleets; the
port's copy of ``ptype_tpu/gateway/``.

See :mod:`ptype_tpu_torch.gateway.frontdoor` for the architecture
overview: admission (:mod:`~ptype_tpu_torch.gateway.admission`), the
replica pool (:mod:`~ptype_tpu_torch.gateway.pool`), the fleet's prefix
directory (:mod:`~ptype_tpu_torch.gateway.directory`) and the SLO
tracker (:mod:`~ptype_tpu_torch.gateway.slo`).
"""

from ptype_tpu_torch.errors import ShedError
from ptype_tpu_torch.gateway.admission import AdmissionQueue
from ptype_tpu_torch.gateway.directory import PrefixDirectory
from ptype_tpu_torch.gateway.frontdoor import (GatewayActor, GatewayConfig,
                                               InferenceGateway,
                                               least_loaded_picker)
from ptype_tpu_torch.gateway.pool import Replica, ReplicaPool
from ptype_tpu_torch.gateway.slo import ScaleHint, SLOTracker

__all__ = [
    "AdmissionQueue",
    "GatewayActor",
    "GatewayConfig",
    "InferenceGateway",
    "PrefixDirectory",
    "Replica",
    "ReplicaPool",
    "ScaleHint",
    "SLOTracker",
    "ShedError",
    "least_loaded_picker",
]
