"""Open-loop traffic observatory — the port's copy of
``ptype_tpu/loadgen/``.

Trace-driven load generation and capacity measurement for the serving
stack: seeded arrival processes + shared-prefix request populations
(:mod:`~ptype_tpu_torch.loadgen.arrivals`), an open-loop driver that issues
on schedule whether or not the fleet keeps up
(:mod:`~ptype_tpu_torch.loadgen.driver`), a :class:`TrafficLedger`
publishing ``loadgen.*`` series through the sampler/telemetry plane
(:mod:`~ptype_tpu_torch.loadgen.ledger`), and the capacity-frontier sweep
that turns rate points into a measured knee
(:mod:`~ptype_tpu_torch.loadgen.frontier`). One seeded RNG home
(:mod:`~ptype_tpu_torch.loadgen.rng`) keeps every trace replayable
from its seed, and the same seed gives the reference's trace bit for
bit.
"""

from ptype_tpu_torch.loadgen.arrivals import (AGENT, CHAT, DEFAULT_MIX,
                                              RAG, Arrival, FamilySpec,
                                              TrafficTrace, bursty_schedule,
                                              diurnal_schedule,
                                              poisson_schedule,
                                              prompt_tokens, synth_trace)
from ptype_tpu_torch.loadgen.driver import (ClosedLoopDriver, DriverConfig,
                                            OpenLoopDriver, gateway_target)
from ptype_tpu_torch.loadgen.frontier import (Frontier, RatePoint,
                                              locate_knee, publish_knee,
                                              point_from_summary,
                                              shed_burn_curve, sweep)
from ptype_tpu_torch.loadgen.ledger import Outcome, TrafficLedger
from ptype_tpu_torch.loadgen.rng import TraceRng

__all__ = [
    "Arrival", "FamilySpec", "TrafficTrace", "synth_trace",
    "prompt_tokens", "poisson_schedule", "bursty_schedule",
    "diurnal_schedule", "CHAT", "RAG", "AGENT", "DEFAULT_MIX",
    "OpenLoopDriver", "ClosedLoopDriver", "DriverConfig",
    "gateway_target",
    "TrafficLedger", "Outcome",
    "Frontier", "RatePoint", "sweep", "locate_knee", "publish_knee",
    "point_from_summary", "shed_burn_curve",
    "TraceRng",
]
