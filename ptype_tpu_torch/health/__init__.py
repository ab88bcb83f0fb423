"""The port's cluster health plane — the counterpart of
``ptype_tpu/health/``: bounded per-process time series sampled from the
metrics registry (:mod:`~ptype_tpu_torch.health.series`), a per-step
goodput ledger + cross-node straggler detection over the
``metrics.annotate`` seam (:mod:`~ptype_tpu_torch.health.goodput`),
declarative alert rules with an engine that logs, counts, and triggers
flight-recorder dumps (:mod:`~ptype_tpu_torch.health.rules`), the live
``obs top`` views (:mod:`~ptype_tpu_torch.health.top`), the profiling
plane on ``torch.profiler`` (:mod:`~ptype_tpu_torch.health.profiling`:
the ``ptype.Profile`` actor endpoint, alert-triggered capture, and
counted-cost MFU), the serving ledger
(:mod:`~ptype_tpu_torch.health.serving`) and tail forensics
(:mod:`~ptype_tpu_torch.health.forensics`).

Importing it loads no torch: the profiling and measurement functions
import it when called.
"""

from ptype_tpu_torch.health.goodput import (GoodputLedger, detect_stragglers,
                                            node_series_means,
                                            node_span_means)
from ptype_tpu_torch.health.profiling import (AlertCapture, ProfileError,
                                              compiled_cost,
                                              measure_compiled_cost,
                                              summarize)
from ptype_tpu_torch.health.rules import (Alert, AlertEngine, BurnRateRule,
                                          CapacityHeadroomRule,
                                          ClusterView, CoordFlapRule,
                                          KvPressureRule, LossRule,
                                          MemoryGrowthRule, MfuGapRule,
                                          MigrationStallRule,
                                          P99Rule, PrefixHitCollapseRule,
                                          RecompileStormRule,
                                          ReshardStallRule, Rule,
                                          ServeStallRule, StallRule,
                                          StragglerRule, TtftRule,
                                          default_rules)
from ptype_tpu_torch.health.series import (Sampler, SeriesRing, SeriesStore,
                                           telemetry_endpoint)
from ptype_tpu_torch.health.serving import (ITER_WINDOW, REQUEST_WINDOW,
                                            RETIRE_REASONS, TTFT_RECENT,
                                            RequestRecord, ServingLedger,
                                            measure_seam_cost_us)
from ptype_tpu_torch.health.top import (render_jit, render_scale,
                                        render_serve, render_top,
                                        render_topo, render_traffic,
                                        run_jit, run_scale, run_serve,
                                        run_top, run_topo, run_traffic)

__all__ = [
    "SeriesRing", "SeriesStore", "Sampler", "telemetry_endpoint",
    "GoodputLedger", "detect_stragglers", "node_series_means",
    "node_span_means",
    "ServingLedger", "RequestRecord", "measure_seam_cost_us",
    "ITER_WINDOW", "REQUEST_WINDOW", "RETIRE_REASONS", "TTFT_RECENT",
    "AlertCapture", "ProfileError", "compiled_cost",
    "measure_compiled_cost", "summarize",
    "Alert", "AlertEngine", "ClusterView", "Rule", "BurnRateRule",
    "P99Rule", "StallRule", "StragglerRule", "LossRule",
    "CoordFlapRule", "MemoryGrowthRule", "MfuGapRule", "TtftRule",
    "KvPressureRule", "PrefixHitCollapseRule", "ServeStallRule",
    "RecompileStormRule", "MigrationStallRule", "ReshardStallRule",
    "CapacityHeadroomRule",
    "default_rules",
    "render_top", "run_top", "render_serve", "run_serve",
    "render_scale", "run_scale", "render_jit", "run_jit",
    "render_topo", "run_topo", "render_traffic", "run_traffic",
]
