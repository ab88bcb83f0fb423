"""The port's health plane — for now the serving ledger
(:mod:`ptype_tpu_torch.health.serving`): per-request lifecycle records,
TTFT/TPOT/e2e histograms, engine-iteration composition and KV-pool
pressure; and tail forensics (:mod:`ptype_tpu_torch.health.forensics`):
the stage vocabulary, per-stage budgets and the culprit of a slow
request."""

from ptype_tpu_torch.health.serving import (ITER_WINDOW, REQUEST_WINDOW,
                                            RETIRE_REASONS, TTFT_RECENT,
                                            RequestRecord, ServingLedger,
                                            measure_seam_cost_us)

__all__ = ["ITER_WINDOW", "REQUEST_WINDOW", "RETIRE_REASONS",
           "TTFT_RECENT", "RequestRecord", "ServingLedger",
           "measure_seam_cost_us"]
