"""Cluster health plane demo: goodput, straggler detection, alerts — the
port's twin of ``examples/observability/health_demo.py``.

A simulated 3-worker fleet shares one process — each worker gets its
OWN metrics registry, goodput ledger and series sampler (what each real
process runs one of), a ``TensorStore`` on a world-1 process group on
``$PTYPE_DEVICE`` (``cuda`` when unset), and an actor server answering
``ptype.Telemetry`` from that node's state. A seeded chaos fault delays
one worker's ``store.push`` — a throttled card, a dying host — and the
closed loop runs end to end:

  chaos fault → TensorStore push seam → goodput ledger (collective
  leg inflates) → sampler series → telemetry pull →
  ``cluster_snapshot`` → straggler rule (median + k·MAD across nodes)
  → a typed Alert NAMING the slow worker → the ``obs top`` view.

Run:  PTYPE_DEVICE=cpu python -m ptype_tpu_torch.examples.observability.health_demo
"""

import os
import tempfile

N_WORKERS = 3
STEPS = 8
SLOW_WORKER = "w2"
SLOW_PUSH_S = 0.12


def main() -> None:
    import torch
    import torch.distributed as dist

    from ptype_tpu_torch import chaos
    from ptype_tpu_torch import metrics as metrics_mod
    from ptype_tpu_torch import telemetry
    from ptype_tpu_torch.actor import ActorServer
    from ptype_tpu_torch.chaos import FaultPlan, FaultSpec
    from ptype_tpu_torch.coord.core import CoordState
    from ptype_tpu_torch.coord.local import LocalCoord
    from ptype_tpu_torch.device import resolve_device
    from ptype_tpu_torch.health import (AlertEngine, GoodputLedger, Sampler,
                                        default_rules, render_top,
                                        telemetry_endpoint)
    from ptype_tpu_torch.parallel.mesh import build_mesh, init_distributed
    from ptype_tpu_torch.parallel.tensorstore import TensorStore
    from ptype_tpu_torch.registry import CoordRegistry

    device = resolve_device(os.environ.get("PTYPE_DEVICE") or None)
    state = CoordState(sweep_interval=0.1)
    registry = CoordRegistry(LocalCoord(state), lease_ttl=5.0)
    rdv = tempfile.mkdtemp(prefix="ptype-health-demo-")
    device = init_distributed(f"file://{rdv}/rdv", 0, 1, device=device)
    mesh = build_mesh({"data": 1}, device=device)
    grads = torch.ones((64, 64), dtype=torch.float32, device=device)

    class Worker:
        """One simulated training worker: its own registry, ledger,
        sampler, store — and a telemetry endpoint serving them."""

        def __init__(self, name: str):
            self.name = name
            self.reg = metrics_mod.MetricsRegistry()
            self.ledger = GoodputLedger(registry=self.reg,
                                        tokens_per_step=64 * 64)
            self.sampler = Sampler(registry=self.reg, cadence_s=0.03)
            self.store = TensorStore(mesh, device=device)
            self.server = ActorServer("127.0.0.1", 0, device=device)
            self.server.register_function(
                "ptype.Telemetry",
                telemetry_endpoint(self.reg, self.sampler.store, name))
            self.server.serve()
            self.registration = registry.register(
                "work", name, "127.0.0.1", self.server.port)

        def step(self, i: int) -> None:
            # The region names a real trainer runs through the
            # metrics.annotate seam — driven directly because several
            # simulated nodes share one process.
            with self.ledger.region("train.step"):
                with self.ledger.region("train.data"):
                    batch = grads + i
                with self.ledger.region(f"store.push/{self.name}"):
                    self.store.push(f"grads/{self.name}", batch,
                                    op="mean")
                    if device.type == "cuda":
                        # The push returns before the card has run it:
                        # wait, so the collective leg holds its time.
                        torch.cuda.synchronize(device)
            self.reg.gauge("train.loss").set(3.0 - 0.05 * i)

        def close(self) -> None:
            self.sampler.close()
            self.registration.close()
            self.server.close()

    workers = [Worker(f"w{i}") for i in range(N_WORKERS)]
    try:
        for w in workers:      # one push each BEFORE the clock runs
            w.step(0)
        for w in workers:
            w.sampler.start()

        # The fault: every one of SLOW_WORKER's pushes runs SLOW_PUSH_S
        # late — fired inside the store.push region, so the ledger
        # attributes it to the collective leg.
        chaos.arm(FaultPlan([FaultSpec("store.push", "delay",
                                       match=SLOW_WORKER,
                                       times=STEPS + 1,
                                       delay_s=SLOW_PUSH_S)]))
        for i in range(1, STEPS + 1):
            for w in workers:
                w.step(i)
        chaos.disarm()
        for w in workers:      # flush the final values into series
            w.sampler.sample_once()

        for w in workers:
            s = w.ledger.summary()
            print(f"{w.name}: goodput {s['goodput_pct']}% "
                  f"step {s['step_breakdown']['step_ms']}ms "
                  f"(collective {s['step_breakdown']['collective_ms']}ms)")

        snap = telemetry.cluster_snapshot(registry, include_local=False)
        engine = AlertEngine(default_rules())
        alerts = engine.evaluate(snap)
        print()
        print(render_top(snap, engine.recent()))
        print()
        # A node's identity in the snapshot (and so in the alert) is
        # its registry key — service/address:port.
        slow = next(w for w in workers if w.name == SLOW_WORKER)
        slow_key = f"work/127.0.0.1:{slow.server.port}"
        straggler = [a for a in alerts if a.rule == "straggler"]
        if not (straggler and straggler[0].node == slow_key):
            raise RuntimeError(f"no straggler alert naming {slow_key}: "
                               f"{alerts}")
        print(f"straggler alert names the afflicted node: "
              f"{straggler[0].node} (= {SLOW_WORKER})")
    finally:
        chaos.disarm()
        for w in workers:
            w.close()
        state.close()
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
