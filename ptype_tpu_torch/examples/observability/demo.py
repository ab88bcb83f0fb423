"""Observability demo: a tiny traced fleet, end to end — the port's twin
of ``examples/observability/demo.py``.

It stands up the serving stack in one process — a coordinator on real
TCP, the registry, two worker actors over real sockets and an inference
gateway fronting them — arms the trace plane, pushes a handful of
requests (one of them afflicted by a seeded chaos fault, to show fault
and recovery span events), then pulls the cluster telemetry snapshot and
writes the stitched Chrome trace.

Open the printed ``trace.json`` in https://ui.perfetto.dev (or
chrome://tracing): every request is one connected gantt —
``gateway.request`` → ``gateway.admit`` → ``gateway.route`` →
``rpc.call`` → ``actor/Work.Do`` — with chaos events pinned to the
request they landed in. Artifacts land in ``$OBS_DIR`` (default
/tmp/ptype-obs-demo); the gateway and the actor servers take
``$PTYPE_DEVICE`` (``cuda`` when unset).

Run:  PTYPE_DEVICE=cpu python -m ptype_tpu_torch.examples.observability.demo
"""

import os
import time


def main() -> None:
    from ptype_tpu_torch import actor as actor_mod
    from ptype_tpu_torch import chaos, logs, telemetry, trace
    from ptype_tpu_torch.actor import ActorServer
    from ptype_tpu_torch.chaos import FaultPlan, FaultSpec
    from ptype_tpu_torch.coord.remote import RemoteCoord
    from ptype_tpu_torch.coord.service import CoordServer
    from ptype_tpu_torch.device import resolve_device
    from ptype_tpu_torch.gateway import GatewayConfig, InferenceGateway
    from ptype_tpu_torch.registry import CoordRegistry

    device = resolve_device(os.environ.get("PTYPE_DEVICE") or None)
    log = logs.get_logger("obs-demo")
    rec = trace.enable("obs-demo")

    class Work:
        """A stand-in replica: sleeps a little, logs inside the span
        (note the auto-attached trace_id in the log line)."""

        def __init__(self, ms: float):
            self.ms = ms
            self.calls = 0

        def Do(self, payload):
            self.calls += 1
            log.info("working", kv={"payload": payload})
            time.sleep(self.ms / 1000.0)
            return f"done:{payload}"

        def Info(self):
            return {"in_flight": 0, "queue_depth": 0, "calls": self.calls}

    # Real TCP between gateway and workers: the in-process fast path
    # would skip the sockets this demo exists to show traces crossing.
    actor_mod.lookup_local = lambda a, p: None

    coordd = CoordServer("127.0.0.1:0")
    coord = RemoteCoord([coordd.address])
    registry = CoordRegistry(coord, lease_ttl=2.0)
    servers, regs = [], []
    gw = None
    try:
        for i, ms in enumerate((2.0, 10.0)):
            s = ActorServer("127.0.0.1", 0, device=device)
            s.register(Work(ms), "Work")
            s.serve()
            servers.append(s)
            regs.append(registry.register("work", f"w{i}", "127.0.0.1",
                                          s.port))
        gw = InferenceGateway(
            registry, "work",
            GatewayConfig(generate_method="Work.Do",
                          info_method="Work.Info",
                          probe_interval_s=0.2, default_deadline_s=10.0),
            device=device)
        deadline = time.monotonic() + 10
        while gw.pool.n_healthy() < 2 and time.monotonic() < deadline:
            time.sleep(0.05)

        # One request gets a chaos fault: its trace carries the
        # chaos.fault event and — after the gateway re-routes — the
        # chaos.recovery beacon.
        chaos.arm(FaultPlan([FaultSpec("rpc.send", "drop",
                                       match="Work.Do", after=2)]))
        for i in range(6):
            out = gw.call("Work.Do", f"req-{i}")
            print(f"request {i}: {out}")
        chaos.disarm()

        snap = telemetry.cluster_snapshot(registry)
        out_dir = os.environ.get("OBS_DIR", "/tmp/ptype-obs-demo")
        chrome = telemetry.write_chrome_trace(
            os.path.join(out_dir, "trace.json"), snap)
        jsonl = telemetry.write_spans_jsonl(
            os.path.join(out_dir, "spans.jsonl"), snap)
        print()
        print(telemetry.render_summary(snap))
        chaos_spans = [s for s in rec.spans()
                       if any(e["name"].startswith("chaos.")
                              for e in s.events)]
        print(f"spans with chaos events: "
              f"{[s.name for s in chaos_spans]}")
        print(f"chrome trace: {chrome} (load in ui.perfetto.dev)")
        print(f"spans jsonl:  {jsonl}")
    finally:
        chaos.disarm()
        trace.disable()
        if gw is not None:
            gw.close()
        for r in regs:
            r.close()
        for s in servers:
            s.close()
        coord.close()
        coordd.close()


if __name__ == "__main__":
    main()
