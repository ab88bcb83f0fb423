"""Serving-fleet walkthrough: three generator replicas, one frontdoor —
the port's twin of ``examples/serving/fleet.py``.

Runs self-contained in one process (in-process coordination backend,
real actor servers) and shows the whole gateway story end to end:

1. three ``GeneratorActor`` replicas register under service ``llm``
   (one is wrapped to answer slowly — the degraded-node scenario);
2. an :class:`~ptype_tpu_torch.gateway.InferenceGateway` fronts them:
   health probes, least-loaded routing, admission control;
3. steady traffic routes around the slow replica (watch the per-replica
   call counts);
4. a burst past capacity is SHED with typed retry-after errors instead
   of timing out;
5. the SLO surface (p50/p95/p99, tokens/sec, shed rate) and the
   autoscale hint come out of ``gateway.stats()``.

Run:  PTYPE_DEVICE=cpu python -m ptype_tpu_torch.examples.serving.fleet
(the replicas and the gateway compute on ``$PTYPE_DEVICE``, ``cuda`` when
it is unset).
"""

import os
import threading
import time

import torch

from ptype_tpu_torch.actor import ActorServer
from ptype_tpu_torch.coord.core import CoordState
from ptype_tpu_torch.coord.local import LocalCoord
from ptype_tpu_torch.device import resolve_device
from ptype_tpu_torch.errors import ShedError
from ptype_tpu_torch.gateway import GatewayConfig, InferenceGateway
from ptype_tpu_torch.models import transformer as tfm
from ptype_tpu_torch.registry import CoordRegistry
from ptype_tpu_torch.serve import GeneratorActor

SLOW_MS = 200.0


class SlowReplica:
    """A degraded node: every call pays an extra SLOW_MS."""

    def __init__(self, inner):
        self._inner = inner

    def Generate(self, *a, **kw):
        time.sleep(SLOW_MS / 1000.0)
        return self._inner.Generate(*a, **kw)

    def Info(self):
        time.sleep(SLOW_MS / 1000.0)
        return self._inner.Info()


def main() -> None:
    device = resolve_device(os.environ.get("PTYPE_DEVICE") or None)
    state = CoordState(sweep_interval=0.1)
    registry = CoordRegistry(LocalCoord(state), lease_ttl=2.0)
    cfg = tfm.preset("tiny", dtype=torch.float32)

    print("== 1. three replicas register under service 'llm' "
          "(r2 is slow) ==")
    base = GeneratorActor(cfg, device=device)
    actors = [base, GeneratorActor(cfg, params=base.params, device=device),
              SlowReplica(GeneratorActor(cfg, params=base.params,
                                         device=device))]
    servers, regs = [], []
    for i, a in enumerate(actors):
        s = ActorServer("127.0.0.1", 0, device=device)
        s.register(a, "Generator")
        s.serve()
        servers.append(s)
        regs.append(registry.register("llm", f"r{i}", "127.0.0.1",
                                      s.port))
        print(f"   r{i} on :{s.port}"
              + ("  (slow: +%dms/call)" % SLOW_MS if i == 2 else ""))

    print("== 2. the gateway fronts the fleet ==")
    gw = InferenceGateway(registry, "llm", GatewayConfig(
        probe_interval_s=0.2, max_queue_depth=4,
        default_deadline_s=30.0), device=device)
    while gw.pool.n_healthy() < 3:
        time.sleep(0.05)
    prompt = torch.ones((1, 8), dtype=torch.int32, device=device)
    base.Generate(prompt, 8)  # warm once (params are shared)

    print("== 3. steady traffic routes around the slow replica ==")
    threads = [threading.Thread(target=lambda: gw.generate(prompt, 8))
               for _ in range(24)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    for d in gw.pool.status()["replicas"]:
        print(f"   {d['key']}: {d['calls']} calls, "
              f"ewma {d['ewma_ms']}ms")

    print("== 4. a burst past capacity is shed, typed, with a "
          "retry hint ==")
    outcomes = {"ok": 0, "shed": 0}

    def fire():
        try:
            gw.generate(prompt, 8, deadline_s=5.0)
            outcomes["ok"] += 1
        except ShedError as e:
            outcomes["shed"] += 1
            outcomes.setdefault("retry_after_s",
                                round(e.retry_after_s, 3))

    burst = [threading.Thread(target=fire) for _ in range(16)]
    for t in burst:
        t.start()
    for t in burst:
        t.join(timeout=120)
    print(f"   burst of 16: {outcomes['ok']} answered, "
          f"{outcomes['shed']} shed "
          f"(retry_after ~{outcomes.get('retry_after_s')}s)")

    print("== 5. SLO surface + autoscale hint ==")
    stats = gw.stats()
    lat = stats["latency"]
    print(f"   p50 {lat['p50_ms']:.0f}ms  p95 {lat['p95_ms']:.0f}ms  "
          f"p99 {lat['p99_ms']:.0f}ms  "
          f"tokens/s {stats['tokens_per_sec']}")
    print(f"   shed_rate {stats['shed_rate']}  "
          f"queue_depth {stats['queue_depth']}")
    hint = stats["scale_hint"]
    print(f"   scale hint: delta {hint['delta']:+d} ({hint['reason']})")

    gw.close()
    for r in regs:
        r.close()
    for s in servers:
        s.close()
    state.close()
    print("FLEET WALKTHROUGH OK")


if __name__ == "__main__":
    main()
