"""Serving observability demo: the paged fleet under the ledger's eye —
the port's twin of ``examples/observability/serve_demo.py``.

A traced 2-replica paged serving fleet shares one process — each
replica gets its OWN metrics registry, serving ledger (built into the
engine) and series sampler, plus an actor server answering
``ptype.Telemetry`` from that node's state — and an inference gateway
fronts them. A shared-prefix burst rides prefix-affinity routing, and
the whole observability loop runs end to end:

  gateway.request span → dispatch rpc.call → engine handler span →
  ServingLedger lifecycle record → synthesized serve.admit /
  serve.prefill.chunk[i] / serve.decode spans (first-token event
  stamped) → TTFT/TPOT/e2e histograms + kv.* pressure series →
  sampler → telemetry pull → ``cluster_snapshot`` → serving alert
  rules → the ``obs serve`` view → one stitched Perfetto export.

Artifacts land in ``$OBS_DIR`` (default .): ``serve_trace.json`` —
load it at ui.perfetto.dev and follow one request's trace id from
``gateway.request`` through every prefill chunk to the first-token
instant.

:func:`main` takes the model preset (``tiny`` as the reference's), the
engines' attention path (``gather`` as the reference's; ``kernel``
decodes through the paged-attention kernel on a card) and the device
(``$PTYPE_DEVICE`` when None, ``cuda`` when that is unset); the model
runs in f32, as the reference's. It returns the burst's prompts and
greedy tokens, each replica's decode steps and ledger summary, and the
prefix-cache block hits.

Run:  PTYPE_DEVICE=cpu python -m ptype_tpu_torch.examples.observability.serve_demo
"""

import os
import time

N_REPLICAS = 2
PREFIX_TOKENS = 64
TAIL_TOKENS = 4
MAX_NEW = 8
BURST = 6
BLOCK_TOKENS = 16


def main(preset: str = "tiny", attn: str = "gather", device=None) -> dict:
    import numpy as np
    import torch

    from ptype_tpu_torch import metrics as metrics_mod
    from ptype_tpu_torch import telemetry, trace
    from ptype_tpu_torch.actor import ActorServer
    from ptype_tpu_torch.coord.core import CoordState
    from ptype_tpu_torch.coord.local import LocalCoord
    from ptype_tpu_torch.device import resolve_device
    from ptype_tpu_torch.gateway import GatewayConfig, InferenceGateway
    from ptype_tpu_torch.health import (AlertEngine, Sampler, default_rules,
                                        render_serve, telemetry_endpoint)
    from ptype_tpu_torch.models import transformer as tfm
    from ptype_tpu_torch.registry import CoordRegistry
    from ptype_tpu_torch.serve_engine import (PagedGeneratorActor,
                                              prefix_affinity_key)

    device = resolve_device(device or os.environ.get("PTYPE_DEVICE") or None)
    state = CoordState(sweep_interval=0.1)
    registry = CoordRegistry(LocalCoord(state), lease_ttl=5.0)
    cfg = tfm.preset(preset, dtype=torch.float32)
    rng = np.random.default_rng(5)
    rec = trace.enable("serve-demo")

    class Replica:
        """One serving replica: engine (with its ledger), sampler,
        telemetry endpoint — what each real serving process runs."""

        def __init__(self, name: str, params=None):
            self.name = name
            self.reg = metrics_mod.MetricsRegistry()
            self.engine = PagedGeneratorActor(
                cfg, params=params, n_slots=4,
                block_tokens=BLOCK_TOKENS, prefill_chunk=32,
                metrics_registry=self.reg, attn=attn, device=device)
            self.sampler = Sampler(registry=self.reg, cadence_s=0.03,
                                   memory=False)
            self.server = ActorServer("127.0.0.1", 0, device=device)
            self.server.register(self.engine, "Generator")
            self.server.register_function(
                "ptype.Telemetry",
                telemetry_endpoint(self.reg, self.sampler.store, name))
            self.server.serve()
            self.registration = registry.register(
                "llm-demo", name, "127.0.0.1", self.server.port)

        def close(self) -> None:
            self.sampler.close()
            self.registration.close()
            self.server.close()
            self.engine.close()

    replicas = [Replica("r0")]
    replicas.append(Replica("r1", params=replicas[0].engine.params))
    gw = None
    try:
        for r in replicas:   # warm each engine off the clock
            r.engine.Generate(torch.as_tensor(rng.integers(
                1, cfg.vocab_size, PREFIX_TOKENS + TAIL_TOKENS
            ).astype(np.int32), device=device)[None], 2)
        for r in replicas:
            r.sampler.start()
        gw = InferenceGateway(
            registry, "llm-demo",
            GatewayConfig(probe_interval_s=0.2,
                          default_deadline_s=60.0), device=device)
        deadline = time.monotonic() + 10
        while (gw.pool.n_healthy() < N_REPLICAS
               and time.monotonic() < deadline):
            time.sleep(0.05)

        # The shared-prefix burst: one 64-token prefix, divergent
        # tails. Affinity routing lands every request on the same
        # replica, whose prefix cache hits for every already-sealed
        # block — watch reused_blocks climb in the admit spans.
        shared = rng.integers(1, cfg.vocab_size, PREFIX_TOKENS)
        key = prefix_affinity_key(shared.astype(np.int32), BLOCK_TOKENS)
        prompts, tokens = [], []
        for _ in range(BURST):
            tail = rng.integers(1, cfg.vocab_size, TAIL_TOKENS)
            prompt = np.concatenate([shared, tail]).astype(np.int32)
            out = gw.generate(torch.as_tensor(prompt, device=device)[None],
                              MAX_NEW, affinity_key=key)
            prompts.append(prompt)
            tokens.append(torch.as_tensor(out).cpu().numpy())

        for r in replicas:   # flush the final values into the series
            r.engine._export_gauges()
            r.sampler.sample_once()

        summaries = {}
        for r in replicas:
            s = summaries[r.name] = r.engine.ledger.summary()
            print(f"{r.name}: {s['requests_retired']} retired, "
                  f"ttft p50 {s['ttft_p50_ms']}ms "
                  f"p99 {s['ttft_p99_ms']}ms, "
                  f"tpot {s['tpot_p50_ms']}ms, "
                  f"prefix hit rate "
                  f"{r.engine.prefix_hit_rate():.2f}")

        snap = telemetry.cluster_snapshot(registry, include_local=False)
        engine = AlertEngine(default_rules())
        engine.evaluate(snap)
        print()
        print(render_serve(snap, engine.recent()))
        print()

        # The stitched Perfetto export: every request's span tree —
        # gateway.request → rpc.call → actor handler → serve.admit /
        # prefill chunks / serve.decode with its first_token instant.
        out_dir = os.environ.get("OBS_DIR", ".")
        path = telemetry.write_chrome_trace(
            os.path.join(out_dir, "serve_trace.json"), rec.to_dicts())
        spans = rec.spans()
        n_admit = sum(1 for s in spans if s.name == "serve.admit")
        n_first = sum(1 for s in spans for e in s.events
                      if e["name"] == "first_token")
        infos = {r.name: r.engine.Info() for r in replicas}
        hits = max(i["prefix_hits"] for i in infos.values())
        if n_admit < BURST or n_first < BURST:
            raise RuntimeError(f"spans: {n_admit} serve.admit and "
                               f"{n_first} first_token for {BURST} "
                               f"requests")
        if hits <= 0:
            raise RuntimeError("affinity burst produced no prefix hits")
        print(f"chrome trace: {path} ({len(spans)} spans, "
              f"{n_first} first-token events, "
              f"{hits} prefix-cache block hits)")
        print("SERVE OBS DEMO OK")
        return {"prompts": prompts, "tokens": tokens,
                "engine_steps": {n: i["engine_steps"]
                                 for n, i in infos.items()},
                "ledgers": summaries, "prefix_hits": hits,
                "n_layers": cfg.n_layers}
    finally:
        if gw is not None:
            gw.close()
        for r in replicas:
            r.close()
        state.close()
        trace.disable()


if __name__ == "__main__":
    main()
