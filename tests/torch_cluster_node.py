"""Cluster member processes of the cluster-plane tests.

    python tests/torch_cluster_node.py calc COORD
    python tests/torch_cluster_node.py serve COORD PARAMS_PKL
    python tests/torch_cluster_node.py mesh COORD RDV RANK WORLD OUT

``calc`` joins the TCP coordinator at COORD as service ``calc`` (lease
TTL 1.0 s) with an ``ActorServer`` serving ``Calculator.Multiply``;
``serve`` joins as service ``llm`` with a ``GeneratorActor`` and a
``PagedGeneratorActor`` (``tiny`` in f32 on the CPU, weights from the
pickled numpy tree PARAMS_PKL) registered as ``Generator`` and
``Paged``. Both print ``READY <port>`` and serve until killed. ``mesh``
is one gloo rank of WORLD: it joins with ``num_processes`` WORLD and
``mesh_axes`` ``{"data": WORLD}`` (rendezvous RDV), builds
``Cluster.mesh()``, all-reduces rank + 1 over it, writes JSON to OUT,
and stays registered until the file OUT.go appears (so the test can
read the live registry), for at most 120 s.

This module imports torch, numpy and ptype_tpu_torch only — never JAX
or ptype_tpu — so a member starts without the reference.
"""

from __future__ import annotations

import json
import pathlib
import pickle
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from ptype_tpu_torch import ActorServer, Config, PlatformConfig, join  # noqa: E402

TTL = 1.0


def member_cfg(service, node, coord, port=0, **platform):
    return Config(service_name=service, node_name=node, port=port,
                  initial_cluster_client_urls=[coord],
                  platform=PlatformConfig(name=node, coordinator_address=coord,
                                          lease_ttl=TTL, **platform))


class Calculator:
    def Multiply(self, a, b):
        return a * b


def _serve_forever(server, cluster):
    print(f"READY {server.port}", flush=True)
    try:
        while True:
            time.sleep(3600)
    finally:
        cluster.close()
        server.close()


def calc(coord: str) -> None:
    server = ActorServer()  # all interfaces: join advertises get_ip()
    server.register(Calculator())
    server.serve()
    cluster = join(member_cfg("calc", "calc-server", coord, server.port))
    _serve_forever(server, cluster)


def serve(coord: str, params_pkl: str) -> None:
    import torch

    from ptype_tpu_torch.models import transformer as tfm
    from ptype_tpu_torch.models.weights import params_from_numpy
    from ptype_tpu_torch.serve import GeneratorActor
    from ptype_tpu_torch.serve_engine import PagedGeneratorActor

    cfg = tfm.preset("tiny", dtype=torch.float32, max_seq=256)
    with open(params_pkl, "rb") as f:
        params = params_from_numpy(pickle.load(f), cfg)
    server = ActorServer(device="cpu")
    server.register(GeneratorActor(cfg, params=params, device="cpu"),
                    "Generator")
    server.register(PagedGeneratorActor(cfg, params=params, device="cpu",
                                        n_slots=4, block_tokens=16,
                                        prefill_chunk=32), "Paged")
    server.serve()
    cluster = join(member_cfg("llm", "llm-server", coord, server.port))
    _serve_forever(server, cluster)


def mesh(coord: str, rdv: str, rank: int, world: int, out: str) -> None:
    import torch
    import torch.distributed as dist

    cluster = join(member_cfg(
        "ranks", f"rank-{rank}", coord, num_processes=world,
        process_id=rank, mesh_axes={"data": world},
        jax_coordinator_address=f"file://{rdv}"), device="cpu")
    try:
        dist.barrier()  # every rank registered before the lowering
        m = cluster.mesh()
        x = torch.tensor([float(rank + 1)])
        dist.all_reduce(x, group=m.group)
        result = {"rank": rank, "mesh_rank": m.rank, "size": m.size,
                  "shape": m.shape, "ordinals": list(cluster.device_ordinals),
                  "sum": x.item()}
        pathlib.Path(out).write_text(json.dumps(result))
        go = pathlib.Path(out + ".go")
        deadline = time.monotonic() + 120
        while not go.exists() and time.monotonic() < deadline:
            time.sleep(0.05)
        dist.barrier()
    finally:
        cluster.close()
    dist.destroy_process_group()


if __name__ == "__main__":
    mode, args = sys.argv[1], sys.argv[2:]
    if mode == "calc":
        calc(*args)
    elif mode == "serve":
        serve(*args)
    elif mode == "mesh":
        mesh(args[0], args[1], int(args[2]), int(args[3]), args[4])
    else:
        raise SystemExit(f"unknown mode {mode!r}")
