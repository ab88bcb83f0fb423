"""The slice as a whole: generation served over the port's cluster
plane (``join`` → ``ActorServer`` → ``Cluster.new_client``), on the CPU
at ``tiny`` in f32, against the reference's generators served by the
reference's ``ActorServer`` (as in ``tests/test_serve.py``).

The port's ``GeneratorActor`` and ``PagedGeneratorActor`` (weights the
reference's ``init_params`` at PRNGKey(0), carried across by
``models/weights.params_from_numpy``) are served twice: in-process
(``local:`` coordinator, the zero-copy ``_LocalConn``) and from a
JAX-free subprocess (``tests/torch_cluster_node.py serve``) found
through a TCP coordinator. Greedy ``Generate`` tokens and the paged
engine's rows must equal the reference's exactly; ``Logits`` agree at
``tests/test_torch_generate.py``'s f32 tolerance (rtol = atol = 1e-4);
``Info()`` keys include the reference's."""

import os
import pathlib
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptype_tpu import actor as jactor
from ptype_tpu import cluster as jcluster
from ptype_tpu import config as jconfig
from ptype_tpu import rpc as jrpc
from ptype_tpu import serve as jserve
from ptype_tpu.models import transformer as jtfm
from ptype_tpu.serve_engine import PagedGeneratorActor as JPaged
from ptype_tpu_torch import ActorServer, ConnConfig, join
from ptype_tpu_torch.config import Config, PlatformConfig
from ptype_tpu_torch.models import transformer as ttfm
from ptype_tpu_torch.models.weights import params_from_numpy
from ptype_tpu_torch.serve import GeneratorActor
from ptype_tpu_torch.serve_engine import PagedGeneratorActor

ROOT = pathlib.Path(__file__).resolve().parents[1]
JCFG = jtfm.preset("tiny", dtype=jnp.float32, max_seq=256)
CFG = ttfm.preset("tiny", dtype=torch.float32, max_seq=256)
TOL = dict(rtol=1e-4, atol=1e-4)
PAGED = dict(n_slots=4, block_tokens=16, prefill_chunk=32)
RNG = np.random.default_rng(21)
PROMPT = RNG.integers(1, CFG.vocab_size, (2, 8)).astype(np.int32)
#: Paged requests: a shared 16-token prefix, then tails of 3..20 tokens.
SHARED = RNG.integers(1, CFG.vocab_size, 16)
PAGED_PROMPTS = [np.concatenate([SHARED, RNG.integers(
    1, CFG.vocab_size, n)]).astype(np.int32)[None] for n in (3, 9, 20)]
MAX_NEW = 6


def _conn():
    return dict(initial_node_timeout=10.0, debounce_time=0.1, retries=0,
                call_timeout=120.0)


@pytest.fixture(scope="module")
def params_np():
    pj = jtfm.init_params(jax.random.PRNGKey(0), JCFG)
    return jax.tree_util.tree_map(np.asarray, pj)


@pytest.fixture(scope="module")
def reference(params_np):
    """The reference's generators served by the reference's plane."""
    gen = jserve.GeneratorActor(JCFG, params=params_np)
    paged = JPaged(JCFG, params=params_np, **PAGED)
    server = jactor.ActorServer(jcluster.get_ip(), 0)
    server.register(gen, "Generator")
    server.register(paged, "Paged")
    server.serve()

    def cfg(service, node, port=0):
        return jconfig.Config(
            service_name=service, node_name=node, port=port,
            platform=jconfig.PlatformConfig(
                name=node, coordinator_address="local:ref-serve-rpc",
                lease_ttl=0.5))

    c_srv = jcluster.join(cfg("llm", "srv", server.port))
    c_cli = jcluster.join(cfg("llm_client", "cli"))
    client = c_cli.new_client("llm", jrpc.ConnConfig(**_conn()))
    try:
        out = {"tokens": np.asarray(client.call(
                   "Generator.Generate", jnp.asarray(PROMPT), MAX_NEW)),
               "logits": np.asarray(client.call("Generator.Logits",
                                                jnp.asarray(PROMPT))),
               "info": client.call("Generator.Info"),
               "paged_info": client.call("Paged.Info")}
        futs = [client.go("Paged.Generate", jnp.asarray(p), MAX_NEW)
                for p in PAGED_PROMPTS]
        out["paged"] = [np.asarray(f.result(timeout=300)) for f in futs]
    finally:
        client.close()
        c_cli.close()
        c_srv.close()
        server.close()
        paged.close()
    return out


def _exercise(client, reference):
    tokens = client.call("Generator.Generate", torch.as_tensor(PROMPT),
                         MAX_NEW)
    assert isinstance(tokens, torch.Tensor) and tokens.device.type == "cpu"
    assert tokens.tolist() == reference["tokens"].tolist()
    logits = client.call("Generator.Logits", torch.as_tensor(PROMPT))
    np.testing.assert_allclose(logits.numpy(), reference["logits"], **TOL)
    futs = [client.go("Paged.Generate", torch.as_tensor(p), MAX_NEW)
            for p in PAGED_PROMPTS]
    rows = [f.result(timeout=300) for f in futs]
    assert [r.tolist() for r in rows] == [
        r.tolist() for r in reference["paged"]]
    assert set(client.call("Generator.Info")) >= set(reference["info"])
    assert set(client.call("Paged.Info")) >= set(reference["paged_info"])
    with pytest.raises(Exception, match="no such method"):
        client.call("Generator.close")


def test_served_in_process_equals_the_reference(params_np, reference):
    params = params_from_numpy(params_np, CFG)
    gen = GeneratorActor(CFG, params=params, device="cpu")
    paged = PagedGeneratorActor(CFG, params=params, device="cpu", **PAGED)
    server = ActorServer(device="cpu")
    server.register(gen, "Generator")
    server.register(paged, "Paged")
    server.serve()

    def cfg(service, node, port=0):
        return Config(service_name=service, node_name=node, port=port,
                      platform=PlatformConfig(
                          name=node, coordinator_address="local:serve-rpc",
                          lease_ttl=0.5))

    c_srv = join(cfg("llm", "srv", server.port))
    c_cli = join(cfg("llm_client", "cli"), device="cpu")
    client = c_cli.new_client("llm", ConnConfig(**_conn()))
    try:
        from ptype_tpu_torch import rpc

        assert isinstance(client._conns.get(), rpc._LocalConn)
        _exercise(client, reference)
    finally:
        client.close()
        c_cli.close()
        c_srv.close()
        server.close()
        paged.close()
        from ptype_tpu_torch.coord.local import reset_local_coords

        reset_local_coords()


def test_served_from_a_process_over_tcp_equals_the_reference(
        params_np, reference, tmp_path):
    from conftest import wait_output

    pkl = tmp_path / "params.pkl"
    with open(pkl, "wb") as f:
        pickle.dump(params_np, f)
    seed = join(Config(service_name="seed", node_name="seed", port=9001,
                       platform=PlatformConfig(
                           name="seed", coordinator_address="127.0.0.1:0",
                           is_coordinator=True, lease_ttl=1.0)),
                device="cpu")
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    proc = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_cluster_node.py"),
         "serve", seed._owned_server.address, str(pkl)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    client = None
    try:
        wait_output(proc, "READY", timeout=120)
        client = seed.new_client("llm", ConnConfig(**_conn()))
        from ptype_tpu_torch import rpc

        assert isinstance(client._conns.get(), rpc._Conn)
        _exercise(client, reference)
    finally:
        if client is not None:
            client.close()
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=30)
        seed.close()
