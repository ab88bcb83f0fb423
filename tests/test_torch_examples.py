"""The port's twins of the reference's example apps, as real processes on
this host's CPU (``PTYPE_DEVICE=cpu``), under the assertions of
``tests/test_examples.py``:

- the calculator: the port's server and client, then the cross-package
  pairs (a port client against the reference server, a reference client
  against the port server), each printing the reference's two lines;
- the optimus scatter-gather: two port workers behind the port
  coordinator, then the port coordinator over a mixed pool of one
  reference worker and one port worker, each of which answers chunks
  (its ``actor/Prime.Check`` spans, pulled over ``ptype.Telemetry``);
- the three observability walkthroughs, their printed markers and the
  files they write; ``serve_demo``'s greedy tokens against the
  reference engine's at the same weights (tiny, f32).

Every process has its own timeout, as in ``tests/test_examples.py``.
"""

import json
import os
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import wait_output
from ptype_tpu import telemetry as jtelemetry
from ptype_tpu.models import transformer as jtfm
from ptype_tpu.registry import Node as JNode
from ptype_tpu.serve_engine import PagedGeneratorActor as JPaged
from ptype_tpu_torch import telemetry as ttelemetry
from ptype_tpu_torch.examples.observability import serve_demo
from ptype_tpu_torch.models import transformer as ttfm
from ptype_tpu_torch.models.weights import init_params, params_to_numpy
from ptype_tpu_torch.registry import Node

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = REPO / "examples"
#: Seconds a process may take to print its ready line.
READY_S = 90


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = f"{REPO}:{env.get('PYTHONPATH', '')}"
    env["JAX_PLATFORMS"] = "cpu"
    env["PTYPE_DEVICE"] = "cpu"
    env.update(extra)
    return env


def _write_cfgs(tmp_path, service, node, port, coord_addr, seed):
    plat = tmp_path / f"{node}_platform.yaml"
    plat.write_text(
        f"name: {node}\n"
        f'coordinator_address: "{coord_addr}"\n'
        f"is_coordinator: {str(seed).lower()}\n"
    )
    cfg = tmp_path / f"{node}.yaml"
    cfg.write_text(
        f"service_name: {service}\n"
        f"node_name: {node}\n"
        f"port: {port}\n"
        f"platform_config_file: {plat.name}\n"
    )
    return cfg


def _cmd(pkg: str, example: str, script: str) -> list:
    """The command line of ``examples/<example>/<script>.py`` (``ref``)
    or of its port twin (``port``)."""
    if pkg == "ref":
        return [sys.executable, str(EXAMPLES / example / f"{script}.py")]
    return [sys.executable, "-m",
            f"ptype_tpu_torch.examples.{example}.{script}"]


def _start(cmd, env):
    return subprocess.Popen(cmd, env=env, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


# ---------------------------------------------------------- calculator


@pytest.mark.parametrize("server,client", [("port", "port"),
                                           ("ref", "port"),
                                           ("port", "ref")])
def test_calculator_example(tmp_path, server, client):
    coord = f"127.0.0.1:{_free_port()}"
    server_cfg = _write_cfgs(tmp_path, "calculator", "srv1", 0, coord, True)
    client_cfg = _write_cfgs(tmp_path, "calc_client", "cli1", 0, coord,
                             False)
    proc = _start(_cmd(server, "calculator", "server"),
                  _env(CONFIG=str(server_cfg)))
    try:
        lines = wait_output(proc, "serving", READY_S)
        if server == "port":
            assert "(cpu)" in "".join(lines)
        out = subprocess.run(
            _cmd(client, "calculator", "client"),
            env=_env(CONFIG=str(client_cfg)), cwd=REPO,
            capture_output=True, text=True, timeout=90)
        assert out.returncode == 0, out.stdout + out.stderr
        assert "3 * 7 = 21" in out.stdout
        assert "tensor multiply: [0. 2. 4. 6.]" in out.stdout
        if server == "port":
            lines = wait_output(proc, "tensor multiply on", 30)
            assert "tensor multiply on cpu and cpu" in "".join(lines)
    finally:
        proc.kill()
        proc.wait(timeout=30)


# ------------------------------------------------------------ optimus


def _probe(http_port, target):
    url = f"http://127.0.0.1:{http_port}/test?target={target}"
    deadline = time.time() + 60
    while True:
        try:
            return urllib.request.urlopen(url, timeout=30).read().decode()
        except OSError:
            if time.time() > deadline:
                raise
            time.sleep(0.5)


def _check_calls(pkg: str, port: int) -> int:
    """``actor/Prime.Check`` spans in a worker's flight recorder, pulled
    by its own package's telemetry client."""
    if pkg == "ref":
        snap = jtelemetry.node_telemetry(JNode("127.0.0.1", port),
                                         timeout=10)
    else:
        snap = ttelemetry.node_telemetry(Node("127.0.0.1", port),
                                         timeout=10)
    return sum(1 for s in snap["spans"] if s["name"] == "actor/Prime.Check")


@pytest.mark.parametrize("pool", ["port", "mixed"])
def test_optimus_prime_example(tmp_path, pool):
    """Two workers (the first seeds the coordination service) and the
    port's coordinator; ``mixed`` makes the first worker the
    reference's. 104729 is the 10000th prime; 600851475143 = 71 x
    8462696833 (Project Euler #3) needs the int64 scan."""
    coord = f"127.0.0.1:{_free_port()}"
    http_port = _free_port()
    cfgs = [_write_cfgs(tmp_path, "prime_worker", "w1", 0, coord, True),
            _write_cfgs(tmp_path, "prime_worker", "w2", 0, coord, False)]
    coord_cfg = _write_cfgs(tmp_path, "optimus_coordinator", "coord1",
                            http_port, coord, False)
    pkgs = ("ref" if pool == "mixed" else "port", "port")
    procs, ports = [], []
    try:
        for pkg, cfg in zip(pkgs, cfgs):
            w = _start(_cmd(pkg, "optimus", "worker"),
                       _env(CONFIG=str(cfg), PTYPE_TRACE="1"))
            procs.append(w)
            line = "".join(wait_output(w, "serving", READY_S))
            ports.append(int(line.split("serving on :")[1].split()[0]))
            if pkg == "port":
                assert "(cpu)" in line
        c = _start(_cmd("port", "optimus", "coordinator"),
                   _env(CONFIG=str(coord_cfg)))
        procs.append(c)
        wait_output(c, "optimus coordinator", READY_S)
        assert "104729 is prime" in _probe(http_port, 104729)
        assert "600851475143 is divisible by 71" in _probe(
            http_port, 600851475143)
        if pool == "mixed":
            # Round-robin reached both packages' workers.
            # The port's worker first: the reference's client closes a
            # connection while its reader may still hold the fd number
            # (ROADMAP C), which a later dial in this process can reuse.
            for k, p in sorted(zip(pkgs, ports), key=lambda kp: kp[0]):
                assert _check_calls(k, p) > 0, k
    finally:
        for p in procs:
            p.kill()
            p.wait(timeout=30)


def test_prime_check_scans_int64_chunks():
    """``Prime.Check`` in process against a Python scan of the chunk:
    the first divisor of [max(lo, 2), hi), else the target itself —
    targets past int32 included."""
    from ptype_tpu_torch.examples.optimus.prime import Prime

    def scan(lo, hi, target):
        return next((d for d in range(max(lo, 2), hi) if target % d == 0),
                    target)

    p = Prime("cpu")
    for lo, hi, target in ((2, 1000, 600851475143),
                           (72, 1000, 600851475143),
                           (840, 1840, 600851475143),
                           (2, 324, 104729), (0, 2, 9), (0, 5, 9),
                           (2, 1002, 2**40 + 15), (5, 9, 2**31 + 11),
                           (10, 10, 97)):
        assert p.Check(lo, hi, target) == scan(lo, hi, target), (lo, hi)
    assert p.Check(72, 1000, 600851475143) == 839


# ------------------------------------------------------ observability


def test_health_demo():
    proc = _start(_cmd("port", "observability", "health_demo"), _env())
    try:
        lines = wait_output(
            proc, "straggler alert names the afflicted node", 240)
        out = "".join(lines)
        assert "ptype health @" in out
        assert "ALERTS (1 recent)" in out
        assert "(= w2)" in out
    finally:
        proc.kill()
        proc.wait(timeout=30)


def test_observability_demo(tmp_path):
    proc = _start(_cmd("port", "observability", "demo"),
                  _env(OBS_DIR=str(tmp_path)))
    try:
        lines = wait_output(proc, "chrome trace:", 240)
        out = "".join(lines)
        assert "spans with chaos events" in out
    finally:
        proc.kill()
        proc.wait(timeout=30)
    chrome = json.load(open(tmp_path / "trace.json"))
    names = {e["name"] for e in chrome["traceEvents"] if e["ph"] == "X"}
    assert {"gateway.request", "gateway.admit", "gateway.route",
            "rpc.call", "actor/Work.Do"} <= names
    assert any(e["ph"] == "i" and e["name"] == "chaos.fault"
               for e in chrome["traceEvents"])
    spans = [json.loads(x) for x in open(tmp_path / "spans.jsonl")]
    assert any(s["name"] == "gateway.request" for s in spans)


def test_serve_obs_demo(tmp_path):
    proc = _start(_cmd("port", "observability", "serve_demo"),
                  _env(OBS_DIR=str(tmp_path)))
    try:
        lines = wait_output(proc, "SERVE OBS DEMO OK", 240)
        out = "".join(lines)
        assert "ptype serving @" in out
        assert "prefix-cache block hits" in out
    finally:
        proc.kill()
        proc.wait(timeout=30)
    chrome = json.load(open(tmp_path / "serve_trace.json"))
    names = {e["name"] for e in chrome["traceEvents"] if e["ph"] == "X"}
    assert {"gateway.request", "rpc.call",
            "actor/Generator.Generate", "serve.admit",
            "serve.decode"} <= names
    assert any(n.startswith("serve.prefill.chunk") for n in names)
    assert any(e["ph"] == "i" and e["name"] == "first_token"
               for e in chrome["traceEvents"])


def test_serve_demo_tokens_equal_the_reference_engine(tmp_path,
                                                      monkeypatch):
    """The burst's greedy tokens through the port's fleet equal the
    reference engine's on the same prompts, from the same weights (the
    replicas' seed-0 init carried across as numpy), tiny in f32."""
    monkeypatch.setenv("OBS_DIR", str(tmp_path))
    got = serve_demo.main(preset="tiny", attn="gather", device="cpu")
    assert len(got["tokens"]) == serve_demo.BURST
    assert sum(got["engine_steps"].values()) > 0
    cfg = ttfm.preset("tiny", dtype=torch.float32)
    params = params_to_numpy(init_params(torch.Generator().manual_seed(0),
                                         cfg))
    ref = JPaged(jtfm.preset("tiny", dtype=jnp.float32),
                 params=jax.tree_util.tree_map(jnp.asarray, params),
                 n_slots=4, block_tokens=serve_demo.BLOCK_TOKENS,
                 prefill_chunk=32)
    try:
        for prompt, toks in zip(got["prompts"], got["tokens"]):
            want = ref.Generate(jnp.asarray(prompt)[None],
                                serve_demo.MAX_NEW)
            np.testing.assert_array_equal(toks, np.asarray(want))
    finally:
        ref.close()
