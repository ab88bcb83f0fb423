"""Package rules of ptype_tpu_torch: it imports with JAX blocked, no
module of it (nor chip_smoke.py, chip_engine_ab.py, the rank bodies
of tests/torch_ranks.py or the cluster members of
tests/torch_cluster_node.py) imports jax or the ptype_tpu package, its
entry points raise rather than run on the CPU unasked, and
chip_smoke.py fails without a card."""

import ast
import json
import os
import pathlib
import shutil
import signal
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "ptype_tpu_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                       ROOT / "chip_engine_ab.py",
                                       ROOT / "tests" / "torch_ranks.py",
                                       ROOT / "tests" /
                                       "torch_cluster_node.py"]


def _modules():
    for p in sorted(PKG.rglob("*.py")):
        rel = p.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts)


def test_every_module_imports_with_jax_blocked():
    mods = list(_modules())
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['jaxlib'] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'ptype_tpu'"
            " or m.startswith('ptype_tpu.')]\n"
            "assert not bad, bad\n"
            "print('ok', len(" + repr(mods) + "))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_the_gateway_loadgen_and_forensics_modules_are_guarded():
    """The serving frontdoor's modules are among those imported with JAX
    blocked and scanned for imports of jax or the reference."""
    mods = set(_modules())
    want = {f"ptype_tpu_torch.gateway.{m}" for m in (
        "slo", "admission", "directory", "pool", "frontdoor")}
    want |= {f"ptype_tpu_torch.loadgen.{m}" for m in (
        "rng", "arrivals", "ledger", "driver", "frontier")}
    want |= {"ptype_tpu_torch.gateway", "ptype_tpu_torch.loadgen",
             "ptype_tpu_torch.health.forensics"}
    assert want <= mods, sorted(want - mods)
    assert {PKG / "health" / "forensics.py",
            PKG / "gateway" / "frontdoor.py",
            PKG / "loadgen" / "driver.py"} <= set(SOURCES)


def test_the_reconciler_modules_are_guarded_and_a_worker_skips_torch():
    """The reconciler's modules are among those imported with JAX blocked
    and scanned; what a ``fake`` replica worker imports (the worker, the
    replica host, the TCP coordinator's client, the registry) loads
    neither torch nor the reconcile loop."""
    mods = set(_modules())
    want = {f"ptype_tpu_torch.reconciler.{m}" for m in (
        "policy", "replica", "worker", "core")} | {
        "ptype_tpu_torch.reconciler"}
    assert want <= mods, sorted(want - mods)
    code = ("import sys\n"
            "import ptype_tpu_torch.reconciler.worker\n"
            "from ptype_tpu_torch.reconciler import FakeGeneratorActor\n"
            "import ptype_tpu_torch.coord.remote, ptype_tpu_torch.registry\n"
            "bad = [m for m in ('torch', 'ptype_tpu_torch.reconciler.core')"
            " if m in sys.modules]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_the_health_plane_imports_without_torch():
    """``series``, ``goodput``, ``rules``, ``top``, ``telemetry`` and
    ``health/__init__`` import with torch blocked, and an alert engine
    evaluates there: the reconciler worker's control plane stays
    torch-free with the health plane loaded (``profiling`` and the
    measurement functions import torch when called)."""
    mods = set(_modules())
    want = {f"ptype_tpu_torch.health.{m}" for m in (
        "series", "goodput", "rules", "top", "profiling", "bench")} | {
        "ptype_tpu_torch.health", "ptype_tpu_torch.telemetry"}
    assert want <= mods, sorted(want - mods)
    code = ("import sys\n"
            "sys.modules['torch'] = None\n"
            "import ptype_tpu_torch.health as h\n"
            "import ptype_tpu_torch.telemetry, ptype_tpu_torch.health.bench\n"
            "from ptype_tpu_torch.health import (series, goodput, rules,"
            " top, profiling)\n"
            "snap = {'ts': 1.0, 'nodes': {}, 'errors': {}}\n"
            "assert h.AlertEngine(h.default_rules(), dump=False)"
            ".evaluate(snap) == []\n"
            "assert 'ptype health' in h.render_top(snap)\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_source_imports_jax_or_the_reference_package(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for n in names:
            root = n.split(".")[0]
            assert root not in ("jax", "jaxlib", "ptype_tpu"), (path, n)


def test_entry_points_raise_without_a_card_unless_asked_for_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from ptype_tpu_torch.device import resolve_device
    from ptype_tpu_torch.models import transformer as ttfm
    from ptype_tpu_torch.serve import GeneratorActor
    from ptype_tpu_torch.serve_engine import PagedGeneratorActor
    from ptype_tpu_torch.train import Trainer, synthetic_batches

    cfg = ttfm.preset("tiny", dtype=torch.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GeneratorActor(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedGeneratorActor(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(synthetic_batches(256, 2, 8))
    from ptype_tpu_torch.parallel.tensorstore import TensorStore
    from ptype_tpu_torch.train.store_dp import StoreDPTrainer

    with pytest.raises(RuntimeError, match="no CUDA device"):
        TensorStore(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StoreDPTrainer(cfg, None)
    from ptype_tpu_torch.checkpoint import Checkpointer
    from ptype_tpu_torch.elastic import ElasticZeroTrainer
    from ptype_tpu_torch.train.trainer import load_reference_state

    with pytest.raises(RuntimeError, match="no CUDA device"):
        ElasticZeroTrainer(cfg, None, "svc", None)
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(1, {"w": torch.ones(2)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ckpt.restore({"w": 0})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_reference_state(str(tmp_path), cfg)
    from ptype_tpu_torch.gateway import InferenceGateway

    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceGateway(None)
    assert resolve_device("cpu") == torch.device("cpu")
    assert Trainer(cfg, device="cpu").device == torch.device("cpu")


def _cli_config(tmp_path, coord, **extra):
    """A two-level config tree (``CONFIG`` → ``platform_config_file``)
    for the CLI verbs below."""
    lines = [f'name: n\ncoordinator_address: "{coord}"\n'
             "mesh_axes:\n  data: 1"]
    lines += [f'{k}: "{v}"' for k, v in extra.items()]
    (tmp_path / "platform.yaml").write_text("\n".join(lines) + "\n")
    (tmp_path / "node.yaml").write_text(
        "service_name: svc\nnode_name: n\nport: 0\n"
        "platform_config_file: platform.yaml\n")
    return str(tmp_path / "node.yaml")


@pytest.mark.parametrize("verb", ["info", "serve", "train", "eval"])
def test_cli_device_verbs_raise_without_a_card(tmp_path, verb):
    """``python -m ptype_tpu_torch`` with no card and no PTYPE_DEVICE:
    every verb that touches a device raises instead of running on the
    CPU (the eval verb, once it has found a checkpoint)."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from ptype_tpu_torch.checkpoint import Checkpointer

    Checkpointer(str(tmp_path / "ckpt")).save(1, {"w": torch.ones(2)})
    env = {k: v for k, v in os.environ.items() if k != "PTYPE_DEVICE"}
    env.update(PYTHONPATH=str(ROOT), PRESET="tiny", STEPS="1",
               CKPT_DIR=str(tmp_path / "ckpt"),
               CONFIG=_cli_config(tmp_path, "127.0.0.1:1"))
    out = subprocess.run([sys.executable, "-m", "ptype_tpu_torch", verb],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr, out.stderr[-2000:]
    assert "PTYPE_DEVICE" in out.stderr


#: Runs a control-plane verb of the CLI in a thread of a process whose
#: torch import is blocked, and reports whether it failed or loaded it.
_TORCHLESS_VERB = """
import json, os, signal, sys, threading, time
sys.modules["torch"] = None
# The standby verb installs its SIGUSR1 handler from a CLI's main
# thread; here it runs in a thread, so the install is recorded instead.
handlers = []
signal.signal = lambda sig, fn: handlers.append(sig)
from ptype_tpu_torch.coord.service import CoordServer
from ptype_tpu_torch.coord import witness
seed = CoordServer(os.environ["SEED_ADDR"], data_dir=os.environ["SEED_DIR"])
errors = []
threading.excepthook = lambda a: errors.append(repr(a.exc_value))
from ptype_tpu_torch import __main__ as cli
def run(*argv):
    sys.argv = ["ptype_tpu_torch", *argv]
    try:
        cli.main()
    except BaseException as e:  # reported below
        errors.append(repr(e))
for argv in (("standby",), ("witness",)):
    threading.Thread(target=run, args=argv, daemon=True).start()
deadline = time.monotonic() + 60
while True:
    try:
        status = witness.status(os.environ["WITNESS_ADDR"])
        break
    except OSError:
        assert time.monotonic() < deadline, "the witness verb never served"
        time.sleep(0.1)
deadline = time.monotonic() + 60
while not any(m.metadata.get("role") == "standby"
              for m in seed.state.member_list()):
    assert time.monotonic() < deadline, "the standby never attached"
    time.sleep(0.1)
run("obs")
run("obs", "top")
run("obs", "request", "deadbe")
loaded = [m for m in sys.modules
          if m.split(".")[0] == "torch" and sys.modules[m] is not None]
print(json.dumps({"errors": errors, "torch": loaded,
                  "status": status, "handlers": handlers}))
sys.stdout.flush()
os._exit(0)
"""


def test_cli_control_plane_verbs_load_no_torch(tmp_path):
    """``standby``, ``witness`` and ``obs`` (a snapshot, ``top`` and
    ``request``) run with torch's import blocked: none of them loads it."""

    def addr():
        import socket

        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return f"127.0.0.1:{s.getsockname()[1]}"

    seed, wit = addr(), addr()
    cfg = _cli_config(tmp_path, seed, witness_address=wit,
                      data_dir=str(tmp_path / "data"))
    spans = tmp_path / "spans.jsonl"
    spans.write_text(json.dumps(
        {"name": "gateway.request", "trace_id": "deadbeef",
         "span_id": "r", "parent_id": None, "start_s": 0.0,
         "dur_s": 0.1, "status": "ok", "tid": 1}) + "\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT), CONFIG=cfg,
               SEED_ADDR=seed, SEED_DIR=str(tmp_path / "seed"),
               WITNESS_ADDR=wit, STANDBY_ADDR=addr(),
               STANDBY_REPLICATE="1", OBS_DIR=str(tmp_path / "obs"),
               TOP_ITERS="1", TOP_INTERVAL="0.1", TRACE_FILE=str(spans))
    (tmp_path / "obs").mkdir()
    out = subprocess.run([sys.executable, "-c", _TORCHLESS_VERB], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["errors"] == [] and got["torch"] == [], got
    assert got["status"]["term"] == 0
    assert got["handlers"] == [int(signal.SIGUSR1)]
    assert (tmp_path / "obs" / "trace.json").exists()
    assert "deadbeef" in out.stdout


def test_kernel_build_is_lazy_and_targets_hopper():
    from ptype_tpu_torch.ops import _build

    assert {p.stem for p in _build.CSRC.glob("*.cu")} == {
        "flash_fwd", "flash_bwd", "paged_decode"}
    assert "arch=compute_90a,code=sm_90a" in _build.ARCH_FLAGS
    assert _build.BUILD_DIR == ROOT / "build" / "kernels"
    # Each source exports its entry points and error_string (the
    # ctypes contract the wrappers bind).
    for name, fns in (("flash_fwd", ["flash_fwd"]),
                      ("flash_bwd", ["flash_bwd_dq", "flash_bwd_dkv"]),
                      ("paged_decode", ["paged_decode"])):
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert "const char* error_string(" in src
        for fn in fns:
            assert f"int {fn}(" in src, (name, fn)
    # The target name hashes source and flags: stable until either moves.
    assert _build._target("flash_fwd") == _build._target("flash_fwd")


def test_kernel_target_hashes_the_shared_headers(tmp_path, monkeypatch):
    """An edit to a shared header renames every source's library, so a
    checkout never loads a build made against the old header."""
    from ptype_tpu_torch.ops import _build

    names = ("flash_fwd", "flash_bwd", "paged_decode")
    assert [p.name for p in _build.CSRC.glob("*.cuh")] == ["hopper.cuh"]
    want = {n: _build._target(n).name for n in names}
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    assert {n: _build._target(n).name for n in names} == want
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    edited = {n: _build._target(n).name for n in names}
    assert all(edited[n] != want[n] and edited[n].startswith(n + "-")
               for n in names)


@pytest.mark.parametrize("symbol,label", [
    ("_ZN45_GLOBAL__N__8f93eff4_12_flash_fwd_cu_b294bfd021flash_fwd_kernel_"
     "bf16ILi128EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16Pfiiiif",
     "flash_fwd_kernel_bf16<128>"),
    ("_ZN45_GLOBAL__N__1402ade2_12_flash_bwd_cu_3c15cd2819flash_bwd_dq_"
     "kernelI13__nv_bfloat16Li64EEEvPKT_S4_S4_S4_PKfS6_PS2_iiiif",
     "flash_bwd_dq_kernel<bf16,64>"),
    ("_ZN45_GLOBAL__N__1402ade2_12_flash_bwd_cu_3c15cd2824flash_bwd_dkv_"
     "kernel_f32ILi128EEEvPKfS2_S2_S2_S2_S2_PfS3_iiiif",
     "flash_bwd_dkv_kernel_f32<128>"),
    ("_ZN48_GLOBAL__N__ca4ab589_15_paged_decode_cu_fed0b86b19paged_decode_"
     "kernelIfLi128EEEvPKT_S3_S3_PKiS5_PS1_iiiif",
     "paged_decode_kernel<f32,128>"),
    ("_ZN12_GLOBAL__N_125paged_decode_split_kernelI13__nv_bfloat16Li128ELi4E"
     "EEvPKT_S4_S4_PKiS6_Pfiiiiif",
     "paged_decode_split_kernel<bf16,128,4>")])
def test_kernel_label_reads_mangled_symbols(symbol, label):
    from ptype_tpu_torch.ops import _build

    assert _build.kernel_label(symbol) == label


def test_bind_sets_the_signature_once(monkeypatch):
    """A C entry point is looked up and given its ctypes signature on the
    first call only; later launches get the same bound function."""
    import ctypes

    from ptype_tpu_torch.ops import _build

    libc = ctypes.CDLL(None)
    loads = []
    monkeypatch.setattr(_build, "_fns", {})
    monkeypatch.setattr(_build, "load",
                        lambda name: loads.append(name) or libc)
    fn = _build.bind("libc", "labs", [ctypes.c_long], ctypes.c_long)
    assert fn(-7) == 7
    assert _build.bind("libc", "labs", [ctypes.c_long],
                       ctypes.c_long) is fn
    assert loads == ["libc"]
    assert fn.argtypes == [ctypes.c_long] and fn.restype is ctypes.c_long


def test_count_sass_counts_instructions_per_kernel():
    from ptype_tpu_torch.ops import _build

    listing = """
        Function : _ZN12_GLOBAL__N_121flash_fwd_kernel_bf16ILi128EEEv14CUtensorMap_st
        /*0290*/  UTMALDG.4D [UR8], [UR4] ;
        /*02a0*/  HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;
        /*02b0*/  HGMMA.64x128x16.F32.BF16 R24, gdesc[UR8], R24 ;
        Function : _ZN12_GLOBAL__N_119flash_bwd_dq_kernelI13__nv_bfloat16Li128EEEvPKT_
        /*0100*/  HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
    """
    assert _build.count_sass(listing) == {
        "flash_fwd_kernel_bf16<128>": {"HGMMA": 2, "UTMALDG": 1, "HMMA": 0},
        "flash_bwd_dq_kernel<bf16,128>": {"HGMMA": 0, "UTMALDG": 0,
                                          "HMMA": 1}}


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    script = ROOT / "chip_smoke.py"
    cwd = ROOT
    if alone:
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
