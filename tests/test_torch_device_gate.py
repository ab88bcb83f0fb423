"""Every entry point of the port that launches kernels for a served
request or a training step runs inside ``device.device_work``: a
profiler session's start and stop (``device.DEVICE_GATE.switch``) never
land while one of them is busy, since CUPTI switched under concurrent
launches can stop recording the process's kernels.

Each case builds its entry point at ``tiny`` f32 on the CPU and calls it
once (a first call pays one-time costs, such as autograd's start, that
would hide a missing gate), then holds a switch, calls the entry point
on another thread, and checks that the call cannot finish until the
switch is released, then that it finishes without error. A new loop
that forgets the gate fails here."""

import tempfile
import threading

import pytest
import torch

from ptype_tpu_torch.device import DEVICE_GATE
from ptype_tpu_torch.models import transformer as tfm

CFG = tfm.preset("tiny", dtype=torch.float32)
#: How long a held switch must keep the call from finishing.
HELD_S = 0.3


@pytest.fixture(scope="module")
def mesh():
    """A world-1 gloo group and its mesh (made here, torn down after the
    module)."""
    import torch.distributed as dist

    from ptype_tpu_torch.parallel.mesh import build_mesh, init_distributed

    own = None
    if not dist.is_initialized():
        own = tempfile.mkdtemp(prefix="gate-pg-")
        init_distributed(f"file://{own}/rdv", 0, 1, device="cpu")
    yield build_mesh
    if own is not None:
        dist.destroy_process_group()


def _batch(b=2, s=16):
    g = torch.Generator().manual_seed(0)
    toks = torch.randint(0, CFG.vocab_size, (b, s + 1), generator=g)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def _prompt():
    g = torch.Generator().manual_seed(1)
    return torch.randint(1, CFG.vocab_size, (1, 8), generator=g)


def _warm(call):
    call()
    return call


def _generator(mesh):
    from ptype_tpu_torch.serve import GeneratorActor

    a = GeneratorActor(CFG, device="cpu")
    return _warm(lambda: a.Generate(_prompt(), 2))


def _logits(mesh):
    from ptype_tpu_torch.serve import GeneratorActor

    a = GeneratorActor(CFG, device="cpu")
    return _warm(lambda: a.Logits(_prompt()))


def _batching(mesh):
    from ptype_tpu_torch.serve import BatchingGeneratorActor

    a = BatchingGeneratorActor(CFG, device="cpu", window_ms=1.0)
    return _warm(lambda: a.Generate(_prompt(), 2))


def _paged(mesh):
    from ptype_tpu_torch.serve_engine import PagedGeneratorActor

    a = PagedGeneratorActor(CFG, device="cpu", n_slots=2)
    return _warm(lambda: a.Generate(_prompt(), 2))


def _trainer(mesh):
    from ptype_tpu_torch.train import Trainer

    tr = Trainer(CFG, device="cpu", sync_every=1)
    return _warm(lambda: tr.step(_batch()))


def _store_dp(mesh):
    from ptype_tpu_torch.parallel.tensorstore import TensorStore
    from ptype_tpu_torch.train.store_dp import StoreDPTrainer

    m = mesh({"data": 1}, device="cpu")
    tr = StoreDPTrainer(CFG, TensorStore(m, device="cpu"), device="cpu")
    return _warm(lambda: tr.step(_batch()))


def _param_server(mesh):
    from ptype_tpu_torch.parallel.tensorstore import TensorStore
    from ptype_tpu_torch.train.param_server import ParamServer

    m = mesh({"data": 1}, device="cpu")
    ps = ParamServer(CFG, TensorStore(m, device="cpu"))
    snap = ps.Pull()
    zeros = {k: ({n: torch.zeros_like(t) for n, t in v.items()}
                 if isinstance(v, dict) else torch.zeros_like(v))
             for k, v in snap["params"].items()}
    return _warm(lambda: ps.Push(zeros, snap["version"]))


def _async_worker(mesh):
    from ptype_tpu_torch.parallel.tensorstore import TensorStore
    from ptype_tpu_torch.train.param_server import AsyncWorker, ParamServer

    m = mesh({"data": 1}, device="cpu")
    ps = ParamServer(CFG, TensorStore(m, device="cpu"))
    w = AsyncWorker(CFG, ps, device="cpu")
    return _warm(lambda: w.step(_batch()))


def _stage(method):
    def build(mesh):
        from ptype_tpu_torch.train.actor_pipeline import StageActor

        s = StageActor(lambda p, x: torch.tanh(x @ p), torch.eye(4))
        x, g = torch.ones(2, 4), torch.ones(2, 4)
        if method in ("Forward", "Infer"):
            return _warm(lambda: getattr(s, method)(*(
                (0, x) if method == "Forward" else (x,))))
        s.Forward(0, x)
        s.Backward(0, g)
        s.Apply()
        s.Forward(1, x)
        if method == "Backward":
            return lambda: s.Backward(1, g)
        s.Backward(1, g)
        return s.Apply
    return build


def _spmd_pipeline(mesh):
    from ptype_tpu_torch.models.weights import init_params
    from ptype_tpu_torch.parallel import pipeline

    m = mesh({"stage": 1}, device="cpu")
    params = init_params(torch.Generator().manual_seed(0), CFG)
    state, _ = pipeline.init_pipeline_state(CFG, m, params)
    step = pipeline.make_pipeline_train_step(CFG, m, n_microbatches=2)
    return _warm(lambda: step(state, _batch()))


ENTRY_POINTS = {
    "GeneratorActor.Generate": _generator,
    "GeneratorActor.Logits": _logits,
    "BatchingGeneratorActor.Generate": _batching,
    "PagedGeneratorActor.Generate": _paged,
    "Trainer.step": _trainer,
    "StoreDPTrainer.step": _store_dp,
    "ParamServer.Push": _param_server,
    "AsyncWorker.step": _async_worker,
    "StageActor.Forward": _stage("Forward"),
    "StageActor.Backward": _stage("Backward"),
    "StageActor.Apply": _stage("Apply"),
    "StageActor.Infer": _stage("Infer"),
    "pipeline.make_pipeline_train_step": _spmd_pipeline,
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_point_waits_for_a_profiler_switch(name, mesh):
    call = ENTRY_POINTS[name](mesh)
    done, errors = threading.Event(), []

    def run():
        try:
            call()
        except BaseException as e:  # noqa: BLE001 — asserted below
            errors.append(e)
        finally:
            done.set()

    with DEVICE_GATE.switch():
        t = threading.Thread(target=run, daemon=True)
        t.start()
        finished_early = done.wait(HELD_S)
    t.join(timeout=120)
    assert not errors, errors
    assert not finished_early, f"{name} ran through a profiler switch"
    assert done.is_set()
