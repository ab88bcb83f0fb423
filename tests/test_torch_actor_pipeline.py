"""The port's actor-per-layer pipeline against the reference's
``tests/test_actor_pipeline.py`` on the CPU: registry PID→stage,
forward and backward waves over RPC, each reference test with a
counterpart here; the stage actors' optimizers (``Adam``, ``SGD``)
held to ``optax`` step by step; and ResNet stage actors trained through
the pipeline against the same stages chained in process.

Tolerances: the reference's (1e-5 relative and absolute on pipeline
outputs, 1e-6 on the mean-of-microbatches apply); the optimizers bit for
bit against eager ``optax`` at f32; losses 1e-5 relative, parameters
after a step 1e-4 (the repo's f32 gradient bound where a reference test
states none)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ptype_tpu.actor import ActorServer as JActorServer
from ptype_tpu.cluster import join as jjoin
from ptype_tpu.config import Config as JConfig
from ptype_tpu.config import PlatformConfig as JPlatformConfig
from ptype_tpu.models import resnet as jresnet
from ptype_tpu.train import actor_pipeline as jap
from ptype_tpu_torch.actor import ActorServer
from ptype_tpu_torch.cluster import get_ip, join
from ptype_tpu_torch.config import Config, PlatformConfig
from ptype_tpu_torch.errors import ClusterError
from ptype_tpu_torch.models import resnet
from ptype_tpu_torch.models.weights import resnet_params_from_numpy
from ptype_tpu_torch.rpc import ConnConfig
from ptype_tpu_torch.train.actor_pipeline import (PipelineClient, StageActor,
                                                  discover_stages,
                                                  stage_service)
from ptype_tpu_torch.train.trainer import SGD, Adam, tree_leaves

OUT = dict(rtol=1e-5, atol=1e-5)
LOSS = dict(rtol=1e-5)
PARAM = dict(rtol=1e-4, atol=1e-4)


def _cfg(service, node, port=0, coord="local:tpipe", pkg=(Config,
                                                          PlatformConfig)):
    cfg, platform = pkg
    return cfg(service_name=service, node_name=node, port=port,
               platform=platform(name=node, coordinator_address=coord,
                                 lease_ttl=0.5))


def _conn():
    return ConnConfig(initial_node_timeout=2.0, debounce_time=0.1,
                      retries=1)


def _ws():
    return np.array(jax.random.normal(jax.random.PRNGKey(0),
                                      (3, 6, 6)) * 0.5)


@pytest.fixture
def pipeline_cluster():
    """A 3-stage linear pipeline served by in-process port actors."""
    ws = torch.from_numpy(_ws())
    clusters, servers, stages = [], [], []
    for i in range(3):
        stage = StageActor(lambda p, x: torch.tanh(x @ p), ws[i].clone(),
                           optimizer=SGD(0.1))
        server = ActorServer(get_ip(), 0, device="cpu")
        server.register(stage, "Stage")
        server.serve()
        clusters.append(join(_cfg(stage_service("mlp", i), f"stage{i}",
                                  server.port), device="cpu"))
        servers.append(server)
        stages.append(stage)
    driver = join(_cfg("driver", "driver0"), device="cpu")
    clusters.append(driver)
    yield driver, stages, ws
    for c in clusters:
        c.close()
    for s in servers:
        s.close()


def test_discover_stages(pipeline_cluster):
    driver, _, _ = pipeline_cluster
    names = discover_stages(driver.registry, "mlp")
    assert names == [stage_service("mlp", i) for i in range(3)]


def test_non_contiguous_stages_refused(pipeline_cluster):
    """A hole in the stage indices (a dead stage) fails loudly instead
    of piping around the missing layer."""
    driver, _, _ = pipeline_cluster
    extra = join(_cfg(stage_service("broken", 0), "b0", 1), device="cpu")
    extra2 = join(_cfg(stage_service("broken", 2), "b2", 2), device="cpu")
    try:
        with pytest.raises(ClusterError, match="non-contiguous"):
            discover_stages(driver.registry, "broken")
        with pytest.raises(ClusterError, match="no stages"):
            PipelineClient(driver, "nothing")
    finally:
        extra.close()
        extra2.close()


def test_apply_accumulates_mean(pipeline_cluster):
    """Backward adds up; Apply folds the MEAN of the microbatch grads
    in one optimizer step (the step size does not depend on M)."""
    s = StageActor(lambda p, x: x @ p, torch.eye(3), optimizer=SGD(1.0))
    x = torch.ones((2, 3))
    g = torch.ones((2, 3))
    s.Forward(0, x)
    s.Forward(1, x)
    assert torch.equal(s.Backward(0, g), g @ torch.eye(3).T)
    s.Backward(1, g)
    assert s.Apply() == 2
    torch.testing.assert_close(s.params, torch.eye(3) - x.T @ g,
                               rtol=1e-6, atol=0)
    assert s.Apply() == 0  # nothing pending


def test_infer_matches_local(pipeline_cluster):
    driver, _, ws = pipeline_cluster
    client = PipelineClient(driver, "mlp", conn_cfg=_conn())
    try:
        x = torch.from_numpy(np.array(jax.random.normal(
            jax.random.PRNGKey(1), (4, 6))))
        got = client.infer(x)
    finally:
        client.close()
    want = x
    for i in range(3):
        want = torch.tanh(want @ ws[i])
    torch.testing.assert_close(got, want, **OUT)


def _ref_train_losses(x, target, steps):
    """The reference's pipeline of the same three stages (its own
    actors and registry), trained the same way."""
    ws = jnp.asarray(_ws())
    clusters, servers = [], []
    pkg = (JConfig, JPlatformConfig)
    for i in range(3):
        stage = jap.StageActor(lambda p, x: jnp.tanh(x @ p), ws[i],
                               optimizer=optax.sgd(0.1))
        server = JActorServer("127.0.0.1", 0)
        server.register(stage, "Stage")
        server.serve()
        clusters.append(jjoin(_cfg(jap.stage_service("mlp", i), f"j{i}",
                                   server.port, "local:jpipe", pkg)))
        servers.append(server)
    driver = jjoin(_cfg("driver", "jdriver", 0, "local:jpipe", pkg))
    clusters.append(driver)
    from ptype_tpu.rpc import ConnConfig as JConnConfig

    try:
        client = jap.PipelineClient(driver, "mlp", conn_cfg=JConnConfig(
            initial_node_timeout=2.0, debounce_time=0.1, retries=1))

        def loss_grad(y):
            def f(y):
                return jnp.mean((y - target[: y.shape[0]]) ** 2)

            return f(y), jax.grad(f)(y)

        return [client.train_step(jnp.asarray(x), loss_grad,
                                  n_microbatches=2) for _ in range(steps)]
    finally:
        for c in clusters:
            c.close()
        for s in servers:
            s.close()


def test_train_step_learns(pipeline_cluster):
    """Ten sweeps of two microbatches learn the target, every stage
    applying its own updates — with the reference pipeline's losses."""
    driver, stages, ws = pipeline_cluster
    client = PipelineClient(driver, "mlp", conn_cfg=_conn())
    x = np.array(jax.random.normal(jax.random.PRNGKey(1), (8, 6)))
    target = torch.full((8, 6), 0.3)

    def loss_grad(y):
        y = y.detach().requires_grad_(True)
        loss = torch.mean((y - target[: y.shape[0]]) ** 2)
        return loss.detach(), torch.autograd.grad(loss, y)[0]

    try:
        losses = [client.train_step(torch.from_numpy(x), loss_grad,
                                    n_microbatches=2) for _ in range(10)]
    finally:
        client.close()
    assert losses[-1] < losses[0] * 0.9
    assert not torch.allclose(stages[0].params, ws[0])
    want = _ref_train_losses(x, jnp.full((8, 6), 0.3), 10)
    np.testing.assert_allclose(losses, want, **LOSS)


def test_resnet_stage_actors(pipeline_cluster):
    """ResNet's stage_split drops into StageActors (tiny preset): their
    chained Infer equals the reference's forward on its weights."""
    jcfg = jresnet.preset("tiny", dtype=jnp.float32)
    jparams = jresnet.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = resnet.preset("tiny", dtype=torch.float32)
    params = resnet_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), cfg)
    actors = [StageActor(fn, p) for _, fn, p in resnet.stage_split(params,
                                                                    cfg)]
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (2, 32, 32, 3)))
    y = torch.from_numpy(x).permute(0, 3, 1, 2)
    for a in actors:
        y = a.Infer(y)
    want, _ = jresnet.forward(jparams, jnp.asarray(x), jcfg, train=False)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), **OUT)


# ------------------------------------------------------------ optimizers


def _tree(rng):
    return {"w": rng.standard_normal((4, 3)).astype(np.float32),
            "blocks": [{"a": rng.standard_normal(5).astype(np.float32)},
                       {"a": rng.standard_normal(5).astype(np.float32)}]}


@pytest.mark.parametrize("name", ["adam", "sgd"])
def test_optimizers_equal_optax_step_by_step(name):
    """``Adam`` is ``optax.adam`` and ``SGD`` is ``optax.sgd``: five
    steps of random gradients, the params (and Adam's moments and count)
    bit for bit at f32."""
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    ours = Adam(1e-3) if name == "adam" else SGD(0.1)
    ref = optax.adam(1e-3) if name == "adam" else optax.sgd(0.1)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    js = ref.init(jp)
    tp = jax.tree_util.tree_map(torch.from_numpy, p0)
    ts = ours.init(tp)
    for _ in range(5):
        g = _tree(rng)
        upd, js = ref.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        ours.update(tp, jax.tree_util.tree_map(torch.from_numpy, g), ts)
    for a, b in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if name == "adam":
        assert ts.count == int(js[0].count) == 5
        for a, b in zip(tree_leaves(ts.mu), jax.tree_util.tree_leaves(
                js[0].mu)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(tree_leaves(ts.nu), jax.tree_util.tree_leaves(
                js[0].nu)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_resnet_train_step_equals_the_stages_in_process(pipeline_cluster):
    """ResNet stage actors (train-mode batch norm) behind their own
    services, trained by ``PipelineClient.train_step`` over two
    microbatches, equal the same stages chained in this process with the
    same optimizer: one loss, then every stage's parameters."""
    driver, _, _ = pipeline_cluster
    cfg = resnet.preset("tiny", dtype=torch.float32)
    params = resnet.init_params(torch.Generator().manual_seed(0), cfg)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(4, 3, 16, 16, generator=g)
    # loss_grad_fn sees only the output, so both microbatches share
    # their labels
    labels = torch.randint(0, cfg.n_classes, (2,), generator=g).repeat(2)

    def loss_grad(logits, lab):
        y = logits.detach().requires_grad_(True)
        logz = torch.logsumexp(y, -1)
        loss = (logz - y.gather(-1, lab[:, None])[:, 0]).mean()
        return loss.detach(), torch.autograd.grad(loss, y)[0]

    parts = resnet.stage_split(params, cfg, train=True)
    actors = [StageActor(fn, p, optimizer=Adam(1e-3)) for _, fn, p in parts]
    servers, clusters = [], []
    for i, a in enumerate(actors):
        srv = ActorServer(get_ip(), 0, device="cpu")
        srv.register(a, "Stage")
        srv.serve()
        servers.append(srv)
        clusters.append(join(_cfg(stage_service("rn", i), f"rn{i}",
                                  srv.port), device="cpu"))
    client = PipelineClient(driver, "rn", conn_cfg=_conn())
    try:
        loss = client.train_step(x, lambda y: loss_grad(y, labels[:2]), 2)
    finally:
        client.close()
        for c in clusters:
            c.close()
        for s in servers:
            s.close()

    local = [StageActor(fn, p, optimizer=Adam(1e-3))
             for _, fn, p in resnet.stage_split(params, cfg, train=True)]
    losses = []
    for m, (xm, lm) in enumerate(zip(x.chunk(2), labels.chunk(2))):
        a = xm
        for s in local:
            a = s.Forward(m, a)
        lo, gr = loss_grad(a, lm)
        losses.append(float(lo))
        for s in reversed(local):
            gr = s.Backward(m, gr)
    assert [s.Apply() for s in local] == [2] * len(local)
    np.testing.assert_allclose(loss, sum(losses) / 2, **LOSS)
    for a, b in zip(actors, local):
        for x1, x2 in zip(tree_leaves(a.params), tree_leaves(b.params)):
            torch.testing.assert_close(x1, x2, **PARAM)
