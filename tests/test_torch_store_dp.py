"""``StoreDPTrainer`` against the reference's, on this host's CPU: every
``overlap`` mode and every ``zero`` rung, 4 steps from the same params
(the reference's init carried across as numpy), loss and param
trajectories at the port's cross-package tolerances
(``tests/test_torch_train.py``: ``LOSS_TOL``, ``STEP_TOL``); the
int8+EF wire's curve against the reference's int8 curve (``rtol=5e-3``,
the reference's own bound for int8 against exact); the ladder's
resident bytes; a reference ``ZeroState.state_tree()`` loaded into the
port; the knob validation.

The reference runs on ``build_mesh({"data": n})`` over the conftest's
CPU devices, the port on n gloo ranks (``tests/torch_ranks.py``); world
sizes 2 and 4, one spawn each. The tiny preset in f32 with dense
attention (``attn_impl="xla"``), B=8, S=32. The scattered rungs run at
``clip=0.05``, under the first step's global grad norm, so the clip —
whose norm the port sums over the ranks — binds.
"""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ptype_tpu.models import transformer as jtfm
from ptype_tpu.parallel.collectives import WireConfig as JWire
from ptype_tpu.parallel.mesh import build_mesh
from ptype_tpu.parallel.tensorstore import TensorStore as JStore
from ptype_tpu.train import store_dp as jsd
from ptype_tpu.train import trainer as jtr
from ptype_tpu_torch.models import transformer as ttfm
from ptype_tpu_torch.train import store_dp as tsd
from ptype_tpu_torch.train import trainer as ttr
from test_torch_train import LOSS_TOL, STEP_TOL
from torch_ranks import Ranks

#: The int8+EF wire's loss curve against the reference's int8 curve,
#: the reference's own bound for int8 against exact
#: (tests/test_quantized_train.py).
INT8_TOL = dict(rtol=5e-3)
#: Adam moments after 4 steps: mu is a running mean of the gradients
#: (GRAD_TOL of tests/test_torch_train.py), nu of their squares.
MOMENT_TOL = {"mu": dict(rtol=2e-4, atol=2e-7), "nu": dict(rtol=4e-4,
                                                            atol=1e-12)}

OPT = dict(lr=2e-3, warmup=1, decay_steps=50)
BIND = dict(OPT, clip=0.05)
SMALL = dict(bucket_bytes=160 * 1024)
INT8 = dict(compress="int8", int8_min_bytes=0)
#: name → (StoreDPTrainer knobs, batches stepped on).
CASES = {
    "barrier": (dict(opt=OPT), [0, 1, 2, 3]),
    "drain": (dict(overlap="drain", opt=OPT), [0, 1, 2, 3]),
    "overlap": (dict(overlap=True, pieces=OPT, wire=SMALL), [0, 1, 2, 3]),
    "zero1": (dict(zero=1, zero_hp=OPT, wire=SMALL), [0, 1, 2, 3]),
    "zero2": (dict(zero=2, zero_hp=BIND, wire=SMALL), [0, 1, 2, 3]),
    "zero3": (dict(zero=3, zero_hp=BIND, wire=SMALL), [0, 1, 2, 3]),
    "int8": (dict(opt=OPT, wire=INT8), [0, 0, 0, 0]),
    "zero2_int8": (dict(zero=2, zero_hp=OPT, wire=dict(INT8, **SMALL)),
                   [0, 0, 0, 0]),
}
EXACT_CASES = ["barrier", "drain", "overlap", "zero1", "zero2", "zero3"]
#: Cases the port also runs with jitwatch armed.
ARMED = ["overlap", "zero2"]


def jcfg():
    return jtfm.preset("tiny", dtype=jnp.float32, attn_impl="xla")


def make_batches():
    rng = np.random.default_rng(3)
    out = []
    for _ in range(4):
        toks = rng.integers(0, 256, (8, 33)).astype(np.int32)
        out.append({"tokens": toks[:, :-1], "targets": toks[:, 1:]})
    return out


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def reference_trainer(mesh, knobs: dict):
    """The reference trainer for ``knobs`` (and the optimizer patch the
    overlap mode's per-bucket recipe needs)."""
    kw = dict(overlap=knobs.get("overlap", False),
              zero=knobs.get("zero", False), rng=jax.random.PRNGKey(7))
    if knobs.get("opt"):
        kw["optimizer"] = jtr.default_optimizer(**knobs["opt"])
    if knobs.get("zero_hp"):
        kw["zero_hparams"] = jtr.OptHParams(**knobs["zero_hp"])
    wire = JWire(**knobs["wire"]) if knobs.get("wire") else None
    patch = mock.patch.object(
        jsd, "default_optimizer_pieces",
        functools.partial(jtr.default_optimizer_pieces,
                          **knobs.get("pieces", {})))
    with patch:
        return jsd.StoreDPTrainer(jcfg(), JStore(mesh, wire=wire), **kw), \
            patch


def run_reference(trainer, patch, batches, idxs):
    with patch:
        return [trainer.step(batches[i]) for i in idxs]


def summary(trainer, steps) -> dict:
    row = {"losses": [float(s["loss"]) for s in steps],
           "grad_epochs": [s["grad_epoch"] for s in steps],
           "params": np_tree(trainer.params()),
           "last_grad_bytes": trainer.last_grad_bytes,
           "param_keys": [k for k in trainer.store.keys()
                          if k.startswith("params/")],
           "residual_keys": sorted(trainer.store._residuals)}
    if trainer.zero:
        z = trainer.zero_state()
        row["moment_bytes"] = z.moment_bytes_per_replica()
        row["param_bytes"] = z.param_bytes_per_replica()
        row["state_tree"] = np_tree(z.state_tree())
    return row


@pytest.fixture(scope="module", params=[2, 4], ids=lambda n: f"world{n}")
def world(request, tmp_path_factory):
    """(n, the port's per-rank case outputs, the reference's)."""
    n = request.param
    mesh = build_mesh({"data": n})
    cfg = jcfg()
    batches = make_batches()
    p0 = np_tree(jax.jit(lambda k: jtfm.init_params(k, cfg))(
        jax.random.PRNGKey(7)))
    # The zero2 run's state after two steps seeds the port's "load" case.
    z2, z2patch = reference_trainer(mesh, CASES["zero2"][0])
    z2_steps = run_reference(z2, z2patch, batches, [0, 1])
    snap = {"tree": np_tree(z2.zero_state().state_tree()),
            "plan": z2.zero_state().plan.manifest(),
            "params": np_tree(z2.params())}
    cases = [dict(name=name, params=p0, batches=idxs, **knobs)
             for name, (knobs, idxs) in CASES.items()]
    cases += [dict(name=f"{name}_armed", params=p0, batches=CASES[name][1],
                   armed=True, **CASES[name][0]) for name in ARMED]
    cases.append(dict(name="load", params=snap["params"], batches=[2, 3],
                      zero=2, zero_hp=BIND, wire=SMALL,
                      load={"tree": snap["tree"], "plan": snap["plan"]}))
    ranks = Ranks("store_dp", n, tmp_path_factory.mktemp(f"dp{n}"),
                  {"cases": cases, "batches": batches})
    try:  # the reference runs while the ranks do
        ref = {}
        for name, (knobs, idxs) in CASES.items():
            if name == "zero2":
                steps = z2_steps + run_reference(z2, z2patch, batches,
                                                 idxs[2:])
                ref[name] = summary(z2, steps)
                continue
            tr, patch = reference_trainer(mesh, knobs)
            ref[name] = summary(tr, run_reference(tr, patch, batches, idxs))
        ref["load"] = dict(ref["zero2"], losses=ref["zero2"]["losses"][2:])
        # The first step's global grad norm: the scattered rungs' clip
        # must bind.
        grads = jax.grad(jtfm.loss_fn)(jax.tree_util.tree_map(
            jnp.asarray, p0), {k: jnp.asarray(v)
                               for k, v in batches[0].items()}, cfg)
        ref["grad_norm0"] = float(optax.global_norm(grads))
    finally:
        outs = ranks.join()
    return n, outs, ref


def assert_params_close(got: dict, want: dict, msg: str, **tol):
    g = jax.tree_util.tree_flatten_with_path(got)[0]
    w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in g] == [p for p, _ in w], msg
    for (path, a), (_, b) in zip(g, w):
        np.testing.assert_allclose(a, b, err_msg=f"{msg} {path}", **tol)


@pytest.mark.parametrize("case", EXACT_CASES + ["load"])
def test_loss_and_params_match_reference(world, case):
    """Every rank returns the reference's loss curve and holds its
    params (the mean over ranks of the local losses is the reference's
    mean over workers)."""
    n, outs, ref = world
    for r, out in enumerate(outs):
        got = out[case]
        np.testing.assert_allclose(got["losses"], ref[case]["losses"],
                                   err_msg=f"{case} rank {r}", **LOSS_TOL)
        assert got["losses"] == outs[0][case]["losses"]
        assert_params_close(got["params"], ref[case]["params"],
                            f"{case} rank {r}", **STEP_TOL)


def test_scattered_rungs_clip_binds(world):
    """The scattered rungs' global norm is the sum over ranks of their
    shard sums: with the clip below the norm, a rank-local norm would
    scale each rank's update differently and miss the reference."""
    n, outs, ref = world
    assert ref["grad_norm0"] > 4 * BIND["clip"]
    for case in ("zero2", "zero3"):
        for out in outs:
            assert_params_close(out[case]["params"], ref[case]["params"],
                                case, **STEP_TOL)


@pytest.mark.parametrize("case", ["int8", "zero2_int8"])
def test_int8_ef_curve_tracks_the_reference_int8_curve(world, case):
    n, outs, ref = world
    for out in outs:
        np.testing.assert_allclose(out[case]["losses"],
                                   ref[case]["losses"], **INT8_TOL)
        assert out[case]["losses"][-1] < out[case]["losses"][0]
        # Residuals live under the grad leaf keys, on every path.
        assert out[case]["residual_keys"] == ref[case]["residual_keys"]
        assert out[case]["residual_keys"][0].startswith("grads/")


def test_grad_epochs_match_reference(world):
    n, outs, ref = world
    for case in CASES:
        for out in outs:
            assert out[case]["grad_epochs"] == ref[case]["grad_epochs"], case


def test_ladder_resident_bytes_match_reference(world):
    """The ladder's per-rank bytes are the reference's per-device bytes,
    and its ratios hold: whole grads at 1, 1/n at 2 and 3; param shards
    only at 3."""
    n, outs, ref = world
    for out in outs:
        for case in ("zero1", "zero2", "zero3"):
            for key in ("last_grad_bytes", "moment_bytes", "param_bytes"):
                assert out[case][key] == ref[case][key], (case, key)
        g1, g2, g3 = (out[c]["last_grad_bytes"]
                      for c in ("zero1", "zero2", "zero3"))
        assert g1 >= (n - 0.5) * g2 and abs(g2 - g3) <= 0.01 * g2
        p3 = out["zero3"]["param_bytes"]
        total = sum(x.nbytes for x in jax.tree_util.tree_leaves(
            out["zero3"]["params"]))
        assert p3 > 0 and total >= (n - 0.5) * p3
        assert out["zero1"]["param_bytes"] == out["zero2"]["param_bytes"] == 0


def test_zero3_holds_no_replicated_leaves(world):
    n, outs, ref = world
    for out in outs:
        assert out["zero3"]["param_leaves_none"]
        assert out["zero3"]["param_keys"] == ref["zero3"]["param_keys"]
        assert all(k.startswith("params/bucket")
                   for k in out["zero3"]["param_keys"])
        assert not out["zero2"]["param_leaves_none"]


@pytest.mark.parametrize("case", ["zero2", "load"])
def test_zero_state_tree_matches_reference(world, case):
    """The moments after 4 steps, in the reference's state_tree layout
    (every rank gathers the whole flats); "load" resumed from the
    reference's state after 2 steps."""
    n, outs, ref = world
    want = ref["zero2"]["state_tree"]
    for out in outs:
        got = out[case]["state_tree"]
        assert int(got["count"]) == int(want["count"]) == 4
        assert sorted(got["buckets"]) == sorted(want["buckets"])
        for b in want["buckets"]:
            for m in ("mu", "nu"):
                np.testing.assert_allclose(got["buckets"][b][m],
                                           want["buckets"][b][m],
                                           err_msg=f"{case} {b} {m}",
                                           **MOMENT_TOL[m])


def test_knob_validation_matches_reference():
    """Each bad combination raises before the store is touched, with
    the reference's message."""
    mesh = build_mesh({"data": 2})
    tcfg = ttfm.preset("tiny", dtype=torch.float32)
    bad = [(dict(zero=4), "ladder stage"), (dict(zero="2"), "ladder stage"),
           (dict(overlap="x"), "overlap must be one of"),
           (dict(zero=True, overlap=True), "overlap=False"),
           (dict(zero_hparams=object()), "zero_hparams only applies"),
           (dict(zero=1, optimizer="custom"), "zero=True shards")]
    for kw, msg in bad:
        jkw = dict(kw)
        if jkw.get("optimizer"):
            jkw["optimizer"] = optax.sgd(1e-2)
        with pytest.raises(ValueError, match=msg):
            jsd.StoreDPTrainer(jcfg(), JStore(mesh), **jkw)
        tkw = dict(kw)
        if tkw.get("optimizer"):
            tkw["optimizer"] = ttr.default_optimizer()
        with pytest.raises(ValueError, match=msg):
            tsd.StoreDPTrainer(tcfg, None, **tkw)


def test_zero_state_of_a_replicated_trainer_raises(world):
    _, outs, _ = world
    for out in outs:
        assert "no ZeRO state" in out["barrier"]["zero_state_error"]


@pytest.mark.parametrize("case", ARMED)
def test_armed_steady_state_equals_the_disarmed_run(world, case):
    """Armed, the store-DP steps take the same losses bit for bit as the
    disarmed run, build nothing after the first step, and held the
    ``train.step`` guard (an unsanctioned host synchronisation in the
    grads, exchange or apply would have raised, failing the run); the
    batch upload is the one sanctioned pass a step."""
    n, outs, _ = world
    for r in range(n):
        armed, plain = outs[r][f"{case}_armed"], outs[r][case]
        assert armed["losses"] == plain["losses"]
        jit = armed["jit"]
        assert jit["steady"] == {} and jit["recompiles"] == {}
        assert jit["hot_regions"] == 4
        assert jit["sanctioned_transfers"] == {"train.data": 4}
