"""Live elastic resharding against the reference, on this host's CPU:
``ZeroState.reshard`` onto survivor meshes (moments, masks and ZeRO-3
flats bit-equal to the reference's ``reshard``), a chaos drop mid-move
that leaves every rank on the old plan, ``ZeroCheckpoint`` written at 4
and restored at 2 in both directions across the packages,
``StoreDPTrainer.reshard`` then survivor steps against the reference's,
the ``FailureDetector``'s event sequence, ``ElasticZeroTrainer``
recovering from ``inject_loss``, and the mesh ``ElasticTrainer``
(checkpoint → survivor mesh → restore) recovering and refusing zero
devices (a second 4-rank spawn, suite "elastic_trainer").

The port runs on 4 gloo ranks (``tests/torch_ranks.py`` suite
"elastic", one spawn, a 300 s ``Ranks.join`` deadline); the reference on
4/3/2/1-device meshes of the conftest's CPU devices, while the ranks
run. Leaves, params and batches are seeded numpy, the same in both.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ptype_tpu.checkpoint import ZeroCheckpoint as JZeroCheckpoint
from ptype_tpu.models import transformer as jtfm
from ptype_tpu.parallel.mesh import build_mesh
from ptype_tpu.parallel.tensorstore import TensorStore as JStore
from ptype_tpu.parallel.zero import ShardPlan as JPlan
from ptype_tpu.parallel.zero import ZeroState as JZero
from ptype_tpu.train import store_dp as jsd
from ptype_tpu.train import trainer as jtr
from ptype_tpu.train.trainer import default_optimizer_hparams as jhp
from test_torch_train import LOSS_TOL, STEP_TOL
from torch_ranks import Ranks

N = 4
#: Three buckets over the leaves, so a drop can land in the middle one.
BUCKET_BYTES = 100
MASK = [True, False, True]
#: name → (source ranks, survivor ranks).
MOVES = {"4to2": ([0, 1, 2, 3], [0, 1]), "4to3": ([0, 1, 2, 3], [0, 1, 2]),
         "2to1": ([0, 1], [0])}
#: The reference's own tolerance between a resharded run and an
#: uninterrupted one (tests/test_zero_train.py).
RESHARD_LOSS_TOL = dict(rtol=1e-4)


def leaves_np():
    k = jax.random.PRNGKey(0)
    return [np.asarray(jax.random.normal(jax.random.fold_in(k, i), s,
                                         jnp.float32))
            for i, s in enumerate(((16, 8), (8,), (24,)))]


def meshes():
    return {n: build_mesh({"data": n}, devices=jax.devices()[:n])
            for n in (1, 2, 3, 4)}


def ref_state(mesh, n, leaves, count=0):
    plan = JPlan.for_leaves(leaves, n, BUCKET_BYTES)
    zs = JZero.create(plan, mesh, "data", jhp(), MASK)
    sh = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("data"))
    for i, b in enumerate(plan.buckets):
        v = np.zeros((b.elems,), np.float32)
        v[:b.elems - b.pad] = np.arange(b.elems - b.pad,
                                        dtype=np.float32) + 1.0
        zs.mu[i] = jax.device_put(v, sh)
        zs.nu[i] = jax.device_put(v * 0.5, sh)
    zs.count = count
    return zs


def ref_view(zs) -> dict:
    out = {"mu": [np.asarray(x) for x in zs.mu],
           "nu": [np.asarray(x) for x in zs.nu],
           "mask": [np.asarray(x) for x in zs._masks],
           "count": zs.count, "plan": zs.plan.manifest(),
           "shard_elems": [int(x.addressable_shards[0].data.size)
                           for x in zs.mu]}
    if zs.pflat is not None:
        out["p"] = [np.asarray(x) for x in zs.pflat]
        out["params"] = [np.asarray(x) for x in zs.gather_params()]
    return out


def make_batches(B, count, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        toks = rng.integers(0, 256, (B, 33)).astype(np.int32)
        out.append({"tokens": toks[:, :-1], "targets": toks[:, 1:]})
    return out


def jcfg():
    return jtfm.preset("tiny", dtype=jnp.float32, attn_impl="xla")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(the port's per-rank outputs, the reference's results)."""
    work = tmp_path_factory.mktemp("elastic")
    ms = meshes()
    leaves = leaves_np()
    ref_dir = str(work / "ref_zero")
    zs = ref_state(ms[4], 4, leaves, count=7)
    zs.scatter_params(leaves)
    JZeroCheckpoint(ref_dir).save(3, zs)
    p0 = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k: jtfm.init_params(k, jcfg()))(jax.random.PRNGKey(7)))
    inputs = {"leaves": leaves, "mask": MASK, "bucket_bytes": BUCKET_BYTES,
              "moves": MOVES, "ref_zero_dir": ref_dir,
              "port_zero_dir": str(work / "port_zero"),
              "drill_dir": str(work / "drill"),
              "measure_dir": str(work / "measure"),
              "params": p0, "batches": make_batches(8, 6, 11),
              "batches12": make_batches(12, 4, 12)}
    (work / "ranks").mkdir()
    ranks = Ranks("elastic", N, work / "ranks", inputs)
    ref: dict = {"moves": {}}
    try:  # the reference runs while the ranks do
        for name, (src, dst) in MOVES.items():
            zs = ref_state(ms[len(src)], len(src), leaves, count=7)
            zs.scatter_params(leaves)
            zs.reshard(ms[len(dst)])
            ref["moves"][name] = ref_view(zs)
        for stage in (2, 3):
            tr = jsd.StoreDPTrainer(jcfg(), JStore(ms[4]), zero=stage,
                                    rng=jax.random.PRNGKey(7))
            b = inputs["batches"]
            losses = [float(tr.step(b[i])["loss"]) for i in range(3)]
            info = tr.reshard(ms[2])
            losses += [float(tr.step(b[i])["loss"]) for i in range(3, 6)]
            ref[f"live_zero{stage}"] = {
                "losses": losses, "info": info,
                "params": jax.tree_util.tree_map(np.asarray, tr.params()),
                "moment_elems": [int(x.addressable_shards[0].data.size)
                                 for x in tr.zero_state().mu]}
    finally:
        outs = ranks.join()
    # The port's 4-rank ZeroCheckpoint, restored by the reference at 2.
    dst = ref_state(ms[2], 2, leaves)
    dst.scatter_params([np.zeros_like(x) for x in leaves])
    for i in range(len(dst.mu)):
        dst.mu[i] = jnp.zeros_like(dst.mu[i])
    step = JZeroCheckpoint(inputs["port_zero_dir"]).restore_into(dst)
    ref["port_zero_restored"] = dict(ref_view(dst), step=step)
    ref["leaves"] = leaves
    return outs, ref


def assert_view_equal(got: dict, want: dict, msg: str) -> None:
    assert got["plan"] == want["plan"], msg
    assert got["count"] == want["count"], msg
    assert got["shard_elems"] == want["shard_elems"], msg
    for name in ("mu", "nu", "mask", "p", "params"):
        if name not in want:
            continue
        assert len(got[name]) == len(want[name]), (msg, name)
        for i, (a, b) in enumerate(zip(got[name], want[name])):
            np.testing.assert_array_equal(a, b, err_msg=f"{msg} {name} {i}")


@pytest.mark.parametrize("move", sorted(MOVES))
def test_zero_reshard_matches_reference(run, move):
    """Every survivor holds the reference's resharded state bit for bit:
    the same plan, the 1/n shard sizes, moments, masks, ZeRO-3 flats,
    and the original leaves gathered back."""
    outs, ref = run
    src, dst = MOVES[move]
    for r in dst:
        assert_view_equal(outs[r]["moves"][move], ref["moves"][move],
                          f"{move} rank {r}")
    for r in set(range(N)) - set(dst):
        assert move not in outs[r]["moves"]
    for got, want in zip(outs[0]["moves"][move]["params"], ref["leaves"]):
        np.testing.assert_array_equal(got, want)


def test_drop_mid_reshard_leaves_every_rank_on_the_old_plan(run):
    """Rank 0 decides the fault at bucket 1 for everyone: every rank
    raises before that bucket's collective with its plan, mesh and
    moments untouched, and the retry lands, pairing the fault."""
    outs, ref = run
    assert len(outs[0]["drop"]["after"]["mu"]) == 3
    for r, out in enumerate(outs):
        d = out["drop"]
        assert d["raised"] and "bucket 1" in d["raised"], r
        assert d["old_plan_kept"], r
        assert d["unrecovered_after_retry"] == {}, r
    assert outs[0]["drop"]["unrecovered_after_drop"] == {"train": 1}
    a0, a1 = outs[0]["drop"]["after"], outs[1]["drop"]["after"]
    assert a0["plan"]["n"] == 2 and a0["count"] == 5
    for i, b in enumerate(a0["plan"]["buckets"]):
        total = sum(s["size"] for s in b["slots"])
        np.testing.assert_array_equal(
            a0["mu"][i][:total], np.arange(total, dtype=np.float32) + 1)
        np.testing.assert_array_equal(a0["mu"][i], a1["mu"][i])


@pytest.mark.parametrize("which", ["ref_zero_dir", "port_zero_dir"])
def test_zero_checkpoint_written_at_4_restores_at_2(run, which):
    """A ZeroCheckpoint saved at 4 (the reference's single-writer layout,
    or the port's 4 rank manifests) restores on 2 ranks of the port as
    the reference resharded it in memory (4 → 2)."""
    outs, ref = run
    want = ref["moves"]["4to2"]
    for r in (0, 1):
        got = outs[r]["zero_restore"][which]
        assert got["step"] == 3
        assert_view_equal(got, want, f"{which} rank {r}")


def test_port_zero_checkpoint_restores_in_the_reference(run):
    """The port's 4-rank save restored by the reference at 2 devices."""
    outs, ref = run
    assert ref["port_zero_restored"]["step"] == 3
    assert_view_equal(ref["port_zero_restored"], ref["moves"]["4to2"],
                      "reference restore of the port's save")


@pytest.mark.parametrize("stage", [2, 3])
def test_store_dp_reshard_then_survivor_steps_match_reference(run, stage):
    """``StoreDPTrainer.reshard`` 4 → 2 after 3 steps, then 3 survivor
    steps: the reference's loss curve and params."""
    outs, ref = run
    want = ref[f"live_zero{stage}"]
    for r in (0, 1):
        got = outs[r][f"live_zero{stage}"]
        assert (got["info"]["old_n"], got["info"]["new_n"]) == (4, 2)
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   err_msg=f"zero{stage} rank {r}",
                                   **LOSS_TOL)
        assert got["moment_elems"] == want["moment_elems"]
        g = jax.tree_util.tree_flatten_with_path(got["params"])[0]
        w = jax.tree_util.tree_flatten_with_path(want["params"])[0]
        assert [p for p, _ in g] == [p for p, _ in w]
        for (path, a), (_, b) in zip(g, w):
            np.testing.assert_allclose(a, b, err_msg=f"{stage} {path}",
                                       **STEP_TOL)
    for r in (2, 3):
        got = outs[r][f"live_zero{stage}"]
        assert got["info"]["new_n"] is None and len(got["losses"]) == 3


def test_checkpoint_drill_resumes_on_two_ranks(run):
    """ZeroCheckpoint + StoreCheckpoint at 4 ranks, restored onto 2: the
    next 3 losses follow the uninterrupted 4-rank run (the reference's
    drill, tests/test_zero_train.py)."""
    outs, _ = run
    for r in (0, 1):
        d = outs[r]["drill"]
        assert d["step"] == 3 and d["count"] == 3
        np.testing.assert_allclose(d["resumed"], d["uninterrupted"],
                                   **RESHARD_LOSS_TOL)


def _fd_script(reg_mod, coord_core, coord_local, elastic) -> list:
    """One loss/join script through a package's registry and detector:
    the sequence of (what, value) it observes."""
    coord = coord_local.LocalCoord(coord_core.CoordState(sweep_interval=0.05))
    reg = reg_mod.CoordRegistry(coord, lease_ttl=0.4)
    r0 = reg.register("fdsvc", "w0", "127.0.0.1", 9100, process_id=0,
                      device_ordinals=(0, 1))
    r1 = reg.register("fdsvc", "w1", "127.0.0.1", 9101, process_id=1,
                      device_ordinals=(2, 3))
    fd = elastic.FailureDetector(reg, "fdsvc")
    seen = []

    def current():
        seen.append(("current", [(n.address, n.port, n.process_id,
                                  n.device_ordinals) for n in fd.current()]))

    def drained():
        deadline = time.time() + 5
        while not fd.changed and time.time() < deadline:
            time.sleep(0.02)
        seen.append(("drain", fd.drain_changes()))

    try:
        fd.wait_seeded()
        current()
        elastic.inject_loss(r1)
        drained()
        current()
        r2 = reg.register("fdsvc", "w2", "127.0.0.1", 9102, process_id=2)
        drained()
        current()
        r0.close(revoke=False)  # crash: the lease expires after its TTL
        drained()
        current()
        r2.close()
        drained()
        seen.append(("changed", fd.changed))
    finally:
        fd.close()
        coord.state.close()
    return seen


def test_failure_detector_sequence_matches_reference():
    from ptype_tpu import elastic as je
    from ptype_tpu import registry as jreg
    from ptype_tpu.coord import core as jcore
    from ptype_tpu.coord import local as jlocal
    from ptype_tpu_torch import elastic as te
    from ptype_tpu_torch import registry as treg
    from ptype_tpu_torch.coord import core as tcore
    from ptype_tpu_torch.coord import local as tlocal

    want = _fd_script(jreg, jcore, jlocal, je)
    got = _fd_script(treg, tcore, tlocal, te)
    assert got == want
    assert want[1] == ("drain", (["127.0.0.1:9101"], []))
    assert want[3] == ("drain", ([], ["127.0.0.1:9102"]))
    assert want[5] == ("drain", (["127.0.0.1:9100"], []))


def test_elastic_trainer_duplicate_loss_resumes_bit_for_bit(run):
    """A lost registration that advertised a rank still registered: the
    trainer raises MembershipChanged on every rank at the same step,
    recovers by a 4 → 4 reshard, and the retried run equals the run
    without the fault bit for bit."""
    outs, _ = run
    for r, out in enumerate(outs):
        row = out["dup_lost"]
        assert row["raised"] == {"lost": ["127.0.0.1:9200"], "joined": []}
        assert not row["left"] and row["n_workers"] == 4
        assert row["recover"]["old_devices"] == 4
        assert row["recover"]["new_devices"] == 4
        assert row["losses"] == out["no_fault"]["losses"], r
        g = jax.tree_util.tree_leaves(row["params"])
        w = jax.tree_util.tree_leaves(out["no_fault"]["params"])
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


def test_elastic_trainer_worker_loss_resumes_on_survivors(run):
    """inject_loss on worker 3: every rank raises at the same step, rank
    3 hands its shards over and leaves, and the 3 survivors' retried
    steps follow the run without the fault."""
    outs, _ = run
    for r, out in enumerate(outs):
        row = out["worker_lost"]
        assert row["raised"] == {"lost": ["127.0.0.1:9103"], "joined": []}
        assert row["left"] == (r == 3)
        assert row["recover"]["old_devices"] == 4
        if r < 3:
            assert row["recover"]["new_devices"] == 3
            assert row["recover"]["new_n"] == 3
            np.testing.assert_allclose(row["losses"],
                                       out["no_fault"]["losses"],
                                       **RESHARD_LOSS_TOL)
            assert row["losses"][:2] == out["no_fault"]["losses"][:2]
    assert outs[0]["worker_lost"]["detect_s"] < 5


def test_elastic_recover_without_survivors_raises(run):
    outs, _ = run
    for out in outs:
        assert "no surviving workers" in out["no_survivors"]


def test_elastic_recover_without_rank_0_raises_on_every_rank(run):
    """inject_loss on worker 0, whose process holds the detector and the
    registrations: every rank raises MembershipChanged at the same step,
    then ClusterError from recover naming the checkpoint way back, and
    no rank leaves."""
    outs, _ = run
    for out in outs:
        row = out["rank0_lost"]
        assert row["raised"] == {"lost": ["127.0.0.1:9100"], "joined": []}
        assert "not among the survivors" in row["recover"]
        assert "ZeroCheckpoint" in row["recover"]
        assert not row["left"]


def test_measure_reshard_reports_both_recoveries_in_steps(run):
    """``measure_reshard`` 4 → 2 on the ranks: the survivors report the
    live reshard and the checkpoint round trip in step units; the
    leavers only hand over their shards."""
    outs, _ = run
    for r, out in enumerate(outs):
        m = out["measure_reshard"]
        if r >= 2:
            assert m == {"zero_stage": 2, "left": True, "old_n": 4}
            continue
        assert (m["old_n"], m["new_n"]) == (4, 2)
        assert m["reshard_resume_steps"] > 0 and m["ckpt_resume_steps"] > 0
        assert m["live_resume_ms"] >= m["reshard_ms"] > 0


# ------------------------------------------------- the mesh ElasticTrainer

ET_OPT = dict(lr=1e-3, warmup=1, decay_steps=50)


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """The port's ``ElasticTrainer`` on 4 gloo ranks (suite
    "elastic_trainer") and the reference's data-parallel losses on the
    same params and batches (B=12: it splits over 4 ranks and over the
    3 survivors)."""
    work = tmp_path_factory.mktemp("elastic_trainer")
    p0 = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k: jtfm.init_params(k, jcfg()))(jax.random.PRNGKey(9)))
    batches = make_batches(12, 3, 13)
    (work / "ranks").mkdir()
    ranks = Ranks("elastic_trainer", N, work / "ranks",
                  {"params": p0, "batches": batches, "opt": ET_OPT,
                   "ckpt": str(work / "ckpt")})
    try:  # the reference runs while the ranks do
        mesh = build_mesh({"data": N})
        opt = jtr.default_optimizer(**ET_OPT)
        state, sh = jtr.init_state(jax.random.PRNGKey(0), jcfg(), mesh, opt)
        state = jtr.TrainState(jax.device_put(p0, sh.params),
                               state.opt_state, state.step)
        step = jtr.make_train_step(jcfg(), mesh, opt)
        ref = []
        for b in batches:
            state, out = step(state, b)
            ref.append(float(out["loss"]))
    finally:
        outs = ranks.join()
    return outs, ref


def test_mesh_elastic_trainer_recovers_from_member_loss(mesh_run):
    """Two steps on 4 ranks; the last worker's lease revoked: the next
    step raises MembershipChanged naming it on every rank; recover saves
    step 2, builds the 3-rank survivor mesh (the lost rank leaves),
    restores into it with the params unchanged, and training goes on:
    the losses are the reference's uninterrupted data-parallel ones."""
    outs, ref = mesh_run
    for r, out in enumerate(outs):
        row = out["lost"]
        assert row["raised"] == {"lost": ["127.0.0.1:9303"], "joined": []}
        if r == N - 1:
            assert row["left"]
            assert row["recover"] == {"restored_step": 2, "devices": None}
            continue
        assert not row["left"]
        assert row["recover"] == {"restored_step": 2, "devices": N - 1}
        assert row["params_kept"] and row["mesh_size"] == N - 1
        assert row["step_after"] == 2 and row["step_after_next"] == 3
        np.testing.assert_allclose(row["losses"], ref, **LOSS_TOL)


def test_mesh_elastic_trainer_refuses_zero_devices(mesh_run):
    outs, _ = mesh_run
    for out in outs:
        assert "no surviving workers" in out["no_survivors"]
