"""The port's checkpoint tier against the reference's: the cases of
``tests/test_checkpoint.py`` (plain, sharded at 2 and 4 writers, async
plus GC, an async failure surfacing on ``wait``, incomplete steps
ignored, bf16, overlapping shards rejected, a re-committed step kept),
a corrupt shard raising, the ``checkpoint.commit`` crash, step
directories crossing between the packages both ways bit for bit with
equal manifest records, ``ZeroCheckpoint`` and ``StoreCheckpoint``
across packages, and a reference ``TrainState`` carried into the port's
``Trainer``.

Several writers are threads here, each a ``Checkpointer`` whose mesh
says (rank r of n): the multi-writer protocol is file-based, so threads
exercise it as rank processes would (``tests/test_torch_elastic.py``
runs it on gloo ranks)."""

import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from ptype_tpu import checkpoint as jck
from ptype_tpu.models import transformer as jtfm
from ptype_tpu.parallel.mesh import build_mesh, named_sharding
from ptype_tpu.parallel.tensorstore import TensorStore as JStore
from ptype_tpu.train import trainer as jtr
from ptype_tpu_torch import chaos
from ptype_tpu_torch import checkpoint as tck
from ptype_tpu_torch.errors import CheckpointError, ClusterError
from ptype_tpu_torch.models import transformer as ttfm
from ptype_tpu_torch.parallel.mesh import Mesh
from ptype_tpu_torch.parallel.tensorstore import TensorStore
from ptype_tpu_torch.train import trainer as ttr
from test_torch_train import LOSS_TOL, to_j


def fake_mesh(rank=0, size=1) -> Mesh:
    """A mesh that says "rank r of n" with no process group: enough for
    the checkpoint writers and the store's placement, which run no
    collective."""
    return Mesh(("data",), {"data": size}, None, rank, torch.device("cpu"),
                None)


def np_tree(seed=0) -> dict:
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(8, 4)).astype(np.float32),
            "b": np.arange(4, dtype=np.float32),
            "step": np.int32(7),
            "mask": rng.random(6) > 0.5,
            "nested": {"ids": rng.integers(0, 9, (3, 2)).astype(np.int32)}}


def t_tree(tree):
    return {k: t_tree(v) if isinstance(v, dict) else torch.from_numpy(
        np.array(v)) for k, v in tree.items()}


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def as_np(x):
    if torch.is_tensor(x):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return x.view(np.int16)
    return x


def assert_trees_equal(got, want):
    g, w = flat(got), flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        a, b = as_np(g[k]), as_np(w[k])
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def records(sdir) -> dict:
    """key → (shape, dtype, [(start, shape, raw, crc32)]) of a step
    directory's manifests (file names aside)."""
    out = {}
    for name in sorted(os.listdir(sdir)):
        if name.startswith("manifest"):
            with open(os.path.join(sdir, name)) as f:
                for key, e in json.load(f)["leaves"].items():
                    recs = out.setdefault(key, (e["shape"], e["dtype"], []))
                    recs[2].extend((r["start"], r["shape"], r["raw"],
                                    r["crc32"]) for r in e["shards"])
    return {k: (s, d, sorted(r)) for k, (s, d, r) in out.items()}


# ------------------------------------------------------- the basic cases


def test_roundtrip_plain(tmp_path):
    ckpt = tck.Checkpointer(str(tmp_path))
    tree = t_tree(np_tree())
    ckpt.save(1, tree)
    assert_trees_equal(ckpt.restore(tree, step=1, device="cpu"), tree)


@pytest.mark.parametrize("n", [2, 4])
def test_roundtrip_sharded(tmp_path, n):
    """n writers each save their row block of "w" (and rank 0 the
    replicated leaves) into one step dir: ``manifest.p<i>.json`` per
    rank, the marker once all are in. Both packages restore the whole
    array."""
    full = np.arange(32, dtype=np.float32).reshape(8, 4)
    rows = 8 // n

    def rank(r):
        ck = tck.Checkpointer(str(tmp_path), mesh=fake_mesh(r, n))
        t = torch.from_numpy(full[r * rows:(r + 1) * rows].copy())
        ck.save(3, {"w": tck.Shard(t, (r * rows, 0), (8, 4)),
                    "count": np.int32(5)})

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    sdir = tmp_path / "step_3"
    assert sorted(p for p in os.listdir(sdir) if p.startswith("manifest")) \
        == [f"manifest.p{r}.json" for r in range(n)]
    assert (sdir / ".complete").exists()
    got = tck.Checkpointer(str(tmp_path)).restore({"w": 0, "count": 0},
                                                  device="cpu")
    np.testing.assert_array_equal(got["w"].numpy(), full)
    assert int(got["count"]) == 5
    ref = jck.Checkpointer(str(tmp_path)).restore({"w": 0, "count": 0})
    np.testing.assert_array_equal(np.asarray(ref["w"]), full)
    # Rows [2, 7) read only the shards that overlap them.
    part = tck.Checkpointer(str(tmp_path)).reader(3).read("w", 2, 7)
    np.testing.assert_array_equal(part.numpy(), full[2:7])


def test_async_save_and_gc(tmp_path):
    ckpt = tck.Checkpointer(str(tmp_path), keep=2)
    tree = t_tree(np_tree())
    for step in (1, 2, 3, 4):
        ckpt.async_save(step, tree)
    ckpt.wait()
    assert ckpt.steps() == [3, 4]
    assert ckpt.latest_step() == 4


def test_async_snapshot_is_taken_before_the_next_in_place_update(tmp_path):
    ckpt = tck.Checkpointer(str(tmp_path))
    w = torch.ones(64, 64)
    ckpt.async_save(1, {"w": w})
    w.add_(1.0)  # the step's in-place update, right after the snapshot
    ckpt.wait()
    got = ckpt.restore({"w": 0}, device="cpu")["w"]
    assert torch.equal(got, torch.ones(64, 64))
    assert ckpt.last_snapshot_s is not None and ckpt.last_write_s > 0


def test_async_save_failure_surfaces_on_wait(tmp_path, monkeypatch):
    ckpt = tck.Checkpointer(str(tmp_path))

    def boom(*a, **k):
        raise OSError("disk gone")

    monkeypatch.setattr(ckpt, "_write", boom)
    ckpt.async_save(1, t_tree(np_tree()))
    with pytest.raises(ClusterError, match="async checkpoint save"):
        ckpt.wait()
    monkeypatch.undo()
    ckpt.save(2, t_tree(np_tree()))
    assert ckpt.latest_step() == 2


def test_incomplete_checkpoint_ignored(tmp_path):
    ckpt = tck.Checkpointer(str(tmp_path))
    ckpt.save(1, t_tree(np_tree()))
    os.makedirs(tmp_path / "step_9")
    assert ckpt.latest_step() == 1
    with pytest.raises(ClusterError):
        tck.Checkpointer(str(tmp_path / "empty")).restore(
            t_tree(np_tree()), device="cpu")


def test_roundtrip_bfloat16(tmp_path):
    tree = {"w_bf16": torch.arange(32, dtype=torch.bfloat16).reshape(8, 4),
            "scalar_bf16": torch.tensor(1.5, dtype=torch.bfloat16),
            "w_f32": torch.ones(4)}
    ckpt = tck.Checkpointer(str(tmp_path))
    sdir = ckpt.save(1, tree)
    got = ckpt.restore(tree, step=1, device="cpu")
    assert got["w_bf16"].dtype == torch.bfloat16
    assert got["scalar_bf16"].dtype == torch.bfloat16
    assert_trees_equal(got, tree)
    m = json.load(open(os.path.join(sdir, "manifest.json")))["leaves"]
    assert m["w_bf16"]["dtype"] == "bfloat16"
    assert m["w_bf16"]["shards"][0]["raw"] is True


def test_restore_rejects_overlapping_shards(tmp_path):
    ckpt = tck.Checkpointer(str(tmp_path))
    ckpt.save(1, {"w": torch.zeros(8, 4)})
    sdir = ckpt._step_dir(1)
    with open(os.path.join(sdir, "manifest.json")) as f:
        manifest = json.load(f)
    rec = manifest["leaves"]["w"]["shards"][0]
    np.save(os.path.join(sdir, "w.shard1.npy"), np.zeros((4, 4), np.float32))
    manifest["leaves"]["w"]["shards"] = [
        {**rec, "start": [0, 0], "shape": [4, 4], "file": "w.shard1.npy"},
        {**rec, "start": [2, 0], "shape": [4, 4], "file": "w.shard1.npy"},
    ]
    with open(os.path.join(sdir, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with pytest.raises(ClusterError, match="overlap"):
        ckpt.restore({"w": 0}, step=1, device="cpu")


def test_multi_recommit_of_committed_step_is_kept(tmp_path):
    tree = {"w": torch.ones(4)}
    ckpt = tck.Checkpointer(str(tmp_path))
    path = ckpt._write_multi(5, ckpt._snapshot(tree).ready(), None, 0, 1)
    marker = os.path.join(path, ".complete")
    mtime = os.path.getmtime(marker)
    assert ckpt._write_multi(5, ckpt._snapshot(tree).ready(), None, 0,
                             1) == path
    assert os.path.getmtime(marker) == mtime
    assert ckpt.latest_step() == 5
    other = {"w": torch.ones(8)}
    with pytest.raises(ClusterError, match="different parameter space"):
        ckpt._write_multi(5, ckpt._snapshot(other).ready(), None, 0, 1)
    assert os.path.getmtime(marker) == mtime


def test_corrupt_shard_raises_naming_it(tmp_path):
    """The ``checkpoint.shard`` seam's ``corrupt`` flips a byte after the
    crc32 was taken: restore names the shard."""
    ckpt = tck.Checkpointer(str(tmp_path))
    plan = chaos.FaultPlan([chaos.FaultSpec("checkpoint.shard", "corrupt",
                                            match="w.shard0")])
    with chaos.armed(plan):
        ckpt.save(1, t_tree(np_tree()))
    assert [e.site for e in plan.fired()] == ["checkpoint.shard"]
    with pytest.raises(CheckpointError, match="'w.shard0.npy' is corrupt"):
        ckpt.restore(t_tree(np_tree()), device="cpu")


def test_commit_crash_leaves_the_step_invisible(tmp_path):
    ckpt = tck.Checkpointer(str(tmp_path))
    ckpt.save(1, {"w": torch.ones(4)})
    plan = chaos.FaultPlan([chaos.FaultSpec("checkpoint.commit", "crash")])
    with chaos.armed(plan):
        with pytest.raises(CheckpointError, match="before committing"):
            ckpt.save(2, {"w": torch.zeros(4)})
    assert ckpt.latest_step() == 1
    assert torch.equal(ckpt.restore({"w": 0}, device="cpu")["w"],
                       torch.ones(4))


def test_restore_is_an_entry_point(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    ckpt = tck.Checkpointer(str(tmp_path))
    ckpt.save(1, {"w": torch.ones(4)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ckpt.restore({"w": 0})


# ------------------------------------------------- across the packages


def jax_tree(tree):
    out = {}
    for k, v in tree.items():
        out[k] = jax_tree(v) if isinstance(v, dict) else jnp.asarray(v)
    return out


def test_reference_written_step_restores_in_the_port(tmp_path):
    """Single-writer and sharded (4 devices, one writer) reference saves,
    bf16 included, restore in the port bit for bit."""
    tree = np_tree(1)
    mesh = build_mesh({"data": 4})
    jt = jax_tree(tree)
    jt["sharded"] = jax.device_put(jnp.arange(32, dtype=jnp.float32)
                                   .reshape(8, 4),
                                   named_sharding(mesh, "data", None))
    jt["bf16"] = jax.device_put(jnp.arange(32, dtype=jnp.bfloat16)
                                .reshape(8, 4),
                                named_sharding(mesh, "data", None))
    jck.Checkpointer(str(tmp_path)).save(2, jt)
    got = tck.Checkpointer(str(tmp_path)).restore(
        jax.tree_util.tree_map(lambda _: 0, jt), device="cpu")
    assert_trees_equal(got, jax.tree_util.tree_map(np.asarray, jt))
    assert got["bf16"].dtype == torch.bfloat16


@pytest.mark.parametrize("writers", [1, 4])
def test_port_written_step_restores_in_the_reference(tmp_path, writers):
    tree = t_tree(np_tree(2))
    tree["bf16"] = torch.arange(32, dtype=torch.bfloat16).reshape(8, 4)
    full = torch.arange(32, dtype=torch.float32).reshape(8, 4)

    def rank(r):
        ck = tck.Checkpointer(str(tmp_path), mesh=fake_mesh(r, writers))
        rows = 8 // writers
        ck.save(2, dict(tree, sharded=tck.Shard(
            full[r * rows:(r + 1) * rows], (r * rows, 0), (8, 4))))

    threads = [threading.Thread(target=rank, args=(r,))
               for r in range(writers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    skeleton = jax.tree_util.tree_map(lambda _: 0, flat_dict(tree))
    skeleton["sharded"] = 0
    got = jck.Checkpointer(str(tmp_path)).restore(skeleton)
    want = dict(tree, sharded=full)
    assert_trees_equal(jax.tree_util.tree_map(np.asarray, got), want)
    assert got["bf16"].dtype == jnp.bfloat16


def flat_dict(tree):
    return {k: flat_dict(v) if isinstance(v, dict) else 0
            for k, v in tree.items()}


def test_manifest_records_are_equal_across_packages(tmp_path):
    """The same tree saved by each package: the same flat keys, shapes,
    dtypes, starts, raw flags and crc32s (and so the same bytes)."""
    tree = np_tree(3)
    tt = t_tree(tree)
    tt["bf16"] = torch.arange(12, dtype=torch.bfloat16).reshape(3, 4)
    tt["params/w"] = torch.ones(2)
    tt["list"] = [torch.zeros(2), torch.ones(3)]
    tt["py_int"], tt["py_float"] = 3, 0.5
    jt = jax_tree(tree)
    jt["bf16"] = jnp.arange(12, dtype=jnp.bfloat16).reshape(3, 4)
    jt["params/w"] = jnp.ones(2)
    jt["list"] = [jnp.zeros(2), jnp.ones(3)]
    jt["py_int"], jt["py_float"] = 3, 0.5
    a = tck.Checkpointer(str(tmp_path / "port")).save(1, tt)
    b = jck.Checkpointer(str(tmp_path / "ref")).save(1, jt)
    ra, rb = records(a), records(b)
    assert ra == rb
    assert "params%2Fw" in ra and "list.1" in ra and "nested.ids" in ra


def test_store_checkpoint_across_packages(tmp_path):
    """A TensorStore namespace (a sharded and a replicated key) saved by
    the reference resumes into the port's store with its bindings and
    epochs, and the port's save resumes into the reference's."""
    jmesh = build_mesh({"data": 2})
    js = JStore(jmesh)
    js.put("params/w", jnp.arange(16, dtype=jnp.float32).reshape(8, 2),
           spec=P("data", None))
    js.put("params/b", jnp.ones(3, jnp.float32), epoch=4)
    jck.StoreCheckpoint(js, str(tmp_path / "ref")).save()
    ts = TensorStore(fake_mesh(), device="cpu")
    keys = tck.StoreCheckpoint(ts, str(tmp_path / "ref")).resume()
    assert keys == ["params/b", "params/w"]
    assert ts.binding("params/w").spec == ("data", None)
    assert ts.epoch("params/b") == 4
    np.testing.assert_array_equal(ts.get("params/w").numpy(),
                                  np.arange(16, dtype=np.float32)
                                  .reshape(8, 2))
    tck.StoreCheckpoint(ts, str(tmp_path / "port"), keys_prefix="params/"
                        ).save(9)
    fresh = JStore(jmesh)
    got = jck.StoreCheckpoint(fresh, str(tmp_path / "port")).resume()
    assert got == ["params/b", "params/w"]
    assert fresh.binding("params/w").spec == P("data", None)
    assert fresh.epoch("params/b") == 4
    np.testing.assert_array_equal(np.asarray(fresh.get("params/w")),
                                  np.asarray(js.get("params/w")))


def test_zero_checkpoint_corrupt_shard_raises(tmp_path):
    """A flipped byte in a moment shard surfaces as CheckpointError
    naming the file (``tests/test_zero_train.py``)."""
    from ptype_tpu_torch.parallel.zero import ShardPlan, ZeroState

    leaves = [torch.randn(16, 8), torch.randn(8)]
    plan = ShardPlan.for_leaves(leaves, 1)
    zs = ZeroState.create(plan, fake_mesh(), "data",
                          ttr.default_optimizer_hparams(), [True, False])
    zs.mu[0].uniform_()
    zc = tck.ZeroCheckpoint(str(tmp_path))
    sdir = zc.save(1, zs)
    victim = sorted(f for f in os.listdir(sdir)
                    if ".nu.shard" in f and f.endswith(".npy"))[0]
    path = os.path.join(sdir, victim)
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.seek(size // 2)
        b = f.read(1)
        f.seek(size // 2)
        f.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(CheckpointError, match=victim.split(".npy")[0]):
        tck.ZeroCheckpoint(str(tmp_path)).restore_into(zs)


# ------------------------------------------------- a TrainState across


OPT = dict(lr=1e-3, warmup=1, decay_steps=50)


def batches(n, seed=9):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, 256, (4, 33)).astype(np.int32)
        out.append({"tokens": toks[:, :-1], "targets": toks[:, 1:]})
    return out


def test_reference_train_state_continues_in_the_port(tmp_path):
    """The reference trains 2 steps and saves its TrainState; the port
    reads that step dir (flat keys from the real save) into a Trainer,
    and its next 3 losses are the reference's continuation. The port's
    own save of the state then restores in the reference bit for bit."""
    jc = jtfm.preset("tiny", dtype=jnp.float32, attn_impl="xla")
    tc = ttfm.preset("tiny", dtype=torch.float32, attn_impl="xla")
    mesh = build_mesh({"data": 1})
    opt = jtr.default_optimizer(**OPT)
    state, sh = jtr.init_state(jax.random.PRNGKey(4), jc, mesh, opt)
    step = jtr.make_train_step(jc, mesh, opt)
    bs = batches(5)
    for b in bs[:2]:
        state, _ = step(state, to_j(b))
    sdir = jck.Checkpointer(str(tmp_path / "ref")).save(2, state)
    keys = set(json.load(open(os.path.join(sdir, "manifest.json")))
               ["leaves"])
    want_keys = set(tck._flat_key(p) for p, _ in
                    tck._flatten(ttr.state_tree(ttr.Trainer(
                        tc, device="cpu").state)))
    assert keys == want_keys

    carried = ttr.load_reference_state(str(tmp_path / "ref"), tc,
                                       device="cpu")
    assert carried.step == 2 and carried.opt_state.count == 2
    adam = state.opt_state[1][0]
    for (path, a), (_, b) in zip(
            tck._flatten({"p": carried.params, "mu": carried.opt_state.mu,
                          "nu": carried.opt_state.nu}),
            tck._flatten({"p": state.params, "mu": adam.mu,
                          "nu": adam.nu})):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=str(path))
    tr = ttr.Trainer(tc, device="cpu", optimizer=ttr.default_optimizer(**OPT))
    assert tr.restore(tck.Checkpointer(str(tmp_path / "ref"))) == 2
    got = [float(tr.step(b)["loss"]) for b in bs[2:]]
    want = []
    for b in bs[2:]:
        state, out = step(state, to_j(b))
        want.append(float(out["loss"]))
    np.testing.assert_allclose(got, want, **LOSS_TOL)
    assert tr.state.step == 5

    # The port's save of its state: the reference restores it.
    tr.save(tck.Checkpointer(str(tmp_path / "port")))
    back = jck.Checkpointer(str(tmp_path / "port")).restore(
        state, shardings=sh)
    # (The reference reads a 0-d leaf back as shape (1,).)
    assert int(np.asarray(back.step).reshape(-1)[0]) == 5
    for (path, a), (_, b) in zip(
            tck._flatten(ttr.state_tree(tr.state)),
            tck._flatten({"0": back.params,
                          "1": {"1": {"0": {".mu": back.opt_state[1][0].mu,
                                            ".nu": back.opt_state[1][0].nu,
                                            ".count":
                                                back.opt_state[1][0].count},
                                      "2": {".count":
                                            back.opt_state[1][2].count}}},
                          "2": back.step})):
        a = as_np(a.detach() if torch.is_tensor(a) else a)
        np.testing.assert_array_equal(a, np.asarray(b).reshape(a.shape),
                                      err_msg=str(path))


def test_trainer_resume_is_bit_exact(tmp_path):
    """A Trainer saved in the background after step 2 and restored into
    a fresh one continues exactly as the uninterrupted run."""
    tc = ttfm.preset("tiny", dtype=torch.float32, attn_impl="xla")
    bs = batches(4, seed=10)
    ck = tck.Checkpointer(str(tmp_path))
    a = ttr.Trainer(tc, device="cpu", optimizer=ttr.default_optimizer(**OPT))
    la = []
    for i, b in enumerate(bs):
        la.append(float(a.step(b)["loss"]))
        if i == 1:
            a.save(ck, background=True)
    ck.wait()
    b_ = ttr.Trainer(tc, device="cpu", optimizer=ttr.default_optimizer(**OPT),
                     generator=torch.Generator().manual_seed(1))
    assert b_.restore(ck) == 2
    lb = [float(b_.step(b)["loss"]) for b in bs[2:]]
    assert lb == la[2:]
    for (_, x), (_, y) in zip(tck._flatten(ttr.state_tree(a.state)),
                              tck._flatten(ttr.state_tree(b_.state))):
        assert np.array_equal(as_np(x.detach() if torch.is_tensor(x) else x),
                              as_np(y.detach() if torch.is_tensor(y) else y))
