"""Rank bodies of the data-plane parity tests, and their launcher.

``Ranks(suite, world, workdir, inputs)`` starts ``world`` processes of

    python tests/torch_ranks.py SUITE RANK WORLD WORKDIR

on one gloo process group (a ``file://`` rendezvous under WORKDIR).
Each rank reads ``WORKDIR/inputs.pkl``, runs ``SUITES[SUITE](mesh,
inputs)`` and writes what it returns to ``WORKDIR/out_RANK.pkl``;
``Ranks.join`` waits for all of them under a deadline and returns the
outputs in rank order, or fails with the failing rank's stderr.

This module imports torch, numpy and ptype_tpu_torch only — never JAX
or ptype_tpu — so a rank process starts without the reference.
"""

from __future__ import annotations

import os
import pathlib
import pickle
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


class Ranks:
    """``world`` rank processes of one suite, started at construction."""

    def __init__(self, suite: str, world: int, workdir, inputs: dict):
        self.workdir = pathlib.Path(workdir)
        self.world = world
        with open(self.workdir / "inputs.pkl", "wb") as f:
            pickle.dump(inputs, f)
        env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
                   MKL_NUM_THREADS="1")
        self.procs = []
        for r in range(world):
            log = open(self.workdir / f"log_{r}.txt", "wb")
            self.procs.append(subprocess.Popen(
                [sys.executable, str(pathlib.Path(__file__).resolve()),
                 suite, str(r), str(world), str(self.workdir)],
                cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT))
            log.close()

    def _kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait(timeout=30)

    def _log(self, r: int) -> str:
        return (self.workdir / f"log_{r}.txt").read_text(errors="replace")

    def join(self, timeout: float = 300.0) -> list:
        deadline = time.monotonic() + timeout
        while True:
            codes = [p.poll() for p in self.procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                self._kill()
                raise AssertionError(f"rank {bad[0]} of {self.world} exited "
                                     f"{codes[bad[0]]}:\n{self._log(bad[0])}")
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                self._kill()
                raise AssertionError(
                    f"ranks did not finish within {timeout} s:\n"
                    + "\n".join(self._log(r)[-2000:]
                                for r in range(self.world)))
            time.sleep(0.05)
        outs = []
        for r in range(self.world):
            with open(self.workdir / f"out_{r}.pkl", "rb") as f:
                outs.append(pickle.load(f))
        return outs


def _np(x):
    """Tensors (in trees, lists) → numpy, for the pickle back."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_np(v) for v in x)
    return x


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _local(tree: dict, r: int) -> dict:
    """Rank r's row of a tree of stacked ``(n, ...)`` arrays."""
    return {k: _local(v, r) if isinstance(v, dict) else _t(v[r])
            for k, v in tree.items()}


class FlakyKV:
    """A dict-backed manifest KV whose ``put`` raises on demand."""

    def __init__(self, error):
        self.data, self.fail, self._error = {}, False, error

    def put(self, key, value):
        if self.fail:
            raise self._error("coordinator unreachable")
        self.data[key] = value

    def delete(self, key):
        self.data.pop(key, None)


# ------------------------------------------------------------- suites


def collectives_suite(mesh, inp: dict) -> dict:
    """The plain collectives, the int8 wire, and the store semantics."""
    from ptype_tpu_torch import chaos
    from ptype_tpu_torch.errors import ClusterError, CoordinationError
    from ptype_tpu_torch.metrics import metrics
    from ptype_tpu_torch.parallel import collectives as C
    from ptype_tpu_torch.parallel.tensorstore import TensorStore

    r, n = mesh.rank, mesh.size
    out: dict = {}
    x, x2, xi, q, res = (inp[k] for k in ("x", "x2", "xi", "q", "res"))
    for op in ("sum", "mean", "max", "min"):
        out[f"all_reduce_{op}"] = C.all_reduce(_t(x[r]), mesh, op=op)
    for op in ("sum", "mean"):
        out[f"all_reduce_int_{op}"] = C.all_reduce(_t(xi[r]), mesh, op=op)
        out[f"reduce_scatter_{op}"] = C.reduce_scatter(_t(x2[r]), mesh,
                                                       op=op)
    out["all_gather"] = C.all_gather(_t(x[r]), mesh)
    for shift in (1, 3):
        out[f"ring_shift_{shift}"] = C.ring_shift(_t(x[r]), mesh,
                                                  shift=shift)
    out["all_to_all"] = C.all_to_all(_t(x2[r]), mesh)
    out["broadcast"] = C.broadcast(_t(x[r]), mesh, src=n - 1)

    # The int8 wire.
    for op in ("sum", "mean"):
        out[f"qar_{op}"] = C.quantized_all_reduce(_t(q[r]), mesh, op=op)
        out[f"qrs_{op}"] = C.quantized_reduce_scatter(_t(q[r]), mesh, op=op)
    out["qar_sum_chunk_scale"] = C.quantized_all_reduce(_t(q[r]), mesh,
                                                        q_block=None)
    wire = dict(compress="int8", int8_min_bytes=0)
    o, rs = C.bucketed_all_reduce([_t(q[r])], mesh, op="mean",
                                  residuals=[_t(res[r])], **wire)
    out["ef_out"], out["ef_res"] = o[0], rs[0]
    (_, red), = list(C.bucketed_reduce_scatter_stream(
        [_t(q[r])], mesh, op="mean", residuals=[_t(res[r])], **wire))
    out["ef_rs_shard"], rres = red.wait()
    out["ef_rs_res"] = rres[0]

    # The store: bucketed vs per-leaf, with the launch count.
    tree = _local(inp["tree"], r)
    small = C.WireConfig(bucket_bytes=200)
    before = metrics.counter("collectives.bucket_launches").value
    out["pt_bucketed"] = TensorStore(mesh, wire=small, device="cpu"
                                     ).push_tree("g", tree, op="mean")
    out["pt_launches"] = (metrics.counter("collectives.bucket_launches")
                          .value - before)
    out["pt_per_leaf"] = TensorStore(mesh, wire=small, device="cpu").push_tree(
        "g", tree, op="mean", bucketed=False)
    int8 = C.WireConfig(compress="int8", bucket_bytes=200,
                        int8_min_bytes=256)
    ts8 = TensorStore(mesh, wire=int8, device="cpu")
    out["pt_int8"] = ts8.push_tree("g", tree, op="mean")
    out["pt_int8_residuals"] = dict(ts8._residuals)
    out["pt_bf16"] = TensorStore(mesh, compress="bf16", device="cpu"
                                 ).push_tree("g", _local(inp["bf16_tree"], r),
                                             op="sum")

    # Streams equal the barrier push.
    ts = TensorStore(mesh, wire=small, device="cpu")
    handles = ts.push_tree_stream("g", tree, op="mean")
    out["stream_buckets"] = len(handles)
    out["stream"] = {k: v for h in handles for k, v in h.wait().items()}
    out["stream_epochs"] = {k: ts.epoch(k) for k in out["stream"]}
    shards = list(ts.push_tree_scatter_iter("s", tree, op="mean"))
    out["scatter_keys"] = [h.keys for h in shards]
    out["scatter_flats"] = [ts.pull(h.wait().key, gather=True)
                            for h in shards]
    out["scatter_epochs"] = [ts.epoch(h.key) for h in shards]

    # Epochs and tree_seq with an external writer.
    rec = []
    s0 = ts.put_tree("params", {"w": torch.ones(4),
                                "v": {"a": torch.zeros(2)}})
    rec += [ts.tree_seq("params") == s0, ts.tree_seq("absent")]
    for _ in range(2):
        ts.push("k/x", _t(x[r]))
    rec += [ts.epoch("k/x"), ts.epoch("params/w")]
    ts.put("params/w", torch.zeros(4))
    s1 = ts.tree_seq("params")
    rec += [s1 > s0, ts.epoch("params/w")]
    ts.delete("params/v/a")
    rec += [ts.tree_seq("params") > s1, sorted(ts.get_tree("params"))]
    out["seq_record"] = rec

    # Manifests, published best effort and caught up.
    kv = FlakyKV(CoordinationError)
    ms = TensorStore(mesh, kv=kv, namespace="ns", device="cpu")
    kv.fail = True
    ms.put("a", torch.ones(4))
    missed = sorted(kv.data)
    kv.fail = False
    ms.put("b", torch.ones(2, 3))
    ms.push_scatter("s", _t(x2[r]), op="sum")
    ms.push("p", _t(x[r]))
    out["kv_missed"], out["kv"] = missed, dict(kv.data)
    out["manifest"] = ms.manifest()

    # A store.push timeout leaves the residuals as they were.
    wire8 = C.WireConfig(compress="int8", int8_min_bytes=0, bucket_bytes=2048)
    ef = TensorStore(mesh, wire=wire8, device="cpu")
    big = _local(inp["ef_tree"], r)
    ef.push_tree("g", big, op="mean")
    ef.push("k", _t(q[r]), op="mean")
    out["store_residuals"] = dict(ef._residuals)
    snap = {k: v.clone() for k, v in ef._residuals.items()}
    plan = chaos.FaultPlan([chaos.FaultSpec("store.push", "timeout",
                                            times=3)])
    raised = 0
    with chaos.armed(plan):
        for push in (lambda: ef.push_tree("g", big, op="mean"),
                     lambda: next(ef.push_tree_iter("g", big, op="mean")),
                     lambda: ef.push("k", _t(q[r]), op="mean")):
            try:
                push()
            except ClusterError:
                raised += 1
    out["chaos_raised"] = raised
    out["chaos_residuals_kept"] = (
        set(snap) == set(ef._residuals)
        and all(torch.equal(snap[k], ef._residuals[k]) for k in snap))
    # An exact-wire stream and an abandoned one keep every residual.
    for _ in ef.push_tree_iter("g", big, op="max"):
        pass
    it = ef.push_tree_iter("g", big, op="mean")
    next(it)
    it.close()
    out["abandoned_residual_keys"] = sorted(ef._residuals)
    out["refusals"] = _refusals(mesh)
    return _np(out)


def _refusals(mesh) -> dict:
    """What each entry point raises where it must not run: name → "Type:
    message" (None when it did not raise)."""
    from ptype_tpu_torch.models import transformer as tfm
    from ptype_tpu_torch.parallel import collectives as C
    from ptype_tpu_torch.parallel.mesh import build_mesh
    from ptype_tpu_torch.parallel.tensorstore import TensorStore
    from ptype_tpu_torch.parallel.topology import Topology
    from ptype_tpu_torch.train.store_dp import StoreDPTrainer

    n = mesh.size
    tiny = tfm.preset("tiny", dtype=torch.float32)
    calls = {
        "cuda_mesh_on_gloo": lambda: build_mesh({"data": n}, device="cuda"),
        "axes_past_the_group": lambda: build_mesh({"data": 2 * n},
                                                  device="cpu"),
        "store_without_device": lambda: TensorStore(mesh),
        "trainer_without_device": lambda: StoreDPTrainer(
            tiny, TensorStore(mesh, device="cpu")),
        "hierarchical_topology": lambda: TensorStore(
            mesh, topology=Topology(n_outer=2, n_inner=n // 2),
            device="cpu"),
        "sub_axis_collective": lambda: C.all_reduce(
            torch.ones(2), build_mesh({"data": n // 2, "model": 2},
                                      device="cpu")),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = None
        except Exception as e:  # noqa: BLE001 — the type is the result
            out[name] = f"{type(e).__name__}: {e}"
    return out


def store_dp_suite(mesh, inp: dict) -> dict:
    """``StoreDPTrainer`` cases: each a trainer from the given params,
    stepped on the given batches; per case the loss curve, the final
    params, the ladder's resident bytes and the store's keys."""
    import functools

    from ptype_tpu_torch.models import transformer as tfm
    from ptype_tpu_torch.parallel.collectives import WireConfig
    from ptype_tpu_torch.parallel.tensorstore import TensorStore
    from ptype_tpu_torch.train import store_dp as sd
    from ptype_tpu_torch.train import trainer as tr

    cfg = tfm.preset("tiny", dtype=torch.float32, attn_impl="xla")
    batches = inp["batches"]
    out = {}
    for case in inp["cases"]:
        wire = WireConfig(**case["wire"]) if case.get("wire") else None
        store = TensorStore(mesh, wire=wire, device="cpu")
        kw = dict(overlap=case.get("overlap", False),
                  zero=case.get("zero", False), params=case["params"],
                  device="cpu")
        if case.get("opt"):
            kw["optimizer"] = tr.default_optimizer(**case["opt"])
        if case.get("zero_hp"):
            kw["zero_hparams"] = tr.OptHParams(**case["zero_hp"])
        pieces = sd.default_optimizer_pieces
        if case.get("pieces"):
            sd.default_optimizer_pieces = functools.partial(
                tr.default_optimizer_pieces, **case["pieces"])
        try:
            t = sd.StoreDPTrainer(cfg, store, **kw)
            if case.get("load"):
                t.zero_state().load_state_tree(case["load"]["tree"],
                                               case["load"]["plan"])
            steps = [t.step(batches[i]) for i in case["batches"]]
        finally:
            sd.default_optimizer_pieces = pieces
        row = {"losses": [s["loss"] for s in steps],
               "grad_epochs": [s["grad_epoch"] for s in steps],
               "params": t.params(),
               "last_grad_bytes": t.last_grad_bytes,
               "param_keys": [k for k in store.keys()
                              if k.startswith("params/")],
               "residual_keys": sorted(store._residuals),
               "param_leaves_none": t._param_leaves is None}
        if t.zero:
            z = t.zero_state()
            row["moment_bytes"] = z.moment_bytes_per_replica()
            row["param_bytes"] = z.param_bytes_per_replica()
            row["state_tree"] = z.state_tree()
        else:
            try:
                t.zero_state()
            except ValueError as e:
                row["zero_state_error"] = str(e)
        out[case["name"]] = row
        del t, store
    return _np(out)


def _zero_state(mesh, n, leaves, inp, count=0):
    """A ZeroState over ``leaves`` whose moments hold recognizable values
    (``arange + 1`` and half of it over each bucket's payload)."""
    from ptype_tpu_torch.parallel.zero import ShardPlan, ZeroState
    from ptype_tpu_torch.train.trainer import default_optimizer_hparams

    plan = ShardPlan.for_leaves(leaves, n, inp["bucket_bytes"])
    zs = ZeroState.create(plan, mesh, "data", default_optimizer_hparams(),
                          inp["mask"])
    for i, b in enumerate(plan.buckets):
        v = torch.zeros(b.elems)
        v[:b.elems - b.pad] = torch.arange(b.elems - b.pad,
                                           dtype=torch.float32) + 1.0
        zs.mu[i] = zs._shard(v).clone()
        zs.nu[i] = zs._shard(v * 0.5).clone()
    zs.count = count
    return zs


def _zero_view(zs) -> dict:
    """Every flat of a ZeroState whole (all its ranks call together)."""
    out = {"mu": [zs._full(x) for x in zs.mu],
           "nu": [zs._full(x) for x in zs.nu],
           "mask": [zs._full(x) for x in zs._masks],
           "count": zs.count, "plan": zs.plan.manifest(),
           "shard_elems": [int(x.numel()) for x in zs.mu]}
    if zs.pflat is not None:
        out["p"] = [zs._full(x) for x in zs.pflat]
        out["params"] = zs.gather_params()
    return out


def _elastic_trainer_runs(mesh, inp, out) -> None:
    """``ElasticZeroTrainer`` on every rank, rank 0 holding the registry
    (the workers' registrations simulated in its process): a run without
    a fault; every worker revoked (no survivors); a duplicate
    registration lost (a 4 → 4 reshard); a worker lost (4 → 3); rank 0's
    worker lost (refused on every rank)."""
    import time

    from ptype_tpu_torch.coord.core import CoordState
    from ptype_tpu_torch.coord.local import LocalCoord
    from ptype_tpu_torch.elastic import (ElasticZeroTrainer,
                                         MembershipChanged, inject_loss)
    from ptype_tpu_torch.errors import ClusterError
    from ptype_tpu_torch.models import transformer as tfm
    from ptype_tpu_torch.parallel.tensorstore import TensorStore
    from ptype_tpu_torch.registry import CoordRegistry
    from ptype_tpu_torch.train.store_dp import StoreDPTrainer

    r, n = mesh.rank, mesh.size
    cfg = tfm.preset("tiny", dtype=torch.float32, attn_impl="xla")
    batches = inp["batches12"]
    kw = dict(zero=2, params=inp["params"], device="cpu")
    reg = None
    if r == 0:
        reg = CoordRegistry(LocalCoord(CoordState(sweep_interval=0.05)),
                            lease_ttl=0.5)

    def workers(service, extra=()):
        if r != 0:
            return []
        regs = [reg.register(service, f"w{i}", "127.0.0.1", 9100 + i,
                             process_id=i) for i in range(n)]
        for j, pid in enumerate(extra):
            regs.append(reg.register(service, f"dup{j}", "127.0.0.1",
                                     9200 + j, process_id=pid))
        return regs

    def wait_for(pred):
        deadline = time.monotonic() + 10
        while not pred() and time.monotonic() < deadline:
            time.sleep(0.01)

    def losses(t, idxs):
        return [t.step(batches[i])["loss"] for i in idxs]

    base = StoreDPTrainer(cfg, TensorStore(mesh, device="cpu"), **kw)
    out["no_fault"] = {"losses": losses(base, range(4)),
                       "params": base.params()}
    del base

    # No survivors: every registration revoked.
    regs = workers("zsvc")
    t = ElasticZeroTrainer(cfg, reg, "zsvc", mesh, **kw)
    for h in regs:
        inject_loss(h)
    if r == 0:
        wait_for(lambda: not t.detector.current())
    try:
        t.recover()
        out["no_survivors"] = None
    except ClusterError as e:
        out["no_survivors"] = str(e)
    t.close()

    def faulted(service, extra, victim):
        regs = workers(service, extra)
        t = ElasticZeroTrainer(cfg, reg, service, mesh, **kw)
        got = losses(t, [0, 1])
        t0 = time.perf_counter()
        if r == 0:
            inject_loss(regs[victim])
            wait_for(lambda: t.detector.changed)
        row = {"detect_s": time.perf_counter() - t0}
        try:
            t.step(batches[2])
            row["raised"] = None
        except MembershipChanged as e:
            row["raised"] = {"lost": e.lost, "joined": e.joined}
        row["recover"] = t.recover()
        row["left"] = t.left
        if not t.left:
            got += losses(t, [2, 3])
            row["params"] = t.params()
            row["n_workers"] = t.trainer.n_workers
        row["losses"] = got
        t.close()
        for h in regs:
            h.close()
        return row

    out["dup_lost"] = faulted("dupsvc", [0], n)
    out["worker_lost"] = faulted("elsvc", [], n - 1)

    # Rank 0 lost: it holds the detector and the registrations, so every
    # rank refuses the live reshard (the way back is ZeroCheckpoint).
    regs = workers("ctlsvc")
    t = ElasticZeroTrainer(cfg, reg, "ctlsvc", mesh, **kw)
    if r == 0:
        inject_loss(regs[0])
        wait_for(lambda: t.detector.changed)
    row = {}
    try:
        t.step(batches[0])
        row["raised"] = None
    except MembershipChanged as e:
        row["raised"] = {"lost": e.lost, "joined": e.joined}
    try:
        t.recover()
        row["recover"] = None
    except ClusterError as e:
        row["recover"] = str(e)
    row["left"] = t.left
    t.close()
    for h in regs:
        h.close()
    out["rank0_lost"] = row


def elastic_suite(mesh, inp: dict) -> dict:
    """Live resharding on n ranks: ``ZeroState.reshard`` onto survivor
    meshes (moments, masks, ZeRO-3 flats), a chaos drop mid-move, the
    ``ZeroCheckpoint`` across rank counts and packages, and
    ``StoreDPTrainer.reshard`` and ``ElasticZeroTrainer`` runs."""
    from ptype_tpu_torch import chaos
    from ptype_tpu_torch.checkpoint import StoreCheckpoint, ZeroCheckpoint
    from ptype_tpu_torch.errors import ClusterError
    from ptype_tpu_torch.models import transformer as tfm
    from ptype_tpu_torch.parallel.mesh import survivor_mesh
    from ptype_tpu_torch.parallel.tensorstore import TensorStore
    from ptype_tpu_torch.train.store_dp import StoreDPTrainer

    r, n = mesh.rank, mesh.size
    out: dict = {"moves": {}}
    leaves = [_t(x) for x in inp["leaves"]]

    def sub(ranks):
        """The mesh over ``ranks`` (None off it); every rank calls."""
        return (mesh if list(ranks) == list(range(n))
                else survivor_mesh(mesh, ranks, device="cpu"))

    # ZeroState.reshard onto survivors.
    for name, (src, dst) in inp["moves"].items():
        old, new = sub(src), sub(dst)
        if old is None:
            continue
        zs = _zero_state(old, len(src), leaves, inp, count=7)
        zs.scatter_params(leaves)
        zs.reshard(new)
        if new is not None:
            out["moves"][name] = _zero_view(zs)

    # A drop at the middle bucket: the old plan on every rank, then a
    # retry that lands.
    zs = _zero_state(mesh, n, leaves, inp, count=5)
    before_plan, before_mu = zs.plan, [x.clone() for x in zs.mu]
    keep = [0, 1]
    drop = {}
    if r == 0:
        chaos.arm(chaos.FaultPlan([chaos.FaultSpec(
            site="train.reshard", action="drop", match="bucket00001",
            times=1)], name="reshard-drop"))
    new = sub(keep)
    try:
        zs.reshard(new)
        drop["raised"] = None
    except ClusterError as e:
        drop["raised"] = str(e)
    drop["old_plan_kept"] = (zs.plan is before_plan and zs.mesh is mesh
                             and all(torch.equal(a, b) for a, b in
                                     zip(zs.mu, before_mu)))
    drop["unrecovered_after_drop"] = chaos.unrecovered()
    zs.reshard(new)
    drop["unrecovered_after_retry"] = chaos.unrecovered()
    chaos.disarm()
    if new is not None:
        drop["after"] = _zero_view(zs)
    out["drop"] = drop

    # ZeroCheckpoint across rank counts and packages: written here at n,
    # and the reference's (written at n) restored at 2.
    zs = _zero_state(mesh, n, leaves, inp, count=7)
    zs.scatter_params(leaves)
    ZeroCheckpoint(inp["port_zero_dir"]).save(3, zs)
    m2 = sub([0, 1])
    if m2 is not None:
        restored = {}
        for which in ("ref_zero_dir", "port_zero_dir"):
            dst = _zero_state(m2, 2, leaves, inp)
            dst.scatter_params([torch.zeros_like(x) for x in leaves])
            for i in range(len(dst.mu)):
                dst.mu[i].zero_()
                dst.nu[i].zero_()
            step = ZeroCheckpoint(inp[which]).restore_into(dst)
            restored[which] = dict(_zero_view(dst), step=step)
        out["zero_restore"] = restored

    # StoreDPTrainer.reshard n → 2 mid-run, and the checkpoint drill.
    cfg = tfm.preset("tiny", dtype=torch.float32, attn_impl="xla")
    batches = inp["batches"]
    for stage in (2, 3):
        t = StoreDPTrainer(cfg, TensorStore(mesh, device="cpu"), zero=stage,
                           params=inp["params"], device="cpu")
        row = {"losses": [t.step(batches[i])["loss"] for i in range(3)]}
        new = sub([0, 1])
        row["info"] = t.reshard(new)
        if new is not None:
            row["losses"] += [t.step(batches[i])["loss"]
                              for i in range(3, 6)]
            row["params"] = t.params()
            row["moment_elems"] = [int(x.numel())
                                   for x in t.zero_state().mu]
        out[f"live_zero{stage}"] = row
    t = StoreDPTrainer(cfg, TensorStore(mesh, device="cpu"), zero=2,
                       params=inp["params"], device="cpu")
    for i in range(3):
        t.step(batches[i])
    ZeroCheckpoint(inp["drill_dir"] + "/zero").save(3, t.zero_state())
    StoreCheckpoint(t.store, inp["drill_dir"] + "/store",
                    keys_prefix="params/").save(3)
    drill = {"uninterrupted": [t.step(batches[i])["loss"]
                               for i in range(3, 6)]}
    m2 = sub([0, 1])
    if m2 is not None:
        t2 = StoreDPTrainer(cfg, TensorStore(m2, device="cpu"), zero=2,
                            device="cpu")
        StoreCheckpoint(t2.store, inp["drill_dir"] + "/store",
                        keys_prefix="params/").resume()
        drill["step"] = ZeroCheckpoint(inp["drill_dir"] + "/zero"
                                       ).restore_into(t2.zero_state())
        drill["count"] = t2.zero_state().count
        drill["resumed"] = [t2.step(batches[i])["loss"]
                            for i in range(3, 6)]
    out["drill"] = drill

    from ptype_tpu_torch.train.store_dp import measure_reshard

    out["measure_reshard"] = measure_reshard(
        mesh, survivors=[0, 1], steps=2, batch=8, seq=32, zero=2,
        device="cpu", workdir=inp["measure_dir"])
    _elastic_trainer_runs(mesh, inp, out)
    return _np(out)


SUITES = {"collectives": collectives_suite, "store_dp": store_dp_suite,
          "elastic": elastic_suite}


def main(argv: list[str]) -> None:
    import torch.distributed as dist

    from ptype_tpu_torch.parallel.mesh import build_mesh, init_distributed

    suite, rank, world, workdir = argv[0], int(argv[1]), int(argv[2]), argv[3]
    torch.set_num_threads(1)
    init_distributed(f"file://{workdir}/rdv", rank, world, device="cpu")
    try:
        mesh = build_mesh({"data": world}, device="cpu")
        with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
            inputs = pickle.load(f)
        out = SUITES[suite](mesh, inputs)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(workdir, f"out_{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1:])
