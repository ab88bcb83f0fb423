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
    params, the ladder's resident bytes and the store's keys. An
    ``armed`` case steps with jitwatch armed (steady after its first
    step) and returns its books."""
    import functools

    from ptype_tpu_torch import jitwatch
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
        jw = None
        try:
            t = sd.StoreDPTrainer(cfg, store, **kw)
            if case.get("load"):
                t.zero_state().load_state_tree(case["load"]["tree"],
                                               case["load"]["plan"])
            if case.get("armed"):
                jw = jitwatch.enable()
            steps = []
            for i in case["batches"]:
                steps.append(t.step(batches[i]))
                if jw is not None and len(steps) == 1:
                    jw.mark_steady()
        finally:
            jitwatch.disable()
            sd.default_optimizer_pieces = pieces
        row = {"losses": [s["loss"] for s in steps],
               "grad_epochs": [s["grad_epoch"] for s in steps],
               "params": t.params(),
               "last_grad_bytes": t.last_grad_bytes,
               "param_keys": [k for k in store.keys()
                              if k.startswith("params/")],
               "residual_keys": sorted(store._residuals),
               "param_leaves_none": t._param_leaves is None}
        if jw is not None:
            row["jit"] = dict(jw.report(),
                              steady=jw.recompiles_since_steady())
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


def _full_state(t) -> dict:
    """A mesh Trainer's params and moments whole (every rank calls)."""
    from ptype_tpu_torch.parallel.mesh import gather
    from ptype_tpu_torch.train import trainer as tr

    out = {}
    mom = tr.opt_state_placements(t.layout, t._shard_update)
    for name, tree, specs in (("params", t.state.params, t.layout.specs),
                              ("mu", t.state.opt_state.mu, mom),
                              ("nu", t.state.opt_state.nu, mom)):
        out[name] = tr._unflatten(
            (path, gather(x.detach(), tr._at(specs, path), t.mesh).clone())
            for path, x in tr._flatten(tree))
    out["count"] = t.state.opt_state.count
    out["step"] = t.state.step
    return out


def _moment_elems(t) -> int:
    from ptype_tpu_torch.train import trainer as tr

    return sum(int(x.numel()) for tree in (t.state.opt_state.mu,
                                           t.state.opt_state.nu)
               for _, x in tr._flatten(tree))


def sharded_train_suite(mesh, inp: dict) -> dict:
    """The mesh ``Trainer`` on every layout of ``inp["cases"]`` (name,
    axes, knobs), each from the given params on the given batches: loss
    and grad-norm curves, the final state whole, the moments' resident
    elements; a grad-accum step with an uneven mask; sub-axis groups;
    ``local_row_range``; a sharded save and a restore of the
    reference's save; evaluation; and a step on rows each rank reads
    itself."""
    import torch.distributed as dist

    from ptype_tpu_torch.checkpoint import Checkpointer
    from ptype_tpu_torch.models import transformer as tfm
    from ptype_tpu_torch.parallel import collectives as C
    from ptype_tpu_torch.parallel.mesh import (axis_group, axis_index,
                                               build_mesh, gather, shard_of)
    from ptype_tpu_torch.train import data as td
    from ptype_tpu_torch.train import trainer as tr

    r = mesh.rank
    cfg = tfm.preset("tiny", dtype=torch.float32, attn_impl="xla",
                     n_kv_heads=2)
    batches = inp["batches"]
    out: dict = {"cases": {}}

    def trainer(m, **kw):
        return tr.Trainer(cfg, mesh=m, params=inp["params"], sync_every=0,
                          optimizer=tr.default_optimizer(**inp["opt"]), **kw)

    for name, axes, knobs in inp["cases"]:
        m = build_mesh(axes, device="cpu")
        t = trainer(m, **knobs)
        steps = [t.step(b) for b in batches]
        row = {"losses": [float(o["loss"]) for o in steps],
               "grad_norms": [float(o["grad_norm"]) for o in steps],
               "moment_elems": _moment_elems(t), "state": _full_state(t)}
        if name == inp["save_case"]:
            ck = Checkpointer(inp["port_ckpt"], mesh=m)
            t.save(ck)
            # Checkpointer.restore into the placements: this rank's
            # blocks, equal to the trainer's own.
            mine = tr.state_tree(t.state)
            got = ck.restore(mine, step=3, device="cpu",
                             placements=t._placements)
            row["restore_blocks_equal"] = all(
                torch.equal(a, b) for (_, a), (_, b) in
                zip(tr._flatten(got), tr._flatten(mine))
                if torch.is_tensor(b))
            row["eval"] = t.evaluate(iter(inp["eval_batches"]),
                                     len(inp["eval_batches"]))
        out["cases"][name] = row

    # Grad accumulation with an uneven mask on a mesh.
    m = build_mesh(inp["accum_axes"], device="cpu")
    params = tr.tree_map(torch.from_numpy, inp["params"])
    state, _ = tr.init_state(cfg, m, params)
    step = tr.make_train_step(cfg, tr.default_optimizer(**inp["opt"]),
                              grad_accum=2, mesh=m)
    t = trainer(m)
    state, o = step(state, t.shard_batch(inp["accum_batch"]))
    t.state = state
    out["accum"] = {"loss": float(o["loss"]), "state": _full_state(t)}

    # Sub-axis groups: axis_index and a sum over each (composite) axis.
    m = build_mesh(inp["group_axes"], device="cpu")
    groups = {}
    for axis in inp["group_probe"]:
        axis = tuple(axis) if isinstance(axis, list) else axis
        x = C.all_reduce(torch.tensor([float(r + 1)]), m, axis)
        groups[str(axis)] = {
            "index": axis_index(m, axis), "sum": float(x),
            "ranks": dist.get_process_group_ranks(axis_group(m, axis))}
    out["groups"] = groups
    # The autograd collectives: forward and backward of each.
    probe = {}
    x = torch.arange(4.0).reshape(2, 2) + 10 * r
    for name, fn in (("gather_for_use", C.gather_for_use),
                     ("gather_replicated", C.gather_replicated)):
        xl = x.clone().requires_grad_()
        y = fn(xl, m, "model", 1)
        (y * (torch.arange(y.numel()).reshape(y.shape) + 1.0)).sum().backward()
        probe[name] = {"y": y.detach(), "grad": xl.grad}
    for name, fn in (("reduce_from", C.reduce_from), ("copy_to", C.copy_to)):
        xl = x.clone().requires_grad_()
        y = fn(xl, m, "model")
        (y * (r + 1.0)).sum().backward()
        probe[name] = {"y": y.detach(), "grad": xl.grad}
    out["autograd_collectives"] = probe
    # Placements: shard_of then gather is the identity.
    full = torch.arange(48.0).reshape(4, 12)
    spec = (tuple(a for a in ("data", "fsdp") if a in m.axis_names) or None,
            "model" if "model" in m.axis_names else None)
    out["roundtrip"] = torch.equal(gather(shard_of(full, spec, m), spec, m),
                                   full)

    # local_row_range on the port's placements.
    out["rows"] = {}
    for label, axes in inp["row_axes"].items():
        m = build_mesh(axes, device="cpu")
        sizes = {a: int(n) for a, n in m.shape.items()}
        out["rows"][label] = {
            "batch": td.local_row_range(tfm.batch_spec(sizes), m, 16),
            "replicated": td.local_row_range((), m, 16)}

    # The reference's save restored into this layout's placements.
    m = build_mesh(inp["restore_axes"], device="cpu")
    t = trainer(m)
    got_step = t.restore(Checkpointer(inp["ref_ckpt"], mesh=m))
    row = {"step": got_step, "state": _full_state(t)}
    row["next"] = float(t.step(inp["next_batch"])["loss"])
    out["restored"] = row

    # Each rank reads its own rows of the global batch (local_row_range)
    # and steps on them: every rank's loss is the global one.
    m = build_mesh({"data": mesh.size}, device="cpu")
    t = trainer(m)
    lo, hi = td.local_row_range(tfm.batch_spec({"data": m.size}), m,
                                inp["mp_rows"].shape[0])
    rows = inp["mp_rows"][lo:hi]
    local = {"tokens": torch.from_numpy(rows[:, :-1]).long(),
             "targets": torch.from_numpy(rows[:, 1:]).long()}
    out["mp"] = {"range": (lo, hi), "losses": [
        float(t._step_fn(t.state, local)[1]["loss"]) for _ in range(3)]}
    return _np(out)


def moe_ep_suite(mesh, inp: dict) -> dict:
    """The mesh ``Trainer`` on a mixture-of-experts config, one case a
    layout of ``inp["cases"]`` (name, axes, knobs: ``capacity_factor``,
    ``grad_accum``, ``shard_update``, ``ring``): loss and grad-norm
    curves, the final state whole, this rank's expert-bank shape, the
    moments' resident elements and the EP branch's calls; a sharded
    save of ``inp["save_case"]``; and the reference's save restored
    into the EP layout ``inp["restore_axes"]``."""
    from dataclasses import replace

    from ptype_tpu_torch.checkpoint import Checkpointer
    from ptype_tpu_torch.models import transformer as tfm
    from ptype_tpu_torch.parallel.mesh import build_mesh
    from ptype_tpu_torch.train import trainer as tr

    base = tfm.preset("tiny-moe", dtype=torch.float32, attn_impl="xla")
    out: dict = {"cases": {}}

    def trainer(m, cfg, **kw):
        return tr.Trainer(cfg, mesh=m, params=inp["params"], sync_every=0,
                          optimizer=tr.default_optimizer(**inp["opt"]), **kw)

    for name, axes, knobs in inp["cases"]:
        cfg = replace(base, capacity_factor=knobs.get("capacity_factor",
                                                      base.capacity_factor),
                      attn_impl="ring" if knobs.get("ring") else "xla")
        m = build_mesh(axes, device="cpu")
        t = trainer(m, cfg, shard_update=knobs.get("shard_update", False))
        g = knobs.get("grad_accum", 1)
        if g > 1:
            t._step_fn = tr.make_train_step(cfg, t.optimizer, t._attn_fn,
                                            grad_accum=g, mesh=m)
        calls = tfm.MeshLayout.moe_calls
        steps = [t.step(b) for b in inp["batches"]]
        row = {"losses": [float(o["loss"]) for o in steps],
               "grad_norms": [float(o["grad_norm"]) for o in steps],
               "moe_calls": tfm.MeshLayout.moe_calls - calls,
               "bank": tuple(t.state.params["blocks"]["w_gate"].shape),
               "moment_elems": _moment_elems(t), "state": _full_state(t)}
        if name == inp["save_case"]:
            t.save(Checkpointer(inp["port_ckpt"], mesh=m))
        out["cases"][name] = row

    # The reference's save, read into an expert-split layout.
    m = build_mesh(inp["restore_axes"], device="cpu")
    t = trainer(m, base)
    row = {"step": t.restore(Checkpointer(inp["ref_ckpt"], mesh=m)),
           "state": _full_state(t)}
    row["next"] = float(t.step(inp["next_batch"])["loss"])
    out["restored"] = row
    return _np(out)


def ring_suite(mesh, inp: dict) -> dict:
    """Ring and Ulysses attention on the cases of this world size: each
    rank's blocks of q, k, v, the attention's output and the grads of
    ``sum(o ** 2)``, gathered whole; the head counts each collective
    carried; a train step with the sequence axis."""
    from unittest import mock

    from ptype_tpu_torch.models import transformer as tfm
    from ptype_tpu_torch.parallel import collectives as C
    from ptype_tpu_torch.parallel import ring_attention as ra
    from ptype_tpu_torch.parallel.mesh import axis_index, build_mesh, gather, \
        shard_of
    from ptype_tpu_torch.train import trainer as tr

    cfg = tfm.preset("tiny", dtype=torch.float32)
    out = {}
    for case in inp["cases"]:
        if case["world"] != mesh.size:
            continue
        m = build_mesh(case["axes"], device="cpu")
        names = m.axis_names
        spec = (("data",) if "data" in names else None,
                "seq" if "seq" in names else None,
                "model" if "model" in names else None, None)
        row = {}
        if case["kind"] == "train":
            t = tr.Trainer(cfg, mesh=m, params=inp["params"], sync_every=0,
                           attn_fn=ra.make_ring_attention(m), seq_axis=True,
                           optimizer=tr.default_optimizer(**inp["opt"]))
            o = t.step(inp["train_batch"])
            out[case["name"]] = {"loss": float(o["loss"]), "step": o["step"]}
            continue
        if case["kind"] == "degrade":
            # Without the axis both are one rank's whole-sequence
            # attention, chosen per call by the device: dense here.
            g = torch.Generator().manual_seed(0)
            q = torch.randn(1, 16, 4, 8, generator=g)
            k, v = torch.randn(2, 1, 16, 2, 8, generator=g)
            c = tfm.preset("tiny", n_heads=4, n_kv_heads=2, d_model=32)
            want = tfm._attention(q, k, v, c)
            out[case["name"]] = {
                name: fn is ra._local_attention
                and torch.equal(fn(q, k, v, c), want)
                for name, fn in (("ring", ra.make_ring_attention(m)),
                                 ("ulysses", ra.make_ulysses_attention(m)))}
            continue
        q, k, v = (torch.from_numpy(case[x]) for x in "qkv")
        ql = shard_of(q, spec, m).clone().requires_grad_()
        kl = shard_of(k, spec[:2], m)
        vl = shard_of(v, spec[:2], m)
        if "model" in names:
            # K/V whole over heads: each model rank's padded share.
            mm, mr = int(m.shape["model"]), axis_index(m, "model")
            c = tfm.preset("tiny", n_heads=q.shape[2],
                           n_kv_heads=k.shape[2],
                           d_model=q.shape[2] * q.shape[3])
            kl = tfm.tp_kv_heads(kl, c, mm, mr)
            vl = tfm.tp_kv_heads(vl, c, mm, mr)
        kl = kl.clone().requires_grad_()
        vl = vl.clone().requires_grad_()
        if case["kind"] == "ring":
            attn = ra.make_ring_attention(
                m, score_chunk=case.get("score_chunk",
                                        ra.RING_SCORE_CHUNK))
        else:
            inner = tfm._flash_attn_fn if case.get("flash_inner") else None
            attn = ra.make_ulysses_attention(m, inner_attn=inner)
        heads = []
        real = {"ring": C.ring_send, "ulysses": C.all_to_all_dims}

        def spy(x, *a, _fn=real[case["kind"]], **k):
            # ring: (2, B, S, K, Dh) stacked K/V; ulysses: (B, S, h, Dh)
            heads.append(int(x.shape[3] if x.dim() == 5 else x.shape[2]))
            return _fn(x, *a, **k)

        target = "ring_send" if case["kind"] == "ring" else "all_to_all_dims"
        with mock.patch.object(C, target, spy):
            o = attn(ql, kl, vl, cfg)
            (o ** 2).sum().backward()
        row["heads"] = heads
        row["o"] = gather(o.detach(), spec, m)
        row["dq"] = gather(ql.grad, spec, m)
        if "model" not in names:
            row["dk"] = gather(kl.grad, spec[:2], m)
            row["dv"] = gather(vl.grad, spec[:2], m)
        out[case["name"]] = row
    return _np(out)


def elastic_trainer_suite(mesh, inp: dict) -> dict:
    """``ElasticTrainer`` on every rank, rank 0 holding the registry:
    two steps, a worker lost, ``MembershipChanged``, ``recover`` onto
    the survivors from the checkpoint, and a step after; then every
    worker revoked, and ``recover`` refused."""
    import time

    from ptype_tpu_torch.coord.core import CoordState
    from ptype_tpu_torch.coord.local import LocalCoord
    from ptype_tpu_torch.elastic import (ElasticTrainer, MembershipChanged,
                                         inject_loss)
    from ptype_tpu_torch.errors import ClusterError
    from ptype_tpu_torch.models import transformer as tfm
    from ptype_tpu_torch.registry import CoordRegistry
    from ptype_tpu_torch.train import trainer as tr

    r, n = mesh.rank, mesh.size
    cfg = tfm.preset("tiny", dtype=torch.float32, attn_impl="xla")
    batches = inp["batches"]
    reg = None
    if r == 0:
        reg = CoordRegistry(LocalCoord(CoordState(sweep_interval=0.05)),
                            lease_ttl=0.5)

    def workers(service):
        if r != 0:
            return []
        return [reg.register(service, f"w{i}", "127.0.0.1", 9300 + i,
                             process_id=i) for i in range(n)]

    def wait_for(pred):
        deadline = time.monotonic() + 10
        while not pred() and time.monotonic() < deadline:
            time.sleep(0.01)

    kw = dict(params=inp["params"],
              optimizer=tr.default_optimizer(**inp["opt"]))
    out = {}
    regs = workers("etsvc")
    t = ElasticTrainer(cfg, reg, "etsvc", inp["ckpt"] + "/lost", mesh, **kw)
    row = {"losses": [float(t.step(b)["loss"]) for b in batches[:2]]}
    if r == 0:
        inject_loss(regs[n - 1])
        wait_for(lambda: t.detector.changed)
    try:
        t.step(batches[2])
        row["raised"] = None
    except MembershipChanged as e:
        row["raised"] = {"lost": e.lost, "joined": e.joined}
    before = t.state.params["embed"].detach().clone()
    row["recover"] = t.recover()
    row["left"] = t.left
    if not t.left:
        row["params_kept"] = torch.equal(t.state.params["embed"], before)
        row["step_after"] = t.state.step
        o = t.step(batches[2])
        row["losses"].append(float(o["loss"]))
        row["step_after_next"] = int(o["step"])
        row["mesh_size"] = t.mesh.size
    t.close()
    for h in regs:
        h.close()
    out["lost"] = row

    # Every worker gone: no survivors, refused on every rank.
    regs = workers("ezsvc")
    t = ElasticTrainer(cfg, reg, "ezsvc", inp["ckpt"] + "/zero", mesh, **kw)
    if r == 0:
        for h in regs:
            inject_loss(h)
        wait_for(lambda: not t.detector.current())
    try:
        t.recover()
        out["no_survivors"] = None
    except ClusterError as e:
        out["no_survivors"] = str(e)
    t.close()
    return _np(out)


def pipeline_suite(mesh, inp: dict) -> dict:
    """The GPipe and 1F1B schedules on a ``stage`` mesh of every rank:
    pipelined logits, losses and grads (the block grads gathered whole),
    train-step losses, the held state's shapes, a checkpoint of it, and
    the counted cost of a step. Which cases run depends on the world
    size, as in the reference's tests (2 stages, or 4)."""
    from ptype_tpu_torch.checkpoint import Checkpointer
    from ptype_tpu_torch.health import profiling
    from ptype_tpu_torch.models import transformer as tfm
    from ptype_tpu_torch.models.weights import (params_from_numpy,
                                                stage_params_from_numpy)
    from ptype_tpu_torch.parallel import pipeline as pp
    from ptype_tpu_torch.parallel.mesh import axis_index, gather
    from ptype_tpu_torch.train import trainer as tr

    S, s = mesh.size, axis_index(mesh, "stage")
    cfg = tfm.preset("tiny", n_layers=4, dtype=torch.float32)
    out: dict = {}

    def whole(grads):
        g = dict(grads)
        g["blocks"] = {k: gather(v, ("stage",), mesh)
                       for k, v in grads["blocks"].items()}
        return g

    def gpipe_grads(tokens, n_mb, mask=None):
        params = stage_params_from_numpy(inp["params"], cfg, s, S)
        paths, leaves = zip(*tr._flatten(params))
        for p in leaves:
            p.requires_grad_(True)
        batch = {"tokens": tokens, "targets": tokens, "loss_mask": mask}
        logits = pp.transformer_pipeline_forward(params, tokens, cfg, mesh,
                                                 n_mb)
        loss = tfm.nll_from_logits(logits, batch)
        grads = tr._unflatten(zip(paths, torch.autograd.grad(loss, leaves)))
        return float(loss), whole(grads)

    def train(c, schedule, n_mb, batch, steps=3):
        state, placements = pp.init_pipeline_state(
            c, mesh, params_from_numpy(inp["params"], c),
            tr.default_optimizer(**inp["opt"]))
        step = pp.make_pipeline_train_step(
            c, mesh, n_mb, tr.default_optimizer(**inp["opt"]),
            schedule=schedule)
        losses = [float(step(state, batch)[1]["loss"]) for _ in range(steps)]
        return state, placements, losses

    ta, tb = _t(inp["tokens_a"]).long(), _t(inp["tokens_b"]).long()
    params = params_from_numpy(inp["params"], cfg)
    if S == 2:
        for n_mb in (2, 4):
            out[f"fwd{n_mb}"] = pp.transformer_pipeline_forward(
                params, ta, cfg, mesh, n_mb)
        out["gpipe_loss"], out["gpipe_grads"] = gpipe_grads(ta, 2)
        flash = tfm.preset("tiny", n_layers=4, dtype=torch.float32,
                           attn_impl="flash")
        out["flash_fwd"] = pp.transformer_pipeline_forward(params, ta, flash,
                                                           mesh, 2)
    if S == 4:
        ws, x = _t(inp["chain_w"]), _t(inp["chain_x"])
        out["chain"] = pp.pipeline_apply(
            lambda w, xm: xm @ w[0], ws.reshape(4, 1, 8, 8)[s], x, mesh, 3)
        out["gpipe8_loss"], out["gpipe8_grads"] = gpipe_grads(tb, 8)
        loss, grads = pp.pipeline_loss_and_grads_1f1b(
            params, {"tokens": tb, "targets": tb}, cfg, mesh, 8)
        out["f1b_loss"], out["f1b_grads"] = float(loss), whole(grads)
        batch = {"tokens": tb, "targets": tb, "loss_mask": _t(inp["mask"])}
        for schedule in ("gpipe", "1f1b"):
            state, placements, losses = train(cfg, schedule, 8, batch)
            out[f"train_{schedule}"] = losses
        out["held"] = {"wq": tuple(state.params["blocks"]["wq"].shape),
                       "mu_wq": tuple(state.opt_state.mu["blocks"]["wq"]
                                      .shape),
                       "spec": placements["0"]["blocks"]["wq"],
                       "embed": tuple(state.params["embed"].shape)}
        ck = Checkpointer(inp["ckpt_dir"], mesh=mesh)
        ck.save(3, tr.state_tree(state, placements, mesh))
        out["final_wq"] = gather(state.params["blocks"]["wq"].detach(),
                                 ("stage",), mesh)
        bf16 = tfm.preset("tiny", n_layers=4)
        _, _, out["train_bf16"] = train(bf16, "gpipe", 4,
                                        {"tokens": tb, "targets": tb})
        state, _ = pp.init_pipeline_state(bf16, mesh, params_from_numpy(
            inp["params"], bf16))
        step = pp.make_pipeline_train_step(bf16, mesh, 4)
        out["cost"] = profiling.compiled_cost(
            step, state, {"tokens": tb, "targets": tb})
    return _np(out)


def store_probes_suite(mesh, inp: dict) -> dict:
    """The Store probes: ``measure_allreduce_gbps``, ``measure_wire_gbps``,
    ``measure_push_tree`` and ``measure_zero`` as the port runs them,
    then ``measure_zero`` again from the reference's weights and token
    stream (``inp["ref"]``: its seed-0 params and the batches its
    ``synthetic_batches`` draws at seed 5) in place of the port's."""
    from ptype_tpu_torch.models.weights import params_from_numpy
    from ptype_tpu_torch.parallel import collectives as C
    from ptype_tpu_torch.parallel import tensorstore as ts
    from ptype_tpu_torch.train import store_dp as sd

    out = {"allreduce_gbps": C.measure_allreduce_gbps(mesh, mbytes=1,
                                                      iters=1),
           "wire": C.measure_wire_gbps(mesh, **inp["wire"]),
           "push_tree": ts.measure_push_tree(mesh, preset="tiny", iters=2,
                                             device="cpu"),
           "zero": sd.measure_zero(mesh, steps=2, batch=8, device="cpu")}
    ref = inp["ref"]
    init0, batches0 = sd.init_params, sd._batches
    sd.init_params = lambda generator, cfg, device=None: params_from_numpy(
        ref["params"], cfg, device)
    sd._batches = lambda cfg, batch, seq, device, seed: iter(
        [{k: _t(v) for k, v in b.items()} for b in ref["batches"]])
    try:
        out["zero_ref_inputs"] = sd.measure_zero(mesh, steps=2, batch=8,
                                                 device="cpu")
    finally:
        sd.init_params, sd._batches = init0, batches0
    return out


def _ef_bias(mesh, topo, g, exact, ef: bool, steps: int = 24) -> float:
    """The mean of ``steps`` int8 (q_block 32) hierarchical pushes of the
    same contribution, against the exact mean: its largest bias."""
    from ptype_tpu_torch.parallel import collectives as C

    res, outer = [None], {}
    acc = torch.zeros_like(exact)
    for _ in range(steps):
        kw = dict(residuals=res, outer_residuals=outer) if ef else {}
        out = C.bucketed_all_reduce([g], mesh, topo.flat_axis, "mean",
                                    compress="int8", int8_min_bytes=0,
                                    q_block=32, topology=topo, **kw)
        if ef:
            out, res = out
        acc += out[0]
    return float((acc / steps - exact).abs().max())


def topology_suite(mesh, inp: dict) -> dict:
    """The hierarchical wire on every (outer, inner) factorization of
    the world: the flat and the two-leg allreduce (mean) and
    reduce-scatter (sum) shards of ``inp["leaves"]``; and on the
    topology ``inp["geom"]``: the max op, per-leg error feedback against
    naive int8, the slow-leg-only int8 wire, the leg counters, the
    ``TensorStore``'s push and scatter, its outer residuals, and ZeRO-2
    and ZeRO-3 curves through the flat and the two-leg store."""
    from ptype_tpu_torch.metrics import metrics
    from ptype_tpu_torch.models import transformer as tfm
    from ptype_tpu_torch.parallel import collectives as C
    from ptype_tpu_torch.parallel.tensorstore import TensorStore
    from ptype_tpu_torch.parallel.mesh import axis_index, axis_n
    from ptype_tpu_torch.parallel.topology import (LegWire, Topology,
                                                   factorizations,
                                                   topology_for)
    from ptype_tpu_torch.train import store_dp as sd
    from ptype_tpu_torch.train import trainer as tr

    r, n = mesh.rank, mesh.size
    leaves = [_t(x[r]) for x in inp["leaves"]]
    out: dict = {"fact": {}}
    for no, ni in factorizations(n):
        topo = Topology.emulated_host(no, ni)
        m, ax = topo.mesh(device="cpu"), topo.flat_axis

        def shards(**kw):
            return [red.wait()[0] for _, red in
                    C.bucketed_reduce_scatter_stream(leaves[:2], m, ax,
                                                     "sum", **kw)]

        out["fact"][(no, ni)] = {
            "flat": C.bucketed_all_reduce(leaves, m, ax, "mean"),
            "hier": C.bucketed_all_reduce(leaves, m, ax, "mean",
                                          topology=topo),
            "rs_flat": shards(), "rs_hier": shards(topology=topo),
            "index": m.rank}

    no, ni = inp["geom"]
    topo = Topology.emulated_host(no, ni)
    m, ax = topo.mesh(device="cpu"), topo.flat_axis
    found = topology_for(m)
    out["geometry"] = {
        "shape": dict(m.shape), "n": axis_n(m, ax),
        "lin": axis_index(m, ax), "inner": axis_index(m, "inner"),
        "outer": axis_index(m, "outer"),
        "topology_for": (found.n_outer, found.n_inner),
        "flat_topology_for": topology_for(mesh)}
    out["max"] = {k: C.bucketed_all_reduce(leaves[:1], m, ax, "max", **kw)[0]
                  for k, kw in (("flat", {}), ("hier", {"topology": topo}))}
    g = _t(inp["g"][r])
    exact = C.bucketed_all_reduce([g], m, ax, "mean")[0]
    out["ef"] = {"naive": _ef_bias(m, topo, g, exact, False),
                 "ef": _ef_bias(m, topo, g, exact, True)}
    slow = Topology(n_outer=no, n_inner=ni,
                    outer_wire=LegWire(compress="int8", q_block=32))
    outer: dict = {}
    got, res = C.bucketed_all_reduce([g], m, ax, "mean", int8_min_bytes=0,
                                     residuals=[None], topology=slow,
                                     outer_residuals=outer)
    out["slow_leg"] = {"err": float((got[0] - exact).abs().max()),
                       "inner_res": res[0], "outer_keys": sorted(outer)}
    base = dict(metrics.snapshot()["counters"])
    C.bucketed_all_reduce(leaves[:2], m, ax, "mean", topology=topo)
    snap = metrics.snapshot()["counters"]
    out["counters"] = {k: snap.get(k, 0) - base.get(k, 0) for k in (
        "collectives.leg_bytes.inner", "collectives.leg_bytes.outer",
        "collectives.leg_bytes.flat_outer", "collectives.hier_launches")}

    tree = {k: _t(v[r]) for k, v in inp["tree"].items()}
    s_flat = TensorStore(mesh, "data", device="cpu")
    s_hier = TensorStore(m, topology=topo, device="cpu")
    out["store_axis"] = s_hier.axis
    out["push_tree"] = {"flat": s_flat.push_tree("g", tree),
                        "hier": s_hier.push_tree("g", tree)}
    for s_ in (s_hier, s_flat):
        for h in s_.push_tree_scatter_iter("gs", tree):
            h.wait()
    keys = [k for k in s_hier.keys() if k.startswith("gs/")]
    out["scatter"] = {k: (s_hier.pull(k, gather=True),
                          s_flat.pull(k, gather=True)) for k in keys}
    mean = {k: C.all_reduce(v, mesh, "data", "mean") for k, v in tree.items()}
    biases = {}
    for label, fb in (("ef", True), ("naive", False)):
        wire = C.WireConfig(compress="int8", int8_min_bytes=0, q_block=32,
                            error_feedback=fb)
        store = TensorStore(m, wire=wire, topology=topo, device="cpu")
        acc = {k: torch.zeros_like(v) for k, v in mean.items()}
        for _ in range(12):
            for k, v in store.push_tree("q", tree).items():
                acc[k.split("/")[-1]] += v
        biases[label] = max(float((acc[k] / 12 - mean[k]).abs().max())
                            for k in acc)
        if fb:
            out["residuals_kept"] = {"outer": sorted(store._outer_residuals),
                                     "inner": sorted(store._residuals)}
            store.reshard(m)
            out["residuals_after_reshard"] = (len(store._outer_residuals),
                                              len(store._residuals))
    out["store_bias"] = biases

    cfg = tfm.preset("tiny", dtype=torch.float32, attn_impl="xla")
    out["zero"] = {}
    for stage in (2, 3):
        for mode in ("flat", "hier"):
            store = (TensorStore(mesh, "data", device="cpu") if mode == "flat"
                     else TensorStore(m, topology=topo, device="cpu"))
            t = sd.StoreDPTrainer(cfg, store, zero=stage, device="cpu",
                                  params=inp["params"],
                                  zero_hparams=tr.OptHParams(**inp["opt"]))
            out["zero"][(stage, mode)] = [float(t.step(b)["loss"])
                                          for b in inp["batches"]]
    return _np(out)


def progaudit_suite(mesh, inp: dict) -> dict:
    """The collective and ZeRO programs of ``progaudit``'s registry on
    this world (their reports as dicts), and the synthetic un-fusions
    that must break their pins: per-leaf psums, a bucket split into two
    reduce-scatters, an allgather after the reduce-scatter, per-leaf
    param gathers."""
    from ptype_tpu_torch import progaudit
    from ptype_tpu_torch.parallel import collectives as C

    n = mesh.size
    progaudit.register_default_programs(device="cpu", mesh=mesh)
    out = {"programs": {k: r.to_dict() for k, r in progaudit.audit_all(
        names=inp["programs"]).items()}}
    g = torch.Generator().manual_seed(mesh.rank)
    a, b = torch.randn(4, generator=g), torch.randn(2, generator=g)
    x = torch.randn(n * 8, 16, generator=g)

    def per_leaf_psum(a, b):
        return C.all_reduce(a, mesh), C.all_reduce(b, mesh)

    def split(x):
        h = x.shape[-1] // 2
        return torch.cat([C.reduce_scatter(x[:, :h].contiguous(), mesh),
                          C.reduce_scatter(x[:, h:].contiguous(), mesh)], 1)

    def rs_then_gather(x):
        return C.all_gather(C.reduce_scatter(x, mesh), mesh)

    def per_leaf_gather(a, b):
        return C.all_gather(a, mesh), C.all_gather(b, mesh)

    audit = progaudit.audit
    out["unfusions"] = {k: r.to_dict() for k, r in {
        "per_leaf_psum": audit(per_leaf_psum, (a, b), name="unfused",
                               expect_collectives=1),
        "per_leaf_psum_pinned_2": audit(per_leaf_psum, (a, b),
                                        expect_collectives={"psum": 2}),
        "split_rs": audit(split, (x,), name="split-rs",
                          expect_collectives={"reduce_scatter": 1}),
        "rs_then_gather": audit(rs_then_gather, (x,),
                                name="sneaky-gather",
                                expect_collectives={"reduce_scatter": 1,
                                                    "all_gather": 0}),
        "per_leaf_gather": audit(per_leaf_gather, (a, b),
                                 name="per-leaf-gather",
                                 expect_collectives={"all_gather": 1}),
    }.items()}
    return out


SUITES = {"collectives": collectives_suite, "store_dp": store_dp_suite,
          "elastic": elastic_suite, "sharded_train": sharded_train_suite,
          "ring": ring_suite, "elastic_trainer": elastic_trainer_suite,
          "pipeline": pipeline_suite, "store_probes": store_probes_suite,
          "moe_ep": moe_ep_suite, "topology": topology_suite,
          "progaudit": progaudit_suite}
#: The one mesh axis a suite's ranks lie on ("data" unless named here).
SUITE_AXIS = {"pipeline": "stage"}


def main(argv: list[str]) -> None:
    import torch.distributed as dist

    from ptype_tpu_torch.parallel.mesh import build_mesh, init_distributed

    suite, rank, world, workdir = argv[0], int(argv[1]), int(argv[2]), argv[3]
    torch.set_num_threads(1)
    init_distributed(f"file://{workdir}/rdv", rank, world, device="cpu")
    try:
        mesh = build_mesh({SUITE_AXIS.get(suite, "data"): world},
                          device="cpu")
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
