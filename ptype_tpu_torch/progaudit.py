"""Hot-program audits — the dispatch-discipline contract; the port of
``ptype_tpu/progaudit.py``.

:mod:`ptype_tpu_torch.jitwatch` watches the hot programs at run time.
This module asserts invariants of the programs themselves, the ones a
green parity suite cannot see breaking:

- **no host round trip** (``callbacks``): a host synchronisation inside
  a hot program (an ``.item()``, a data-dependent shape, a
  device-to-host or pageable host-to-device copy) stalls every
  dispatch; one inside :func:`jitwatch.sanctioned_transfer` is reported
  (``sanctioned``) but is not a problem;
- **no f64** (``f64_sites``): any op output or program input of
  ``float64`` doubles the bytes of everything downstream;
- **donation consumed**: a donated tensor (the KV banks, the ZeRO-3
  shards, the wire residuals) must be consumed — its storage written in
  place with its address unchanged, no fresh tensor of its shape and
  dtype returned in its place, and no copy-family op (``clone``,
  ``_to_copy``, a functional ``copy``/``index_put``/scatter, ``cat``,
  a pad) making a buffer its size out of it. A dropped donation is a
  per-step copy of the KV pool with no failing test;
- **collective-launch count**: one bucket must cost ONE launch; a
  refactor that un-fuses it keeps every parity test green.

Eager PyTorch has no program to trace: ``torch.export`` and dynamo are
``torch.compile`` machinery, and the port's kernels launch through
``ctypes``, which they cannot see into. So :func:`audit` RUNS
``fn(*args)`` once under a recording ``TorchDispatchMode``
(:func:`jitwatch.recording`), on the tensors it is given — tiny ones on
the CPU, full width on the card — and counts the aten and c10d ops it
dispatches; the kernels launch outside the dispatcher, so the audit
counts the ops around them. The c10d ops are mapped onto the
reference's primitive names (:data:`COLLECTIVE_NAMES`), so pins compare
directly.

:func:`register` + :func:`audit_registered` keep a process-wide
registry of hot-program builders; :func:`register_default_programs`
installs :data:`DEFAULT_PROGRAMS`, built from the port's own programs on
``device`` (``cuda`` unless named). The collective and ZeRO programs
run on ``mesh`` (default: the ``data`` axis over the default process
group, which must be initialised).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ptype_tpu_torch import jitwatch

__all__ = [
    "AuditError", "AuditReport", "audit", "collect_primitives",
    "register", "registered", "audit_registered", "audit_all",
    "register_default_programs", "DEFAULT_PROGRAMS",
    "COLLECTIVE_NAMES",
]

#: c10d op → the reference's collective primitive name.
COLLECTIVE_NAMES = {
    "c10d::allreduce_": "psum", "c10d::allreduce_coalesced_": "psum",
    "c10d::allgather_": "all_gather", "c10d::_allgather_base_": "all_gather",
    "c10d::allgather_into_tensor_coalesced_": "all_gather",
    "c10d::allgather_coalesced_": "all_gather",
    "c10d::reduce_scatter_": "reduce_scatter",
    "c10d::_reduce_scatter_base_": "reduce_scatter",
    "c10d::reduce_scatter_tensor_coalesced_": "reduce_scatter",
    "c10d::send": "ppermute", "c10d::recv_": "ppermute",
    "c10d::recv_any_source_": "ppermute",
    "c10d::alltoall_": "all_to_all", "c10d::alltoall_base_": "all_to_all",
    "c10d::broadcast_": "broadcast", "c10d::barrier": "barrier",
}

#: Ops that make a new buffer holding a copy (or a functional update)
#: of their input: one of these over a donated tensor is a dropped
#: donation.
_COPY_OPS = frozenset({
    "aten::clone", "aten::_to_copy", "aten::copy", "aten::index_put",
    "aten::scatter", "aten::scatter_add", "aten::index_copy",
    "aten::slice_scatter", "aten::select_scatter", "aten::masked_scatter",
    "aten::cat", "aten::constant_pad_nd",
})


class AuditError(AssertionError):
    """A hot program broke its dispatch contract; the message names
    every violated invariant."""


@dataclasses.dataclass
class AuditReport:
    """One audited program: counts, sites, and the verdict."""

    name: str
    problems: list[str]
    collectives: dict[str, int]
    callbacks: list[str]
    f64_sites: list[str]
    eqns: int
    donated_expected: int = 0
    donated_consumed: int = 0
    #: Host synchronisations inside ``sanctioned_transfer`` (not
    #: problems), with their reasons.
    sanctioned: list[str] = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.problems

    def raise_if_failed(self) -> "AuditReport":
        if self.problems:
            raise AuditError(
                f"progaudit[{self.name}]: " + "; ".join(self.problems))
        return self

    def to_dict(self) -> dict:
        return {
            "name": self.name, "ok": self.ok,
            "problems": list(self.problems),
            "collectives": dict(self.collectives),
            "callbacks": list(self.callbacks),
            "f64_sites": list(self.f64_sites),
            "eqns": self.eqns,
            "donated_expected": self.donated_expected,
            "donated_consumed": self.donated_consumed,
            "sanctioned": list(self.sanctioned),
        }


# ------------------------------------------------------------- traversal


def _tensors(x):
    """The tensors of a (nested) argument or result, in order."""
    if torch.is_tensor(x):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def _ptr(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _written(func, args, kwargs):
    """The tensors an op writes in place (its schema's mutable
    arguments)."""
    for i, a in enumerate(func._schema.arguments):
        if a.alias_info is not None and a.alias_info.is_write:
            val = args[i] if i < len(args) else kwargs.get(a.name)
            yield from _tensors(val)


def collect_primitives(fn, args) -> dict[str, int]:
    """op name -> count over one run of ``fn(*args)``."""
    counts: dict[str, int] = {}

    def on_op(frame, func, a, kw, out):
        name = func._schema.name
        counts[name] = counts.get(name, 0) + 1

    with jitwatch.recording("collect", on_op):
        fn(*args)
    return counts


# ----------------------------------------------------------------- audit


class _Run:
    """What one audited run saw."""

    def __init__(self, donated: list):
        self.eqns = 0
        self.collectives: dict[str, int] = {}
        self.callbacks: list[str] = []
        self.sanctioned: list[str] = []
        self.f64_sites: list[str] = []
        #: donated storage address -> its tensor's bytes.
        self.donated = {_ptr(t): t.numel() * t.element_size()
                        for t in donated}
        self.written: set[int] = set()
        self.copied: set[int] = set()

    def __call__(self, frame, func, args, kwargs, out):
        self.eqns += 1
        name = func._schema.name
        prim = COLLECTIVE_NAMES.get(name)
        if prim is not None:
            self.collectives[prim] = self.collectives.get(prim, 0) + 1
        op = jitwatch.sync_op(func, args, kwargs)
        if op is not None:
            if frame.sanctioned:
                self.sanctioned.append(f"{op} ({frame.reasons[-1]})")
            else:
                self.callbacks.append(op)
        outs = list(_tensors(out))
        if any(t.dtype == torch.float64 for t in outs):
            self.f64_sites.append(
                f"{name} -> f64" if name == "aten::_to_copy"
                else f"{name} produces f64")
        if not self.donated:
            return
        for t in _written(func, args, kwargs):
            self.written.add(_ptr(t))
        if name in _COPY_OPS:
            ins = {_ptr(t) for t in _tensors((args, kwargs))} \
                & self.donated.keys()
            for p in ins:
                if any(_ptr(t) not in self.donated
                       and t.numel() * t.element_size()
                       >= self.donated[p] for t in outs):
                    self.copied.add(p)


def audit(fn, args, *, name: str = "", donate_argnums=(),
          expect_collectives: int | dict | None = None,
          allow_f64: bool = False,
          check_donation: bool | None = None) -> AuditReport:
    """Run ``fn(*args)`` once under the recorder and audit it.
    ``expect_collectives``: an int pins the TOTAL collective count, a
    dict pins per-primitive counts (primitives absent from the dict are
    unconstrained). ``donate_argnums``: the arguments whose tensors the
    program must consume (see the module docstring). Returns the report;
    :meth:`AuditReport.raise_if_failed` turns problems into a typed
    :class:`AuditError`."""
    if check_donation is None:
        check_donation = bool(donate_argnums)
    donated = ([t for i in donate_argnums for t in _tensors(args[i])]
               if check_donation else [])
    before = [_ptr(t) for t in donated]
    run = _Run(donated)
    f64_inputs = sum(t.dtype == torch.float64 for t in _tensors(args))
    with jitwatch.recording(name or "audit", run):
        out = fn(*args)

    problems: list[str] = []
    f64_sites = ["f64 program input"] * f64_inputs + run.f64_sites
    if run.callbacks:
        problems.append(
            f"host synchronisations in the program: "
            f"{sorted(set(run.callbacks))} (a host round trip per "
            f"dispatch)")
    if f64_sites and not allow_f64:
        problems.append(
            f"float64 in the program ({len(f64_sites)} sites, first: "
            f"{f64_sites[0]}) — 2x the bytes of every downstream op")
    if expect_collectives is not None:
        total = sum(run.collectives.values())
        if isinstance(expect_collectives, int):
            if total != expect_collectives:
                problems.append(
                    f"collective launch count {total} != expected "
                    f"{expect_collectives} (got {run.collectives}) — the "
                    f"bucket fusion contract")
        else:
            for prim, want in expect_collectives.items():
                got = run.collectives.get(prim, 0)
                if got != want:
                    problems.append(
                        f"{prim} count {got} != expected {want} "
                        f"(got {run.collectives})")

    consumed = 0
    if donated:
        fresh = [t for t in _tensors(out) if _ptr(t) not in run.donated]
        for t, p0 in zip(donated, before):
            p = _ptr(t)
            replaced = any(r.shape == t.shape and r.dtype == t.dtype
                           for r in fresh)
            if (p == p0 and p in run.written and p not in run.copied
                    and not replaced):
                consumed += 1
        if consumed < len(donated):
            problems.append(
                f"donation not consumed: {consumed}/{len(donated)} "
                f"donated buffers written in place — the rest are "
                f"COPIED or replaced per step")

    return AuditReport(
        name=name or getattr(fn, "__name__", "<fn>"),
        problems=problems, collectives=dict(run.collectives),
        callbacks=sorted(set(run.callbacks)), f64_sites=f64_sites,
        eqns=run.eqns, donated_expected=len(donated),
        donated_consumed=consumed, sanctioned=run.sanctioned)


# -------------------------------------------------------------- registry

#: name -> zero-arg builder returning an :class:`AuditReport`.
_REGISTRY: dict[str, Callable[[], AuditReport]] = {}

DEFAULT_PROGRAMS = (
    "train.grads", "zero.shard_apply", "zero1.shard_apply",
    "zero2.grad_reduce_scatter", "zero3.param_gather",
    "zero3.shard_apply", "collectives.bucket_allreduce",
    "collectives.bucket_reduce_scatter",
    "collectives.hier_allreduce",
    "collectives.hier_reduce_scatter", "serve.decode_step",
    "serve.spec_window", "serve.kv_pack", "serve.kv_unpack",
)


def register(name: str, builder: Callable[[], AuditReport]) -> None:
    _REGISTRY[name] = builder


def registered() -> list[str]:
    return sorted(_REGISTRY)


def audit_registered(name: str) -> AuditReport:
    if name not in _REGISTRY:
        raise KeyError(f"no registered hot program {name!r} "
                       f"(have: {registered()})")
    return _REGISTRY[name]()


def audit_all(raise_on_failure: bool = False,
              names=None) -> dict[str, AuditReport]:
    """Audit every registered program (or ``names``), in name order."""
    out = {}
    for name in sorted(names) if names is not None else registered():
        out[name] = audit_registered(name)
        if raise_on_failure:
            out[name].raise_if_failed()
    return out


# ---------------------------------------------------- default programs

#: The ZeRO and collective programs' leaves: two leaves, one bucket.
_SHAPES = ((4, 4), (8,))


def _model(preset: str, dtype, device):
    from ptype_tpu_torch.models import transformer as tfm
    from ptype_tpu_torch.models.weights import init_params

    cfg = tfm.preset(preset, dtype=dtype)
    params = init_params(torch.Generator(device=device).manual_seed(0),
                         cfg)
    return cfg, params


def _mesh(mesh, device):
    import torch.distributed as dist

    from ptype_tpu_torch.parallel.mesh import build_mesh

    return mesh if mesh is not None else build_mesh(
        {"data": dist.get_world_size()}, device=device)


def _leaves(device, seed: int = 0) -> list:
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=g).to(device) for s in _SHAPES]


def _adamw_f64(device) -> bool:
    """The AdamW update takes its square root through f64 on the CPU
    (``trainer._sqrt``: the correctly rounded f32 root the reference's
    bits need); on CUDA it stays f32 and the pin holds."""
    return device.type == "cpu"


def _build_train_grads(preset, batch, seq, dtype, device):
    def builder() -> AuditReport:
        from ptype_tpu_torch.models import transformer as tfm
        from ptype_tpu_torch.parallel.collectives import (tree_flatten,
                                                          tree_unflatten)

        cfg, params = _model(preset, dtype, device)
        paths = [p for p, _ in tree_flatten(params)]
        leaves = [t.requires_grad_(True) for _, t in tree_flatten(params)]
        g = torch.Generator().manual_seed(1)
        rows = {k: torch.randint(1, cfg.vocab_size, (batch, seq),
                                 generator=g).to(device)
                for k in ("tokens", "targets")}

        def grads(leaves, rows):
            loss = tfm.loss_fn(tree_unflatten(paths, leaves), rows, cfg)
            return loss.detach(), torch.autograd.grad(loss, leaves)

        # The single-replica grad program is collective-free (the wire
        # is the Store's job) and stays f32/bf16 end to end.
        return audit(grads, (leaves, rows), name="train.grads",
                     expect_collectives=0)

    return builder


def _zero_state(mesh):
    from ptype_tpu_torch.parallel.zero import ShardPlan, ZeroState
    from ptype_tpu_torch.train.trainer import default_optimizer_hparams

    leaves = _leaves(mesh.device)
    plan = ShardPlan.for_leaves(leaves, mesh.shape["data"])
    zs = ZeroState.create(plan, mesh, "data", default_optimizer_hparams(),
                          [True, False])
    return zs, leaves


def _build_zero_apply(mesh, device, full: bool):
    def builder() -> AuditReport:
        m = _mesh(mesh, device)
        zs, params = _zero_state(m)
        b = zs.plan.buckets[0]
        scale = torch.ones((), device=m.device)
        if full:
            grads = _leaves(m.device, 1)
            fn = lambda p, g, s: zs.apply_bucket_full(0, p, g, s)  # noqa: E731
            name = "zero1.shard_apply"
        else:
            grads = torch.randn(zs.plan.shard_elems(b),
                                generator=torch.Generator().manual_seed(1)
                                ).to(m.device)
            fn = lambda p, g, s: zs.apply_bucket(0, p, g, s)  # noqa: E731
            name = "zero.shard_apply"
        # ONE all_gather: the fused shard-apply's whole point (pack →
        # slice this rank's shard → AdamW → gather); a second gather
        # means the fusion regressed to per-leaf assembly. ZeRO-1 takes
        # full grads in, the same one param gather out.
        return audit(fn, (params, grads, scale), name=name,
                     expect_collectives={"all_gather": 1},
                     allow_f64=_adamw_f64(m.device))

    return builder


def _build_zero2_grad_rs(mesh, device):
    def builder() -> AuditReport:
        from ptype_tpu_torch.parallel import collectives as coll

        m = _mesh(mesh, device)

        def rs(leaves):
            return [red.wait()[0] for _, red in
                    coll.bucketed_reduce_scatter_stream(leaves, m, "data",
                                                        "mean")]

        # ZeRO-2's whole point: grads arrive shard-resident from ONE
        # reduce_scatter per bucket and are never allgathered.
        return audit(rs, (_leaves(m.device),),
                     name="zero2.grad_reduce_scatter",
                     expect_collectives={"reduce_scatter": 1,
                                         "all_gather": 0})

    return builder


def _build_zero3_gather(mesh, device):
    def builder() -> AuditReport:
        m = _mesh(mesh, device)
        zs, params = _zero_state(m)
        zs.scatter_params(params)

        def gather(pflat):
            zs.pflat[0] = pflat
            return zs.gather_bucket(0)

        # The just-in-time param materialization: ONE all_gather per
        # bucket, however many leaves it unpacks to.
        return audit(gather, (zs.pflat[0],), name="zero3.param_gather",
                     expect_collectives={"all_gather": 1})

    return builder


def _build_zero3_apply(mesh, device):
    def builder() -> AuditReport:
        m = _mesh(mesh, device)
        zs, params = _zero_state(m)
        zs.scatter_params(params)
        g = torch.randn(zs.pflat[0].shape,
                        generator=torch.Generator().manual_seed(1)
                        ).to(m.device)

        def apply(p, grad, mu, nu, scale):
            zs.pflat[0], zs.mu[0], zs.nu[0] = p, mu, nu
            return zs.apply_bucket3(0, grad, scale)

        # ZeRO-3's update is elementwise on the resident flats (the one
        # all_gather lives in zero3.param_gather), IN PLACE on the
        # param shard and both moments: a dropped donation doubles the
        # rung's resident footprint mid-step.
        return audit(apply, (zs.pflat[0], g, zs.mu[0], zs.nu[0],
                             torch.ones((), device=m.device)),
                     name="zero3.shard_apply", donate_argnums=(0, 2, 3),
                     expect_collectives=0,
                     allow_f64=_adamw_f64(m.device))

    return builder


def _build_bucket_collective(mesh, device, kind: str):
    def builder() -> AuditReport:
        from ptype_tpu_torch.parallel import collectives as coll

        m = _mesh(mesh, device)
        if kind == "allreduce":
            def fn(leaves):
                return coll.bucketed_all_reduce(leaves, m, "data", "mean")
            expect = {"psum": 1}
            name = "collectives.bucket_allreduce"
        else:
            def fn(leaves):
                return [red.wait()[0] for _, red in
                        coll.bucketed_reduce_scatter_stream(
                            leaves, m, "data", "sum")]
            expect = {"reduce_scatter": 1}
            name = "collectives.bucket_reduce_scatter"
        # N leaves, ONE launch: a per-leaf regression shows as count N.
        return audit(fn, (_leaves(m.device),), name=name,
                     expect_collectives=expect)

    return builder


def _build_hier_collective(mesh, device, kind: str):
    def builder() -> AuditReport:
        import torch.distributed as dist

        from ptype_tpu_torch.parallel import collectives as coll
        from ptype_tpu_torch.parallel.topology import Topology

        n = mesh.size if mesh is not None else dist.get_world_size()
        no = 2 if n % 2 == 0 and n >= 4 else 1
        topo = Topology(n_outer=no, n_inner=n // no)
        m = topo.mesh(group=getattr(mesh, "group", None), device=device)
        ni, two = int(n // no > 1), int(no > 1)
        if kind == "allreduce":
            def fn(leaves):
                return coll.bucketed_all_reduce(
                    leaves, m, topo.flat_axis, "mean", topology=topo)
            # One launch a leg: the inner reduce-scatter, ONE outer
            # exchange (the only cross-domain launch), the inner
            # allgather; a size-1 leg launches nothing.
            expect = {"reduce_scatter": ni, "psum": two, "all_gather": ni}
            name = "collectives.hier_allreduce"
        else:
            def fn(leaves):
                return [red.wait()[0] for _, red in
                        coll.bucketed_reduce_scatter_stream(
                            leaves, m, topo.flat_axis, "sum",
                            topology=topo)]
            # Inner then outer reduce-scatter; no gather leg.
            expect = {"reduce_scatter": ni + two}
            name = "collectives.hier_reduce_scatter"
        return audit(fn, (_leaves(m.device),), name=name,
                     expect_collectives=expect)

    return builder


def _kv_banks(cfg, n_blocks: int, block_tokens: int, device, seed=2):
    g = torch.Generator().manual_seed(seed)
    shape = (cfg.n_layers, n_blocks, block_tokens, cfg.kv_heads,
             cfg.d_model // cfg.n_heads)
    return [torch.randn(shape, generator=g).to(device, cfg.dtype)
            for _ in range(2)]


def _build_decode_step(preset, dtype, device, n_slots, n_blocks,
                       block_tokens):
    def builder() -> AuditReport:
        from ptype_tpu_torch.models import generate as gen

        cfg, params = _model(preset, dtype, device)
        kb, vb = _kv_banks(cfg, n_blocks, block_tokens, device)
        B, nb = n_slots, n_blocks // n_slots
        g = torch.Generator().manual_seed(3)
        tables = (1 + torch.arange(B * nb) % (n_blocks - 1)).reshape(B, nb)
        pos = torch.randint(0, nb * block_tokens, (B,), generator=g)
        tok = torch.randint(1, cfg.vocab_size, (B,), generator=g)
        wr_b = tables[torch.arange(B), pos // block_tokens]
        args = [t.to(device) for t in (tok, pos, tables, wr_b,
                                       pos % block_tokens)]
        attn = "kernel" if device.type == "cuda" else "gather"

        def step(params, kb, vb, tok, pos, tables, wr_b, wr_o):
            return gen.decode_step_paged(params, tok, pos, cfg, kb, vb,
                                         tables, wr_b, wr_o,
                                         attn_impl=attn)

        # Banks donated (written in place): a dropped donation copies
        # the whole KV pool every step.
        return audit(step, (params, kb, vb, *args),
                     name="serve.decode_step", donate_argnums=(1, 2),
                     expect_collectives=0)

    return builder


def _build_spec_window(preset, dtype, device, k: int):
    def builder() -> AuditReport:
        import numpy as np

        from ptype_tpu_torch.models import generate as gen
        from ptype_tpu_torch.serve_engine import (PagedGeneratorActor,
                                                  SpecConfig)

        cfg, params = _model(preset, dtype, device)
        dp, dcfg = gen.truncated_draft_params(params, cfg, n_layers=1)
        eng = PagedGeneratorActor(
            cfg, params=params, device=device, n_slots=2, block_tokens=16,
            attn="kernel" if device.type == "cuda" else "gather",
            spec=SpecConfig(draft_params=dp, draft_cfg=dcfg, k=k,
                            adaptive=False))
        try:
            W, B = k + 1, eng.n_slots
            g = np.random.default_rng(4)
            tables = np.arange(1, 1 + B * 2, dtype=np.int32).reshape(B, 2)
            eng._sdev = {
                "tables": eng._upload(np.pad(tables, ((0, 0),
                                                      (0, eng.nb - 2)))),
                "dtables": eng._upload(np.pad(tables, ((0, 0),
                                                       (0, eng.nb - 2)))),
                "nalloc": eng._upload(np.full(B, 2, np.int32)),
                "dnalloc": eng._upload(np.full(B, 2, np.int32)),
                "active": eng._upload(np.ones(B, bool)),
            }
            tok = eng._upload(g.integers(1, cfg.vocab_size, B))
            pos = eng._upload(g.integers(0, 16, B).astype(np.int32))

            def window(kb, vb, dkb, dvb, tok, pos):
                eng.pool.k, eng.pool.v = kb, vb
                eng._dpool.k, eng._dpool.v = dkb, dvb
                out, n_acc = eng._spec_window(W, False, tok, pos)
                return (out, n_acc, eng.pool.k, eng.pool.v, eng._dpool.k,
                        eng._dpool.v)

            # The engine's own window: draft steps, one batched verify,
            # acceptance, both pools' banks written in place, no
            # collectives, no f64, no host read.
            return audit(window, (eng.pool.k, eng.pool.v, eng._dpool.k,
                                  eng._dpool.v, tok, pos),
                         name="serve.spec_window",
                         donate_argnums=(0, 1, 2, 3),
                         expect_collectives=0)
        finally:
            eng.close()

    return builder


def _build_kv_pack(preset, dtype, device, n_blocks, block_tokens):
    def builder() -> AuditReport:
        from ptype_tpu_torch.models import transformer as tfm
        from ptype_tpu_torch.serve_engine.migrate import KVMigrator

        cfg = tfm.preset(preset, dtype=dtype)
        kb, vb = _kv_banks(cfg, n_blocks, block_tokens, device)
        mig = KVMigrator(kb[:, 0].shape, kb.dtype)
        rk, rv = (torch.zeros_like(kb[:, 0]) for _ in range(2))

        def pack(kb, vb, rk, rv):
            mig._res[7] = (rk, rv)
            payload, _ = mig.pack_block(kb, vb, 1, 7, "q8")
            return payload, mig._res[7]

        # Residuals donated (consumed into the pre-quantization sum,
        # replaced in place by the new per-block error): a dropped
        # donation doubles the wire path's live residual memory per
        # transfer. The wire hop to the host is the one sanctioned
        # synchronisation.
        return audit(pack, (kb, vb, rk, rv), name="serve.kv_pack",
                     donate_argnums=(2, 3), expect_collectives=0)

    return builder


def _build_kv_unpack(preset, dtype, device, n_blocks, block_tokens):
    def builder() -> AuditReport:
        from ptype_tpu_torch.models import transformer as tfm
        from ptype_tpu_torch.serve_engine.migrate import KVMigrator

        cfg = tfm.preset(preset, dtype=dtype)
        src_k, src_v = _kv_banks(cfg, n_blocks, block_tokens, device, 5)
        mig = KVMigrator(src_k[:, 0].shape, src_k.dtype)
        payload, _ = mig.pack_block(src_k, src_v, 1, None, "q8")
        kb, vb = _kv_banks(cfg, n_blocks, block_tokens, device)

        def unpack(kb, vb, payload):
            mig.unpack_block(kb, vb, payload, 3, "q8")
            return kb, vb

        # Banks donated (written in place): a dropped donation copies
        # the decode replica's whole KV pool per imported block.
        return audit(unpack, (kb, vb, payload), name="serve.kv_unpack",
                     donate_argnums=(0, 1), expect_collectives=0)

    return builder


def register_default_programs(preset: str = "tiny", batch: int = 4,
                              seq: int = 16, spec_k: int = 3, *,
                              device=None, dtype=torch.float32, mesh=None,
                              n_slots: int = 2, n_blocks: int = 12,
                              block_tokens: int = 16) -> None:
    """Install :data:`DEFAULT_PROGRAMS` (idempotent), built from the
    port's programs at ``preset`` in ``dtype`` on ``device`` (``cuda``
    unless named): ``train.grads`` at ``batch`` x ``seq``, the decode
    step at ``n_slots`` slots over ``n_blocks`` blocks of
    ``block_tokens``. The ZeRO and collective programs run on ``mesh``
    (default: the ``data`` axis over the default process group, built
    when audited)."""
    from ptype_tpu_torch.device import resolve_device

    device = resolve_device(device)
    register("train.grads",
             _build_train_grads(preset, batch, seq, dtype, device))
    register("zero.shard_apply", _build_zero_apply(mesh, device, False))
    register("zero1.shard_apply", _build_zero_apply(mesh, device, True))
    register("zero2.grad_reduce_scatter", _build_zero2_grad_rs(mesh, device))
    register("zero3.param_gather", _build_zero3_gather(mesh, device))
    register("zero3.shard_apply", _build_zero3_apply(mesh, device))
    register("collectives.bucket_allreduce",
             _build_bucket_collective(mesh, device, "allreduce"))
    register("collectives.bucket_reduce_scatter",
             _build_bucket_collective(mesh, device, "reduce_scatter"))
    register("collectives.hier_allreduce",
             _build_hier_collective(mesh, device, "allreduce"))
    register("collectives.hier_reduce_scatter",
             _build_hier_collective(mesh, device, "reduce_scatter"))
    register("serve.decode_step",
             _build_decode_step(preset, dtype, device, n_slots, n_blocks,
                                block_tokens))
    register("serve.spec_window",
             _build_spec_window(preset, dtype, device, spec_k))
    register("serve.kv_pack",
             _build_kv_pack(preset, dtype, device, n_blocks, block_tokens))
    register("serve.kv_unpack",
             _build_kv_unpack(preset, dtype, device, n_blocks,
                              block_tokens))
