"""Collectives over a mesh axis on ``torch.distributed`` — the port of
``ptype_tpu/parallel/collectives.py``: the plain collectives, the
block-scaled int8 wire with error feedback, the bucket planner and the
bucketed allreduce / reduce-scatter streams the ``TensorStore`` pushes
through; and the host-side leaf codec (the KV wire's ``q8`` mode).

The reference is one controller: a collective takes the stacked
``(n, *rest)`` contributions of all n devices. The port runs one process
per rank, so each function takes THIS rank's contribution ``x`` (shape
``rest``) and returns what the reference leaves on this rank's device:
the reduction (allreduce), shard r of it (reduce-scatter, rank r), the
stacked contributions (allgather). Every rank of the axis must call.

Collectives run on the mesh's process group: NCCL on ``cuda`` (enqueued
on NCCL's stream; a wait orders the caller's stream after it and never
blocks the host) and gloo on the CPU (a wait blocks the host). A
bucket's exact collective is dispatched with ``async_op=True``; its
result is read only through the handle's ``wait()``. The int8 wire's
legs depend on each other, so they run in order inside the dispatch.

The int8 arithmetic follows the reference step for step, so ``q`` and
``s`` match its eager arithmetic bit for bit: the payload is cast to f32
(the residual added in f32); each block's scale is ``amax / 127`` in f32
(1 for an all-zero block); the quantized value is ``round(x / scale)``,
half to even, clipped to ±127; every division (the scale, the
quantization, ``mean``) divides by a tensor, since CUDA turns a
Python-scalar divisor into a product with its reciprocal.

Counters (``metrics``): ``collectives.bucket_launches`` (one a bucket,
as the reference's ``_count_launch``), ``collectives.calls`` (each
``torch.distributed`` call) and ``collectives.wire_bytes`` (the bytes
each call is handed).

The autograd-aware collectives at the end (:func:`gather_for_use`,
:func:`gather_replicated`, :func:`reduce_from`, :func:`copy_to`,
:func:`sum_over`, :func:`ring_send`, :func:`all_to_all_dims`) are the
sharded trainer's: each is the identity on an axis of size 1.

The tree codec (:func:`quantize_tree`, :func:`dequantize_tree`) is the
param server's int8 RPC wire: one quantized leaf a gradient, in the
reference's leaf order, so a tree either package quantized decodes in
the other.

The probes (:func:`measure_allreduce_gbps`, :func:`measure_wire_gbps`)
time the exact allreduce and one bucketed allreduce a wire format on
this rank, GB/s by the reference's ring convention (2(n-1)/n of the f32
buffer a rank): at world 1 nothing crosses a wire, so they read 0.0
GB/s and the milliseconds they time are the bucketing and quantize legs
alone.

The hierarchical wire (a :class:`~ptype_tpu_torch.parallel.topology.
Topology` passed to the bucketed streams, over the composite ``("inner",
"outer")`` axis of ``Topology.mesh``): each sum or mean bucket
reduce-scatters inside the fast inner domain, exchanges only its
``1/n_inner`` chunk over the slow outer leg and allgathers back out,
every leg with its own wire format (``Topology.resolve_leg``) and its
own error feedback; a leg of size 1 is skipped. The reduce-scatter
leaves each rank the same flat shard as the flat composite scatter, so
ZeRO's shards ride either wire. Counters: ``collectives.hier_launches``
and the analytic per-leg bytes ``collectives.leg_bytes.inner``,
``.outer`` and ``.flat_outer`` (the flat ring's bytes, all charged to
the slow leg). :func:`measure_hier_allreduce` times the two wires on
one composite mesh.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ptype_tpu_torch.metrics import metrics
from ptype_tpu_torch.parallel.mesh import axis_group, axis_index, axis_n
from ptype_tpu_torch.parallel.topology import (INNER_AXIS, OUTER_AXIS,
                                               Topology)

_REDUCERS = ("sum", "mean", "max", "min")
#: ``mean`` is a sum divided after the wire, as the reference's pmean.
_OPS = {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM,
        "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}

#: Default elements per quantization scale block: small enough that one
#: outlier poisons a small share of a bucket, large enough that the f32
#: scale overhead stays under 1% of the int8 bytes.
DEFAULT_QUANT_BLOCK = 512

#: Marker key of a quantized leaf (the reference's wire name).
_Q8_KEY = "__ptype_q8__"
#: Marker key of a quantized tree (:func:`quantize_tree`).
_Q8_TREE_KEY = "__ptype_q8_tree__"

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64}


#: The flat allgather and reduce-scatter: torch 2.13 renamed them (the
#: old names warn), older releases have only the old names.
_all_gather_flat = (getattr(dist, "all_gather_single", None)
                    or dist.all_gather_into_tensor)
_reduce_scatter_flat = (getattr(dist, "reduce_scatter_single", None)
                        or dist.reduce_scatter_tensor)


def _called(t: torch.Tensor) -> None:
    metrics.counter("collectives.calls").add(1)
    metrics.counter("collectives.wire_bytes").add(t.numel()
                                                  * t.element_size())


def _div(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x / n`` by a tensor divisor; integers become f32 first (the
    reference's pmean promotes them)."""
    if not x.is_floating_point():
        x = x.float()
    return x / torch.full((), n, dtype=x.dtype, device=x.device)


# ------------------------------------------------------ plain collectives


def all_reduce(x: torch.Tensor, mesh, axis: str = "data",
               op: str = "sum") -> torch.Tensor:
    """Reduce every rank's ``x`` over ``axis``; every rank gets the
    result (the Store push lowering)."""
    if op not in _REDUCERS:
        raise ValueError(f"all_reduce: op must be one of {_REDUCERS}")
    group, n = axis_group(mesh, axis), axis_n(mesh, axis)
    out = x.contiguous().clone()
    _called(out)
    dist.all_reduce(out, op=_OPS[op], group=group)
    return _div(out, n) if op == "mean" else out


def all_gather(x: torch.Tensor, mesh, axis: str = "data") -> torch.Tensor:
    """Every rank's ``x`` stacked ``(n, *x.shape)`` in rank order, on
    every rank (the Store pull lowering)."""
    return _gather(x, axis_group(mesh, axis), axis_n(mesh, axis))


def reduce_scatter(x: torch.Tensor, mesh, axis: str = "data",
                   op: str = "sum") -> torch.Tensor:
    """Reduce every rank's ``x`` and leave rank r shard r of dim 0
    (``x.shape[0]`` must divide by the axis size): half the bytes of an
    allreduce when the consumer is itself sharded."""
    if op not in ("sum", "mean"):
        raise ValueError(
            f"reduce_scatter: op must be 'sum' or 'mean', got {op!r}")
    group, n = axis_group(mesh, axis), axis_n(mesh, axis)
    if x.dim() < 1 or x.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim 0 ({tuple(x.shape)}) must "
                         f"divide by axis size {n}")
    x = x.contiguous()
    out = torch.empty((x.shape[0] // n, *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _called(x)
    _reduce_scatter_flat(out, x, op=dist.ReduceOp.SUM, group=group)
    return _div(out, n) if op == "mean" else out


def ring_shift(x: torch.Tensor, mesh, axis: str = "data",
               shift: int = 1) -> torch.Tensor:
    """Rotate around the ``axis`` ring: rank r's ``x`` goes to rank
    ``(r + shift) % n``; returns what this rank receives."""
    group, n = axis_group(mesh, axis), axis_n(mesh, axis)
    x = x.contiguous()
    if shift % n == 0:
        return x.clone()
    r = axis_index(mesh, axis)
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x,
                      dist.get_global_rank(group, (r + shift) % n), group),
           dist.P2POp(dist.irecv, out,
                      dist.get_global_rank(group, (r - shift) % n), group)]
    _called(x)
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return out


def all_to_all(x: torch.Tensor, mesh, axis: str = "data") -> torch.Tensor:
    """Transpose chunk ownership: ``x`` is ``n`` equal chunks along dim
    0; chunk j goes to rank j, and the result holds the chunks every
    rank sent here, in rank order (the EP/Ulysses exchange)."""
    group, n = axis_group(mesh, axis), axis_n(mesh, axis)
    if x.dim() < 1 or x.shape[0] % n:
        raise ValueError(
            f"all_to_all: dim 0 must divide by axis size {n}")
    x = x.contiguous()
    out = torch.empty_like(x)
    _called(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def broadcast(value: torch.Tensor, mesh, axis: str = "data",
              src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``value`` on every rank (the others pass a tensor
    of the same shape and dtype)."""
    group = axis_group(mesh, axis)
    out = value.contiguous().clone()
    _called(out)
    dist.broadcast(out, src=dist.get_global_rank(group, src), group=group)
    return out


# ------------------------------------------------- block-scaled int8 wire


def _q_int8_blockwise(chunks: torch.Tensor, block: int | None):
    """Int8-quantize ``chunks: (m, c)`` f32 with one absmax scale per
    ``block`` contiguous elements (``None``: one scale per chunk). Each
    chunk zero-pads to a block multiple; zero blocks quantize exactly.
    Returns ``(q (m, nb, block) int8, scales (m, nb) f32)``."""
    m, c = chunks.shape
    block = c if block is None else min(int(block), c)
    pad = (-c) % block
    if pad:
        chunks = torch.nn.functional.pad(chunks, (0, pad))
    b = chunks.reshape(m, -1, block)
    amax = b.abs().amax(dim=2)
    scale = torch.where(amax == 0.0, torch.ones_like(amax),
                        amax / torch.full_like(amax, 127.0)
                        ).to(torch.float32)
    q = torch.clamp(torch.round(b.to(torch.float32) / scale[:, :, None]),
                    -127, 127).to(torch.int8)
    return q, scale


def _dq_int8_blockwise(q: torch.Tensor, scale: torch.Tensor, c: int):
    """Inverse of :func:`_q_int8_blockwise`: ``(m, nb, block)`` int8 +
    ``(m, nb)`` scales → ``(m, c)`` f32 (the block pad dropped)."""
    out = q.to(torch.float32) * scale[:, :, None]
    return out.reshape(q.shape[0], -1)[:, :c]


def _a2a(t: torch.Tensor, group) -> torch.Tensor:
    out = torch.empty_like(t)
    _called(t)
    dist.all_to_all_single(out, t.contiguous(), group=group)
    return out


def _gather(t: torch.Tensor, group, n: int) -> torch.Tensor:
    """Every rank's ``t`` stacked ``(n, *t.shape)`` in rank order."""
    flat = t.contiguous().reshape(-1)
    out = flat.new_empty(n * flat.numel())
    _called(flat)
    _all_gather_flat(out, flat, group=group)
    return out.view((n, *t.shape))


def _int8_phase1(x: torch.Tensor, mesh, axis, op: str, block: int | None):
    """The int8 reduce-scatter leg, shared by the quantized allreduce
    and reduce-scatter: slice this rank's flat contribution into n
    chunks, quantize each with per-``block`` scales, all_to_all so rank
    j collects everyone's chunk j, dequantize and sum. Returns this
    rank's reduced f32 chunk ``(len/n,)`` and its local quantization
    error ``(n, len/n)`` (what error feedback carries forward)."""
    group, n = axis_group(mesh, axis), axis_n(mesh, axis)
    c = x.shape[0] // n
    chunks = x.to(torch.float32).reshape(n, c)
    q, scale = _q_int8_blockwise(chunks, block)
    err = chunks - _dq_int8_blockwise(q, scale, c)
    q, scale = _a2a(q, group), _a2a(scale, group)
    red = _dq_int8_blockwise(q, scale, c).sum(dim=0)
    if op == "mean":
        red = _div(red, n)
    return red, err


def _int8_all_reduce_body(x: torch.Tensor, mesh, axis, op: str,
                          block: int | None = DEFAULT_QUANT_BLOCK,
                          res: torch.Tensor | None = None):
    """Both legs of the int8 allreduce on this rank's flat ``x``
    (``len(x) % n == 0``): phase 1 in sum space, then re-quantize this
    rank's reduced chunk, allgather and dequantize, so every rank holds
    the whole f32 reduction (``mean`` divides at the very end).

    ``res`` arms error feedback: it is added before quantizing, and the
    returned residual carries both legs' error — phase 1's across the
    whole contribution, plus phase 2's on the chunk this rank owns,
    folded in at its offset. The rank owns the same chunk next step, so
    the error cancels in the next reduction. Returns ``(out, new_res |
    None)``."""
    group, n = axis_group(mesh, axis), axis_n(mesh, axis)
    c = x.shape[0] // n
    xf = x.to(torch.float32)
    if res is not None:
        xf = xf + res.to(torch.float32)
    red, err1 = _int8_phase1(xf, mesh, axis, "sum", block)
    q2, s2 = _q_int8_blockwise(red[None], block)
    err2 = red - _dq_int8_blockwise(q2, s2, c)[0]
    qg, sg = _gather(q2[0], group, n), _gather(s2[0], group, n)
    out = _dq_int8_blockwise(qg, sg, c).reshape(x.shape)
    if op == "mean":
        out = _div(out, n)
    if res is None:
        return out, None
    new_res = err1.reshape(x.shape)
    idx = axis_index(mesh, axis)
    new_res[idx * c:(idx + 1) * c] += err2
    return out, new_res.to(res.dtype)


def quantized_all_reduce_eligible(shape: tuple, n: int, op: str) -> bool:
    """Whether a contribution of ``shape`` can take the int8 path: a
    sum or mean whose dim 0 divides by the axis size (the single source
    of its constraints; callers route others to the exact wire)."""
    return op in ("sum", "mean") and len(shape) >= 1 and shape[0] % n == 0


def _check_eligible(name: str, x: torch.Tensor, n: int, op: str) -> None:
    if not quantized_all_reduce_eligible(tuple(x.shape), n, op):
        raise ValueError(
            f"{name}: need op in sum/mean (got {op!r}) and dim 0 to divide "
            f"by the axis size {n} (got {tuple(x.shape)})")


def quantized_all_reduce(x: torch.Tensor, mesh, axis: str = "data",
                         op: str = "sum", *,
                         q_block: int | None = DEFAULT_QUANT_BLOCK
                         ) -> torch.Tensor:
    """Block-scaled int8 allreduce (the EQuARX pattern): both legs of
    the bandwidth-optimal decomposition (all_to_all reduce-scatter,
    allgather) carry int8 with one f32 scale per ``q_block`` elements,
    ~4× fewer bytes than f32 at a bounded error. Lossy: for gradients."""
    n = axis_n(mesh, axis)
    _check_eligible("quantized_all_reduce", x, n, op)
    out, _ = _int8_all_reduce_body(x.reshape(-1), mesh, axis, op, q_block)
    return out.reshape(x.shape).to(x.dtype)


def quantized_reduce_scatter(x: torch.Tensor, mesh, axis: str = "data",
                             op: str = "sum", *,
                             q_block: int | None = DEFAULT_QUANT_BLOCK
                             ) -> torch.Tensor:
    """Phase 1 of :func:`quantized_all_reduce` alone: rank r keeps shard
    r of dim 0 of the reduction, in ``x``'s dtype."""
    n = axis_n(mesh, axis)
    _check_eligible("quantized_reduce_scatter", x, n, op)
    red, _ = _int8_phase1(x.reshape(-1), mesh, axis, op, q_block)
    return red.reshape((x.shape[0] // n,) + tuple(x.shape[1:])).to(x.dtype)


# ------------------------------------------------------- bucket planner

#: Default per-rank payload target per bucket.
DEFAULT_BUCKET_BYTES = 32 * 1024 * 1024

#: Buckets below this payload ride the exact wire even under int8.
INT8_MIN_BUCKET_BYTES = 64 * 1024


@dataclasses.dataclass(frozen=True)
class WireConfig:
    """The gradient-wire policy, plumbed from the trainers through the
    ``TensorStore`` down to the bucketed collectives.

    ``compress``: None (exact) | "bf16" | "int8" (block-scaled).
    ``q_block``: elements per int8 scale block (None = one a chunk).
    ``error_feedback``: carry each leaf's quantization error into its
    next push (int8 only).
    """

    compress: str | None = None
    q_block: int | None = DEFAULT_QUANT_BLOCK
    error_feedback: bool = True
    bucket_bytes: int = DEFAULT_BUCKET_BYTES
    int8_min_bytes: int = INT8_MIN_BUCKET_BYTES

    def __post_init__(self):
        if self.compress not in (None, "bf16", "int8"):
            raise ValueError(
                f"WireConfig: unknown compression {self.compress!r}")
        # Below 8 the f32 scale per block costs more than int8 saves.
        if self.q_block is not None and self.q_block < 8:
            raise ValueError(
                f"WireConfig: q_block must be None or >= 8 (the f32 "
                f"scale overhead is 4/q_block bytes per element), got "
                f"{self.q_block!r}")

    @property
    def feedback_armed(self) -> bool:
        return self.compress == "int8" and self.error_feedback


@dataclasses.dataclass(frozen=True)
class LeafSlot:
    """One leaf's location inside a bucket's flat payload."""

    index: int            # position in the caller's flat leaf list
    offset: int           # element offset into the bucket payload
    size: int             # payload elements
    shape: tuple          # the leaf's shape (this rank's contribution)


@dataclasses.dataclass(frozen=True)
class Bucket:
    """A dtype-homogeneous pack of leaves reduced as one flat buffer."""

    dtype: str            # dtype name ("float32", "bfloat16", ...)
    slots: tuple          # tuple[LeafSlot, ...], ascending offsets
    pad: int              # zero elements appended so elems % n == 0

    @property
    def elems(self) -> int:
        last = self.slots[-1]
        return last.offset + last.size + self.pad

    @property
    def payload_bytes(self) -> int:
        return (self.elems - self.pad) * torch_dtype(self.dtype).itemsize


def dtype_name(dt) -> str:
    """``torch.float32`` / ``np.float32`` / ``"float32"`` → ``"float32"``."""
    if isinstance(dt, torch.dtype):
        return str(dt).removeprefix("torch.")
    if isinstance(dt, str):
        return dt
    return getattr(dt, "name", None) or str(dt)


def torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def plan_buckets(leaves, n: int,
                 bucket_bytes: int = DEFAULT_BUCKET_BYTES) -> list[Bucket]:
    """Greedy same-dtype packing of leaves (anything with ``shape`` and
    ``dtype``: this rank's contributions, or their shapes alone).

    Leaves keep their order within a dtype group; a group's open bucket
    closes when the next leaf would push its payload past
    ``bucket_bytes`` (an oversize leaf gets its own bucket). Every
    bucket is zero-padded to a multiple of ``n``, so the scatter and
    int8 paths always fit it. The same leaves give the reference's
    buckets and slots (its leaves carry a leading contribution axis)."""
    out: list[Bucket] = []
    open_slots: dict[str, list[LeafSlot]] = {}
    open_bytes: dict[str, int] = {}

    def close(dt: str) -> None:
        slots = open_slots.pop(dt, [])
        if slots:
            total = slots[-1].offset + slots[-1].size
            out.append(Bucket(dt, tuple(slots), (-total) % n))
        open_bytes.pop(dt, None)

    for i, leaf in enumerate(leaves):
        shape = tuple(int(d) for d in leaf.shape)
        dt = dtype_name(leaf.dtype)
        size = 1
        for d in shape:
            size *= d
        nbytes = size * torch_dtype(dt).itemsize
        if dt in open_slots and open_bytes[dt] + nbytes > bucket_bytes:
            close(dt)
        slots = open_slots.setdefault(dt, [])
        off = (slots[-1].offset + slots[-1].size) if slots else 0
        slots.append(LeafSlot(i, off, size, shape))
        open_bytes[dt] = open_bytes.get(dt, 0) + nbytes
    for dt in list(open_slots):
        close(dt)
    return out


def _bucket_wire(bucket: Bucket, op: str, compress: str | None,
                 int8_min_bytes: int) -> str | None:
    """A bucket's wire format. Non-float buckets ride exact (step
    counters must not round-trip through bf16/int8); int8 also needs a
    sum/mean and enough payload to pay for the quantize legs."""
    if compress is None or not torch_dtype(bucket.dtype).is_floating_point:
        return None
    if compress == "bf16":
        return "bf16"
    if op in ("sum", "mean") and \
            bucket.payload_bytes >= max(int8_min_bytes, 1):
        return "int8"
    return None


def _unpack(red: torch.Tensor, slots) -> list:
    """Views of a flat buffer's slots, in slot order."""
    return [red[s.offset:s.offset + s.size].view(s.shape) for s in slots]


def _slot_offsets(shapes) -> list:
    """Contiguous :class:`LeafSlot` layout for ``shapes``: the one
    offset computation every bucket program unpacks with."""
    offs, off = [], 0
    for s in shapes:
        size = 1
        for d in s:
            size *= int(d)
        offs.append(LeafSlot(0, off, size, tuple(s)))
        off += size
    return offs


def _pack_flat(leaves, pad: int) -> torch.Tensor:
    """Flatten and concatenate ``leaves`` into a NEW buffer, zero-padded
    by ``pad``: the one packing every bucket program shares (and never a
    view of a caller's tensor, which a collective would write)."""
    parts = [x.reshape(-1) for x in leaves]
    if pad:
        parts.append(parts[0].new_zeros(pad))
    return torch.cat(parts)


def _seeded(residuals, leaves, bucket) -> list:
    """The bucket's residuals, zeros where missing or stale-shaped."""
    out = []
    for s in bucket.slots:
        r, leaf = residuals[s.index], leaves[s.index]
        ok = r is not None and tuple(r.shape) == tuple(leaf.shape)
        out.append(r if ok else torch.zeros_like(leaf))
    return out


def _count_launch(n: int = 1) -> None:
    metrics.counter("collectives.bucket_launches").add(n)


class Reduction:
    """One bucket's collective in flight. :meth:`wait` finishes it (on
    NCCL the caller's stream waits for it; on gloo the host does) and
    returns its result; later calls return the same result."""

    def __init__(self, bucket: Bucket, wire: str | None, works, finish):
        self.bucket = bucket
        #: The bucket's wire format (None: exact); for a hierarchical
        #: bucket its inner leg's, which carries the per-leaf residuals.
        self.wire = wire
        self._works = list(works)
        self._finish = finish
        self._result = None

    def wait(self):
        if self._finish is not None:
            for w in self._works:
                w.wait()
            self._result = self._finish()
            self._works, self._finish = [], None
        return self._result


def _check_stream_args(name: str, op: str, ops, compress) -> None:
    if op not in ops:
        raise ValueError(f"{name}: op must be one of {ops}, got {op!r}")
    if compress not in (None, "bf16", "int8"):
        raise ValueError(f"{name}: unknown compression {compress!r}")


# ------------------------------------------------- the hierarchical wire
#
# Error feedback on the two-leg wire, per leg, as the reference keeps it:
# the INNER residual is the rank's own phase-1 error across its whole
# contribution (on the allreduce plus its share of the gather-leg error
# at its own chunk, divided by n_outer: every domain holds a copy of
# that chunk and folds the same error); the OUTER residual is the error
# of quantizing the inner chunk this rank carries across the slow leg,
# which it carries again next step. The outer residual is a flat vector
# a bucket (the chunk boundaries cut across leaf slots), keyed by the
# bucket's index in the caller's dict.


def _leg_sum(x: torch.Tensor, mesh, leg: str, wire, block,
             res: torch.Tensor | None = None):
    """The exact, bf16 or int8 allreduce (sum) of ``x`` over one leg:
    ``(sum, new_res | None)``."""
    if wire == "int8":
        return _int8_all_reduce_body(x, mesh, leg, "sum", block, res)
    w = x.to(torch.bfloat16) if wire == "bf16" else x
    return all_reduce(w, mesh, leg).to(x.dtype), None


def _leg_scatter(x: torch.Tensor, mesh, leg: str, wire, block):
    """The reduce-scatter (sum) of ``x`` over one leg: ``(this rank's
    chunk, the int8 phase-1 error of all of x | None)``."""
    if wire == "int8":
        return _int8_phase1(x, mesh, leg, "sum", block)
    w = x.to(torch.bfloat16) if wire == "bf16" else x
    return reduce_scatter(w, mesh, leg).to(x.dtype), None


def _hier_allreduce_body(flat: torch.Tensor, mesh, op: str, wire_in,
                         wire_out, qb_in, qb_out, res_in=None, res_out=None):
    """Three legs on this rank's flat contribution (length ``E``, a
    multiple of ``n_inner · n_outer``): inner reduce-scatter, outer
    allreduce of the ``E/n_inner`` chunk, inner allgather. A size-1 leg
    is the identity, so every factorization runs this body. Returns
    ``(out (E,), new_res_in (E,) | None, new_res_out (E/n_inner,) |
    None)``; the error terms are in sum space (``mean`` divides at the
    very end, as the flat bodies do)."""
    ni, no = axis_n(mesh, INNER_AXIS), axis_n(mesh, OUTER_AXIS)
    c1 = flat.shape[0] // ni
    quant = "int8" in (wire_in, wire_out)
    xf = flat.to(torch.float32) if quant else flat
    if res_in is not None:
        xf = xf + res_in.to(torch.float32)
    new_res_in = None
    if ni == 1:
        red = xf
    else:
        red, err1 = _leg_scatter(xf, mesh, INNER_AXIS, wire_in, qb_in)
        if res_in is not None:
            new_res_in = err1.reshape(xf.shape)
    new_res_out = None
    if no > 1:
        red, new_res_out = _leg_sum(red, mesh, OUTER_AXIS, wire_out, qb_out,
                                    res_out)
    if ni == 1:
        out = red
    elif wire_in == "int8":
        group = axis_group(mesh, INNER_AXIS)
        q2, s2 = _q_int8_blockwise(red[None], qb_in)
        err3 = red - _dq_int8_blockwise(q2, s2, c1)[0]
        out = _dq_int8_blockwise(_gather(q2[0], group, ni),
                                 _gather(s2[0], group, ni), c1
                                 ).reshape(xf.shape)
        if new_res_in is not None:
            idx = axis_index(mesh, INNER_AXIS)
            new_res_in[idx * c1:(idx + 1) * c1] += _div(err3, no)
    else:
        w = red.to(torch.bfloat16) if wire_in == "bf16" else red
        out = all_gather_dim(w, mesh, INNER_AXIS, 0).to(xf.dtype)
    if op == "mean":
        out = _div(out, ni * no)
    return out, new_res_in, new_res_out


def _hier_reduce_scatter_body(flat: torch.Tensor, mesh, op: str, wire_in,
                              wire_out, qb_in, qb_out, res_in=None,
                              res_out=None):
    """The scatter half of :func:`_hier_allreduce_body`: inner
    reduce-scatter, then outer reduce-scatter of the chunk. The rank at
    (outer o, inner i) must end with chunk ``o·n_inner + i`` of the
    reduction, the flat composite scatter's; inner-then-outer alone
    would leave it chunk ``i·n_outer + o``, so the contribution's
    chunks are first laid out inner-major. Returns ``(shard (E/n,),
    new_res_in (E,) | None, new_res_out (E/n_inner,) | None)``, the
    inner residual in the contribution's own layout."""
    ni, no = axis_n(mesh, INNER_AXIS), axis_n(mesh, OUTER_AXIS)
    E = flat.shape[0]
    quant = "int8" in (wire_in, wire_out)
    xf = flat.to(torch.float32) if quant else flat
    if res_in is not None:
        xf = xf + res_in.to(torch.float32)
    new_res_in = None
    if ni == 1:
        red = xf
    else:
        swapped = xf.reshape(no, ni, -1).transpose(0, 1).reshape(E)
        red, err1 = _leg_scatter(swapped, mesh, INNER_AXIS, wire_in, qb_in)
        if res_in is not None:
            new_res_in = err1.reshape(ni, no, -1).transpose(0, 1).reshape(E)
    new_res_out = None
    if no > 1:
        if wire_out == "int8" and res_out is not None:
            red = red.to(torch.float32) + res_out.to(torch.float32)
        red, err_o = _leg_scatter(red, mesh, OUTER_AXIS, wire_out, qb_out)
        if wire_out == "int8" and res_out is not None:
            new_res_out = err_o.reshape(-1)
    if op == "mean":
        red = _div(red, ni * no)
    return red, new_res_in, new_res_out


def _wire_scale(wire, q_block, itemsize: int) -> float:
    """Bytes on the wire of a leg's format against the bucket's own
    dtype (the int8 scales included)."""
    if wire == "bf16":
        return 2.0 / itemsize
    if wire == "int8":
        qb = q_block if q_block else DEFAULT_QUANT_BLOCK
        return (1.0 + 4.0 / qb) / itemsize
    return 1.0


def _resolve_leg_wires(topo: Topology, bucket: Bucket, op: str, compress,
                       int8_min_bytes: int, q_block):
    """Each leg's wire for one bucket: the topology's leg policy over the
    caller's setting, then the bucket's eligibility (:func:`_bucket_wire`)
    per leg; a size-1 leg is exact (it moves nothing). Returns
    ``(wire_in, wire_out, qb_in, qb_out, restore)``."""
    c_in, qb_in = topo.resolve_leg(INNER_AXIS, compress, q_block)
    c_out, qb_out = topo.resolve_leg(OUTER_AXIS, compress, q_block)
    wire_in = _bucket_wire(bucket, op, c_in, int8_min_bytes)
    wire_out = _bucket_wire(bucket, op, c_out, int8_min_bytes)
    if int(topo.n_inner) == 1:
        wire_in = None
    if int(topo.n_outer) == 1:
        wire_out = None
    return wire_in, wire_out, qb_in, qb_out, (c_in is not None
                                              or c_out is not None)


def _count_leg_bytes(topo: Topology, bucket: Bucket, kind: str, wire_in,
                     wire_out, qb_in, qb_out) -> None:
    """The analytic per-leg wire bytes of one hierarchical bucket, per
    rank and scaled by each leg's format: the counters ``obs topo``
    reads."""
    itemsize = torch_dtype(bucket.dtype).itemsize
    legs = topo.leg_bytes(bucket.elems * itemsize, kind)
    inner = legs["inner"] * _wire_scale(wire_in, qb_in, itemsize)
    outer = legs["outer"] * _wire_scale(wire_out, qb_out, itemsize)
    metrics.counter("collectives.leg_bytes.inner").add(int(inner))
    metrics.counter("collectives.leg_bytes.outer").add(int(outer))
    metrics.counter("collectives.leg_bytes.flat_outer").add(
        int(legs["flat_outer"]))
    metrics.counter("collectives.hier_launches").add(1)


def _seed_outer_residual(outer_residuals: dict, bi: int, size: int,
                         device) -> torch.Tensor:
    """Bucket ``bi``'s outer-leg residual from the caller's dict; zeros
    when absent or stale-shaped (a replan changed the bucket)."""
    r = outer_residuals.get(bi)
    if r is None or tuple(r.shape) != (size,):
        r = torch.zeros(size, dtype=torch.float32, device=device)
    return r


def _hier_bucket(b: Bucket, bi: int, leaves, mesh, op: str, kind: str,
                 topology: Topology, compress, int8_min_bytes: int,
                 q_block, residuals, outer_residuals):
    """One bucket through the two-leg wire (``kind`` "allreduce" or
    "reduce_scatter"): the legs run in order at dispatch, the outer
    residual is updated in ``outer_residuals`` then. Returns the
    bucket's :class:`Reduction`, whose wait gives the stream's result
    (the reduced leaves, or the flat shard) and the new inner
    residuals by slot (None unless the inner leg carried int8
    feedback)."""
    wire_in, wire_out, qb_in, qb_out, restore = _resolve_leg_wires(
        topology, b, op, compress, int8_min_bytes, q_block)
    ef_in = wire_in == "int8" and residuals is not None
    ef_out = wire_out == "int8" and outer_residuals is not None
    flat = _pack_flat([leaves[s.index] for s in b.slots], b.pad)
    res_in = (_pack_flat(_seeded(residuals, leaves, b), b.pad) if ef_in
              else None)
    res_out = (_seed_outer_residual(outer_residuals, bi,
                                    b.elems // int(topology.n_inner),
                                    flat.device) if ef_out else None)
    body = (_hier_allreduce_body if kind == "allreduce"
            else _hier_reduce_scatter_body)
    out, nri, nro = body(flat, mesh, op, wire_in, wire_out, qb_in, qb_out,
                         res_in, res_out)
    if ef_out:
        outer_residuals[bi] = nro
    _count_launch()
    _count_leg_bytes(topology, b, kind, wire_in, wire_out, qb_in, qb_out)
    dtype = torch_dtype(b.dtype)

    def finish():
        red = out.to(dtype) if restore else out
        new = _unpack(nri.to(dtype), b.slots) if ef_in else None
        return (_unpack(red, b.slots) if kind == "allreduce" else red), new

    return Reduction(b, wire_in, [], finish)


def bucketed_all_reduce_stream(leaves, mesh, axis: str = "data",
                               op: str = "sum", *,
                               bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                               compress: str | None = None,
                               int8_min_bytes: int = INT8_MIN_BUCKET_BYTES,
                               q_block: int | None = DEFAULT_QUANT_BLOCK,
                               residuals: list | None = None,
                               topology: Topology | None = None,
                               outer_residuals: dict | None = None):
    """Dispatch one collective per bucket of ``leaves`` (this rank's
    contributions) and yield ``(bucket, reduction)`` right after each
    dispatch; ``reduction.wait()`` gives ``(reduced_by_slot,
    new_residuals_by_slot | None)``. A consumer can apply bucket i
    while buckets i+1.. are on the wire.

    ``residuals``: per-leaf error-feedback residuals aligned with
    ``leaves`` (None entries seed zeros). They engage only on buckets
    whose wire resolves to int8; other buckets give ``None``.

    ``topology``: the sum and mean buckets take the two-leg wire
    (``axis`` is the composite ``("inner", "outer")`` of the topology's
    mesh); max and min take the flat program over the same axis.
    ``outer_residuals``: the caller's dict of outer-leg residuals by
    bucket index, read for the seed and updated at each dispatch."""
    _check_stream_args("bucketed_all_reduce", op, _REDUCERS, compress)
    group, n = axis_group(mesh, axis), axis_n(mesh, axis)
    restore = compress is not None
    for bi, b in enumerate(plan_buckets(leaves, n, bucket_bytes)):
        if topology is not None and op in ("sum", "mean"):
            yield b, _hier_bucket(b, bi, leaves, mesh, op, "allreduce",
                                  topology, compress, int8_min_bytes,
                                  q_block, residuals, outer_residuals)
            continue
        wire = _bucket_wire(b, op, compress, int8_min_bytes)
        flat = _pack_flat([leaves[s.index] for s in b.slots], b.pad)
        dtype = torch_dtype(b.dtype)
        if wire == "int8":
            ef = residuals is not None
            res = (_pack_flat(_seeded(residuals, leaves, b), b.pad)
                   if ef else None)
            red, new_res = _int8_all_reduce_body(flat, mesh, axis, op,
                                                 q_block, res)

            def finish(red=red, new_res=new_res, b=b, dtype=dtype):
                outs = _unpack(red.to(dtype) if restore else red, b.slots)
                return outs, (None if new_res is None
                              else _unpack(new_res.to(dtype), b.slots))

            works = []
        else:
            w = flat.to(torch.bfloat16) if wire == "bf16" else flat
            _called(w)
            works = [dist.all_reduce(w, op=_OPS[op], group=group,
                                     async_op=True)]

            def finish(w=w, b=b, dtype=dtype):
                red = _div(w, n) if op == "mean" else w
                return _unpack(red.to(dtype) if restore else red,
                               b.slots), None

        _count_launch()
        yield b, Reduction(b, wire, works, finish)


def bucketed_all_reduce(leaves, mesh, axis: str = "data", op: str = "sum",
                        *, bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                        compress: str | None = None,
                        int8_min_bytes: int = INT8_MIN_BUCKET_BYTES,
                        q_block: int | None = DEFAULT_QUANT_BLOCK,
                        residuals: list | None = None,
                        topology: Topology | None = None,
                        outer_residuals: dict | None = None):
    """Allreduce a list of leaves through dtype buckets, every bucket on
    the wire before the first wait. Returns the reduced leaves in input
    order; with ``residuals``, ``(reduced, new_residuals)`` where a leaf
    that rode no int8 bucket keeps its input residual. ``topology`` and
    ``outer_residuals`` as for :func:`bucketed_all_reduce_stream`."""
    pending = list(bucketed_all_reduce_stream(
        leaves, mesh, axis, op, bucket_bytes=bucket_bytes,
        compress=compress, int8_min_bytes=int8_min_bytes, q_block=q_block,
        residuals=residuals, topology=topology,
        outer_residuals=outer_residuals))
    out: list = [None] * len(leaves)
    new_res = list(residuals) if residuals is not None else None
    for b, red in pending:
        outs, res = red.wait()
        for i, (s, r) in enumerate(zip(b.slots, outs)):
            out[s.index] = r
            if res is not None:
                new_res[s.index] = res[i]
    return out if residuals is None else (out, new_res)


def bucketed_reduce_scatter_stream(leaves, mesh, axis: str = "data",
                                   op: str = "sum", *,
                                   bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                                   compress: str | None = None,
                                   int8_min_bytes: int =
                                   INT8_MIN_BUCKET_BYTES,
                                   q_block: int | None = DEFAULT_QUANT_BLOCK,
                                   residuals: list | None = None,
                                   topology: Topology | None = None,
                                   outer_residuals: dict | None = None):
    """The ZeRO gradient leg: one reduce-scatter per bucket, yielding
    ``(bucket, reduction)``; ``reduction.wait()`` gives ``(shard,
    new_residuals_by_slot | None)``, ``shard`` being this rank's
    contiguous ``elems/n`` piece of the bucket's reduced flat (half the
    allreduce's bytes, and the form the shard-local optimizer reads).
    Under int8+EF the residual is the phase-1 error of this rank's
    whole contribution: the scatter has no gather leg. ``topology``
    routes every bucket through the two-leg scatter, which hands each
    rank the same shard; ``outer_residuals`` as for
    :func:`bucketed_all_reduce_stream`."""
    _check_stream_args("bucketed_reduce_scatter", op, ("sum", "mean"),
                       compress)
    group, n = axis_group(mesh, axis), axis_n(mesh, axis)
    restore = compress is not None
    for bi, b in enumerate(plan_buckets(leaves, n, bucket_bytes)):
        if topology is not None:
            yield b, _hier_bucket(b, bi, leaves, mesh, op, "reduce_scatter",
                                  topology, compress, int8_min_bytes,
                                  q_block, residuals, outer_residuals)
            continue
        wire = _bucket_wire(b, op, compress, int8_min_bytes)
        flat = _pack_flat([leaves[s.index] for s in b.slots], b.pad)
        dtype = torch_dtype(b.dtype)
        if wire == "int8":
            ef = residuals is not None
            if ef:
                flat = flat.to(torch.float32) + _pack_flat(
                    _seeded(residuals, leaves, b), b.pad).to(torch.float32)
            shard, err = _int8_phase1(flat, mesh, axis, op, q_block)

            def finish(shard=shard, err=err, ef=ef, b=b, dtype=dtype):
                out = shard.to(dtype) if restore else shard
                return out, (_unpack(err.reshape(-1).to(dtype), b.slots)
                             if ef else None)

            works = []
        else:
            w = flat.to(torch.bfloat16) if wire == "bf16" else flat
            shard = w.new_empty(b.elems // n)
            _called(w)
            works = [_reduce_scatter_flat(
                shard, w, op=dist.ReduceOp.SUM, group=group, async_op=True)]

            def finish(shard=shard, dtype=dtype):
                out = _div(shard, n) if op == "mean" else shard
                return (out.to(dtype) if restore else out), None

        _count_launch()
        yield b, Reduction(b, wire, works, finish)


# ---------------------------------------------------- along one dim


def all_gather_dim(x: torch.Tensor, mesh, axis, dim: int) -> torch.Tensor:
    """Every rank's block of ``axis`` concatenated along ``dim`` in rank
    order (the inverse of cutting ``dim`` into contiguous blocks)."""
    n = axis_n(mesh, axis)
    if n == 1:
        return x
    out = _gather(x, axis_group(mesh, axis), n)       # (n, *x.shape)
    shape = list(x.shape)
    shape[dim] *= n
    return out.movedim(0, dim).reshape(shape)


def reduce_scatter_dim(x: torch.Tensor, mesh, axis, dim: int) -> torch.Tensor:
    """The sum of every rank's ``x``, cut along ``dim`` into contiguous
    blocks, this rank keeping its own."""
    n = axis_n(mesh, axis)
    if n == 1:
        return x
    out = reduce_scatter(x.movedim(dim, 0).contiguous(), mesh, axis)
    return out.movedim(0, dim).contiguous()


def all_to_all_dim(x: torch.Tensor, mesh, axis, split_dim: int,
                   concat_dim: int) -> torch.Tensor:
    """Cut ``x`` into ``n`` blocks along ``split_dim``, send block j to
    rank j, and concatenate what arrives along ``concat_dim``, in rank
    order (the Ulysses exchange)."""
    n = axis_n(mesh, axis)
    if n == 1:
        return x
    blocks = torch.stack(torch.chunk(x, n, dim=split_dim))
    got = all_to_all(blocks, mesh, axis)
    return torch.cat(got.unbind(0), dim=concat_dim)


# ------------------------------------------------- autograd collectives


class _GatherForUse(torch.autograd.Function):
    """Allgather along a dim; backward sums the gradient over the axis
    and keeps this rank's block (a reduce-scatter): the FSDP pair, for
    ranks that compute different terms of the loss."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return all_gather_dim(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return (reduce_scatter_dim(g.contiguous(), ctx.mesh, ctx.axis,
                                   ctx.dim), None, None, None)


class _GatherReplicated(torch.autograd.Function):
    """Allgather along a dim; backward keeps this rank's block of the
    gradient: for ranks that compute the SAME loss from the gathered
    value (a tensor-parallel group), whose gradients are equal."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        ctx.size = x.shape[dim]
        return all_gather_dim(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        i = axis_index(ctx.mesh, ctx.axis)
        return (g.narrow(ctx.dim, i * ctx.size, ctx.size).contiguous(),
                None, None, None)


class _ReduceFrom(torch.autograd.Function):
    """Megatron's "g": allreduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyTo(torch.autograd.Function):
    """Megatron's "f": identity forward, allreduce backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, ctx.axis), None, None


class _SumOver(torch.autograd.Function):
    """Allreduce forward and backward: a sum that every rank's loss
    uses whole (the router aux's batch statistics), so each rank's
    gradient of it is the sum of every rank's."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, ctx.axis), None, None


class _RingSend(torch.autograd.Function):
    """:func:`ring_shift` whose backward sends the gradient back the
    other way."""

    @staticmethod
    def forward(ctx, x, mesh, axis, shift):
        ctx.mesh, ctx.axis, ctx.shift = mesh, axis, shift
        return ring_shift(x, mesh, axis, shift)

    @staticmethod
    def backward(ctx, g):
        return (ring_shift(g, ctx.mesh, ctx.axis, -ctx.shift), None, None,
                None)


class _AllToAllDims(torch.autograd.Function):
    """:func:`all_to_all_dim`, whose backward is the inverse exchange."""

    @staticmethod
    def forward(ctx, x, mesh, axis, split_dim, concat_dim):
        ctx.args = (mesh, axis, concat_dim, split_dim)
        return all_to_all_dim(x, mesh, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        return (all_to_all_dim(g.contiguous(), *ctx.args), None, None, None,
                None)


def _live(mesh, axis) -> bool:
    return axis is not None and axis_n(mesh, axis) > 1


def gather_for_use(x, mesh, axis, dim: int):
    """FSDP: the full tensor from every rank's block along ``dim``;
    the gradient is reduce-scattered back."""
    return _GatherForUse.apply(x, mesh, axis, dim) if _live(mesh, axis) \
        else x


def gather_replicated(x, mesh, axis, dim: int):
    """The full tensor along ``dim`` for a group that computes one loss
    from it; the gradient's own block comes back."""
    return (_GatherReplicated.apply(x, mesh, axis, dim)
            if _live(mesh, axis) else x)


def reduce_from(x, mesh, axis):
    """Sum the partial results of a row-parallel product ("g")."""
    return _ReduceFrom.apply(x, mesh, axis) if _live(mesh, axis) else x


def copy_to(x, mesh, axis):
    """Enter a column-parallel region ("f"): the gradient is summed."""
    return _CopyTo.apply(x, mesh, axis) if _live(mesh, axis) else x


def sum_over(x, mesh, axis):
    """The sum of every rank's ``x`` over ``axis``, for a loss each rank
    computes from it whole: the gradient is summed too."""
    return _SumOver.apply(x, mesh, axis) if _live(mesh, axis) else x


def ring_send(x, mesh, axis, shift: int = 1):
    """Differentiable :func:`ring_shift`."""
    return _RingSend.apply(x, mesh, axis, shift) if _live(mesh, axis) \
        else x


def all_to_all_dims(x, mesh, axis, split_dim: int, concat_dim: int):
    """Differentiable :func:`all_to_all_dim`."""
    return (_AllToAllDims.apply(x, mesh, axis, split_dim, concat_dim)
            if _live(mesh, axis) else x)


# ------------------------------------------------------------ tree forms


def tree_flatten(tree: dict, prefix: tuple = ()) -> list[tuple[tuple, object]]:
    """(path, leaf) pairs of a nested dict in the reference's leaf order:
    keys sorted at every level (``jax.tree_util``'s order for dicts)."""
    out = []
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, dict):
            out += tree_flatten(val, prefix + (key,))
        else:
            out.append((prefix + (key,), val))
    return out


def tree_unflatten(paths, leaves) -> dict:
    tree: dict = {}
    for path, leaf in zip(paths, leaves):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def tree_all_reduce(tree: dict, mesh, axis: str = "data", op: str = "sum",
                    *, bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                    compress: str | None = None,
                    int8_min_bytes: int = INT8_MIN_BUCKET_BYTES,
                    q_block: int | None = DEFAULT_QUANT_BLOCK) -> dict:
    """Bucketed allreduce of a whole tree of this rank's contributions —
    one collective a bucket, not a leaf. Returns the reduced tree."""
    paths, leaves = zip(*tree_flatten(tree)) if tree else ((), ())
    reduced = bucketed_all_reduce(
        list(leaves), mesh, axis, op, bucket_bytes=bucket_bytes,
        compress=compress, int8_min_bytes=int8_min_bytes, q_block=q_block)
    return tree_unflatten(paths, reduced)


@dataclasses.dataclass
class ScatteredTree:
    """Result of :func:`tree_reduce_scatter`: this rank's flat shard of
    every bucket (the one resident sharded form: grads here, moments and
    ZeRO-3 params in ``zero.ZeroState``). :meth:`gather` rebuilds the
    tree with one allgather a bucket."""

    paths: list
    buckets: list          # [(Bucket, this rank's shard)]
    mesh: object
    axis: str
    n_leaves: int

    def gather(self) -> dict:
        group, n = axis_group(self.mesh, self.axis), axis_n(self.mesh,
                                                            self.axis)
        leaves: list = [None] * self.n_leaves
        for b, shard in self.buckets:
            flat = _gather(shard, group, n).reshape(-1)
            for s, r in zip(b.slots, _unpack(flat, b.slots)):
                leaves[s.index] = r
        return tree_unflatten(self.paths, leaves)


def tree_reduce_scatter(tree: dict, mesh, axis: str = "data",
                        op: str = "sum", *,
                        bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                        compress: str | None = None,
                        int8_min_bytes: int = INT8_MIN_BUCKET_BYTES,
                        q_block: int | None = DEFAULT_QUANT_BLOCK
                        ) -> ScatteredTree:
    """Bucketed reduce-scatter of a tree: half the allreduce's bytes,
    this rank left with one flat shard a bucket."""
    pairs = tree_flatten(tree)
    paths, leaves = [p for p, _ in pairs], [x for _, x in pairs]
    pending = list(bucketed_reduce_scatter_stream(
        leaves, mesh, axis, op, bucket_bytes=bucket_bytes,
        compress=compress, int8_min_bytes=int8_min_bytes, q_block=q_block))
    return ScatteredTree(paths, [(b, red.wait()[0]) for b, red in pending],
                         mesh, axis, len(leaves))


# ------------------------------------------------ host-side wire codec


def quantize_leaf(x: torch.Tensor, q_block: int | None = DEFAULT_QUANT_BLOCK,
                  residual: torch.Tensor | None = None, *,
                  want_residual: bool = True):
    """Block-scaled int8 encoding of one tensor (+ an optional
    error-feedback residual added in before quantizing). Returns
    ``(wire_dict, new_residual)``; non-float tensors pass through
    unquantized (``new_residual=None``). ``want_residual=False`` skips
    the dequantize-and-subtract."""
    if not x.is_floating_point() or x.numel() == 0:
        return {_Q8_KEY: 0, "raw": x}, None
    flat = x.to(torch.float32).reshape(1, -1)
    if residual is not None and residual.numel() == x.numel():
        flat = flat + residual.reshape(1, -1).to(torch.float32)
    q, scale = _q_int8_blockwise(flat, q_block)
    new_res = None
    if want_residual:
        new_res = (flat - _dq_int8_blockwise(q, scale, flat.shape[1])
                   ).reshape(x.shape).to(x.dtype)
    return {_Q8_KEY: 1, "q": q[0], "s": scale[0], "shape": list(x.shape),
            "dtype": str(x.dtype).removeprefix("torch.")}, new_res


def dequantize_leaf(wire: dict) -> torch.Tensor:
    """Inverse of :func:`quantize_leaf`; ``q``/``s`` may be tensors or
    numpy arrays (a decoded wire)."""
    if not wire.get(_Q8_KEY):
        return wire["raw"]
    n = 1
    for d in wire["shape"]:
        n *= int(d)
    q, s = torch.as_tensor(wire["q"]), torch.as_tensor(wire["s"])
    out = _dq_int8_blockwise(q[None], s[None].to(q.device), n)
    return out.reshape(wire["shape"]).to(_DTYPES[wire["dtype"]])


def quantize_tree(tree: dict, q_block: int | None = DEFAULT_QUANT_BLOCK,
                  residuals: list | None = None, *,
                  want_residuals: bool = True):
    """Encode a tree for the RPC wire: ``({"__ptype_q8_tree__": [leaf
    wires in the reference's leaf order]}, new_residuals)``, a
    :func:`quantize_leaf` a leaf (``residuals[i]`` added into leaf i).
    The receiver reassembles against its own tree
    (:func:`dequantize_tree`): both ends of a param-server push share
    the parameter structure."""
    wires, new_res = [], []
    for i, (_, leaf) in enumerate(tree_flatten(tree)):
        r = residuals[i] if residuals is not None else None
        w, nr = quantize_leaf(leaf, q_block, r, want_residual=want_residuals)
        wires.append(w)
        new_res.append(nr)
    return {_Q8_TREE_KEY: wires}, new_res


def is_quantized_tree(obj) -> bool:
    return isinstance(obj, dict) and _Q8_TREE_KEY in obj


def dequantize_tree(obj: dict, like: dict) -> dict:
    """Decode :func:`quantize_tree` output into the structure of
    ``like`` (a tree with the same paths: the receiver's parameters)."""
    paths = [p for p, _ in tree_flatten(like)]
    wires = obj[_Q8_TREE_KEY]
    if len(wires) != len(paths):
        raise ValueError(f"dequantize_tree: {len(wires)} leaves on the "
                         f"wire, {len(paths)} in the tree")
    return tree_unflatten(paths, [dequantize_leaf(w) for w in wires])


# ------------------------------------------------------------ probes


def _drain(device: torch.device) -> None:
    """Wait for the device before a clock read (a CPU collective on gloo
    has returned when it is done)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _ring_bytes(n: int, nbytes: int) -> float:
    """Bytes a rank moves in a ring allreduce of ``nbytes``: 2(n-1)/n of
    them (0 at n = 1)."""
    return 2 * (n - 1) / n * nbytes


def allreduce_probe(mesh, axis: str = "data", mbytes: int = 64,
                    iters: int = 10) -> dict:
    """Time the exact allreduce of an ``mbytes`` MB f32 contribution over
    ``axis`` after one warm call: ``{"gbps", "ms", "payload_mb", "n"}``,
    ``ms`` a call. Every rank of the axis must call."""
    import time

    n = axis_n(mesh, axis)
    elems = mbytes * 1024 * 1024 // 4
    x = torch.ones(elems, dtype=torch.float32, device=mesh.device)
    all_reduce(x, mesh, axis, "sum")
    _drain(mesh.device)
    t0 = time.perf_counter()
    for _ in range(iters):
        all_reduce(x, mesh, axis, "sum")
    _drain(mesh.device)
    dt = (time.perf_counter() - t0) / iters
    return {"gbps": _ring_bytes(n, elems * 4) / dt / 1e9, "ms": dt * 1e3,
            "payload_mb": mbytes, "n": n}


def measure_allreduce_gbps(mesh, axis: str = "data", mbytes: int = 64,
                           iters: int = 10) -> float:
    """Measured algorithmic allreduce bandwidth (GB/s) over ``axis`` —
    the BASELINE "Store push/pull collective bandwidth" metric
    (:func:`allreduce_probe`'s ``gbps``)."""
    return allreduce_probe(mesh, axis, mbytes, iters)["gbps"]


def measure_wire_gbps(mesh, axis: str = "data", mbytes: int = 32,
                      iters: int = 5,
                      blocks: tuple = (256, 512, 1024)) -> dict:
    """Algorithmic bandwidth of one bucketed allreduce under each wire
    format: fp32 (exact), int8 with one scale a chunk, and the
    block-scaled int8 wire at each of ``blocks``.

    GB/s is app-level (f32 payload bytes reduced per second, ring
    convention 2(n-1)/n), so a wire that spends less time on the same
    payload scores higher whatever bytes it moved. ``wire_bytes_pct`` is
    the analytic wire footprint of each int8 format against fp32. Beside
    the reference's keys, ``*_ms`` give each format's milliseconds a
    call. Every rank of the axis must call."""
    import time

    n = axis_n(mesh, axis)
    elems = mbytes * 1024 * 1024 // 4
    leaf = torch.full((elems,), 0.5, dtype=torch.float32,
                      device=mesh.device)
    app_bytes = _ring_bytes(n, elems * 4)

    def timed(compress, q_block):
        def run():
            return bucketed_all_reduce(
                [leaf], mesh, axis, "sum", compress=compress,
                int8_min_bytes=0, q_block=q_block)[0]

        run()
        _drain(mesh.device)
        t0 = time.perf_counter()
        for _ in range(iters):
            run()
        _drain(mesh.device)
        dt = (time.perf_counter() - t0) / iters
        return round(app_bytes / dt / 1e9, 3), dt * 1e3

    def wire_pct(q_block):
        if q_block is None:
            q_block = elems // n
        return round(100.0 * (elems + elems / q_block * 4)
                     / (elems * 4), 2)

    fp32, chunk = timed(None, None), timed("int8", None)
    block = {str(b): timed("int8", b) for b in blocks}
    return {
        "payload_mb": mbytes,
        "fp32_gbps": fp32[0],
        "int8_chunk_gbps": chunk[0],
        "int8_chunk_wire_pct": wire_pct(None),
        "int8_block_gbps": {b: v[0] for b, v in block.items()},
        "int8_block_wire_pct": {str(b): wire_pct(b) for b in blocks},
        "fp32_ms": fp32[1],
        "int8_chunk_ms": chunk[1],
        "int8_block_ms": {b: v[1] for b, v in block.items()},
    }


def measure_hier_allreduce(topology: Topology | None = None,
                           mbytes: int = 16, iters: int = 5, group=None,
                           device=None) -> dict:
    """The hierarchical against the flat bucketed allreduce over the SAME
    composite mesh (``topology.mesh``, over ``group``, the default
    group when None; the reference's ``make hier-bench`` probe). Both
    at the exact wire, after one warm call each, the device drained
    before each clock read: ``flat_step_ms``, ``hier_step_ms``; the
    per-rank leg bytes of a hierarchical launch from the counters
    (``hier_slow_leg_bytes`` at most ``flat_outer_bytes / n_inner``);
    and the topology's model of the two (``model_*``). With no topology,
    one of the group's size: two domains when it is even and at least
    4, else one. Every rank of the group calls."""
    import time

    if topology is None:
        n = dist.get_world_size(group)
        no = 2 if n % 2 == 0 and n >= 4 else 1
        topology = Topology.emulated_host(no, max(n // no, 1))
    topo = topology
    mesh, ax = topo.mesh(group=group, device=device), topo.flat_axis
    elems = mbytes * 1024 * 1024 // 4
    payload = elems * 4
    leaf = torch.full((elems,), 0.5, dtype=torch.float32, device=mesh.device)

    def timed(**kw):
        bucketed_all_reduce([leaf], mesh, ax, "sum", **kw)
        _drain(mesh.device)
        t0 = time.perf_counter()
        for _ in range(iters):
            bucketed_all_reduce([leaf], mesh, ax, "sum", **kw)
        _drain(mesh.device)
        return (time.perf_counter() - t0) / iters * 1e3

    flat_ms = timed()
    keys = ("leg_bytes.inner", "leg_bytes.outer", "leg_bytes.flat_outer",
            "hier_launches")

    def snap():
        c = metrics.snapshot()["counters"]
        return {k: c.get(f"collectives.{k}", 0) for k in keys}

    base = snap()
    hier_ms = timed(topology=topo)
    d = {k: v - base[k] for k, v in snap().items()}
    launches = max(int(d["hier_launches"]), 1)
    slow = d["leg_bytes.outer"] / launches
    flat_outer = d["leg_bytes.flat_outer"] / launches
    model_flat = topo.flat_allreduce_ms(payload)
    model_hier = topo.hier_allreduce_ms(payload)
    return {
        "geometry": topo.describe(),
        "payload_mb": mbytes,
        "flat_step_ms": flat_ms,
        "hier_step_ms": hier_ms,
        "hier_slow_leg_bytes": int(slow),
        "hier_inner_leg_bytes": int(d["leg_bytes.inner"] / launches),
        "flat_outer_bytes": int(flat_outer),
        "slow_leg_pct": (round(100.0 * slow / flat_outer, 2)
                         if flat_outer else None),
        "model_flat_ms": round(model_flat, 3),
        "model_hier_ms": round(model_hier, 3),
        "model_speedup": (round(model_flat / model_hier, 2)
                          if model_hier else None),
    }
