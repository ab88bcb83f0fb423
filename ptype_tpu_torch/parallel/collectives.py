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

Not ported yet (ROADMAP A7): the hierarchical two-leg bodies and the
``measure_*`` probes.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ptype_tpu_torch.metrics import metrics
from ptype_tpu_torch.parallel.mesh import axis_group, axis_index, axis_n

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
        #: The bucket's wire format (None: exact).
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


def bucketed_all_reduce_stream(leaves, mesh, axis: str = "data",
                               op: str = "sum", *,
                               bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                               compress: str | None = None,
                               int8_min_bytes: int = INT8_MIN_BUCKET_BYTES,
                               q_block: int | None = DEFAULT_QUANT_BLOCK,
                               residuals: list | None = None):
    """Dispatch one collective per bucket of ``leaves`` (this rank's
    contributions) and yield ``(bucket, reduction)`` right after each
    dispatch; ``reduction.wait()`` gives ``(reduced_by_slot,
    new_residuals_by_slot | None)``. A consumer can apply bucket i
    while buckets i+1.. are on the wire.

    ``residuals``: per-leaf error-feedback residuals aligned with
    ``leaves`` (None entries seed zeros). They engage only on buckets
    whose wire resolves to int8; other buckets give ``None``."""
    _check_stream_args("bucketed_all_reduce", op, _REDUCERS, compress)
    group, n = axis_group(mesh, axis), axis_n(mesh, axis)
    restore = compress is not None
    for b in plan_buckets(leaves, n, bucket_bytes):
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
                        residuals: list | None = None):
    """Allreduce a list of leaves through dtype buckets, every bucket on
    the wire before the first wait. Returns the reduced leaves in input
    order; with ``residuals``, ``(reduced, new_residuals)`` where a leaf
    that rode no int8 bucket keeps its input residual."""
    pending = list(bucketed_all_reduce_stream(
        leaves, mesh, axis, op, bucket_bytes=bucket_bytes,
        compress=compress, int8_min_bytes=int8_min_bytes, q_block=q_block,
        residuals=residuals))
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
                                   residuals: list | None = None):
    """The ZeRO gradient leg: one reduce-scatter per bucket, yielding
    ``(bucket, reduction)``; ``reduction.wait()`` gives ``(shard,
    new_residuals_by_slot | None)``, ``shard`` being this rank's
    contiguous ``elems/n`` piece of the bucket's reduced flat (half the
    allreduce's bytes, and the form the shard-local optimizer reads).
    Under int8+EF the residual is the phase-1 error of this rank's
    whole contribution: the scatter has no gather leg."""
    _check_stream_args("bucketed_reduce_scatter", op, ("sum", "mean"),
                       compress)
    group, n = axis_group(mesh, axis), axis_n(mesh, axis)
    restore = compress is not None
    for b in plan_buckets(leaves, n, bucket_bytes):
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
