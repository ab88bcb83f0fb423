"""Checkpoint / resume — sharded, async, Store-aware; the port of
``ptype_tpu/checkpoint.py``, with the same on-disk layout, so a step
directory written by either package restores in the other.

- :class:`Checkpointer` — save/restore a tree (nested dicts, lists and
  tuples) of tensors, numpy arrays and scalars. A :class:`Shard` leaf
  is this rank's block of a larger array: each rank writes only its own
  blocks, so a sharded state never materializes unsharded. ``restore``
  merges every manifest of the step, checks that the records tile each
  array exactly, checks each file's crc32, and returns tensors on the
  requested device (reshard-on-restore: the rank count that saved does
  not matter). ``async_save`` snapshots to host memory on the calling
  thread — on CUDA a copy into pinned buffers enqueued on the current
  stream, so a later in-place step cannot overtake it — and writes the
  files on a background thread that first waits for the copy.

  **Several ranks**: a Checkpointer given a ``mesh`` takes its writer
  index and count from the mesh's process group (after an elastic
  reshard, the survivors' group). Each rank writes its own shards plus
  ``manifest.p<i>.json`` into the shared step directory; replicated
  leaves are written by rank 0 of the group (the reference's
  ``replica_id == 0`` rule); rank 0 polls for all N manifests, then
  commits the marker.
- :class:`ZeroCheckpoint` — the sharded ZeRO optimizer state: each
  rank's own moment (and ZeRO-3 param) shards, the plan manifest
  riding the commit; restore reads only the records that overlap this
  rank's new shard, re-padded for the restoring rank count.
- :class:`StoreCheckpoint` — a TensorStore namespace (values plus
  spec/epoch manifest); ``resume()`` re-puts every key with its binding.

Layout (one directory per step)::

    <dir>/step_<N>/manifest.json                (single-writer saves)
    <dir>/step_<N>/manifest.p<i>.json           (one per rank)
    <dir>/step_<N>/<flat-key>[.p<i>].shard<j>.npy
    <dir>/step_<N>/.complete          (commit marker, written last)

bfloat16 has no numpy dtype here (the port never imports
``ml_dtypes``): a bf16 block is written as the reference writes it, its
raw bytes as a uint8 array with ``"raw": true`` and the logical dtype
``"bfloat16"`` in the manifest, and read back through torch.
"""

from __future__ import annotations

import dataclasses
import glob as _glob
import json
import os
import shutil
import threading
import time
import zlib
from typing import Any

import numpy as np
import torch

from ptype_tpu_torch import chaos, logs, retry
from ptype_tpu_torch.device import resolve_device
from ptype_tpu_torch.errors import CheckpointError, ClusterError
from ptype_tpu_torch.metrics import annotate
from ptype_tpu_torch.parallel.mesh import block_of

log = logs.get_logger("checkpoint")

_MANIFEST = "manifest.json"
_COMPLETE = ".complete"


@dataclasses.dataclass(frozen=True)
class Shard:
    """A leaf that is this rank's block of a larger array: ``local``
    (a tensor or numpy array) placed at ``start`` in an array of
    ``shape``. The writer records the block as this rank's own."""

    local: Any
    start: tuple
    shape: tuple


# ------------------------------------------------------------ trees


def _flat_key(path) -> str:
    """The reference's flat key of a tree path: the parts joined by
    ".", a "/" inside a part escaped (store keys become filenames)."""
    parts = [str(p).replace("/", "%2F") for p in path]
    return ".".join(parts) or "_root"


def _flatten(tree, path: tuple = ()) -> list:
    """(path, leaf) pairs in the reference's order: dict keys sorted,
    sequences by index; None is an empty subtree."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], path + (k,))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten(v, path + (i,))
        return out
    if tree is None:
        return []
    return [(path, tree)]


def _rebuild(tree, fn, path: tuple = ()):
    """``tree`` with every leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, fn, path + (i,))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree)


def _dtype_name(dt) -> str:
    if isinstance(dt, torch.dtype):
        return str(dt).removeprefix("torch.")
    return np.dtype(dt).name


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise CheckpointError(f"restore: unknown dtype {name!r}")
    return dt


def _as_host(x) -> np.ndarray | torch.Tensor:
    """A leaf's value as numpy (Python scalars as the reference's
    default 32-bit types) or a tensor."""
    if torch.is_tensor(x):
        return x.detach()
    if isinstance(x, bool):
        return np.asarray(x)
    if isinstance(x, int):
        return np.asarray(x, np.int32)
    if isinstance(x, float):
        return np.asarray(x, np.float32)
    return np.asarray(x)


def _host_bytes(data) -> tuple[np.ndarray, bool]:
    """(numpy array to write, raw): bf16 as its raw bytes (uint8)."""
    if torch.is_tensor(data):
        data = data.contiguous()
        if data.dtype == torch.bfloat16:
            return data.reshape(-1).view(torch.uint8).numpy(), True
        data = data.numpy()
    # As the reference writes it: a 0-d block becomes shape (1,).
    return np.ascontiguousarray(data), False


class _Snapshot:
    """Host copies of this rank's owned blocks: ``[(key, [(start,
    host), ...], meta)]``; ``ready()`` waits for pending device copies."""

    def __init__(self, entries: list, event=None):
        self.entries = entries
        self._event = event

    def ready(self) -> list:
        if self._event is not None:
            self._event.synchronize()
            self._event = None
        return self.entries


class Checkpointer:
    """Sharded tree checkpoints under ``directory``.

    ``mesh`` (a :class:`~ptype_tpu_torch.parallel.mesh.Mesh`) makes the
    saves multi-writer over its group; without one this process is the
    only writer. ``barrier_timeout`` bounds how long rank 0 waits for
    the other ranks' manifests before declaring a save failed (no
    commit marker is written: the step stays invisible)."""

    def __init__(self, directory: str, keep: int = 3,
                 barrier_timeout: float = 120.0, mesh=None):
        self.directory = directory
        self.keep = keep
        self.barrier_timeout = barrier_timeout
        self.mesh = mesh
        os.makedirs(directory, exist_ok=True)
        self._pending: threading.Thread | None = None
        self._pending_error: BaseException | None = None
        self._seq = 0
        #: Pinned host buffers of CUDA snapshots, reused across saves.
        self._pinned: dict = {}
        #: Seconds of the last snapshot (on the calling thread) and of
        #: the last file write (on whichever thread wrote).
        self.last_snapshot_s: float | None = None
        self.last_write_s: float | None = None

    def _proc_info(self) -> tuple[int, int]:
        """(writer index, writer count): the mesh group's, else (0, 1)."""
        if self.mesh is None:
            return 0, 1
        return int(self.mesh.rank), int(self.mesh.size)

    # ------------------------------------------------------------- save

    def save(self, step: int, tree: Any,
             extras: dict[str, str] | None = None) -> str:
        """Synchronous save; returns the step directory. ``extras`` are
        additional ``{filename: json-text}`` committed WITH the step
        (written before the completion marker). Waits for any pending
        async save first — one writer at a time per Checkpointer. A
        ``checkpoint.save/<step>`` region."""
        with annotate(f"checkpoint.save/{step}"):
            self.wait()
            host = self._snapshot(tree)
            return self._write(step, host.ready(), extras)

    def async_save(self, step: int, tree: Any) -> None:
        """Snapshot now, write in the background. At most one pending
        write: a second call waits for the first. A failed background
        write re-raises from the NEXT ``wait``/``save``/``async_save``.
        Only the snapshot (a ``checkpoint.snapshot/<step>`` region) holds
        the calling thread; on CUDA it enqueues the copies and returns
        without waiting for them."""
        with annotate(f"checkpoint.snapshot/{step}"):
            self.wait()
            host = self._snapshot(tree)

        def run():
            try:
                self._write(step, host.ready())
            except Exception as e:  # noqa: BLE001 — re-raised on wait()
                self._pending_error = e

        self._pending = threading.Thread(target=run, name=f"ckpt-{step}",
                                         daemon=True)
        self._pending.start()

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        err = self._pending_error
        if err is not None:
            self._pending_error = None
            raise ClusterError(f"async checkpoint save failed: {err}") \
                from err

    def _host_copy(self, key: str, t: torch.Tensor, stream) -> torch.Tensor:
        """A host copy of ``t``: pinned and enqueued on ``stream`` for a
        CUDA tensor, a clone for a CPU one (the step updates in place)."""
        if t.device.type != "cuda":
            return t.clone()
        slot = (key, tuple(t.shape), t.dtype)
        buf = self._pinned.get(slot)
        if buf is None:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._pinned[slot] = buf
        with torch.cuda.stream(stream):
            buf.copy_(t, non_blocking=True)
        return buf

    def _snapshot(self, tree: Any) -> _Snapshot:
        """This rank's OWNED blocks in host memory: its :class:`Shard`
        leaves, plus every other leaf on rank 0 (replicated leaves are
        identical everywhere, so one owner tiles each array once)."""
        t0 = time.perf_counter()
        pid, _ = self._proc_info()
        stream, event = None, None
        out = []
        for path, leaf in _flatten(tree):
            key = _flat_key(path)
            if isinstance(leaf, Shard):
                local = _as_host(leaf.local)
                owned = [(list(leaf.start), local)]
                shape = list(leaf.shape)
            else:
                local = _as_host(leaf)
                owned = [([0] * local.ndim, local)] if pid == 0 else []
                shape = list(local.shape)
            meta = {"shape": shape, "dtype": _dtype_name(local.dtype)}
            blocks = []
            for start, data in owned:
                if torch.is_tensor(data):
                    if data.device.type == "cuda" and stream is None:
                        stream = torch.cuda.current_stream(data.device)
                    data = self._host_copy(key, data, stream)
                else:
                    data = np.array(data, copy=True)
                blocks.append((start, data))
            out.append((key, blocks, meta))
        if stream is not None:
            event = torch.cuda.Event()
            event.record(stream)
        self.last_snapshot_s = time.perf_counter() - t0
        return _Snapshot(out, event)

    def _write(self, step: int, host: list,
               extras: dict[str, str] | None = None) -> str:
        t0 = time.perf_counter()
        pid, nproc = self._proc_info()
        if nproc == 1:
            out = self._write_single(step, host, extras)
        else:
            out = self._write_multi(step, host, extras, pid, nproc)
        self.last_write_s = time.perf_counter() - t0
        return out

    def _write_single(self, step: int, host: list,
                      extras: dict[str, str] | None) -> str:
        final = self._step_dir(step)
        # Unique per process AND per write: a sync save racing a stale
        # async writer must never share (or rmtree) the other's tmp dir.
        self._seq += 1
        tmp = f"{final}.tmp.{os.getpid()}.{self._seq}"
        os.makedirs(tmp)
        manifest = {"step": step, "leaves": {}}
        for key, shards, meta in host:
            files = []
            for i, (start, data) in enumerate(shards):
                fname = f"{key}.shard{i}.npy"
                files.append(_save_shard(tmp, fname, start, data))
            manifest["leaves"][key] = {**meta, "shards": files}
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump(manifest, f)
        for fname, text in (extras or {}).items():
            with open(os.path.join(tmp, fname), "w") as f:
                f.write(text)
        f = chaos.hit("checkpoint.commit", str(step))
        if f is not None and f.action == "crash":
            # Every shard and the manifest are on disk in the tmp dir,
            # but the step never becomes visible: restore() falls back
            # to the previous complete step.
            raise CheckpointError(
                f"chaos: crashed before committing step {step} "
                f"(uncommitted shards left in {tmp})")
        with open(os.path.join(tmp, _COMPLETE), "w") as f:
            f.write("ok\n")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()
        log.info("checkpoint saved", kv={"step": step, "dir": final})
        chaos.note_ok("checkpoint.save", final)
        return final

    def _write_multi(self, step: int, host: list,
                     extras: dict[str, str] | None,
                     pid: int, nproc: int) -> str:
        """Save into a SHARED step dir: every rank writes its owned
        shards + ``manifest.p<pid>.json`` (each file via tmp+rename);
        rank 0 polls for all N manifests and then writes the completion
        marker. A crashed peer ⇒ barrier timeout ⇒ no marker ⇒ restore
        ignores the step (never a silent partial)."""
        final = self._step_dir(step)
        os.makedirs(final, exist_ok=True)
        if os.path.exists(os.path.join(final, _COMPLETE)):
            # A COMMITTED checkpoint of this step exists: rewriting in
            # place would delete its marker before the new save
            # commits. Keep it, unless what we were asked to save has a
            # different parameter space (keys/shapes/dtypes).
            mf_path = os.path.join(final, f"manifest.p{pid}.json")
            committed = None
            try:
                with open(mf_path) as f:
                    committed = json.load(f).get("leaves", {})
            except (OSError, ValueError):
                pass  # unreadable: keep-and-warn
            if committed is not None:
                mine = json.loads(json.dumps(
                    {key: meta for key, _, meta in host}))
                theirs = {k: {a: b for a, b in v.items() if a != "shards"}
                          for k, v in committed.items()}
                if mine != theirs:
                    raise ClusterError(
                        f"checkpoint step {step} is already committed "
                        f"with a different parameter space — refusing "
                        f"to silently keep the stale copy; delete "
                        f"{final} to re-save this step")
            log.warning(
                "checkpoint step already committed; keeping the "
                "committed copy (tensor values are not compared)",
                kv={"step": step, "dir": final, "process": pid})
            return final
        # Stale-attempt debris must never satisfy the barrier: rank 0
        # clears EVERY old manifest before writing anything; peers
        # clear their own.
        if pid == 0:
            for p in _glob.glob(
                    os.path.join(_glob.escape(final), "manifest*.json")):
                os.unlink(p)
            _rm_f(os.path.join(final, _COMPLETE))
        else:
            _rm_f(os.path.join(final, f"manifest.p{pid}.json"))
        manifest = {"step": step, "process": pid,
                    "num_processes": nproc, "leaves": {}}
        for key, shards, meta in host:
            files = []
            for i, (start, data) in enumerate(shards):
                fname = f"{key}.p{pid}.shard{i}.npy"
                files.append(_save_shard(final, fname, start, data))
            manifest["leaves"][key] = {**meta, "shards": files}
        mf_name = f"manifest.p{pid}.json"
        mf_json = json.dumps(manifest)
        _atomic_write(final, mf_name, mf_json)
        deadline = time.monotonic() + self.barrier_timeout
        if pid == 0:
            pat = os.path.join(_glob.escape(final), "manifest.p*.json")
            barrier_bo = retry.Backoff(base=0.05, cap=0.25)
            while len(_glob.glob(pat)) < nproc:
                if time.monotonic() > deadline:
                    _rm_f(os.path.join(final, "manifest.p0.json"))
                    raise ClusterError(
                        f"checkpoint step {step}: only "
                        f"{len(_glob.glob(pat))}/{nproc} process "
                        f"manifests arrived within {self.barrier_timeout}s"
                        " — not committing")
                barrier_bo.sleep()
            f = chaos.hit("checkpoint.commit", str(step))
            if f is not None and f.action == "crash":
                raise CheckpointError(
                    f"chaos: crashed before committing step {step} "
                    f"(no {_COMPLETE} marker written)")
            for fname, text in (extras or {}).items():
                _atomic_write(final, fname, text)
            _atomic_write(final, _COMPLETE, "ok\n")
            self._gc()
        else:
            # Hold until rank 0 commits, RE-ASSERTING our manifest: a
            # peer that outran rank 0 has its manifest swept by rank
            # 0's debris cleanup.
            marker = os.path.join(final, _COMPLETE)
            mf_path = os.path.join(final, mf_name)
            commit_bo = retry.Backoff(base=0.2, cap=0.5)
            while not os.path.exists(marker):
                if time.monotonic() > deadline:
                    raise ClusterError(
                        f"checkpoint step {step}: process 0 did not "
                        f"commit within {self.barrier_timeout}s")
                if not os.path.exists(mf_path):
                    _atomic_write(final, mf_name, mf_json)
                commit_bo.sleep()
        log.info("checkpoint shards saved",
                 kv={"step": step, "dir": final, "process": pid})
        chaos.note_ok("checkpoint.save", final)
        return final

    # ---------------------------------------------------------- restore

    def steps(self) -> list[int]:
        """Complete checkpoint steps, ascending."""
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and os.path.exists(
                    os.path.join(self.directory, name, _COMPLETE)):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    continue
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def _resolve_step(self, step: int | None) -> int:
        if step is None:
            step = self.latest_step()
            if step is None:
                raise ClusterError(
                    f"no complete checkpoint under {self.directory}")
        return step

    def restore(self, tree_like: Any, step: int | None = None,
                device=None, placements: Any | None = None) -> Any:
        """Rebuild the tree saved at ``step`` (default: latest) in the
        shape of ``tree_like`` (any tree with the saved leaves' paths;
        its leaf values are ignored), each leaf a tensor of the saved
        dtype on ``device``. With ``placements`` (a matching tree of
        placement tuples) each leaf is this rank's block on the
        checkpointer's mesh, and only that block is read. Entry point:
        ``cuda`` unless ``device`` names another. A
        ``checkpoint.restore/<step>`` region."""
        device = resolve_device(device)
        step = self._resolve_step(step)
        if placements is not None and self.mesh is None:
            raise ClusterError("restore: placements need the "
                               "Checkpointer's mesh")
        with annotate(f"checkpoint.restore/{step}"):
            reader = self.reader(step)

            def leaf(path, _):
                key = _flat_key(path)
                spec = None
                if placements is not None:
                    spec = placements
                    for p in path:
                        spec = spec[p]
                if not any(spec or ()):
                    return reader.read(key).to(device)
                start, size = block_of(reader.entry(key)["shape"], spec,
                                       self.mesh)
                return reader.read_block(key, start, size).to(device)

            out = _rebuild(tree_like, leaf)
            chaos.note_ok("checkpoint.restore", str(step))
            return out

    def reader(self, step: int | None = None) -> "StepReader":
        """A reader of one complete step's merged manifest, for whole
        leaves or rows of them."""
        step = self._resolve_step(step)
        return StepReader(self._step_dir(step), step)

    # ----------------------------------------------------------- intern

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}")

    def _gc(self) -> None:
        steps = self.steps()
        for old in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(self._step_dir(old), ignore_errors=True)


class StepReader:
    """The leaves of one step directory: ``read(key)`` the whole array,
    ``read(key, lo, hi)`` rows ``[lo, hi)`` of dim 0, ``read_block`` a
    block on any dims, loading only the shard files that overlap them
    (each checked against its crc32)."""

    def __init__(self, sdir: str, step: int):
        self.sdir = sdir
        self.step = step
        self.manifest = _merged_manifest(sdir, step)

    def entry(self, key: str) -> dict:
        entry = self.manifest["leaves"].get(key)
        if entry is None:
            raise ClusterError(
                f"restore: checkpoint {self.step} has no leaf {key!r}")
        return entry

    def read(self, key: str, lo: int | None = None,
             hi: int | None = None) -> torch.Tensor:
        entry = self.entry(key)
        shape = list(entry["shape"])
        if not shape:
            return self.read_block(key, [], [])
        lo = 0 if lo is None else int(lo)
        hi = shape[0] if hi is None else int(hi)
        if not 0 <= lo <= hi <= shape[0]:
            raise ClusterError(f"restore: rows [{lo}, {hi}) of {key!r} "
                               f"outside its {shape[0]}")
        return self.read_block(key, [lo] + [0] * (len(shape) - 1),
                               [hi - lo] + shape[1:])

    def read_block(self, key: str, start, size) -> torch.Tensor:
        """The block of ``key`` at ``start`` of ``size`` (one entry a
        dim), loading only the shard files that overlap it."""
        entry = self.entry(key)
        dtype = _torch_dtype(entry["dtype"])
        shape = list(entry["shape"])
        if not shape:
            return _load_shard(self.sdir, entry["shards"][0],
                               dtype).reshape(())
        _check_tiling(key, entry["shards"], shape)
        start, size = [int(a) for a in start], [int(n) for n in size]
        if len(start) != len(shape) or any(
                a < 0 or n < 0 or a + n > d
                for a, n, d in zip(start, size, shape)):
            raise ClusterError(f"restore: block at {start} of {size} of "
                               f"{key!r} outside its {shape}")
        out = torch.zeros(size, dtype=dtype)
        for rec in entry["shards"]:
            box = list(zip(rec["start"], rec["shape"]))
            lo = [max(a, s0) for a, (s0, _) in zip(start, box)]
            hi = [min(a + n, s0 + n0)
                  for a, n, (s0, n0) in zip(start, size, box)]
            if any(a >= b for a, b in zip(lo, hi)):
                continue
            data = _load_shard(self.sdir, rec, dtype)
            src = tuple(slice(a - s0, b - s0)
                        for a, b, (s0, _) in zip(lo, hi, box))
            dst = tuple(slice(a - s, b - s)
                        for a, b, s in zip(lo, hi, start))
            out[dst] = data[src]
        return out


def _save_shard(dirpath: str, fname: str, start: list, data) -> dict:
    """Write one shard file (tmp+rename — shared multi-writer dirs must
    never expose partial files) and return its manifest record, which
    carries a crc32 of the logical bytes so restore can tell disk
    corruption from a clean load."""
    arr, raw = _host_bytes(data)
    shape = list(data.shape if raw else arr.shape)
    tmp = os.path.join(dirpath, f".tmp.{fname}.{os.getpid()}")
    with open(tmp, "wb") as f:
        crc = zlib.crc32(arr) & 0xFFFFFFFF
        np.save(f, arr)
    os.replace(tmp, os.path.join(dirpath, fname))
    cf = chaos.hit("checkpoint.shard", fname)
    if cf is not None and cf.action == "corrupt":
        _corrupt_file(os.path.join(dirpath, fname))
    return {"file": fname, "start": start, "shape": shape, "raw": raw,
            "crc32": crc}


def _corrupt_file(path: str) -> None:
    """Chaos ``checkpoint.shard``/``corrupt``: flip one byte in the
    middle of the file AFTER the manifest checksum was computed — the
    bit-rot restore must catch, never silently load."""
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.seek(size // 2)
        b = f.read(1) or b"\x00"
        f.seek(size // 2)
        f.write(bytes([b[0] ^ 0xFF]))


def _atomic_write(dirpath: str, fname: str, text: str) -> None:
    tmp = os.path.join(dirpath, f".tmp.{fname}.{os.getpid()}")
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, os.path.join(dirpath, fname))


def _rm_f(path: str) -> None:
    try:
        os.unlink(path)
    except FileNotFoundError:
        pass


def _merged_manifest(sdir: str, step: int) -> dict:
    """Union of the step's manifests: the single-writer ``manifest.json``
    and/or every per-rank ``manifest.p<i>.json``. Shard lists
    concatenate; duplicate boxes keep the first occurrence."""
    paths = sorted(_glob.glob(
        os.path.join(_glob.escape(sdir), "manifest*.json")))
    if not paths:
        raise ClusterError(f"restore: step {step} has no manifest")
    per_proc = [p for p in paths if os.path.basename(p) != "manifest.json"]
    if per_proc and len(per_proc) != len(paths):
        raise ClusterError(
            f"restore: step {step} mixes a single-writer manifest.json "
            f"with per-process manifests — two save modes' debris")
    merged: dict[str, dict] = {}
    expected_nproc: int | None = None
    for path in paths:
        with open(path) as f:
            m = json.load(f)
        nproc = m.get("num_processes")
        if nproc is not None:
            if expected_nproc is None:
                expected_nproc = nproc
            elif nproc != expected_nproc:
                raise ClusterError(
                    f"restore: step {step} manifests disagree on "
                    f"num_processes ({expected_nproc} vs {nproc}) — "
                    "mixed save attempts")
        for key, entry in m["leaves"].items():
            tgt = merged.setdefault(
                key, {k: v for k, v in entry.items() if k != "shards"})
            tgt.setdefault("shards", []).extend(entry["shards"])
    if expected_nproc is not None and len(per_proc) != expected_nproc:
        raise ClusterError(
            f"restore: step {step} has {len(per_proc)} process manifests "
            f"but the save ran with num_processes={expected_nproc} — "
            "incomplete (uncommitted?) save")
    for entry in merged.values():
        seen: set[tuple] = set()
        uniq = []
        for rec in entry["shards"]:
            box = (tuple(rec["start"]), tuple(rec["shape"]))
            if box in seen:
                continue
            seen.add(box)
            uniq.append(rec)
        entry["shards"] = uniq
    return {"step": step, "leaves": merged}


def _load_shard(sdir: str, rec: dict, dtype: torch.dtype) -> torch.Tensor:
    try:
        loaded = np.load(os.path.join(sdir, rec["file"]))
    except (OSError, ValueError) as e:
        # Corruption can land in the npy header: same contract as a
        # checksum mismatch — name the shard.
        raise CheckpointError(
            f"restore: shard {rec['file']!r} is corrupt "
            f"(unreadable: {e})") from e
    want = rec.get("crc32")
    if want is not None:
        got = zlib.crc32(np.ascontiguousarray(loaded)) & 0xFFFFFFFF
        if got != want:
            raise CheckpointError(
                f"restore: shard {rec['file']!r} is corrupt: crc32 "
                f"{got:#010x} != manifest {want:#010x}")
    t = torch.from_numpy(np.ascontiguousarray(loaded))
    if rec.get("raw"):
        t = t.view(dtype)
    elif t.dtype != dtype:
        raise CheckpointError(
            f"restore: shard {rec['file']!r} holds {t.dtype}, the "
            f"manifest says {dtype}")
    return t.reshape(rec["shape"])


def _check_tiling(key: str, shards: list[dict], shape: list[int]) -> None:
    """Shards must tile the array exactly: total element count matches
    AND no two boxes overlap (a raw count can be satisfied by overlaps
    masking gaps)."""
    total = int(np.prod(shape)) if shape else 1
    boxes = [(tuple(r["start"]), tuple(r["shape"])) for r in shards]
    covered = sum(int(np.prod(s)) for _, s in boxes)
    overlap = any(
        all(a0 < b0 + bs and b0 < a0 + as_
            for a0, as_, b0, bs in zip(sa, za, sb, zb))
        for i, (sa, za) in enumerate(boxes)
        for sb, zb in boxes[i + 1:])
    if covered != total or overlap:
        raise ClusterError(
            f"restore: leaf {key!r} shards cover {covered} of {total} "
            f"elements{' with overlaps' if overlap else ''} — corrupt "
            "or partial checkpoint (saved from a different process set?)")


class ZeroCheckpoint:
    """Checkpoint tier for the sharded ZeRO optimizer state
    (:class:`~ptype_tpu_torch.parallel.zero.ZeroState`): each rank writes
    its OWN moment shards (``start = rank · shard_len``, one crc32'd
    file each) and, under ZeRO-3, its param shards; rank 0 writes the
    step count. The shard plan rides the commit as ``zero_plan.json``,
    which makes restore reshardable: bucket slots do not depend on the
    rank count, only the tail pads do, so a state saved by n ranks
    restores onto m. A corrupt shard raises
    :class:`~ptype_tpu_torch.errors.CheckpointError` naming the file."""

    def __init__(self, directory: str, keep: int = 3):
        self._ckpt = Checkpointer(directory, keep=keep)

    def latest_step(self) -> int | None:
        return self._ckpt.latest_step()

    def save(self, step: int, zero_state) -> str:
        """Persist this rank's shards + the count + the plan manifest as
        one committed step dir (every rank of the state's group calls)."""
        self._ckpt.mesh = zero_state.mesh
        return self._ckpt.save(
            step, zero_state.shard_tree(),
            extras={"zero_plan.json": json.dumps(
                zero_state.plan.manifest())})

    def restore_into(self, zero_state, step: int | None = None) -> int:
        """Load a saved step INTO an existing ZeroState (whose plan
        defines the restoring rank count), resharding when the saved
        count differs; each rank reads only the records overlapping its
        new shards. Returns the restored step."""
        step = step if step is not None else self._ckpt.latest_step()
        if step is None:
            raise ClusterError(
                f"ZeroCheckpoint: no complete step under "
                f"{self._ckpt.directory}")
        sdir = self._ckpt._step_dir(step)
        try:
            with open(os.path.join(sdir, "zero_plan.json")) as f:
                saved_plan = json.load(f)
        except (OSError, ValueError) as e:
            raise CheckpointError(
                f"ZeroCheckpoint: step {step} has no readable "
                f"zero_plan.json ({e}) — not a sharded-optimizer "
                f"checkpoint") from e
        zero_state.load_shards(self._ckpt.reader(step), saved_plan)
        return step


class StoreCheckpoint:
    """Persist / resume a TensorStore namespace (the Store tier).
    Resume is "Join + Store pull": a fresh member calls ``resume()``
    and the parameter space reappears with its bindings. Every rank of
    the store's mesh calls both: each writes its own shards of sharded
    keys, rank 0 the replicated ones."""

    def __init__(self, store, directory: str, keep: int = 3,
                 keys_prefix: str | None = None):
        from ptype_tpu_torch.parallel.tensorstore import TensorStore

        if not isinstance(store, TensorStore):
            raise TypeError("StoreCheckpoint needs a TensorStore")
        self.store = store
        #: Persist only keys under this prefix (e.g. ``"params/"``): a
        #: training store also holds transient grads/*.
        self.keys_prefix = keys_prefix
        self._ckpt = Checkpointer(directory, keep=keep)

    def latest_step(self) -> int | None:
        return self._ckpt.latest_step()

    def save(self, step: int | None = None) -> str:
        from ptype_tpu_torch.parallel.tensorstore import spec_to_json

        store = self.store
        keys = store.keys()
        if self.keys_prefix:
            keys = [k for k in keys if k.startswith(self.keys_prefix)]
        tree = {k: store.shard_leaf(k) for k in keys}
        step = step if step is not None else max(
            (store.epoch(k) for k in keys), default=0)
        meta = {k: {"spec": spec_to_json(store.binding(k).spec),
                    "epoch": store.epoch(k)} for k in keys}
        # Meta rides the step's atomic commit (written before .complete).
        self._ckpt.mesh = store.mesh
        return self._ckpt.save(
            step, tree, extras={"store_meta.json": json.dumps(meta)})

    def resume(self, step: int | None = None) -> list[str]:
        """Load the latest (or given) step back into the store; returns
        the restored keys."""
        from ptype_tpu_torch.parallel.tensorstore import spec_from_json

        step = step if step is not None else self._ckpt.latest_step()
        if step is None:
            raise ClusterError("StoreCheckpoint: nothing to resume from")
        sdir = self._ckpt._step_dir(step)
        with open(os.path.join(sdir, "store_meta.json")) as f:
            meta = json.load(f)
        reader = self._ckpt.reader(step)
        for key in sorted(meta):
            self.store.put(key, reader.read(_flat_key((key,))),
                           spec=spec_from_json(meta[key]["spec"]),
                           epoch=int(meta[key].get("epoch", 0)))
        return sorted(meta)
