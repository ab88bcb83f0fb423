"""Optimus trainer — the port's twin of ``examples/optimus/trainer.py``.

Join the cluster described by ``$CONFIG`` and train a transformer on a
synthetic token stream, with the reference's environment knobs and
printed lines (the banner, ``step … loss …``, ``resumed …`` and
``checkpointed step N``). Two modes:

- ``gspmd`` (default): the port's :class:`~ptype_tpu_torch.train.Trainer`
  on one device, with ``Checkpointer`` save and resume;
- ``store``: Store-backed DP (``train/store_dp.py``) — push/pull IS the
  gradient exchange, manifests published through the cluster's KV.

Env knobs: PRESET (optimus-125m), STEPS, BATCH, SEQ, MODE,
LR/WARMUP/WEIGHT_DECAY/DECAY_STEPS (optimizer), METRICS_PATH (JSONL
sink), COMPRESS (store mode: bf16|int8 gradient-push wire compression),
ZERO=1 (store mode: sharded weight update, ``ZeroCheckpoint`` beside the
params), CKPT_DIR and CKPT_EVERY (save/resume), and PTYPE_DEVICE (the
device, ``cuda`` when unset; set it to ``cpu`` to train on the CPU).

Not ported: ``MODE=async`` (the parameter server, ROADMAP A8) and
``SHARD_UPDATE=1`` (the trainer's shardings, ROADMAP A6(a)) raise.
"""

from __future__ import annotations

import math
import os
import socket

from ptype_tpu_torch.cluster import join
from ptype_tpu_torch.config import config_from_env
from ptype_tpu_torch.device import resolve_device
from ptype_tpu_torch.models import transformer as tfm
from ptype_tpu_torch.train.data import synthetic_batches


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _own_process_group(platform, device) -> bool:
    """Make the world-1 process group a one-process store run needs (a
    multi-process run joins its group inside ``join``; a group made by
    the caller is reused). Returns True when this made it."""
    import torch.distributed as dist

    from ptype_tpu_torch.parallel.mesh import init_distributed

    if dist.is_initialized() or platform.num_processes > 1:
        return False
    init_distributed(f"tcp://127.0.0.1:{_free_port()}", 0, 1, device)
    return True


def _mfu(out) -> str:
    return "n/a" if out["mfu"] is None else f"{out['mfu']:.3f}"


def main() -> None:
    cfg = config_from_env()
    mode = os.environ.get("MODE", "gspmd")
    if mode == "async":
        raise NotImplementedError(
            "optimus trainer: MODE=async needs the parameter server "
            "(train/param_server.py), which the port does not have yet "
            "(ROADMAP A8)")
    if mode not in ("gspmd", "store"):
        raise SystemExit(f"unknown MODE {mode!r}")
    if mode == "gspmd" and os.environ.get("SHARD_UPDATE") == "1":
        raise NotImplementedError(
            "optimus trainer: SHARD_UPDATE=1 needs the trainer's "
            "shardings, which the port does not have yet (ROADMAP A6(a))")
    n_axes = math.prod(cfg.platform.mesh_axes.values())
    if mode == "gspmd" and n_axes > 1:
        raise NotImplementedError(
            f"optimus trainer: MODE=gspmd over mesh axes "
            f"{cfg.platform.mesh_axes} needs the trainer's shardings "
            "(ROADMAP A6(a)); the port's Trainer runs on one device")
    device = resolve_device(os.environ.get("PTYPE_DEVICE") or None)

    # Optimizer knobs ($LR/$WARMUP/$WEIGHT_DECAY/$DECAY_STEPS) and a
    # JSONL metrics sink ($METRICS_PATH — tail-able, one line per log
    # interval) for real runs.
    from ptype_tpu_torch.train.trainer import default_optimizer

    optimizer = default_optimizer(
        lr=float(os.environ.get("LR", "3e-4")),
        weight_decay=float(os.environ.get("WEIGHT_DECAY", "0.1")),
        warmup=int(os.environ.get("WARMUP", "100")),
        decay_steps=int(os.environ.get("DECAY_STEPS", "100000")),
    )
    mw = None
    if os.environ.get("METRICS_PATH"):
        from ptype_tpu_torch.metrics import MetricsWriter

        mw = MetricsWriter(os.environ["METRICS_PATH"])

    own_group = mode == "store" and _own_process_group(cfg.platform, device)
    cluster = join(cfg, device=device)
    preset = os.environ.get("PRESET", "optimus-125m")
    steps = int(os.environ.get("STEPS", "50"))
    seq = int(os.environ.get("SEQ", "1024"))

    model_cfg = tfm.preset(preset)
    mesh = cluster.mesh() if mode == "store" else None
    n_dev = mesh.size if mesh is not None else 1
    batch = int(os.environ.get("BATCH", str(8 * n_dev)))
    stream = synthetic_batches(model_cfg.vocab_size, batch, seq,
                               device=device)
    print(f"optimus[{mode}] {preset} on {n_dev} devices, "
          f"batch={batch} seq={seq}", flush=True)

    try:
        if mode == "gspmd":
            from ptype_tpu_torch.train.trainer import Trainer

            trainer = Trainer(model_cfg, device=device, optimizer=optimizer)
            print(f"params: {trainer.n_params/1e6:.1f}M", flush=True)
            # CKPT_DIR enables save/resume: restart the process with the
            # same dir and training continues from the latest complete
            # step (the reference's TrainState layout, either package's).
            ckpt_dir = os.environ.get("CKPT_DIR")
            ckpt_every = int(os.environ.get("CKPT_EVERY", "50"))
            ck = None
            if ckpt_dir:
                from ptype_tpu_torch.checkpoint import Checkpointer

                ck = Checkpointer(ckpt_dir)
                latest = ck.latest_step()
                if latest is not None:
                    trainer.restore(ck, step=latest)
                    print(f"resumed from step {latest}", flush=True)
            for i in range(steps):
                out = trainer.step(next(stream))
                if i % 10 == 0 or i == steps - 1:
                    loss = float(out["loss"])
                    print(f"step {out['step']:5d} loss {loss:.4f} "
                          f"tok/s/chip {out['tokens_per_sec_per_chip']:.0f} "
                          f"mfu {_mfu(out)}", flush=True)
                    if mw is not None:
                        mw.emit(int(out["step"]), loss=loss,
                                grad_norm=float(out["grad_norm"]),
                                tokens_per_sec_per_chip=out[
                                    "tokens_per_sec_per_chip"],
                                mfu=out["mfu"])
                if (ck is not None and ckpt_every
                        and (i + 1) % ckpt_every == 0):
                    trainer.sync()
                    # The snapshot is copied out now and written on the
                    # checkpointer's thread while training continues.
                    trainer.save(ck, background=True)
            if ck is not None:
                trainer.sync()
                # Drain any in-flight background save BEFORE consulting
                # latest_step(): an uncommitted final-step save would
                # otherwise be written twice.
                ck.wait()
                final = int(trainer.state.step)
                if ck.latest_step() != final:
                    trainer.save(ck)
                print(f"checkpointed step {final}", flush=True)
        else:
            from ptype_tpu_torch.parallel.tensorstore import TensorStore
            from ptype_tpu_torch.train.store_dp import StoreDPTrainer

            # COMPRESS=bf16|int8 compresses the gradient push wire.
            store = TensorStore(mesh, kv=cluster.store,
                                compress=os.environ.get("COMPRESS") or None,
                                device=device)
            # ZERO=1: sharded weight update (parallel/zero.py); the same
            # LR/WARMUP/... knobs feed the shard-local recipe.
            zero = os.environ.get("ZERO") == "1"
            if zero:
                from ptype_tpu_torch.train.trainer import \
                    default_optimizer_hparams

                trainer = StoreDPTrainer(
                    model_cfg, store, zero=True, device=device,
                    zero_hparams=default_optimizer_hparams(
                        lr=float(os.environ.get("LR", "3e-4")),
                        weight_decay=float(
                            os.environ.get("WEIGHT_DECAY", "0.1")),
                        warmup=int(os.environ.get("WARMUP", "100")),
                        decay_steps=int(
                            os.environ.get("DECAY_STEPS", "100000"))))
            else:
                trainer = StoreDPTrainer(model_cfg, store,
                                         optimizer=optimizer, device=device)
            # CKPT_DIR persists the Store's parameter space. Resume
            # restores params INTO the store after the trainer seeded
            # it — optimizer moments restart ("resume = join + Store
            # pull"), unless ZERO=1 saved them beside the params.
            sc = zc = None
            ckpt_every = int(os.environ.get("CKPT_EVERY", "50"))
            if os.environ.get("CKPT_DIR"):
                from ptype_tpu_torch.checkpoint import StoreCheckpoint

                # params/ only: the store also holds transient grads/*.
                sc = StoreCheckpoint(store, os.environ["CKPT_DIR"],
                                     keys_prefix="params/")
                if zero:
                    from ptype_tpu_torch.checkpoint import ZeroCheckpoint

                    zc = ZeroCheckpoint(os.path.join(
                        os.environ["CKPT_DIR"], "zero_opt"))
                # Probe emptiness explicitly so a CORRUPT checkpoint
                # still fails loudly instead of restarting from step 0.
                resumed_step = sc.latest_step()
                if resumed_step is not None:
                    restored = sc.resume()
                    # Continue the step numbering, so new saves never
                    # collide with the previous run's committed steps.
                    trainer.step_count = resumed_step
                    print(f"resumed {len(restored)} Store keys at "
                          f"step {resumed_step}", flush=True)
                    if zc is not None:
                        # Pinned to the params' step: a crash between
                        # the two saves fails loudly here.
                        zc.restore_into(trainer.zero_state(),
                                        step=resumed_step)
                        print("resumed sharded optimizer state "
                              f"(count {trainer.zero_state().count})",
                              flush=True)
            saved_i = -1
            for i in range(steps):
                out = trainer.step(next(stream))
                if i % 10 == 0 or i == steps - 1:
                    print(f"step {out['step']:5d} loss {out['loss']:.4f} "
                          f"grad_epoch {out['grad_epoch']}", flush=True)
                    if mw is not None:
                        mw.emit(int(out["step"]), loss=out["loss"],
                                grad_epoch=out["grad_epoch"])
                if sc is not None and ckpt_every and (
                        i + 1) % ckpt_every == 0:
                    # Step passed explicitly: params epochs don't bump
                    # on put(), so the derived step would always be 0.
                    sc.save(step=out["step"])
                    if zc is not None:
                        zc.save(out["step"], trainer.zero_state())
                    saved_i = i
            if sc is not None and saved_i != steps - 1:
                print(f"store checkpoint: {sc.save(step=out['step'])}",
                      flush=True)
                if zc is not None:
                    zc.save(out["step"], trainer.zero_state())
    finally:
        if mw is not None:
            mw.close()
        cluster.close()
        if own_group:
            import torch.distributed as dist

            dist.destroy_process_group()


if __name__ == "__main__":
    main()
