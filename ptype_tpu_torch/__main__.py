"""Operator CLI of the port: ``python -m ptype_tpu_torch <command>``.

The twin of ``python -m ptype_tpu``: the same verbs, environment
variables, messages and exit codes. Verbs that touch a device (``info``,
``serve``, ``train``, ``eval``) run on the device ``$PTYPE_DEVICE``
names — ``cuda`` when it is unset, and then they raise on a host with no
card; set it to ``cpu`` to run on the CPU. The control-plane verbs
(``join``, ``standby``, ``witness``, ``obs``) import no torch. Commands:

- ``info``   — the device, mesh axes from config (if any), native wire
- ``join``   — join the cluster described by $CONFIG and idle (a seed
               or bare member; ^C to leave)
- ``serve``  — join + serve a GeneratorActor ($PRESET, default tiny)
- ``train``  — join + train ($PRESET/$STEPS/$BATCH/$SEQ/$MODE as in
               ptype_tpu_torch/examples/optimus/trainer.py;
               $CKPT_DIR/$CKPT_EVERY for save/resume, $COMPRESS for
               store-mode grad wire)
- ``eval``   — held-out loss/perplexity of a checkpoint ($CKPT_DIR;
               $PRESET/$BATCH/$SEQ/$EVAL_STEPS; $CORPUS points at a raw
               token file, else a fixed synthetic stream). A store-mode
               checkpoint (``StoreCheckpoint``) is read as well
- ``bench``  — not ported: the port has no headline benchmark yet
               (ROADMAP A9); raises
- ``standby`` — warm-standby coordinator: probe the seed, take over on
               failure ($STANDBY_ADDR to listen on; the platform
               config supplies coordinator_address + data_dir;
               $STANDBY_REPLICATE=1 streams the WAL cross-host
               instead of assuming a shared data_dir).
               ``kill -USR1`` for operator switchover; ^C exits.
- ``witness`` — quorum witness (platform ``witness_address`` /
               ``witness_ttl``): the third vote that lets a
               partitioned-minority primary self-fence and gates
               standby promotion on a real majority.
- ``obs``    — fleet-wide observability snapshot: walk the registry
               of the cluster described by $CONFIG, pull every node's
               telemetry (metrics + flight-recorder spans) over its
               actor RPC surface, write a stitched Chrome trace
               ($OBS_DIR/trace.json — load in Perfetto) + spans JSONL,
               and print the summary (docs/OBSERVABILITY.md).
- ``obs top`` — LIVE cluster health view: re-pull the cluster
               telemetry every $TOP_INTERVAL (default 2 s), run the
               health alert rules over the per-node series, and
               repaint per-node goodput / step breakdown / memory +
               recent alerts ($TOP_ITERS bounds the refreshes for
               scripted runs; ^C exits). docs/OPERATIONS.md has the
               per-alert runbook.
- ``obs serve`` — LIVE serving-plane view: re-pull the
               cluster telemetry every $TOP_INTERVAL, run the alert
               rules (incl. kv-pressure / prefix-hit-collapse /
               serve-stall; ttft-p99 when an SLO is set), and repaint
               per-replica TTFT/TPOT/e2e tails, queue + batch
               occupancy, and KV-pool pressure from the serving
               ledger ($TOP_ITERS bounds refreshes; ^C exits).
- ``obs scale`` — LIVE elastic-fleet view: re-pull the
               cluster telemetry every $TOP_INTERVAL and repaint
               every reconciler's desired-vs-actual fleet size, warm/
               draining/pending counts, and decision/spawn/drain/
               escalation counters, plus every serving replica's
               lifecycle state (spawning/warm/active/draining) —
               the autoscaling loop and its effect in one screen
               ($TOP_ITERS bounds refreshes; ^C exits).
               docs/OPERATIONS.md "Elastic serving" has the runbook.
- ``obs topo`` — LIVE topology view: re-pull the cluster
               telemetry every $TOP_INTERVAL and repaint per-domain
               replica counts (the ``serve.domain`` gauge), per-leg
               collective wire bytes (inner vs the slow outer leg vs
               the flat baseline), and the KV-migration locality
               split (local-domain vs cross-domain) — the
               cross-domain-pressure runbook row reads this after
               ``obs serve`` ($TOP_ITERS bounds refreshes; ^C exits).
- ``obs traffic`` — LIVE traffic-plane view: re-pull the
               cluster telemetry every $TOP_INTERVAL and repaint each
               open-loop load driver's offered/achieved rates,
               SLO-attributed goodput, shed/overrun/chaos-drop split,
               open-loop TTFT p99, and the last measured capacity
               knee with live headroom against it ($TOP_ITERS bounds
               refreshes; ^C exits). docs/OPERATIONS.md "Capacity
               planning" has the runbook.
- ``obs profile`` — cluster-wide device profiling: simultaneous
               torch.profiler capture on every registered node
               via the built-in ptype.Profile endpoint
               ($PROFILE_DURATION seconds, default 1), artifacts
               shipped back under $OBS_DIR/profile/<node>/, then a
               host-side top-ops table + per-node device-memory table
               (load the gzipped Chrome trace in ui.perfetto.dev for
               the full device timeline). ``obs profile summarize``
               re-parses an existing artifact tree ($PROFILE_DIR or
               $OBS_DIR/profile) without touching the cluster.
- ``obs request <trace_id>`` — tail forensics: render one
               request's stage-attributed waterfall (queue-wait /
               route / prefill / migrate / decode-queue / decode …)
               from its stitched cross-process spans. Post-mortem
               first: reads $TRACE_FILE, else $OBS_DIR/spans.jsonl,
               else the newest $PTYPE_TRACE_DUMP_DIR flight dump,
               and only dials the cluster when no file exists.
               Trace-id prefixes match (paste the short id from
               ``obs tail``).
- ``obs tail`` — the fleet's worst tail: per-histogram worst
               exemplars (value + trace id, the input to ``obs
               request``) and the gateway stage-time p99 breakdown
               ($TAIL_LIMIT bounds rows, default 8).
               docs/OBSERVABILITY.md "Tail forensics".
- ``obs export`` — OpenMetrics text dump of every node's metric
               families (counters/gauges/timings/histograms, p99
               exemplars inline) for standard scrape tooling.
"""

from __future__ import annotations

import json
import sys
import threading


def _device():
    """The device a device verb runs on: ``$PTYPE_DEVICE``, else
    ``cuda`` (which raises on a host with no card)."""
    import os

    from ptype_tpu_torch.device import resolve_device

    try:
        return resolve_device(os.environ.get("PTYPE_DEVICE") or None)
    except RuntimeError as e:
        raise RuntimeError(f"{e} (the CLI reads it from PTYPE_DEVICE)") \
            from e


def _info() -> None:
    import os

    import torch

    from ptype_tpu_torch import native

    dev = _device()
    cuda = dev.type == "cuda"
    out = {
        "version": __import__("ptype_tpu_torch").__version__,
        "platform": dev.type,
        "devices": torch.cuda.device_count() if cuda else 1,
        "device_kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "native_wire": native.available(),
    }
    if os.environ.get("CONFIG"):
        from ptype_tpu_torch import config_from_env

        cfg = config_from_env()
        out["service"] = cfg.service_name
        out["mesh_axes"] = cfg.platform.mesh_axes
    print(json.dumps(out, indent=2))


def _join() -> None:
    from ptype_tpu_torch import config_from_env, join

    cluster = join(config_from_env())
    print(f"joined as {cluster.cfg.node_name} "
          f"(member {cluster.member.id}); ^C to leave", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        cluster.close()


def _serve() -> None:
    import os

    from ptype_tpu_torch import config_from_env, join
    from ptype_tpu_torch.models import transformer as tfm
    # Replica lifecycle has ONE home: the server that
    # fronts a serving replica is constructed by reconciler/replica.py
    # — the same code path the elastic reconciler's spawned workers
    # use, so an operator-launched replica and an autoscaled one are
    # the same thing.
    from ptype_tpu_torch.reconciler.replica import serve_actor
    from ptype_tpu_torch.serve import BatchingGeneratorActor

    cfg = config_from_env()
    device = _device()
    model_cfg = tfm.preset(os.environ.get("PRESET", "tiny"))
    # $SERVE_MODE=continuous: slot-based continuous batching (requests
    # join/leave the one running decode loop at step boundaries;
    # $SERVE_SLOTS caches). Default: dynamic batching — concurrent
    # greedy requests coalesce into one decode round
    # ($SERVE_WINDOW_MS/$SERVE_MAX_BATCH to tune). Sampled requests
    # run solo in both modes.
    if os.environ.get("SERVE_MODE") == "continuous":
        from ptype_tpu_torch.serve import ContinuousGeneratorActor

        actor = ContinuousGeneratorActor(
            model_cfg, device=device,
            n_slots=int(os.environ.get("SERVE_SLOTS", "8")))
    else:
        actor = BatchingGeneratorActor(
            model_cfg, device=device,
            window_ms=float(os.environ.get("SERVE_WINDOW_MS", "5")),
            max_batch=int(os.environ.get("SERVE_MAX_BATCH", "32")))
    server = serve_actor(actor, "Generator", port=cfg.port, device=device)
    cfg.port = server.port
    cluster = join(cfg, device=device)
    print(f"serving Generator.{{Generate,Logits,Info}} on :{server.port}",
          flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        cluster.close()
        server.close()


def _train() -> None:
    from ptype_tpu_torch.examples.optimus import trainer

    trainer.main()


def _eval() -> None:
    import json as _json
    import os

    from ptype_tpu_torch.checkpoint import Checkpointer
    from ptype_tpu_torch.models import transformer as tfm
    from ptype_tpu_torch.train.data import TokenFileDataset, synthetic_batches
    from ptype_tpu_torch.train.trainer import Trainer, default_optimizer

    ckpt_dir = os.environ.get("CKPT_DIR")
    if not ckpt_dir:
        print("eval: set CKPT_DIR to the checkpoint directory",
              file=sys.stderr)
        raise SystemExit(2)
    ck = Checkpointer(ckpt_dir)
    step = ck.latest_step()
    if step is None:
        print(f"eval: no complete checkpoint under {ckpt_dir}",
              file=sys.stderr)
        raise SystemExit(2)

    device = _device()
    cfg = tfm.preset(os.environ.get("PRESET", "tiny"))
    steps = int(os.environ.get("EVAL_STEPS", "10"))
    batch = int(os.environ.get("BATCH", "8"))
    seq = int(os.environ.get("SEQ", "1024"))

    # The TrainState skeleton comes from a Trainer; the restore replaces
    # its fresh params with the checkpoint's, and Trainer.evaluate runs
    # with the trainer's attention.
    tr = Trainer(cfg, device=device, optimizer=default_optimizer())
    _restore_params(tr, ck, step)

    corpus = os.environ.get("CORPUS")
    if corpus:
        stream = TokenFileDataset(corpus, device=device).batches(
            batch, seq, seed=1234)
    else:
        stream = synthetic_batches(cfg.vocab_size, batch, seq, seed=1234,
                                   device=device)
    out = tr.evaluate(stream, steps)
    print(_json.dumps({"checkpoint_step": step, "eval_steps": steps,
                       "batch": batch, "seq": seq, **out}))


def _restore_params(tr, ck, step: int) -> None:
    """Load checkpoint ``step`` into the trainer: a ``TrainState`` in
    the reference's layout (either package's ``Checkpointer``), or the
    ``params/`` keys of a store-mode ``StoreCheckpoint``."""
    import os

    import torch

    from ptype_tpu_torch.checkpoint import _flat_key
    from ptype_tpu_torch.train.trainer import _flatten

    if not os.path.exists(os.path.join(ck._step_dir(step),
                                       "store_meta.json")):
        tr.restore(ck, step=step)
        return
    reader = ck.reader(step)
    with torch.no_grad():
        for path, leaf in _flatten(tr.state.params):
            key = "params/" + "/".join(path)
            leaf.copy_(reader.read(_flat_key((key,))))
    tr.state.step = step


def _bench() -> None:
    raise NotImplementedError(
        "bench: the port has no headline benchmark yet (ROADMAP A9); "
        "python3 chip_smoke.py drives the port on a GPU")


def _standby() -> None:
    import os
    import signal

    from ptype_tpu_torch import config_from_env
    from ptype_tpu_torch.coord.standby import Standby

    cfg = config_from_env()
    listen = os.environ.get("STANDBY_ADDR")
    if not listen:
        print("standby: set STANDBY_ADDR=host:port (the address this "
              "standby serves on after takeover)", file=sys.stderr)
        raise SystemExit(2)
    data_dir = os.path.join(cfg.platform.data_dir, "coord")
    if not cfg.platform.data_dir:
        print("standby: platform config needs data_dir (the seed's WAL "
              "directory, shared)", file=sys.stderr)
        raise SystemExit(2)
    # STANDBY_REPLICATE=1: cross-host mode — data_dir is local and a
    # WalFollower streams the primary's WAL into it (no shared fs).
    sb = Standby(cfg.platform.coordinator_address, listen, data_dir,
                 replicate=os.environ.get("STANDBY_REPLICATE") == "1",
                 fsync=cfg.platform.wal_fsync,
                 witness_addr=cfg.platform.witness_address or None,
                 witness_ttl=cfg.platform.witness_ttl)

    def _switchover(*_):
        # promote() raises if the primary still holds the WAL fence
        # (and re-arms monitoring); a raise out of a signal handler
        # would tear down the whole standby process.
        try:
            sb.promote()
        except RuntimeError as e:
            print(f"standby: switchover refused: {e}", file=sys.stderr,
                  flush=True)

    signal.signal(signal.SIGUSR1, _switchover)
    print(f"standby for {cfg.platform.coordinator_address}; will serve "
          f"on {listen} (SIGUSR1 = switchover)", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        sb.close()


def _witness() -> None:
    import os

    from ptype_tpu_torch import config_from_env
    from ptype_tpu_torch.coord.witness import WitnessServer

    cfg = config_from_env()
    addr = cfg.platform.witness_address
    if not addr:
        print("witness: platform config needs witness_address "
              "(host:port this witness listens on)", file=sys.stderr)
        raise SystemExit(2)
    data_dir = (os.path.join(cfg.platform.data_dir, "witness")
                if cfg.platform.data_dir else None)
    srv = WitnessServer(addr, ttl=cfg.platform.witness_ttl,
                        data_dir=data_dir)
    print(f"witness on {srv.address} (ttl {srv.ttl}s)", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        srv.close()


def _obs_profile_summarize(root: str) -> None:
    """Host-side re-parse of an artifact tree — one top-ops table per
    node directory (or the root itself when it holds a capture)."""
    import os

    from ptype_tpu_torch.health import profiling

    if not os.path.isdir(root):
        print(f"no artifacts under {root} (set $PROFILE_DIR or "
              f"$OBS_DIR, or run `obs profile` first)")
        return
    dirs = [os.path.join(root, d) for d in sorted(os.listdir(root))
            if os.path.isdir(os.path.join(root, d))] or [root]
    for d in dirs:
        s = profiling.summarize(d)
        if not s["files"]:
            continue
        print(f"{d}: {len(s['files'])} files, {s['events']} events")
        for op in s["top_ops"]:
            print(f"  {op['total_us']:>12.1f} us  x{op['count']:<6} "
                  f"{op['name'][:80]}")


def _obs_profile(registry) -> None:
    import os

    from ptype_tpu_torch import telemetry as tel
    from ptype_tpu_torch.health import profiling

    out_dir = os.path.join(os.environ.get("OBS_DIR", "."), "profile")
    dur = float(os.environ.get("PROFILE_DURATION", "1"))
    res = tel.cluster_profile(registry, duration_s=dur,
                              out_dir=out_dir)
    print(f"cluster profile @ {res['ts']} ({dur}s capture)")
    for key in sorted(res["nodes"]):
        n = res["nodes"][key]
        print(f"{key}: {len(n['files'])} artifacts -> {n['dir']}")
        s = profiling.summarize(n["dir"], top=8)
        for op in s["top_ops"]:
            print(f"  {op['total_us']:>12.1f} us  x{op['count']:<6} "
                  f"{op['name'][:80]}")
        if n.get("memory"):
            print(profiling.render_hbm_table(n["memory"]))
    for key in sorted(res["errors"]):
        print(f"{key}: FAILED ({res['errors'][key]})")
    print(f"artifacts under {out_dir} (the .pt.trace.json.gz files "
          f"load in ui.perfetto.dev or chrome://tracing)")


def _obs_request_offline(trace_id: str) -> bool:
    """Render a request waterfall from span files on disk — returns
    False when no file source exists (caller falls through to the
    live cluster pull). Sources, in order: $TRACE_FILE (a spans.jsonl
    or flight-recorder dump), $OBS_DIR/spans.jsonl (what a plain
    ``obs`` run writes), the newest flight dump under
    $PTYPE_TRACE_DUMP_DIR (what an SLO violation wrote)."""
    import os

    from ptype_tpu_torch.health import forensics

    path = os.environ.get("TRACE_FILE")
    if not path:
        cand = os.path.join(os.environ.get("OBS_DIR", "."),
                            "spans.jsonl")
        if os.path.isfile(cand):
            path = cand
    if not path:
        dump_dir = os.environ.get("PTYPE_TRACE_DUMP_DIR")
        if dump_dir:
            path = forensics.latest_dump(dump_dir)
    if not path or not os.path.isfile(path):
        return False
    traces = forensics.load_dump_traces(path)
    try:
        wf = forensics.waterfall_from_snapshot({"traces": traces},
                                               trace_id)
    except KeyError:
        # The dump predates (or never saw) this trace — fall through
        # to the live cluster pull rather than dead-ending offline.
        print(f"(trace {trace_id!r} not in {path}; "
              f"{len(traces)} traces there — trying the cluster)",
              file=sys.stderr)
        return False
    print(forensics.render_waterfall(wf))
    print(f"(source: {path})")
    return True


def _obs() -> None:
    import os

    from ptype_tpu_torch import config_from_env
    from ptype_tpu_torch import telemetry as tel
    from ptype_tpu_torch.coord.remote import RemoteCoord
    from ptype_tpu_torch.registry import CoordRegistry

    if (len(sys.argv) > 3 and sys.argv[2] == "profile"
            and sys.argv[3] == "summarize"):
        # Offline re-parse of an existing artifact tree — the
        # post-mortem path must work with the cluster (and its
        # coordinator) down, so dispatch before dialing anything.
        _obs_profile_summarize(os.environ.get(
            "PROFILE_DIR",
            os.path.join(os.environ.get("OBS_DIR", "."), "profile")))
        return
    if len(sys.argv) > 3 and sys.argv[2] == "request":
        # Waterfall forensics. Same post-mortem rule as profile
        # summarize: when a span file exists ($TRACE_FILE, or the
        # spans.jsonl / flight dump a previous obs run or SLO
        # violation wrote), render from it without dialing — the tail
        # request's trace must be readable after the cluster is gone.
        if _obs_request_offline(sys.argv[3]):
            return
    cfg = config_from_env()
    coord = RemoteCoord([cfg.platform.coordinator_address])
    try:
        if len(sys.argv) > 2 and sys.argv[2] == "profile":
            _obs_profile(CoordRegistry(coord))
            return
        if len(sys.argv) > 2 and sys.argv[2] == "top":
            from ptype_tpu_torch.health import run_top

            try:
                run_top(CoordRegistry(coord),
                        iters=int(os.environ.get("TOP_ITERS", "0")),
                        interval_s=float(
                            os.environ.get("TOP_INTERVAL", "2")))
            except KeyboardInterrupt:
                pass
            return
        if len(sys.argv) > 2 and sys.argv[2] == "serve":
            from ptype_tpu_torch.health import run_serve

            try:
                run_serve(CoordRegistry(coord),
                          iters=int(os.environ.get("TOP_ITERS", "0")),
                          interval_s=float(
                              os.environ.get("TOP_INTERVAL", "2")))
            except KeyboardInterrupt:
                pass
            return
        if len(sys.argv) > 2 and sys.argv[2] == "scale":
            from ptype_tpu_torch.health import run_scale

            try:
                run_scale(CoordRegistry(coord),
                          iters=int(os.environ.get("TOP_ITERS", "0")),
                          interval_s=float(
                              os.environ.get("TOP_INTERVAL", "2")))
            except KeyboardInterrupt:
                pass
            return
        if len(sys.argv) > 2 and sys.argv[2] == "traffic":
            from ptype_tpu_torch.health import run_traffic

            try:
                run_traffic(CoordRegistry(coord),
                            iters=int(os.environ.get(
                                "TOP_ITERS", "0")),
                            interval_s=float(
                                os.environ.get("TOP_INTERVAL", "2")))
            except KeyboardInterrupt:
                pass
            return
        if len(sys.argv) > 2 and sys.argv[2] == "topo":
            from ptype_tpu_torch.health import run_topo

            try:
                run_topo(CoordRegistry(coord),
                         iters=int(os.environ.get("TOP_ITERS", "0")),
                         interval_s=float(
                             os.environ.get("TOP_INTERVAL", "2")))
            except KeyboardInterrupt:
                pass
            return
        if len(sys.argv) > 2 and sys.argv[2] == "jit":
            from ptype_tpu_torch.health import run_jit

            try:
                run_jit(CoordRegistry(coord),
                        iters=int(os.environ.get("TOP_ITERS", "0")),
                        interval_s=float(
                            os.environ.get("TOP_INTERVAL", "2")))
            except KeyboardInterrupt:
                pass
            return
        if len(sys.argv) > 3 and sys.argv[2] == "request":
            from ptype_tpu_torch.health import forensics

            snap = tel.cluster_snapshot(CoordRegistry(coord),
                                        include_local=False)
            try:
                wf = forensics.waterfall_from_snapshot(snap, sys.argv[3])
            except KeyError as e:
                # The flight ring is bounded; old request traces get
                # evicted by probe churn. Point the operator at dumps.
                print(f"obs request: {e.args[0]}", file=sys.stderr)
                print("  (flight rings are bounded; an evicted trace "
                      "may survive in $PTYPE_TRACE_DUMP_DIR flight "
                      "dumps or $OBS_DIR/spans.jsonl)", file=sys.stderr)
                sys.exit(1)
            print(forensics.render_waterfall(wf))
            return
        if len(sys.argv) > 2 and sys.argv[2] == "tail":
            from ptype_tpu_torch.health import forensics

            snap = tel.cluster_snapshot(CoordRegistry(coord),
                                        include_local=False)
            print(forensics.render_tail(
                snap, limit=int(os.environ.get("TAIL_LIMIT", "8"))))
            return
        if len(sys.argv) > 2 and sys.argv[2] == "export":
            snap = tel.cluster_snapshot(CoordRegistry(coord),
                                        include_local=False)
            sys.stdout.write(tel.openmetrics(snap))
            return
        snap = tel.cluster_snapshot(CoordRegistry(coord),
                                    include_local=False)
        out_dir = os.environ.get("OBS_DIR", ".")
        chrome = tel.write_chrome_trace(
            os.path.join(out_dir, "trace.json"), snap)
        jsonl = tel.write_spans_jsonl(
            os.path.join(out_dir, "spans.jsonl"), snap)
        print(tel.render_summary(snap))
        print(f"chrome trace: {chrome} (load in ui.perfetto.dev or "
              f"chrome://tracing)")
        print(f"spans jsonl:  {jsonl}")
    finally:
        coord.close()


COMMANDS = {
    "info": _info,
    "join": _join,
    "serve": _serve,
    "train": _train,
    "eval": _eval,
    "bench": _bench,
    "standby": _standby,
    "witness": _witness,
    "obs": _obs,
}


def main() -> None:
    if len(sys.argv) < 2 or sys.argv[1] not in COMMANDS:
        print(f"usage: python -m ptype_tpu_torch {{{'|'.join(COMMANDS)}}}",
              file=sys.stderr)
        raise SystemExit(2)
    COMMANDS[sys.argv[1]]()


if __name__ == "__main__":
    main()
