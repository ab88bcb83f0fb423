"""The port's jitwatch, case for case with ``tests/test_jitwatch.py``:
inert disarmed; the kernel build cache as the compile seam (a forced
rebuild of one ``_build`` target is a recompile and storms at the
threshold, a new signature is not, internal names stay out of the
books, ``mark_steady`` books later builds); the hot-region guard's
dispatch detector (each synchronising op raises under ``disallow``,
logs under ``log``, passes and is counted inside ``sanctioned_transfer``,
and reaches autograd's backward); the CUDA detector's warnings hook with
the card's sync debug mode stubbed (only the region's thread raises, a
repeat at one line raises again, ``disable`` restores the prior mode,
hook and filters); the storm dump through ``trace``; arming from
``PTYPE_JITWATCH=1`` at import; the recompile-storm rule and ``obs
jit`` reading a port node's own published ``jit.*``; the overhead
probe re-arming an armed watchdog.

The build seam runs with ``nvcc`` and ``ctypes.CDLL`` stubbed (there is
neither here): the "compiler" writes the target file, and the stub
library hands out C functions that accept any signature. The reference
side needs no stub: its cases are in ``tests/test_jitwatch.py``, and
the rule and the view are fed through the reference package here too,
where their inputs are the same. Counts are exact."""

import ctypes
import os
import subprocess
import sys
import threading
import warnings
from unittest import mock

import pytest
import torch

from ptype_tpu.health import rules as jrules
from ptype_tpu.health import top as jtop
from ptype_tpu_torch import jitwatch, metrics, trace
from ptype_tpu_torch.health import rules, series, top
from ptype_tpu_torch.ops import _build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def watch():
    jw = jitwatch.enable(storm_threshold=3)
    yield jw
    jitwatch.disable()


@pytest.fixture
def registry(monkeypatch):
    """A fresh process registry for what jitwatch publishes."""
    reg = metrics.MetricsRegistry()
    monkeypatch.setattr(metrics, "metrics", reg)
    return reg


class _FakeLib:
    def __getattr__(self, name):
        return ctypes.CFUNCTYPE(ctypes.c_int)(lambda: 0)


@pytest.fixture
def fake_build(monkeypatch, tmp_path):
    """``_build`` over a scratch build dir with the compiler and the
    loader stubbed; yields a function that drops the process cache
    and the built file of one target (the forced rebuild)."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_fns", {})
    monkeypatch.setattr(_build, "_nvcc_cmd", lambda name, out: [
        sys.executable, "-c", f"open({str(out)!r}, 'w').close()"])
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: _FakeLib())

    def rebuild(name):
        _build._libs.pop(name, None)
        _build._target(name).unlink(missing_ok=True)

    return rebuild


def test_disarmed_is_inert(fake_build, registry):
    jitwatch.disable()
    assert jitwatch.active() is None
    with jitwatch.hot_region("x"):
        torch.ones(3).sum().item()  # a host read: fine disarmed
    with jitwatch.sanctioned_transfer("x"):
        pass
    _build.load("flash_fwd")
    assert registry.snapshot()["counters"] == {}


def test_forced_rebuild_is_a_recompile(watch, fake_build, registry):
    """THE fixture: dropping a built target and its cached library makes
    the next load build the SAME target again — booked as a recompile
    every time after the first, and a storm at the threshold."""
    for _ in range(4):
        fake_build("paged_decode")
        _build.load("paged_decode")
    assert watch.compiles() == {"csrc/paged_decode": 4}
    assert watch.recompiles() == {"csrc/paged_decode": 3}
    storms = watch.storms()
    assert len(storms) == 1 and storms[0]["fn"] == "csrc/paged_decode"
    assert storms[0]["compiles"] == watch.storm_threshold
    assert storms[0]["signature"] == _build._target("paged_decode").name
    snap = registry.snapshot()
    assert snap["counters"]["jit.compiles"] == 4
    assert snap["counters"]["jit.recompiles"] == 3
    assert snap["gauges"]["jit.fn.csrc/paged_decode"] == 3.0


def test_new_signature_is_not_a_recompile(watch, fake_build, monkeypatch):
    """A target under other flags hashes to another file: a distinct
    program, counted as a compile and never as a recompile; a cached
    load and a second bind book nothing."""
    _build.load("flash_bwd")
    _build.load("flash_bwd")  # cache hit
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-G"])
    _build._libs.pop("flash_bwd")
    _build.load("flash_bwd")
    _build.bind("flash_bwd", "flash_bwd_dq", [])
    _build.bind("flash_bwd", "flash_bwd_dq", [])
    assert watch.compiles() == {"csrc/flash_bwd": 2,
                                "csrc/flash_bwd:flash_bwd_dq": 1}
    assert watch.recompiles() == {} and watch.storms() == []


def test_internal_names_stay_out_of_the_recompile_books(watch):
    """Names with a leading underscore are internal (the reference
    keeps its eager wrappers out the same way): counted as compiles,
    never as recompiles or storms."""
    for _ in range(4):
        watch.on_compile("_probe", "sig")
    assert watch.compiles() == {"_probe": 4}
    assert watch.recompiles() == {} and watch.storms() == []


SYNCS = {
    "item": lambda x: x.sum().item(),
    "int": lambda x: int(x[0]),
    "bool": lambda x: bool(x[0] > 0),
    "nonzero": lambda x: x.nonzero(),
    "masked_select": lambda x: torch.masked_select(x, x > 0),
    "bool_index": lambda x: x[x > 0],
    "unique": lambda x: torch.unique(x),
    "repeat_interleave": lambda x: torch.repeat_interleave(
        x, torch.tensor([1, 2, 1])),
    "cross_device_copy": lambda x: x.to("meta"),
}


@pytest.mark.parametrize("op", sorted(SYNCS))
def test_hot_region_blocks_an_unsanctioned_host_sync(watch, op):
    """Armed, every op that synchronises the host on the card raises at
    the call inside a hot region, the message naming the region and the
    op; the same call passes, counted, inside the sanctioned seam."""
    x = torch.tensor([1.0, -2.0, 3.0])
    SYNCS[op](x)  # outside any region: fine
    with jitwatch.hot_region("test.hot"):
        x * 2 + 1  # no synchronisation
        with pytest.raises(jitwatch.HostSyncError, match=r"test\.hot.*aten"):
            SYNCS[op](x)
        with jitwatch.sanctioned_transfer("test.meter"):
            SYNCS[op](x)
    assert watch.sanctioned() == {"test.meter": 1}
    assert watch.report()["hot_regions"] == 1


def test_non_synchronising_ops_pass(watch):
    """The look-alikes that do not synchronise: integer indexing,
    ``repeat_interleave`` by an int or with ``output_size``, a
    same-device copy."""
    x = torch.arange(6.0)
    with jitwatch.hot_region("test.hot"):
        x[torch.tensor([0, 2])]
        x.repeat_interleave(2)
        torch.repeat_interleave(x, torch.full((6,), 2), output_size=12)
        x.to("cpu", copy=True)
        torch.where(x > 2, x, 0.0)


def test_log_level_logs_and_off_level_only_counts():
    x = torch.ones(3)
    jitwatch.enable(transfer_level="log")
    try:
        with mock.patch.object(jitwatch.log, "warning") as warn:
            with jitwatch.hot_region("test.log"):
                x.sum().item()
        (msg,), _ = warn.call_args
        assert "test.log" in msg and "_local_scalar_dense" in msg
        jw = jitwatch.enable(transfer_level="off")
        with jitwatch.hot_region("test.off"):
            x.sum().item()
        assert jw.report()["hot_regions"] == 0
    finally:
        jitwatch.disable()
    with pytest.raises(ValueError, match="transfer level"):
        jitwatch.enable(transfer_level="warn")


class _ReadsInBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a):
        return a * 2

    @staticmethod
    def backward(ctx, g):
        g.sum().item()  # a host read inside the backward
        return g * 2


def test_dispatch_mode_reaches_the_autograd_backward(watch):
    """The region's state lives on the dispatch mode, which autograd
    carries to the thread that runs the backward: an ``.item()`` in a
    custom Function's backward raises inside an armed region, and not
    outside one."""
    a = torch.ones(3, requires_grad=True)
    _ReadsInBackward.apply(a).sum().backward()
    with jitwatch.hot_region("train.step"):
        loss = _ReadsInBackward.apply(a).sum()
        with pytest.raises(jitwatch.HostSyncError, match="train.step"):
            loss.backward()


def test_mark_steady_books_every_later_compile(watch, fake_build):
    _build.load("flash_fwd")
    watch.mark_steady()
    assert watch.recompiles_since_steady() == {}
    _build.load("flash_fwd")  # cache hit: still zero
    _build.bind("flash_fwd", "flash_fwd", [])  # first bind: booked
    assert watch.recompiles_since_steady() == {"csrc/flash_fwd:flash_fwd": 1}
    assert watch.report()["steady_marked"] is True


def test_storm_dumps_through_flight_recorder(watch, tmp_path):
    trace.enable("jitwatch-test", dump_dir=str(tmp_path))
    trace._dump_last = 0.0  # an earlier test's dump must not eat the
    #                         one-per-interval rate limit
    try:
        with trace.span("drive") as sp:
            for _ in range(3):
                watch.on_compile("engine_step", "sig")
        assert watch.storms()
        assert [e["name"] for e in sp.events] == ["jitwatch.storm"]
        assert list(tmp_path.glob("flight-*.jsonl")), \
            "no flight-recorder dump for the storm"
    finally:
        trace.disable()


def test_enable_from_env_at_import():
    env = dict(os.environ, PYTHONPATH=ROOT, **{jitwatch.ENV_VAR: "1"})
    out = subprocess.run(
        [sys.executable, "-c", "from ptype_tpu_torch import jitwatch; "
         "print(jitwatch.active() is not None)"],
        env=env, capture_output=True, text=True, timeout=120, check=True)
    assert out.stdout.strip() == "True"


class _FakeCuda:
    """``torch.cuda``'s availability and sync debug mode, stubbed: what
    the CUDA detector's hook sees on the card is the warning text."""

    def __init__(self):
        self.mode = 0
        self.calls = []

    def get_sync_debug_mode(self):
        return self.mode

    def set_sync_debug_mode(self, mode):
        self.calls.append(mode)
        self.mode = {"default": 0, "warn": 1, "error": 2}.get(mode, mode)


def _card_sync():
    # The card's warning names the Python line that made the call.
    warnings.warn(f"{jitwatch.SYNC_WARNING} (stubbed)", UserWarning,
                  stacklevel=2)


@pytest.fixture
def fake_cuda(monkeypatch):
    fake = _FakeCuda()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode",
                        fake.get_sync_debug_mode)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode",
                        fake.set_sync_debug_mode)
    return fake


def test_cuda_hook_raises_only_for_the_regions_thread(fake_cuda, capsys):
    """Armed on a card: sync debug mode ``warn``, and each
    synchronisation warning of the thread inside a hot region raises —
    a repeat at the same line too (the filter is ``always``) — while
    the same warning inside ``sanctioned_transfer``, or from another
    thread (the mode is process-global), passes, unprinted."""
    prior_show, prior_filters = warnings.showwarning, list(warnings.filters)
    jw = jitwatch.enable()
    try:
        assert fake_cuda.mode == 1
        _card_sync()  # outside a region
        errs = []
        with jitwatch.hot_region("serve.decode"):
            for _ in range(2):
                with pytest.raises(jitwatch.HostSyncError,
                                   match=r"serve\.decode.*test_torch_jitwatch\.py"):
                    _card_sync()
            with jitwatch.sanctioned_transfer("serve.decode_read"):
                _card_sync()

            def other():
                try:
                    _card_sync()
                except Exception as e:  # noqa: BLE001
                    errs.append(e)

            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
        assert errs == []
        assert jw.sanctioned() == {"serve.decode_read": 1}
        assert jitwatch.SYNC_WARNING not in capsys.readouterr().err
        # A CPU region on the card's machine takes the dispatch detector.
        with jitwatch.hot_region("cpu.work", device="cpu"):
            with pytest.raises(jitwatch.HostSyncError):
                torch.ones(2).sum().item()
            _card_sync()
    finally:
        jitwatch.disable()
    assert fake_cuda.calls == ["warn", 0]
    assert warnings.showwarning is prior_show
    assert warnings.filters == prior_filters


def test_recompile_storm_rule_names_the_function(watch, registry):
    """The rule on a port node's OWN published series: the node's
    ``jit.recompiles`` grows past the threshold inside the window and the
    page names the function from its ``jit.fn.*`` books — the same
    alert the reference's rule raises on the same snapshot."""
    s = series.Sampler(registry=registry, cadence_s=0.05, memory=False)
    for _ in range(2):
        watch.on_compile("engine_step", "sig")
    s.sample_once(now=900.0, now_mono=1.0)
    for _ in range(4):
        watch.on_compile("engine_step", "sig")
    watch.on_compile("apply", "a")
    watch.on_compile("apply", "a")
    s.sample_once(now=995.0, now_mono=2.0)
    snap = {"ts": 1000.0, "errors": {},
            "nodes": {"w0": series.telemetry_endpoint(registry, s.store,
                                                      "w0")()}}
    for mod in (rules, jrules):
        alerts = mod.RecompileStormRule(threshold=3, window_s=120.0
                                        ).evaluate(mod.ClusterView(snap,
                                                                   1000.0))
        assert len(alerts) == 1 and alerts[0].node == "w0"
        assert alerts[0].labels.get("fn") == "engine_step"
        assert "engine_step" in alerts[0].message
    assert any(isinstance(r, rules.RecompileStormRule)
               for r in rules.default_rules())


def test_obs_jit_shows_the_armed_node(watch, registry):
    for _ in range(3):
        watch.on_compile("engine_step", "sig")
    with jitwatch.sanctioned_transfer("serve.decode_read"):
        pass
    snap = {"ts": "t", "errors": {}, "nodes": {
        "workers/w0": {"metrics": registry.snapshot(), "series": {}},
        "workers/w1": {"metrics": {"counters": {}}, "series": {}}}}
    out = top.render_jit(snap)
    assert out == jtop.render_jit(snap)
    assert "1 armed" in out and "engine_step (2x)" in out
    row = next(ln for ln in out.splitlines() if ln.startswith("workers/w0"))
    assert row.split()[1:4] == ["3", "2", "1"]


def test_overhead_probe_rearms_an_armed_watchdog(fake_build):
    """``measure_jitwatch_overhead`` in an armed process leaves a LIVE
    watchdog behind with the caller's threshold and level (fresh
    books), one that still books the build seam and guards regions."""
    from ptype_tpu_torch.health.bench import measure_jitwatch_overhead

    jitwatch.enable(storm_threshold=5, transfer_level="disallow")
    try:
        rep = measure_jitwatch_overhead(iters=50, repeats=1, device="cpu")
        assert rep["jitwatch_steady_recompiles"] == 0
        assert rep["device"] == "cpu" and rep["jitwatch_step_ms"] > 0
        assert set(rep) >= {"jitwatch_overhead_pct", "jitwatch_region_us",
                            "jitwatch_dispatch_us"}
        jw = jitwatch.active()
        assert jw is not None and jw.storm_threshold == 5
        for _ in range(2):
            fake_build("flash_fwd")
            _build.load("flash_fwd")
        assert jw.recompiles() == {"csrc/flash_fwd": 1}
        with pytest.raises(jitwatch.HostSyncError):
            with jitwatch.hot_region("bench.after"):
                torch.ones(2).sum().item()
    finally:
        jitwatch.disable()
