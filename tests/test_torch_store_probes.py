"""The Store probes and the peak seam of the port, on this host's CPU.

Probes: ``measure_allreduce_gbps``, ``measure_wire_gbps``,
``measure_push_tree`` and ``measure_zero`` on 4 gloo ranks (the
``store_probes`` suite of ``tests/torch_ranks.py``), held to the
reference's own checks of them (``tests/test_parallel.py``,
``tests/test_store_bench.py``, ``tests/test_zero_train.py``; the ZeRO
ratio bar scaled from the reference's world 8 to world 4) and to the
reference's records: the same keys, the same analytic wire footprints
and bucket plan, and ``measure_zero``'s final losses from the
reference's weights and token stream against the reference's own
``measure_zero`` at the same preset, seed, stream and batch.

The peak seam: a twin of ``tests/test_profiling.py``'s override test,
and an unknown card that has no peak and warns once.
"""

import logging
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from ptype_tpu.models import transformer as jtfm
from ptype_tpu.parallel import collectives as JC
from ptype_tpu.parallel.mesh import build_mesh
from ptype_tpu.parallel.tensorstore import measure_push_tree as jpush_tree
from ptype_tpu.train import data as jdata
from ptype_tpu.train import store_dp as jsd
from ptype_tpu_torch import metrics as tmetrics
from test_torch_cli import BF16_LOSS_TOL
from torch_ranks import Ranks

N = 4
WIRE = dict(mbytes=1, iters=1, blocks=(256, 512, 1024))
#: measure_zero's steps and batch (the reference test's).
ZERO = dict(steps=2, batch=8)


@pytest.fixture(scope="module")
def probes(tmp_path_factory):
    """(the port's per-rank records, the reference's records)."""
    jcfg = jtfm.preset("tiny")
    params = jax.jit(lambda r: jtfm.init_params(r, jcfg))(
        jax.random.PRNGKey(0))
    stream = jdata.synthetic_batches(jcfg.vocab_size, ZERO["batch"],
                                     min(jcfg.max_seq, 128), seed=5)
    batches = [{k: np.asarray(v) for k, v in next(stream).items()}
               for _ in range(ZERO["steps"] + 1)]
    inp = {"wire": WIRE,
           "ref": {"params": jax.tree_util.tree_map(np.asarray, params),
                   "batches": batches}}
    ranks = Ranks("store_probes", N, tmp_path_factory.mktemp("probes"), inp)
    try:  # the reference's records while the ranks run
        mesh = build_mesh({"data": N}, devices=jax.devices()[:N])
        ref = {"wire": JC.measure_wire_gbps(mesh, **WIRE),
               "push_tree": jpush_tree(mesh, preset="tiny", iters=1),
               "zero": jsd.measure_zero(mesh, **ZERO),
               "zero8": jsd.measure_zero(build_mesh({"data": 8}), **ZERO)}
    finally:
        outs = ranks.join()
    return outs, ref


def test_measure_allreduce_gbps_positive(probes):
    outs, _ = probes
    for out in outs:
        assert out["allreduce_gbps"] > 0


def test_measure_wire_gbps_has_the_reference_record(probes):
    outs, ref = probes
    want = ref["wire"]
    for out in outs:
        rec = out["wire"]
        assert set(want) <= set(rec)
        assert rec["payload_mb"] == want["payload_mb"]
        assert rec["int8_chunk_wire_pct"] == want["int8_chunk_wire_pct"]
        assert rec["int8_block_wire_pct"] == want["int8_block_wire_pct"]
        assert set(rec["int8_block_gbps"]) == set(want["int8_block_gbps"])
        gbps = [rec["fp32_gbps"], rec["int8_chunk_gbps"],
                *rec["int8_block_gbps"].values()]
        assert all(g > 0 for g in gbps), rec
        assert rec["fp32_ms"] > 0 and rec["int8_chunk_ms"] > 0


def test_measure_push_tree_reports_speedup(probes):
    outs, ref = probes
    want = ref["push_tree"]
    for out in outs:
        r = out["push_tree"]
        assert set(r) == set(want)
        assert r["bucketed_ms"] > 0 and r["per_leaf_ms"] > 0
        assert r["n_buckets"] <= r["n_leaves"]
        assert r["gbps"] > 0
        for k in ("n_leaves", "n_buckets", "payload_mb"):
            assert r[k] == want[k], k


def test_measure_zero_probe(probes):
    """~n x less optimizer memory a replica at matched loss: the
    reference's bar of 7.5 at world 8 is 3.75 at world 4."""
    outs, ref = probes
    for out in outs:
        r = out["zero"]
        assert set(r) == set(ref["zero"])
        assert r["n_replicas"] == N
        assert r["opt_mem_ratio"] >= 3.75
        assert r["zero_opt_mem_mb"] < r["repl_opt_mem_mb"]
        np.testing.assert_allclose(r["final_loss_zero"],
                                   r["final_loss_repl"], rtol=1e-3)


@pytest.mark.parametrize("ref_world", ["zero", "zero8"])
def test_measure_zero_losses_equal_the_reference(probes, ref_world):
    """From the reference's weights and stream, the port's final losses
    (world 4) equal the reference's measure_zero at world 4 and on its
    8-device host mesh: the loss is a global-batch mean, so the replica
    count does not move it. The packages' bf16 products round in other
    orders: the cross-package bf16 loss tolerance."""
    outs, ref = probes
    want = ref[ref_world]
    for out in outs:
        r = out["zero_ref_inputs"]
        for k in ("final_loss_zero", "final_loss_repl"):
            np.testing.assert_allclose(r[k], want[k], **BF16_LOSS_TOL,
                                       err_msg=k)
        assert r["repl_opt_mem_mb"] == pytest.approx(
            want["repl_opt_mem_mb"], abs=1e-3)


# ------------------------------------------------------------- peak seam


def test_device_peak_tflops_override_env_and_pin(monkeypatch):
    monkeypatch.delenv(tmetrics.PEAK_TFLOPS_ENV, raising=False)
    assert tmetrics.device_peak_tflops("cpu") is None
    # A bare float wins for whatever device this process computes on.
    monkeypatch.setenv(tmetrics.PEAK_TFLOPS_ENV, "123.5")
    assert tmetrics.device_peak_tflops() == 123.5
    assert tmetrics.device_peak_tflops("cpu") == 123.5
    # kind=value pairs extend the table: the CPU gets a peak too.
    monkeypatch.setenv(tmetrics.PEAK_TFLOPS_ENV, "cpu=7.5")
    assert tmetrics.device_peak_tflops() == 7.5
    assert tmetrics.device_peak_tflops("cpu") == 7.5
    # Malformed entries are ignored, not fatal: no peak, as with none.
    monkeypatch.setenv(tmetrics.PEAK_TFLOPS_ENV, "garbage=x,,")
    assert tmetrics.device_peak_tflops("cpu") is None
    monkeypatch.delenv(tmetrics.PEAK_TFLOPS_ENV)
    # The process pin wins over everything.
    monkeypatch.setenv(tmetrics.PEAK_TFLOPS_ENV, "cpu=7.5")
    tmetrics.set_peak_tflops(42.0)
    try:
        assert tmetrics.device_peak_tflops("cpu") == 42.0
    finally:
        tmetrics.set_peak_tflops(None)
    assert tmetrics.device_peak_tflops("cpu") == 7.5


def test_card_names_resolve_and_unknown_card_warns_once(monkeypatch):
    """The table and the env pairs match a card's name case-blind; a
    card none of them names has no peak (no other chip's figure) and
    logs one warning per kind, naming the env var."""
    monkeypatch.delenv(tmetrics.PEAK_TFLOPS_ENV, raising=False)

    class _Sink(logging.Handler):
        def __init__(self):
            super().__init__()
            self.records = []

        def emit(self, record):
            self.records.append(record)

    name = {"v": "NVIDIA H100 80GB HBM3"}
    sink = _Sink()
    lg = logging.getLogger("ptype_tpu_torch.metrics")
    lg.addHandler(sink)
    with mock.patch.object(torch.cuda, "is_available", return_value=True), \
            mock.patch.object(torch.cuda, "get_device_name",
                              side_effect=lambda d=None: name["v"]):
        try:
            assert tmetrics.device_peak_tflops("cuda") == 989.0
            name["v"] = "NVIDIA Weirdcard 9000"
            tmetrics._peak_warned.discard("nvidia weirdcard 9000")
            assert tmetrics.device_peak_tflops("cuda") is None
            assert tmetrics.device_peak_tflops("cuda") is None
            monkeypatch.setenv(tmetrics.PEAK_TFLOPS_ENV, "weirdcard=1234")
            assert tmetrics.device_peak_tflops("cuda") == 1234.0
        finally:
            lg.removeHandler(sink)
    hits = [r for r in sink.records
            if "unknown accelerator" in r.getMessage()]
    assert len(hits) == 1
    assert tmetrics.PEAK_TFLOPS_ENV in hits[0].getMessage()
