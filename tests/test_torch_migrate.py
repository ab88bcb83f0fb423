"""The port's disaggregated prefill/decode against the JAX reference, in
f32 (and bf16 for the wire) on the CPU at ``tiny``: the q8 leaf codec
bit for bit, exact-wire payloads crossing between the packages both
ways and through the port's socket codec, the engine migration
protocol (exact-wire greedy tokens equal to solo decode and to the
reference engines' own migration, chain-hash dedup, q8 decodes, a
truncated wire refused and unwound, speculation across a migration,
imports interleaved with an in-flight decode) and a sampled migrated
row equal to its unified run. Parameters cross as numpy; prompts are
numpy, seeded."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptype_tpu.metrics import MetricsRegistry as JRegistry
from ptype_tpu.models import transformer as jtfm
from ptype_tpu.parallel import collectives as jcoll
from ptype_tpu.serve_engine import KVMigrator as JMigrator
from ptype_tpu.serve_engine import PagedGeneratorActor as JPaged
from ptype_tpu.serve_engine import migrate as jmig
from ptype_tpu_torch import codec
from ptype_tpu_torch.metrics import MetricsRegistry
from ptype_tpu_torch.models import generate as tgen
from ptype_tpu_torch.models import transformer as ttfm
from ptype_tpu_torch.models.weights import params_from_numpy
from ptype_tpu_torch.parallel import collectives as tcoll
from ptype_tpu_torch.serve_engine import (WIRE_MODES, KVMigrator,
                                          PagedGeneratorActor, SpecConfig)
from ptype_tpu_torch.serve_engine import migrate as tmig

JCFG = jtfm.preset("tiny", dtype=jnp.float32)
CFG = ttfm.preset("tiny", dtype=torch.float32)
BT = 16
SHAPE = (2, BT, 2, 8)
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(scope="module")
def trees():
    pj = jtfm.init_params(jax.random.PRNGKey(0), JCFG)
    return pj, params_from_numpy(jax.tree_util.tree_map(np.asarray, pj),
                                 CFG)


def _prompt(n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(1, CFG.vocab_size, n)


def _engine(params, serve_class="unified", spec=None, **over):
    kw = dict(params=params, device="cpu", n_slots=2, block_tokens=BT,
              prefill_chunk=32, serve_class=serve_class, spec=spec,
              metrics_registry=MetricsRegistry())
    kw.update(over)
    return PagedGeneratorActor(CFG, **kw)


def _jengine(params, serve_class="unified"):
    return JPaged(JCFG, params=params, n_slots=2, block_tokens=BT,
                  prefill_chunk=32, serve_class=serve_class,
                  metrics_registry=JRegistry())


def _migrate(pre, dec, prompt, max_new, kv_wire="exact", **kw):
    """The whole protocol in one process (no RPC): Prefill →
    MigratePlan → ExportBlocks → ImportBlocks → ReleaseExport →
    MigrateDecode. Returns (tokens, prefill reply, plan)."""
    rep = pre.Prefill(prompt, max_new, **kw)
    plan = dec.MigratePlan(prompt, max_new, **kw)
    wire = pre.ExportBlocks(rep["export_id"], plan["need"], kv_wire)
    dec.ImportBlocks(plan["ticket"], wire)
    assert pre.ReleaseExport(rep["export_id"])
    toks = dec.MigrateDecode(plan["ticket"], rep["first_token"])
    return toks, rep, plan


def _banks(dtype, seed):
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(2, 4) + SHAPE[1:]).astype(np.float32)
    v = rng.normal(size=(2, 4) + SHAPE[1:]).astype(np.float32)
    return k, v


# ------------------------------------------------------- wire (unit)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_q8_leaf_codec_equals_the_reference_bit_for_bit(dtype):
    """``q``, ``s`` and the new residual equal the reference's
    ``quantize_leaf`` exactly (the same f32 flatten, ``amax / 127``
    division and half-to-even rounding); the dequantized leaf too."""
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(11)
    # 128 scale blocks: a reciprocal product in place of the division
    # would be 1 ulp off in ~5% of them.
    x = (rng.normal(size=(16, 16, 4, 64)) * 3).astype(np.float32)
    x[0, 0, 0, :4] = 0.0
    res = (rng.normal(size=x.shape) * 0.01).astype(np.float32)
    for r in (None, res):
        wt, nrt = tcoll.quantize_leaf(
            torch.from_numpy(x).to(tdt), 512,
            None if r is None else torch.from_numpy(r).to(tdt))
        wj, nrj = jcoll.quantize_leaf(
            jnp.asarray(x, jdt), 512,
            None if r is None else jnp.asarray(r, jdt))
        np.testing.assert_array_equal(wt["q"].numpy(), np.asarray(wj["q"]))
        np.testing.assert_array_equal(wt["s"].numpy(), np.asarray(wj["s"]))
        assert wt["shape"] == wj["shape"] and wt["dtype"] == wj["dtype"]
        np.testing.assert_array_equal(
            nrt.float().numpy(), np.asarray(nrj.astype(jnp.float32)))
        np.testing.assert_array_equal(
            tcoll.dequantize_leaf(wt).float().numpy(),
            np.asarray(jcoll.dequantize_leaf(wj).astype(jnp.float32)))
    assert tcoll.DEFAULT_QUANT_BLOCK == jcoll.DEFAULT_QUANT_BLOCK
    assert tcoll._Q8_KEY == jcoll._Q8_KEY


def test_kv_migrator_roundtrip_and_residual_lru():
    k, v = _banks("float32", 3)
    kb, vb = torch.from_numpy(k), torch.from_numpy(v)
    mig = KVMigrator(SHAPE, torch.float32, max_residuals=3)
    payload, nb = mig.pack_block(kb, vb, 1, None, "exact")
    assert nb == 2 * int(np.prod(SHAPE)) * 4
    k2, v2 = torch.zeros_like(kb), torch.zeros_like(vb)
    ptr = k2.data_ptr()
    mig.unpack_block(k2, v2, payload, 2, "exact")
    assert k2.data_ptr() == ptr  # written in place
    assert torch.equal(k2[:, 2], kb[:, 1]) and torch.equal(v2[:, 2], vb[:, 1])
    payload, nbq = mig.pack_block(kb, vb, 1, 7, "q8")
    assert nbq == 2 * (int(np.prod(SHAPE)) + 4 * 1)  # one scale a leaf
    k3, v3 = torch.zeros_like(kb), torch.zeros_like(vb)
    mig.unpack_block(k3, v3, payload, 0, "q8")
    np.testing.assert_allclose(k3[:, 0].numpy(), k[:, 1], atol=0.05)
    assert mig.residual_count() == 1
    for h in range(20, 26):
        mig.pack_block(kb, vb, 0, h, "q8")
    assert mig.residual_count() == 3
    with pytest.raises(ValueError, match="kv_wire"):
        mig.pack_block(kb, vb, 0, None, "zstd")
    assert WIRE_MODES == jmig.WIRE_MODES


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_wire_payloads_cross_between_the_packages(dtype):
    """A port payload unpacks through the reference, and the reverse:
    the exact wire bit for bit (bf16 as raw bits + dtype name), the q8
    wire to the same dequantized block."""
    tdt, jdt = DTYPES[dtype]
    k, v = _banks(dtype, 5)
    kt, vt = torch.from_numpy(k).to(tdt), torch.from_numpy(v).to(tdt)
    kj, vj = jnp.asarray(k, jdt), jnp.asarray(v, jdt)
    tm, jm = KVMigrator(SHAPE, tdt), JMigrator(SHAPE, jdt)
    pt, nbt = tm.pack_block(kt, vt, 1, None, "exact")
    pj, nbj = jm.pack_block(kj, vj, 1, None, "exact")
    assert nbt == nbj
    for name, ref in (("k", kt), ("v", vt)):
        got = np.asarray(jmig._unwire_leaf(pt[name]))
        assert str(got.dtype) == dtype
        np.testing.assert_array_equal(
            got.astype(np.float32), ref[:, 1].float().numpy())
        back = tmig._unwire_leaf(pj[name])
        assert back.dtype == tdt and torch.equal(back, ref[:, 1])
    # q8: the same bytes on the wire. The reference packs in a jitted
    # program, where XLA turns ``amax / 127`` into a product with the
    # reciprocal: its scales sit within 1 ulp of the division the port
    # (and the reference's eager ``quantize_leaf``) computes, and a
    # value on a rounding boundary moves by 1.
    qt, nqt = tm.pack_block(kt, vt, 2, 9, "q8")
    qj, nqj = jm.pack_block(kj, vj, 2, 9, "q8")
    assert nqt == nqj
    for name in ("k", "v"):
        s_t, s_j = qt[name]["s"], np.asarray(qj[name]["s"])
        np.testing.assert_allclose(s_t, s_j, rtol=2.0 ** -23, atol=0)
        dq = qt[name]["q"].astype(int) - np.asarray(qj[name]["q"]).astype(int)
        assert np.abs(dq).max() <= 1 and (dq != 0).mean() < 0.01
    # One payload, one block out of either package's unpack.
    kj2, vj2 = jm.unpack_block(jnp.zeros_like(kj), jnp.zeros_like(vj), qt,
                               0, "q8")
    k2, v2 = torch.zeros_like(kt), torch.zeros_like(vt)
    tm.unpack_block(k2, v2, qt, 0, "q8")
    np.testing.assert_array_equal(
        k2[:, 0].float().numpy(), np.asarray(kj2[:, 0].astype(jnp.float32)))
    np.testing.assert_array_equal(
        v2[:, 0].float().numpy(), np.asarray(vj2[:, 0].astype(jnp.float32)))


def test_exact_wire_bf16_banks_survive_the_port_codec():
    k, v = _banks("bfloat16", 6)
    kb = torch.from_numpy(k).to(torch.bfloat16)
    vb = torch.from_numpy(v).to(torch.bfloat16)
    mig = KVMigrator(SHAPE, torch.bfloat16)
    payload, nb = mig.pack_block(kb, vb, 1, None, "exact")
    assert nb == 2 * int(np.prod(SHAPE)) * 2
    wired = codec.decode(codec.encode(payload))  # the socket hop
    k2, v2 = torch.zeros_like(kb), torch.zeros_like(vb)
    mig.unpack_block(k2, v2, wired, 3, "exact")
    assert torch.equal(k2[:, 3], kb[:, 1]) and torch.equal(v2[:, 3], vb[:, 1])
    payload, _ = mig.pack_block(kb, vb, 0, 9, "q8")
    codec.decode(codec.encode(payload))


# ------------------------------------------- engine protocol (parity)


def test_migration_exact_wire_matches_solo_decode_and_dedups(trees):
    """A migrated request's tokens equal the same request served solo
    (exact wire, greedy); a second request sharing the prefix ships
    nothing but the tail."""
    _, pt = trees
    pre, dec = _engine(pt, "prefill"), _engine(pt, "decode")
    try:
        prompt = torch.as_tensor(_prompt(40, 1))[None]
        max_new = 8
        ref = tgen.generate(pt, CFG, prompt, max_new)[0].tolist()
        toks, rep, plan = _migrate(pre, dec, prompt, max_new)
        assert rep["first_token"] == ref[0]
        assert toks == ref
        assert plan["need"] == [0, 1] and plan["resident"] == 0
        assert plan["tail"] == 8
        toks2, _, plan2 = _migrate(pre, dec, prompt, max_new)
        assert toks2 == toks
        assert plan2["need"] == [] and plan2["resident"] == 2
        info = dec.Info()
        assert info["serve_class"] == "decode"
        assert info["migrations"] == 2 and info["migrate_dedup_hits"] == 2
        assert info["migrate_bytes"] > 0 and info["migrate_inflight"] == 0
        assert pre.Info()["serve_class"] == "prefill"
        summ = dec.ledger.summary()
        assert summ["migrated_requests"] == 2 and "migrate_p99_ms" in summ
        assert pre.pool.check_invariants() == []
        assert dec.pool.check_invariants() == []
    finally:
        pre.close()
        dec.close()


def test_migrated_tokens_equal_the_reference_engines_migration(trees):
    """The same request migrated between two reference engines and
    between two port engines: the same first token, plan and tokens;
    and a port export lands in a reference decode engine."""
    pj, pt = trees
    prompt_np = _prompt(40, 2)
    jpre, jdec = _jengine(pj, "prefill"), _jengine(pj, "decode")
    pre, dec = _engine(pt, "prefill"), _engine(pt, "decode")
    try:
        jtoks, jrep, jplan = _migrate(jpre, jdec,
                                      jnp.asarray(prompt_np)[None], 8)
        toks, rep, plan = _migrate(pre, dec,
                                   torch.as_tensor(prompt_np)[None], 8)
        assert toks == jtoks and rep["first_token"] == jrep["first_token"]
        assert rep["hashes"] == jrep["hashes"]
        assert {k: plan[k] for k in ("need", "resident", "tail")} == \
            {k: jplan[k] for k in ("need", "resident", "tail")}
        # Port prefill → reference decode: the wire crosses packages.
        p2 = _prompt(40, 3)
        rep2 = pre.Prefill(torch.as_tensor(p2)[None], 8)
        plan2 = jdec.MigratePlan(jnp.asarray(p2)[None], 8)
        jdec.ImportBlocks(plan2["ticket"], pre.ExportBlocks(
            rep2["export_id"], plan2["need"], "exact"))
        pre.ReleaseExport(rep2["export_id"])
        got = jdec.MigrateDecode(plan2["ticket"], rep2["first_token"])
        want = np.asarray(jpre.Generate(jnp.asarray(p2)[None], 8))[0]
        assert got == [int(x) for x in want]
    finally:
        for e in (jpre, jdec, pre, dec):
            e.close()


def test_q8_wire_decodes_at_a_quarter_of_exact_bytes_on_f32_banks(trees):
    _, pt = trees
    pre, dec = _engine(pt, "prefill"), _engine(pt, "decode")
    try:
        prompt = torch.as_tensor(_prompt(40, 4))[None]
        rep = pre.Prefill(prompt, 6)
        plan = dec.MigratePlan(prompt, 6)
        exact = pre.ExportBlocks(rep["export_id"], plan["need"], "exact")
        q8 = pre.ExportBlocks(rep["export_id"], plan["need"], "q8")
        # int8 + one f32 scale a 512 elements, against f32.
        assert q8["nbytes"] == pytest.approx(exact["nbytes"]
                                             * (1 + 4 / 512) / 4)
        dec.ImportBlocks(plan["ticket"], q8)
        pre.ReleaseExport(rep["export_id"])
        toks = dec.MigrateDecode(plan["ticket"], rep["first_token"])
        assert 1 <= len(toks) <= 6 and toks[0] == rep["first_token"]
        assert pre._migrator.residual_count() > 0   # EF state stayed
        assert dec._migrator.residual_count() == 0
    finally:
        pre.close()
        dec.close()


def test_truncated_wire_refused_and_abort_unwinds(trees):
    _, pt = trees
    pre, dec = _engine(pt, "prefill"), _engine(pt, "decode")
    try:
        prompt = torch.as_tensor(_prompt(40, 5))[None]
        free0 = dec.pool.free_blocks()
        rep = pre.Prefill(prompt, 6)
        plan = dec.MigratePlan(prompt, 6)
        wire = pre.ExportBlocks(rep["export_id"], plan["need"], "exact")
        short = dict(wire, blocks=wire["blocks"][:-1])
        with pytest.raises(RuntimeError, match="truncated"):
            dec.ImportBlocks(plan["ticket"], short)
        with pytest.raises(RuntimeError, match="not"):
            dec.MigrateDecode(plan["ticket"], rep["first_token"])
        assert dec.AbortMigration(plan["ticket"])
        assert not dec.AbortMigration(plan["ticket"])  # idempotent
        assert pre.ReleaseExport(rep["export_id"])
        assert not pre.ReleaseExport(rep["export_id"])
        assert dec.pool.free_blocks() == free0
        assert dec.pool.check_invariants() == []
        assert pre.pool.check_invariants() == []
        assert dec.Info()["migrations"] == 0
        assert dec.ledger.summary()["retire_reasons"] == {"cancelled": 1}
    finally:
        pre.close()
        dec.close()


def test_speculation_survives_migration_with_accept_rate_intact(trees):
    """The decode side prefills its draft locally: a migrated greedy
    request emits the solo spec engine's tokens at its accept rate."""
    _, pt = trees
    dp, dcfg = tgen.truncated_draft_params(pt, CFG, n_layers=1)

    def spec():
        return SpecConfig(draft_params=dp, draft_cfg=dcfg, k=3,
                          adaptive=False)

    solo = _engine(pt, spec=spec())
    pre, dec = _engine(pt, "prefill", spec=spec()), _engine(
        pt, "decode", spec=spec())
    try:
        prompt = torch.as_tensor(_prompt(40, 6))[None]
        ref = solo.Generate(prompt, 10)[0].tolist()
        toks, _, _ = _migrate(pre, dec, prompt, 10)
        assert toks == ref
        r_solo = solo.Info().get("spec_accept_rate")
        r_mig = dec.Info().get("spec_accept_rate")
        assert r_solo is not None and r_mig == pytest.approx(r_solo)
        assert r_mig > 0
        assert dec._dpool.check_invariants() == []
    finally:
        for e in (solo, pre, dec):
            e.close()


def test_migration_interleaves_with_inflight_decode(trees):
    _, pt = trees
    pre, dec = _engine(pt, "prefill"), _engine(pt, "decode")
    try:
        p_bg = torch.as_tensor(_prompt(24, 7))[None]
        p_mig = torch.as_tensor(_prompt(40, 8))[None]
        ref_bg = tgen.generate(pt, CFG, p_bg, 12)
        ref_mig = tgen.generate(pt, CFG, p_mig, 6)[0].tolist()
        out = {}

        def bg():
            out["bg"] = dec.Generate(p_bg, 12)

        t = threading.Thread(target=bg)
        t.start()
        time.sleep(0.05)  # the background decode gets in flight
        toks, _, _ = _migrate(pre, dec, p_mig, 6)
        t.join(timeout=60)
        assert torch.equal(out["bg"], ref_bg)
        assert toks == ref_mig
    finally:
        pre.close()
        dec.close()


def test_sampled_migrated_row_equals_its_unified_run(trees):
    """The decode side advances a sampled row's generator past the
    first token's draw (made on the prefill side): the migrated stream
    is the one a unified engine draws."""
    _, pt = trees
    uni = _engine(pt)
    pre, dec = _engine(pt, "prefill"), _engine(pt, "decode")
    kw = dict(temperature=0.8, seed=5, top_k=50, top_p=0.95)
    try:
        prompt = torch.as_tensor(_prompt(40, 9))[None]
        want = uni.Generate(prompt, 10, **kw)[0].tolist()
        toks, _, _ = _migrate(pre, dec, prompt, 10, **kw)
        assert toks == want
    finally:
        for e in (uni, pre, dec):
            e.close()
