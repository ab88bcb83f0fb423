"""The port's CUDA kernels on the card: each held against its plain
PyTorch version, and the serving and training paths' launch counts;
and the audits' card side (jitwatch's CUDA detector, an armed engine,
the audit's dispatch mode on autograd's device thread).
Every test here
needs a CUDA device (a hand-written kernel has no CPU mode) and skips
without one. The file imports neither JAX nor the reference package,
so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

from ptype_tpu_torch.models import generate as gen_mod
from ptype_tpu_torch.models import transformer as ttfm
from ptype_tpu_torch.ops import flash_attention as flash_mod
from ptype_tpu_torch.ops import paged_attention as paged_mod
from ptype_tpu_torch.parallel import collectives as coll
from ptype_tpu_torch.serve import BatchingGeneratorActor, GeneratorActor
from ptype_tpu_torch.serve_engine import (KVMigrator, PagedGeneratorActor,
                                          SpecConfig)
from ptype_tpu_torch.train import Trainer, default_optimizer, synthetic_batches

pytestmark = pytest.mark.cuda
#: Kernel vs plain: f32 at the reference tests' tolerances; bf16 within
#: two bf16 ulps of outputs up to 2 in magnitude (the kernel rounds the
#: probabilities to bf16 before the P·V product, the plain version
#: does not).
FLASH_TOL = {torch.float32: 2e-4, torch.bfloat16: 3e-2}
PAGED_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
#: Backward kernels vs plain, as max abs error over the largest reference
#: magnitude: f32 sums the same terms in another order; bf16 rounds P
#: and dS to bf16 (8-bit mantissa) before the tensor-core products, where
#: the plain version keeps f32.
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
#: A narrow config with the serving head width (Dh = 128) and GQA.
NARROW = ttfm.TransformerConfig(vocab_size=256, d_model=512, n_layers=2,
                                n_heads=4, n_kv_heads=2, d_ff=256,
                                max_seq=256, dtype=torch.float32)
#: A narrow mixture-of-experts config with optimus-moe's head width
#: (Dh = 64), 4 experts, top-2.
NARROW_MOE = ttfm.TransformerConfig(vocab_size=256, d_model=256, n_layers=2,
                                    n_heads=4, d_ff=128, max_seq=256,
                                    n_experts=4, dtype=torch.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.Generator(device="cuda").manual_seed(0)


#: Shapes for both directions: the main paths' own, and the bf16
#: kernels' tile edges (128-row q tiles and 64-row K/V tiles in the
#: forward and dq, 128-row kv tiles and 64-row q tiles in dk/dv): one
#: position, one short of and one past a tile, GQA 32/8 at S=2048, a grid
#: under one wave of SMs (B=1, H=2), non-causal at S off the tile size and
#: at the B=4, S=1024 shape chip_smoke.py times, Dh=64, and optimus-moe's
#: serving prefill (B=4, S=512) and training (B=16, S=1024) shapes, 12
#: heads of 64.
EDGES = [(2, 320, 4, 2, 128, True), (2, 320, 4, 2, 128, False),
         (1, 200, 6, 6, 128, True), (2, 256, 4, 1, 64, True),
         (1, 1, 2, 2, 128, True), (1, 127, 2, 2, 128, True),
         (1, 129, 2, 2, 128, True), (1, 129, 2, 2, 64, False),
         (1, 2048, 32, 8, 128, True), (1, 256, 2, 2, 128, True),
         (4, 1024, 6, 6, 128, False), (4, 512, 12, 12, 64, True),
         (16, 1024, 12, 12, 64, True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,K,Dh,causal", EDGES)
def test_flash_kernel_matches_plain(cuda, dtype, B, S, H, K, Dh, causal):
    q = torch.randn(B, S, H, Dh, generator=cuda, device="cuda").to(dtype)
    k = torch.randn(B, S, K, Dh, generator=cuda, device="cuda").to(dtype)
    v = torch.randn(B, S, K, Dh, generator=cuda, device="cuda").to(dtype)
    before = flash_mod.flash_attention.launches
    o, lse = flash_mod.flash_attention(q, k, v, causal, return_lse=True)
    ro, rl = flash_mod.flash_attention_plain(q, k, v, causal,
                                             return_lse=True)
    torch.cuda.synchronize()
    assert flash_mod.flash_attention.launches == before + 1
    assert (o.float() - ro.float()).abs().max().item() < FLASH_TOL[dtype]
    assert (lse - rl).abs().max().item() < 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,K,Dh,causal", EDGES)
def test_flash_backward_kernels_match_plain(cuda, dtype, B, S, H, K, Dh,
                                            causal):
    q = torch.randn(B, S, H, Dh, generator=cuda, device="cuda").to(dtype)
    k = torch.randn(B, S, K, Dh, generator=cuda, device="cuda").to(dtype)
    v = torch.randn(B, S, K, Dh, generator=cuda, device="cuda").to(dtype)
    do = torch.randn(B, S, H, Dh, generator=cuda, device="cuda").to(dtype)
    o, lse = flash_mod.flash_attention(q, k, v, causal, return_lse=True)
    delta = flash_mod.bwd_delta(o, do)
    before = (flash_mod.flash_attention_dq.launches,
              flash_mod.flash_attention_dkv.launches)
    got = (flash_mod.flash_attention_dq(q, k, v, do, lse, delta, causal),
           *flash_mod.flash_attention_dkv(q, k, v, do, lse, delta, causal))
    want = flash_mod.flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    assert (flash_mod.flash_attention_dq.launches,
            flash_mod.flash_attention_dkv.launches) == (before[0] + 1,
                                                        before[1] + 1)
    # With one key, dS = P (dP - delta) is zero in exact arithmetic, so dq
    # and dk are rounding noise: hold them to the scale of dv there.
    floor = want[2].float().abs().max().item() if S == 1 else 0.0
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == dtype and a.shape == b.shape
        err = (a.float() - b.float()).abs().max().item()
        assert err <= BWD_TOL[dtype] * max(b.float().abs().max().item(),
                                           floor), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bert_base_full_mask_instance_matches_plain(cuda, dtype):
    """bert-base's attention as the async param server's workers run it
    (B=16, S=512, 12 heads of 64, no causal mask): the forward, dq and
    dk/dv kernels against their plain twins."""
    shape = (16, 512, 12, 12, 64, False)
    test_flash_kernel_matches_plain(cuda, dtype, *shape)
    test_flash_backward_kernels_match_plain(cuda, dtype, *shape)


def test_flash_grad_goes_through_the_kernels(cuda):
    q, k, v = (torch.randn(2, 128, 4, 128, generator=cuda, device="cuda",
                           requires_grad=True) for _ in range(3))
    counts = (flash_mod.flash_attention.launches,
              flash_mod.flash_attention_dq.launches,
              flash_mod.flash_attention_dkv.launches)
    o = flash_mod.flash_attention(q, k, v)
    assert o.grad_fn is not None
    o.sum().backward()
    assert (flash_mod.flash_attention.launches,
            flash_mod.flash_attention_dq.launches,
            flash_mod.flash_attention_dkv.launches) == tuple(
                c + 1 for c in counts)
    with torch.no_grad():
        flash_mod.flash_attention(q, k, v)
    assert flash_mod.flash_attention.launches == counts[0] + 2


def test_trainer_step_launches_every_kernel_per_layer(cuda):
    tr = Trainer(NARROW, device="cuda",
                 optimizer=default_optimizer(lr=1e-3, warmup=1))
    batch = next(synthetic_batches(256, 2, 128, seed=0, device="cuda"))
    flash_mod.flash_attention.launches = 0
    flash_mod.flash_attention_dq.launches = 0
    flash_mod.flash_attention_dkv.launches = 0
    losses = [float(tr.step(batch)["loss"]) for _ in range(3)]
    want = 3 * NARROW.n_layers
    assert (flash_mod.flash_attention.launches,
            flash_mod.flash_attention_dq.launches,
            flash_mod.flash_attention_dkv.launches) == (want, want, want)
    assert all(torch.isfinite(torch.tensor(losses)))
    assert losses[-1] < losses[0]


#: Decode positions: one key (0), both sides of a page (15, 16), both
#: sides of a split CTA's four pages (63, 64), and the last position of
#: the reach (nb * bt - 1).
PAGED_POS = [0, 15, 16, 63, 64, 100, 16 * 16 - 1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,Kh,Dh", [(6, 6, 128), (32, 8, 128),
                                     (16, 2, 128), (6, 6, 64),
                                     (12, 12, 64)])
def test_paged_kernel_matches_plain(cuda, dtype, H, Kh, Dh):
    n_blocks, bt, nb = 200, 16, 16
    B = len(PAGED_POS)
    kc = torch.randn(n_blocks, bt, Kh, Dh, generator=cuda,
                     device="cuda").to(dtype)
    vc = torch.randn_like(kc)
    q = torch.randn(B, 1, H, Dh, generator=cuda, device="cuda").to(dtype)
    tables = torch.randint(1, n_blocks, (B, nb), generator=cuda,
                           device="cuda", dtype=torch.int32)
    tables[1] = tables[0]  # a shared prefix: two rows, one table
    pos = torch.tensor(PAGED_POS, dtype=torch.int32, device="cuda")
    before = paged_mod.paged_attention.launches
    got = paged_mod.paged_attention(q, kc, vc, tables, pos)
    again = paged_mod.paged_attention(q, kc, vc, tables, pos)
    want = paged_mod.paged_attention_plain(q, kc, vc, tables, pos)
    torch.cuda.synchronize()
    assert paged_mod.paged_attention.launches == before + 2
    assert (got.float() - want.float()).abs().max().item() < PAGED_TOL[dtype]
    # The combine merges the splits in a fixed order: bit for bit.
    assert torch.equal(got, again)


def test_generate_prefill_launches_flash_once_per_layer(cuda):
    actor = GeneratorActor(NARROW, device="cuda")
    prompt = torch.randint(1, 256, (2, 128), generator=cuda, device="cuda")
    flash_mod.flash_attention.launches = 0
    out = actor.Generate(prompt, 4)
    assert flash_mod.flash_attention.launches == NARROW.n_layers
    assert out.shape == (2, 4)


def test_engine_launches_paged_kernel_per_step_and_layer(cuda):
    a = PagedGeneratorActor(NARROW, device="cuda", n_slots=2,
                            attn="kernel")
    b = PagedGeneratorActor(NARROW, params=a.params, device="cuda",
                            n_slots=2)
    try:
        p = torch.randint(1, 256, (1, 37), generator=cuda, device="cuda")
        paged_mod.paged_attention.launches = 0
        steps0 = a.Info()["engine_steps"]
        got = a.Generate(p, 12)
        steps = a.Info()["engine_steps"] - steps0
        assert paged_mod.paged_attention.launches == steps * NARROW.n_layers
        assert torch.equal(got, b.Generate(p, 12))
    finally:
        a.close()
        b.close()


def test_moe_paths_launch_every_kernel_per_layer(cuda):
    """The MoE prefill, engine and trainer at Dh=64: flash forward once a
    layer in prefill, paged decode once a step and layer, the three flash
    kernels once a layer a train step; engine tokens equal the
    contiguous path's."""
    actor = GeneratorActor(NARROW_MOE, device="cuda")
    prompt = torch.randint(1, 256, (2, 128), generator=cuda, device="cuda")
    flash_mod.flash_attention.launches = 0
    assert actor.Generate(prompt, 4).shape == (2, 4)
    assert flash_mod.flash_attention.launches == NARROW_MOE.n_layers
    eng = PagedGeneratorActor(NARROW_MOE, params=actor.params,
                              device="cuda", n_slots=2, attn="kernel")
    try:
        p = torch.randint(1, 256, (1, 37), generator=cuda, device="cuda")
        paged_mod.paged_attention.launches = 0
        got = eng.Generate(p, 12)
        steps = eng.Info()["engine_steps"]
        assert paged_mod.paged_attention.launches == (steps
                                                      * NARROW_MOE.n_layers)
        assert torch.equal(got, actor.Generate(p, 12))
    finally:
        eng.close()
    tr = Trainer(NARROW_MOE, device="cuda",
                 optimizer=default_optimizer(lr=1e-3, warmup=1))
    batch = next(synthetic_batches(256, 2, 128, seed=0, device="cuda"))
    for c in (flash_mod.flash_attention, flash_mod.flash_attention_dq,
              flash_mod.flash_attention_dkv):
        c.launches = 0
    losses = [float(tr.step(batch)["loss"]) for _ in range(3)]
    want = 3 * NARROW_MOE.n_layers
    assert (flash_mod.flash_attention.launches,
            flash_mod.flash_attention_dq.launches,
            flash_mod.flash_attention_dkv.launches) == (want, want, want)
    assert losses[-1] < losses[0]


def test_spec_engine_greedy_identical_to_plain_on_card(cuda):
    """f32, gather path, TF32 off: the speculative engine's greedy tokens
    equal the plain engine's."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    plain = PagedGeneratorActor(NARROW, device="cuda", n_slots=2)
    dp, dc = gen_mod.truncated_draft_params(plain.params, NARROW, 1)
    spec = PagedGeneratorActor(NARROW, params=plain.params, device="cuda",
                               n_slots=2,
                               spec=SpecConfig(dp, dc, k=3, adaptive=False))
    try:
        for n in (9, 40):
            p = torch.randint(1, 256, (1, n), generator=cuda, device="cuda")
            assert torch.equal(spec.Generate(p, 20), plain.Generate(p, 20))
        assert spec.Info()["spec_windows"] > 0
    finally:
        plain.close()
        spec.close()
        torch.backends.cuda.matmul.allow_tf32 = prev


# ------------------------------------------- KV wire and host surface


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_q8_leaf_round_trip_on_card_equals_the_cpu(cuda, dtype):
    """The q8 codec on CUDA tensors: the same q, s and residual as on
    the CPU (the same f32 division and half-to-even rounding), and the
    round trip within half a scale step of the input."""
    x = (torch.randn(12, 16, 6, 128, generator=cuda, device="cuda")
         * 3).to(dtype)
    r = (torch.randn(x.shape, generator=cuda, device="cuda") * 0.01).to(dtype)
    w, nr = coll.quantize_leaf(x, 512, r)
    wc, nrc = coll.quantize_leaf(x.cpu(), 512, r.cpu())
    assert torch.equal(w["q"].cpu(), wc["q"])
    assert torch.equal(w["s"].cpu(), wc["s"])
    assert torch.equal(nr.cpu(), nrc)
    back = coll.dequantize_leaf(w)
    assert back.dtype == dtype and back.device.type == "cuda"
    step = w["s"].repeat_interleave(512)[:x.numel()].reshape(x.shape)
    err = ((x.float() + r.float()) - back.float()).abs()
    # Half a step, plus the bank dtype's rounding of the output.
    slack = 0.0 if dtype == torch.float32 else 2.0 ** -8
    assert bool((err <= step / 2 + slack * back.float().abs() + 1e-6)
                .all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_exact_wire_moves_a_block_pair_between_card_banks(cuda, dtype):
    """Exact wire: a block pair packed from one set of CUDA banks lands
    bit for bit in another, written in place (the banks keep their
    storage); a q8 block lands within its scale step."""
    shape = (2, 9, 16, 2, 128)
    kb = torch.randn(shape, generator=cuda, device="cuda").to(dtype)
    vb = torch.randn(shape, generator=cuda, device="cuda").to(dtype)
    mig = KVMigrator((2, 16, 2, 128), dtype)
    payload, nbytes = mig.pack_block(kb, vb, 3, None, "exact")
    assert nbytes == 2 * 2 * 16 * 2 * 128 * kb.element_size()
    k2, v2 = torch.zeros_like(kb), torch.zeros_like(vb)
    ptrs = (k2.data_ptr(), v2.data_ptr())
    mig.unpack_block(k2, v2, payload, 5, "exact")
    torch.cuda.synchronize()
    assert (k2.data_ptr(), v2.data_ptr()) == ptrs
    assert torch.equal(k2[:, 5], kb[:, 3]) and torch.equal(v2[:, 5], vb[:, 3])
    assert k2[:, :5].abs().sum() == 0 and k2[:, 6:].abs().sum() == 0
    payload, nq = mig.pack_block(kb, vb, 3, 77, "q8")
    assert nq == 2 * (8192 + 4 * 16)
    mig.unpack_block(k2, v2, payload, 6, "q8")
    assert (k2.data_ptr(), v2.data_ptr()) == ptrs
    assert float((k2[:, 6].float() - kb[:, 3].float()).abs().max()) < 0.05
    assert mig.residual_count() == 1


def test_engine_migration_on_card_matches_unified(cuda):
    """f32, TF32 off: a request migrated between two card engines over
    the exact wire emits the unified engine's tokens; the decode side
    launches the paged kernel a step and layer, the prefill side none."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    kw = dict(device="cuda", n_slots=2, attn="kernel")
    uni = PagedGeneratorActor(NARROW, **kw)
    pre = PagedGeneratorActor(NARROW, params=uni.params,
                              serve_class="prefill", **kw)
    dec = PagedGeneratorActor(NARROW, params=uni.params,
                              serve_class="decode", **kw)
    try:
        p = torch.randint(1, 256, (1, 40), generator=cuda, device="cuda")
        want = uni.Generate(p, 12)[0].tolist()
        paged_mod.paged_attention.launches = 0
        rep = pre.Prefill(p, 12)
        assert paged_mod.paged_attention.launches == 0
        plan = dec.MigratePlan(p, 12)
        dec.ImportBlocks(plan["ticket"], pre.ExportBlocks(
            rep["export_id"], plan["need"], "exact"))
        pre.ReleaseExport(rep["export_id"])
        steps0 = dec.Info()["engine_steps"]
        got = dec.MigrateDecode(plan["ticket"], rep["first_token"])
        steps = dec.Info()["engine_steps"] - steps0
        assert got == want
        assert paged_mod.paged_attention.launches == steps * NARROW.n_layers
        info = dec.Info()
        assert info["migrations"] == 1 and info["requests_retired"] == 1
        assert dec.pool.check_invariants() == []
        assert pre.pool.check_invariants() == []
    finally:
        for e in (uni, pre, dec):
            e.close()
        torch.backends.cuda.matmul.allow_tf32 = prev


def test_batching_actor_equal_length_batch_launches_flash(cuda):
    """An equal-length batch with S a multiple of 128 prefills through
    the flash kernel once a layer; a mixed-length one never."""
    actor = BatchingGeneratorActor(NARROW, device="cuda", window_ms=500.0)
    try:
        import threading

        for lens, want in (((128, 128, 128), NARROW.n_layers),
                           ((100, 128, 60), 0)):
            flash_mod.flash_attention.launches = 0
            outs = [None] * len(lens)
            ps = [torch.randint(1, 256, (1, n), generator=cuda,
                                device="cuda") for n in lens]

            def call(i):
                outs[i] = actor.Generate(ps[i], 4)

            ts = [threading.Thread(target=call, args=(i,))
                  for i in range(len(lens))]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=120)
            assert flash_mod.flash_attention.launches == want
            for p, o in zip(ps, outs):
                assert o.shape == (1, 4)
    finally:
        actor.close()


# ------------------------------------------------------------ data plane


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    """A world-1 NCCL mesh on the card and a world-1 gloo mesh on the
    CPU, in this process."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (NCCL runs on the card)")
    import torch.distributed as dist

    from ptype_tpu_torch.parallel.mesh import build_mesh, init_distributed

    rdv = tmp_path_factory.mktemp("pg") / "rdv"
    init_distributed(f"file://{rdv}", 0, 1)
    try:
        gloo = dist.new_group(backend="gloo")
        yield (build_mesh({"data": 1}),
               build_mesh({"data": 1}, group=gloo, device="cpu"))
    finally:
        dist.destroy_process_group()


def _store_calls(mesh, device):
    """push, push_scatter, pull(gather=True), the int8 allreduce and an
    int8+EF tree push twice (the second folds the first's residual),
    on tensors made on the CPU from one seed and moved to ``device``."""
    from ptype_tpu_torch.parallel.collectives import (WireConfig,
                                                      quantized_all_reduce)
    from ptype_tpu_torch.parallel.tensorstore import TensorStore

    g = torch.Generator().manual_seed(5)
    x = torch.randn(64, 48, generator=g)
    tree = {"a": torch.randn(4096, generator=g) * 3,
            "b": {"c": torch.randn(96, 33, generator=g)}}
    x[::7] *= 30  # outliers
    ts = TensorStore(mesh, device=device.type)
    out = {"push": ts.push("k", x.to(device)),
           "scatter": ts.push_scatter("s", x.to(device), op="sum"),
           "pull": ts.pull("s", gather=True),
           "q8": quantized_all_reduce(x.to(device), mesh, op="mean")}
    ef = TensorStore(mesh, device=device.type, wire=WireConfig(
        compress="int8", int8_min_bytes=0, bucket_bytes=8192))
    dev_tree = {"a": tree["a"].to(device),
                "b": {"c": tree["b"]["c"].to(device)}}
    for i in range(2):
        for k, v in ef.push_tree("g", dev_tree, op="mean").items():
            out[f"ef{i}/{k}"] = v
    out.update({f"res/{k}": v for k, v in ef._residuals.items()})
    return {k: v.cpu() for k, v in out.items()}


def test_store_on_nccl_equals_the_store_on_gloo(meshes):
    """World 1: the same Store calls on CUDA tensors over NCCL and on
    CPU tensors over gloo give the same bits (the int8 wire divides by
    tensors on both, so its scales and quantized values match)."""
    nccl, gloo = meshes
    assert nccl.backend == "nccl" and gloo.backend == "gloo"
    got = _store_calls(nccl, torch.device("cuda"))
    want = _store_calls(gloo, torch.device("cpu"))
    assert sorted(got) == sorted(want)
    assert any(k.startswith("res/") for k in got)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_store_dp_trainer_with_no_device_runs_on_the_card_only(meshes):
    """With no device named, the trainer and the store are CUDA entry
    points: over a gloo CPU mesh they raise, and a cuda mesh refuses a
    gloo group."""
    from ptype_tpu_torch.errors import ClusterError
    from ptype_tpu_torch.parallel.mesh import build_mesh
    from ptype_tpu_torch.parallel.tensorstore import TensorStore
    from ptype_tpu_torch.train.store_dp import StoreDPTrainer

    nccl, gloo = meshes
    cfg = ttfm.preset("tiny", dtype=torch.float32)
    with pytest.raises(ClusterError, match="mesh"):
        TensorStore(gloo)
    with pytest.raises(ClusterError, match="store"):
        StoreDPTrainer(cfg, TensorStore(gloo, device="cpu"))
    with pytest.raises(ClusterError, match="nccl"):
        build_mesh({"data": 1}, group=gloo.group, device="cuda")
    tr = StoreDPTrainer(cfg, TensorStore(nccl))
    assert tr.device.type == "cuda"


# ------------------------------------------------- checkpoint and elastic


def test_checkpoint_round_trip_of_card_tensors(cuda, tmp_path):
    """Card tensors (f32, bf16, a Shard of a card tensor) saved and
    restored onto the card bit for bit; restore with no device named
    lands on cuda."""
    from ptype_tpu_torch.checkpoint import Checkpointer, Shard

    w = torch.randn(64, 32, generator=cuda, device="cuda")
    tree = {"w": w, "b": w[:4].to(torch.bfloat16), "n": 3,
            "half": Shard(w[:32], (0, 0), (32, 32))}
    ck = Checkpointer(str(tmp_path))
    ck.save(1, tree)
    got = ck.restore({"w": 0, "b": 0, "n": 0, "half": 0})
    assert all(v.device.type == "cuda" for v in got.values())
    assert torch.equal(got["w"], w) and torch.equal(got["b"], tree["b"])
    assert torch.equal(got["half"], w[:32]) and int(got["n"]) == 3


def test_async_save_races_an_in_place_adamw_step(cuda, tmp_path):
    """The snapshot is a copy enqueued on the step's stream: the next
    step, dispatched right after ``async_save`` returns and updating
    params and moments in place, cannot reach the saved bytes."""
    from ptype_tpu_torch.checkpoint import Checkpointer
    from ptype_tpu_torch.train import trainer as tr_mod

    tr = Trainer(NARROW, device="cuda", sync_every=0,
                 optimizer=default_optimizer(lr=1e-2, warmup=1))
    stream = synthetic_batches(256, 4, 64, seed=1, device="cuda")
    batches = [next(stream) for _ in range(2)]
    tr.step(batches[0])
    ck = Checkpointer(str(tmp_path))
    tr.save(ck, background=True)
    tr.step(batches[1])  # in place, right behind the snapshot's copies
    torch.cuda.synchronize()
    want = Trainer(NARROW, device="cuda", sync_every=0,
                   optimizer=default_optimizer(lr=1e-2, warmup=1))
    want.step(batches[0])
    ck.wait()
    got = Trainer(NARROW, device="cuda", sync_every=0,
                  generator=torch.Generator().manual_seed(3))
    assert got.restore(ck) == 1
    from ptype_tpu_torch.checkpoint import _flatten

    for (p, a), (_, b) in zip(_flatten(tr_mod.state_tree(got.state)),
                              _flatten(tr_mod.state_tree(want.state))):
        if torch.is_tensor(a):
            assert torch.equal(a, b), p
    moved = tr_mod.state_tree(tr.state)["0"]["embed"]
    assert not torch.equal(moved, got.state.params["embed"])


@pytest.mark.parametrize("zero", [2, 3])
def test_live_reshard_at_world_1_on_nccl(meshes, zero):
    """StoreDPTrainer.reshard onto a new world-1 NCCL group (with its
    gloo control group) mid-run: the next steps equal an uninterrupted
    trainer's bit for bit."""
    from ptype_tpu_torch.parallel.mesh import survivor_mesh
    from ptype_tpu_torch.parallel.tensorstore import TensorStore
    from ptype_tpu_torch.train.store_dp import StoreDPTrainer

    nccl, _ = meshes
    cfg = NARROW
    stream = synthetic_batches(cfg.vocab_size, 4, 64, seed=2, device="cuda")
    batches = [next(stream) for _ in range(4)]

    def trainer():
        return StoreDPTrainer(
            cfg, TensorStore(nccl), zero=zero,
            generator=torch.Generator(device="cuda").manual_seed(0))

    a, b = trainer(), trainer()
    la = [a.step(x)["loss"] for x in batches]
    lb = [b.step(x)["loss"] for x in batches[:2]]
    new = survivor_mesh(nccl, [0])
    assert new.backend == "nccl" and new.control is not None
    info = b.reshard(new)
    assert (info["old_n"], info["new_n"]) == (1, 1)
    lb += [b.step(x)["loss"] for x in batches[2:]]
    assert la == lb
    pa, pb = a.params(), b.params()
    from ptype_tpu_torch.checkpoint import _flatten

    for (p, x), (_, y) in zip(_flatten(pa), _flatten(pb)):
        assert torch.equal(x, y), p


# ------------------------------------------------------- cluster plane


class _CardEcho:
    def Echo(self, x):
        return x

    def Where(self, x):
        return str(x.device)

    def Sum(self, x):
        return x.sum()


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32,
                                   torch.bfloat16])
def test_actor_tcp_round_trip_lands_on_the_card(cuda, dtype, monkeypatch):
    """A CUDA tensor through the port's ActorServer over TCP: it arrives
    on the server's card (no device named → cuda) and the reply lands
    on the client's card, equal bit for bit."""
    from ptype_tpu_torch import actor as actor_mod
    from ptype_tpu_torch import rpc
    from ptype_tpu_torch.registry import Node

    monkeypatch.setattr(actor_mod, "lookup_local", lambda a, p: None)
    srv = actor_mod.ActorServer("127.0.0.1", 0)
    srv.register(_CardEcho(), "E")
    srv.serve()
    try:
        conn = rpc._dial(Node("127.0.0.1", srv.port), 5.0)
        assert isinstance(conn, rpc._Conn)
        x = (torch.randn(257, 33, generator=cuda, device="cuda") * 100
             ).to(dtype)
        assert conn.call_async("E.Where", (x,)).result(timeout=60) \
            .startswith("cuda")
        y = conn.call_async("E.Echo", (x,)).result(timeout=60)
        assert y.device.type == "cuda" and y.dtype == dtype
        assert torch.equal(y, x)  # no NaN in x: equal is bit for bit
        conn.close()
    finally:
        srv.close()


def test_local_conn_waits_for_the_callers_side_stream(cuda):
    """In one process a CUDA tensor passes by reference into the
    dispatch thread: a tensor still being written on the caller's side
    stream must be read complete (the dispatch stream waits for the
    caller's), and the reply is complete when the call resolves."""
    from ptype_tpu_torch import actor as actor_mod
    from ptype_tpu_torch import rpc
    from ptype_tpu_torch.registry import Node

    srv = actor_mod.ActorServer("127.0.0.1", 0)
    srv.register(_CardEcho(), "E")
    srv.serve()
    try:
        conn = rpc._dial(Node("127.0.0.1", srv.port), 5.0)
        assert isinstance(conn, rpc._LocalConn)
        x = torch.zeros(1 << 22, device="cuda")
        torch.cuda.synchronize()
        side = torch.cuda.Stream()
        with torch.cuda.stream(side):
            torch.cuda._sleep(200_000_000)  # ~0.1 s ahead of the fill
            x.fill_(1.0)
            fut = conn.call_async("E.Sum", (x,))
        s = fut.result(timeout=60)
        assert s.item() == float(x.numel())
    finally:
        srv.close()


def test_gateway_answers_int32_on_the_card(cuda):
    """The port's InferenceGateway (no device named → cuda) in front of
    one in-process ActorServer engine: the answer is an int32 tensor on
    the card, equal to the engine's own tokens, and the engine's decode
    steps went through the paged kernel."""
    from ptype_tpu_torch.actor import ActorServer
    from ptype_tpu_torch.coord.core import CoordState
    from ptype_tpu_torch.coord.local import LocalCoord
    from ptype_tpu_torch.gateway import GatewayConfig, InferenceGateway
    from ptype_tpu_torch.registry import CoordRegistry

    eng = PagedGeneratorActor(NARROW, device="cuda", n_slots=2,
                              attn="kernel")
    srv = ActorServer("127.0.0.1", 0)
    srv.register(eng, "Paged")
    srv.serve()
    state = CoordState(sweep_interval=0.05)
    registry = CoordRegistry(LocalCoord(state), lease_ttl=1.0)
    reg = registry.register("card-llm", "r0", "127.0.0.1", srv.port)
    gw = InferenceGateway(registry, "card-llm", GatewayConfig(
        generate_method="Paged.Generate", info_method="Paged.Info",
        probe_interval_s=0.1))
    try:
        assert gw.device == torch.device("cuda")
        assert gw.pool.n_healthy() == 1
        p = torch.randint(1, 256, (1, 37), generator=cuda, device="cuda")
        paged_mod.paged_attention.launches = 0
        steps0 = eng.Info()["engine_steps"]
        out = gw.generate(p.to(torch.int32), 12)
        steps = eng.Info()["engine_steps"] - steps0
        assert out.device.type == "cuda" and out.dtype == torch.int32
        assert tuple(out.shape) == (1, 12)
        assert paged_mod.paged_attention.launches == steps * NARROW.n_layers
        assert torch.equal(out, eng.Generate(p, 12).to(torch.int32))
    finally:
        gw.close()
        reg.close()
        srv.close()
        eng.close()
        state.close()


# ------------------------------------------------------ health plane


def test_profile_on_the_card_captures_cuda_kernels(cuda, tmp_path):
    """A ``ptype.Profile`` session in a CUDA process traces CUDA
    activity: the shipped trace names the flash forward kernel a
    prefill launched, on another thread than the session's, and the
    manifest says CUDA was traced."""
    import threading

    from ptype_tpu_torch.health import profiling

    actor = GeneratorActor(NARROW, device="cuda")
    prompt = torch.randint(1, 256, (2, 128), generator=cuda, device="cuda")
    actor.Generate(prompt, 4)  # the kernels' modules load before the window
    profiling.start(label="card", base=str(tmp_path))
    t = threading.Thread(target=lambda: actor.Generate(prompt, 4))
    t.start()
    t.join(timeout=120)
    assert not t.is_alive()
    out = profiling.stop(include_data=True)
    assert out["activities"] == ["cpu", "cuda"]
    assert out["device_events"] > 0
    top = profiling.summarize(out["dir"], top=10_000)["top_ops"]
    assert any("flash_fwd_kernel" in op["name"] for op in top), [
        op["name"] for op in top][:20]
    mem = out["memory"]["devices"][0]
    assert mem["platform"] == "cuda" and mem["stats"]["bytes_limit"] > 0
    assert set(mem["stats"]) >= {"bytes_in_use", "peak_bytes_in_use",
                                 "bytes_limit"}
    assert out["memory"]["memory_profile_size"] > 0


#: A fresh CUDA process: a loader thread launches kernels inside
#: ``device_work`` without pause while the main thread runs 12 profiler
#: sessions one after another; one line a session: its kernel records.
_SESSIONS_UNDER_LOAD = """
import gzip, json, os, sys, threading, time
import torch
from ptype_tpu_torch.device import device_work
from ptype_tpu_torch.health import profiling
stop = threading.Event()
def load():
    a = torch.randn(256, 256, device="cuda")
    while not stop.is_set():
        with device_work():
            for _ in range(8):
                a = torch.tanh(a @ a) * 0.5
        torch.cuda.synchronize()
t = threading.Thread(target=load, daemon=True)
t.start()
time.sleep(1.0)
for i in range(12):
    profiling.start(label=f"s{i}", base=sys.argv[1])
    time.sleep(0.3)
    out = profiling.stop()
    n = 0
    for f in out["files"]:
        if f["path"].endswith(".trace.json.gz"):
            with gzip.open(os.path.join(out["dir"], f["path"]), "rt") as fp:
                n += sum(1 for e in json.load(fp)["traceEvents"]
                         if e.get("ph") == "X" and e.get("cat") == "kernel")
    print(n, flush=True)
stop.set()
t.join(timeout=30)
"""


def test_sessions_under_load_keep_their_kernel_records(cuda, tmp_path):
    """CUPTI switched on or off while another thread launches kernels
    could stop recording kernels for that session and the process's
    later ones (a replica's capture with none of the 12 flash records
    failover (d) needs). Sessions switch only with no device work in
    flight, so each of 12 back-to-back sessions under a launching
    thread holds that thread's kernels."""
    import os
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, "-c", _SESSIONS_UNDER_LOAD, str(tmp_path)],
        cwd=root, env=dict(os.environ, PYTHONPATH=str(root)),
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    counts = [int(x) for x in out.stdout.split()]
    assert len(counts) == 12
    assert min(counts) >= 100, counts


def test_a_chunked_capture_holds_kernels_in_every_trace(cuda, tmp_path,
                                                        monkeypatch):
    """A session longer than ``CHUNK_S`` (0.3 s here) while another
    thread launches kernels inside ``device_work`` (then pauses 10 ms)
    is recorded in several sessions (stopped once three have ended, or
    after 120 s): every trace file holds device records, each full one
    at least 100 (the loader's kernels), the manifest's device records
    are their sum, and its ``kernels_lost`` each file's kernel launches
    less its kernel records, by a parse."""
    import gzip
    import json
    import os
    import threading
    import time

    from ptype_tpu_torch.device import device_work
    from ptype_tpu_torch.health import profiling

    monkeypatch.setattr(profiling, "CHUNK_S", 0.3)
    halt = threading.Event()

    def load():
        a = torch.randn(256, 256, device="cuda")
        while not halt.is_set():
            with device_work():
                for _ in range(8):
                    a = torch.tanh(a @ a) * 0.5
            torch.cuda.synchronize()
            halt.wait(0.01)

    t = threading.Thread(target=load, daemon=True)
    t.start()
    try:
        profiling.start(label="chunks", base=str(tmp_path))
        deadline = time.monotonic() + 120
        while (len(profiling._active["chunks"]) < 3
               and time.monotonic() < deadline):
            time.sleep(0.05)
        out = profiling.stop()
    finally:
        halt.set()
        t.join(timeout=30)
    assert out["chunks"] >= 3 and len(out["files"]) == out["chunks"]
    per_file, lost = [], []
    for f in out["files"]:
        with gzip.open(os.path.join(out["dir"], f["path"]), "rt") as fp:
            evs = [e for e in json.load(fp)["traceEvents"]
                   if e.get("ph") == "X"]
        per_file.append(sum(e.get("cat") in profiling.DEVICE_CATEGORIES
                            for e in evs))
        launches = sum(e.get("cat") in ("cuda_runtime", "cuda_driver")
                       and e["name"].startswith(("cudaLaunchKernel",
                                                 "cuLaunchKernel"))
                       for e in evs)
        lost.append(max(0, launches - sum(e.get("cat") == "kernel"
                                          for e in evs)))
    # The last recording is cut short by the stop; the others ran 0.3 s.
    assert min(per_file[:-1]) >= 100 and per_file[-1] > 0, per_file
    assert out["device_events"] == sum(per_file)
    assert out["kernels_lost"] == lost


#: Seconds the idle-after-load test repeats its loaded-then-idle pair.
IDLE_AFTER_LOAD_S = 60.0


def test_an_idle_capture_after_loaded_ones_keeps_a_kernel_in_every_trace(
        cuda, tmp_path):
    """An idle capture that follows loaded ones in the same process
    (``--profile-sweep``'s order: a 0.1 s warm-up, loaded captures of
    0.25, 1, 3 and 3 s while a thread launches kernels inside
    ``device_work``, then an idle 3 s capture; then the loaded 1 s and
    idle 3 s pair again until ``IDLE_AFTER_LOAD_S`` have passed, at the
    production ``CHUNK_S`` of 1 s) ends ok, and every trace file of
    every capture holds a kernel record. Such a recording could come
    back with none, its markers' launches traced: the stop raised. One
    ``idle_after_load`` line gives the captures, the idle ones, those
    that failed (the stop raised, or a trace held no kernel record), and
    each idle capture's kernel records by file. In the process of the
    card tests, before ``profiling.CUPTI_TEARDOWN_ENV``, every idle
    capture failed so."""
    import gzip
    import json
    import os
    import threading
    import time

    from ptype_tpu_torch.device import device_work
    from ptype_tpu_torch.health import profiling

    load_on, halt = threading.Event(), threading.Event()

    def load():
        a = torch.randn(512, 512, device="cuda")
        while not halt.is_set():
            if not load_on.wait(0.05):
                continue
            with device_work():
                for _ in range(8):
                    a = torch.tanh(a @ a) * 0.5
            torch.cuda.synchronize()
            halt.wait(0.002)

    def kernels(d):
        out = []
        for f in sorted(os.listdir(d)):
            with gzip.open(os.path.join(d, f), "rb") as fp:
                out.append(profiling.count_records(fp.read)["kernel"])
        return out

    stats = {"captures": 0, "idle": 0, "failed": [], "idle_kernels": []}

    def cap(window, loaded):
        (load_on.set if loaded else load_on.clear)()
        if loaded:
            time.sleep(0.2)
        stats["captures"] += 1
        base = str(tmp_path / f"c{stats['captures']}")
        try:
            out = profiling.capture(duration_s=window, base=base)
        except profiling.ProfileError as e:
            (d,) = os.listdir(base)
            stats["failed"].append([window, loaded, str(e)[-200:],
                                    kernels(os.path.join(base, d))])
            return
        per_file = kernels(out["dir"])
        if not loaded:
            stats["idle_kernels"].append(per_file)
        if not per_file or min(per_file) < 1:
            stats["failed"].append([window, loaded, None, per_file])

    torch.zeros(1, device="cuda")  # a CUDA process: its captures trace CUDA
    torch.cuda.synchronize()
    t = threading.Thread(target=load, daemon=True)
    t.start()
    t0 = time.monotonic()
    try:
        cap(0.1, False)
        for w in (0.25, 1.0, 3.0, 3.0):
            cap(w, True)
        while True:
            cap(3.0, False)
            stats["idle"] += 1
            if time.monotonic() - t0 > IDLE_AFTER_LOAD_S:
                break
            cap(1.0, True)
    finally:
        halt.set()
        t.join(timeout=30)
    print(json.dumps({"idle_after_load": stats}), flush=True)
    assert not stats["failed"], stats


def test_store_dp_compiled_cost_on_the_card(meshes):
    """``StoreDPTrainer.compiled_cost`` of a card trainer counts on
    ``meta`` skeletons: the same FLOPs as the CPU count, and the card
    state untouched."""
    from ptype_tpu_torch.health import profiling
    from ptype_tpu_torch.parallel.tensorstore import TensorStore
    from ptype_tpu_torch.train.store_dp import StoreDPTrainer

    nccl, _ = meshes
    cfg = NARROW
    tr = StoreDPTrainer(cfg, TensorStore(nccl))
    toks = torch.randint(0, cfg.vocab_size, (8, 33), device="cuda")
    tr.step({"tokens": toks[:, :-1], "targets": toks[:, 1:]})
    before = [p.clone() for p in tr._param_leaves]
    cost = tr.compiled_cost()
    assert all(torch.equal(a, b) for a, b in zip(before, tr._param_leaves))
    assert cost["flops"] == profiling.transformer_grads_cost(
        cfg, 8, 32, stacked=1)["flops"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("policy", ["none", "dots"])
def test_remat_grads_equal_no_remat_through_the_flash_kernels(cuda, policy,
                                                              dtype):
    """Remat re-runs each layer's forward, the flash forward kernel
    among it, in backward (2 forward launches a layer, one dq and one
    dk/dv): the loss and every gradient equal no remat's, through the
    kernels, at the narrow GQA config (Dh = 128)."""
    from dataclasses import replace

    from ptype_tpu_torch.models.weights import init_params
    from ptype_tpu_torch.train import trainer as tr

    cfg = replace(NARROW, dtype=dtype, attn_impl="flash")
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    for _, p in tr._flatten(params):
        p.requires_grad_(True)
    batch = next(synthetic_batches(cfg.vocab_size, 2, 256, seed=1,
                                   device="cuda"))
    counters = (flash_mod.flash_attention, flash_mod.flash_attention_dq,
                flash_mod.flash_attention_dkv)
    got = {}
    for name, c in (("off", cfg),
                    ("on", replace(cfg, remat=True, remat_policy=policy))):
        before = [k.launches for k in counters]
        loss, grads = tr.grads_of(params, batch, c)
        torch.cuda.synchronize()
        got[name] = (loss, [g for _, g in tr._flatten(grads)],
                     [k.launches - b for k, b in zip(counters, before)])
    L = cfg.n_layers
    assert got["off"][2] == [L, L, L]
    assert got["on"][2] == [2 * L, L, L]
    assert torch.equal(got["on"][0], got["off"][0])
    for a, b in zip(got["on"][1], got["off"][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)


def test_mesh_trainer_at_world_1_on_nccl_equals_the_one_device_trainer(
        meshes):
    """The sharded code path on a world-1 NCCL mesh {data, fsdp, model}
    (every collective the identity) trains as the one-device Trainer:
    the same losses and params after three steps at the narrow config,
    through the flash kernels."""
    from ptype_tpu_torch.parallel.mesh import build_mesh
    from ptype_tpu_torch.train import trainer as tr

    mesh = build_mesh({"data": 1, "fsdp": 1, "model": 1})
    cfg = NARROW
    stream = synthetic_batches(cfg.vocab_size, 4, 256, seed=2,
                               device="cuda")
    batches = [next(stream) for _ in range(3)]
    runs = {}
    for name, kw in (("one", dict(device="cuda")), ("mesh", dict(mesh=mesh))):
        t = Trainer(cfg, generator=torch.Generator(device="cuda").manual_seed(
            0), optimizer=default_optimizer(lr=1e-3, warmup=1),
                    sync_every=0, **kw)
        losses = [float(t.step(b)["loss"]) for b in batches]
        runs[name] = (losses, [p.detach() for _, p in
                               tr._flatten(t.state.params)])
    assert runs["mesh"][0] == pytest.approx(runs["one"][0], rel=1e-6)
    for a, b in zip(runs["mesh"][1], runs["one"][1]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_sequence_parallel_attention_at_world_1_runs_the_flash_kernels(
        meshes, impl):
    """Ring and Ulysses on a world-1 mesh (a ``seq`` axis of size 1, or
    none) are one rank's whole-sequence attention: the flash kernels on
    the card, forward and backward, never dense attention."""
    from ptype_tpu_torch.parallel import ring_attention as ra
    from ptype_tpu_torch.parallel.mesh import build_mesh

    make = (ra.make_ring_attention if impl == "ring"
            else ra.make_ulysses_attention)
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(1, 256, 4, 128, generator=gen, device="cuda",
                    requires_grad=True)
    k, v = (torch.randn(1, 256, 2, 128, generator=gen, device="cuda",
                        requires_grad=True) for _ in range(2))
    counters = (flash_mod.flash_attention, flash_mod.flash_attention_dq,
                flash_mod.flash_attention_dkv)
    for mesh in (meshes[0], build_mesh({"data": 1, "seq": 1})):
        before = [c.launches for c in counters]
        o = make(mesh)(q, k, v, NARROW)
        o.float().square().sum().backward()
        torch.cuda.synchronize()
        assert [c.launches - b for c, b in zip(counters, before)] == [1, 1, 1]
        ref = ttfm._attention(q, k, v, NARROW)
        assert (o - ref).abs().max().item() < FLASH_TOL[torch.float32]


# ----------------------------------------------------- jitwatch on the card


@pytest.fixture
def armed(cuda):
    from ptype_tpu_torch import jitwatch

    jw = jitwatch.enable()
    yield jw
    jitwatch.disable()


def test_cuda_detector_raises_sanctions_and_spares_other_threads(armed):
    """The card's own sync check behind the armed guard: an ``.item()``
    and a pageable upload inside a hot region raise; inside
    ``sanctioned_transfer`` they pass and are counted; another thread's
    ``.cpu()`` outside any region, made while this thread sits in one,
    does not raise; ``disable`` puts the prior sync debug mode back."""
    import threading

    import numpy as np

    from ptype_tpu_torch import jitwatch

    x = torch.ones(4, device="cuda")
    host = np.ones(4, np.float32)
    with jitwatch.hot_region("card.test"):
        x * 2
        for call in (lambda: x.sum().item(),
                     lambda: torch.as_tensor(host, device="cuda")):
            with pytest.raises(jitwatch.HostSyncError, match="card.test"):
                call()
        with jitwatch.sanctioned_transfer("card.read"):
            x.sum().item()
            torch.as_tensor(host, device="cuda")
        errs = []

        def other():
            try:
                x.cpu()
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=60)
        assert not t.is_alive() and errs == []
    assert armed.sanctioned() == {"card.read": 1}
    prior = torch.cuda.get_sync_debug_mode()
    jitwatch.disable()
    assert prior == 1 and torch.cuda.get_sync_debug_mode() == 0


def test_armed_paged_engine_steady_state_on_the_card(armed):
    """An armed kernel engine at a narrow width: steady requests build
    nothing, the decode and chunk guards hold, each step books its one
    read, each request's first step (after its admission; no block
    boundary) the eight uploads of the slot state's device mirror and its
    other steps none, and the tokens equal a disarmed run's. The warmup
    serves the prompt twice: the cold request's chunk (bucket 32) and a
    resident one's tail past its reused block (bucket 16), which is what
    the steady requests prefill."""
    from ptype_tpu_torch import jitwatch

    a = PagedGeneratorActor(NARROW, device="cuda", n_slots=2, attn="kernel")
    try:
        p = torch.randint(1, 256, (1, 21), generator=torch.Generator(
            device="cuda").manual_seed(3), device="cuda")
        warm = a.Generate(p, 8)
        assert torch.equal(a.Generate(p, 8), warm)
        armed.mark_steady()
        for _ in range(2):
            assert torch.equal(a.Generate(p, 8), warm)
        assert armed.recompiles_since_steady() == {}
        books = armed.sanctioned()
        assert armed.report()["hot_regions"] > 0
        assert books["serve.decode_read"] == 4 * 7
        assert books["serve.slot_state"] == 8 * 4
        # The greedy step and the two chunk buckets each captured once,
        # in the warm requests, and booked.
        assert books["serve.capture"] == len(a._programs.progs) == 3
        assert armed.compiles()["serve.decode"] == 1
        assert armed.compiles()["serve.prefill_chunk"] == 2
        jitwatch.disable()
        assert torch.equal(a.Generate(p, 8), warm)
    finally:
        a.close()


def _in_order(eng, prompts, max_new, kws=None):
    """``prompts`` from one thread each, queued in order while the
    engine's dispatch lock is held, so two engines admit and batch them
    alike; ``kws``: each request's sampling keywords. Returns the
    outputs."""
    import threading
    import time

    outs = [None] * len(prompts)

    def call(i):
        outs[i] = eng.Generate(prompts[i][None], max_new,
                               **(kws[i] if kws else {}))

    threads = []
    with eng._lock:
        for i in range(len(prompts)):
            threads.append(threading.Thread(target=call, args=(i,)))
            threads[-1].start()
            deadline = time.monotonic() + 60
            while (len(eng._queue) + (eng._admitting is not None) < i + 1
                   and time.monotonic() < deadline):
                time.sleep(0.001)
    for t in threads:
        t.join(timeout=300)
    assert all(o is not None for o in outs)
    return outs


def test_steady_engine_steps_upload_nothing_on_the_card(armed):
    """optimus-125m's widths (2 of 12 layers), 8 slots, the paged
    kernel, armed: a step that finds the device mirror of the slot
    state built and no row at a block boundary books no slot-state
    upload, and the profile of one such step with every slot live holds
    no host-to-device copy; a build books eight. The tokens equal the
    same engine's with the mirror rebuilt from the host arrays every
    step (the host-routed step)."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from ptype_tpu_torch.models.weights import init_params

    cfg = dataclasses.replace(ttfm.preset("optimus-125m"), n_layers=2)
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    g = torch.Generator().manual_seed(5)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=g)
               for n in (40, 70, 100, 130, 160, 190, 220, 250)]
    kw = dict(params=params, device="cuda", n_slots=8, block_tokens=16,
              prefill_chunk=256, attn="kernel")
    eng = PagedGeneratorActor(cfg, **kw)
    step, steps, prof = eng._plain_step, [], {}

    def watched():
        live = eng._active.nonzero()[0]
        steady = eng._sdev is not None and not (
            eng._pos[live] == eng._nalloc[live] * eng.block_tokens).any()
        n = armed.sanctioned().get("serve.slot_state", 0)
        if steady and eng._active.all() and not prof:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as p:
                step()
                torch.cuda.synchronize()
            prof["events"] = p.key_averages()
        else:
            step()
        steps.append((steady,
                      armed.sanctioned().get("serve.slot_state", 0) - n))

    eng._plain_step = watched
    try:
        got = _in_order(eng, prompts, 48)
    finally:
        eng.close()
    assert sum(s for s, _ in steps) >= 20, steps
    assert all(up == (0 if s else 8) for s, up in steps), steps
    dev = [e for e in prof["events"]
           if "CUDA" in str(getattr(e, "device_type", ""))]
    assert any("paged_decode" in e.key for e in dev), [e.key for e in dev]
    assert [e.key for e in dev if "Memcpy HtoD" in e.key] == []
    # The step is its captured program: one graph launch, no kernel
    # launched on its own.
    calls = {}
    for e in prof["events"]:
        if e not in dev and e.key.startswith(("cudaGraphLaunch",
                                              "cudaLaunchKernel")):
            name = e.key.split("_v")[0]
            calls[name] = calls.get(name, 0) + e.count
    assert calls == {"cudaGraphLaunch": 1}, calls

    host = PagedGeneratorActor(cfg, **kw)
    plain = host._plain_step

    def rebuilt():
        host._sdev = None
        plain()

    host._plain_step = rebuilt
    try:
        want = _in_order(host, prompts, 48)
    finally:
        host.close()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_a_replay_equals_its_bodys_direct_call(cuda, moe, spec):
    """bf16, the paged kernel, 4 slots, a narrow dense and MoE config,
    with and without a 1-layer draft (k=3): at each program's first
    replay the banks and the mirror are cloned, the body runs directly,
    the state is put back and the graph replays. The outputs (a plain
    step's logits and tokens, a window's tokens and accept counts) and
    the banks and mirror after are bitwise equal, for the plain step and
    every window width replayed; paged launches count every plain step,
    replays included."""
    import dataclasses

    from ptype_tpu_torch.models.weights import init_params
    from ptype_tpu_torch.ops import launch_tally

    cfg = dataclasses.replace(NARROW_MOE if moe else NARROW,
                              dtype=torch.bfloat16)
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    sc = None
    if spec:
        dp, dc = gen_mod.truncated_draft_params(params, cfg, 1)
        sc = SpecConfig(dp, dc, k=3, adaptive=False)
    eng = PagedGeneratorActor(cfg, params=params, device="cuda", n_slots=4,
                              block_tokens=16, attn="kernel", spec=sc)
    run, results = eng._programs.run, {}

    def state():
        pools = [eng.pool] + ([eng._dpool] if spec else [])
        return ([t for p in pools for t in (p.k, p.v)]
                + list(eng._sbuf.values()))

    def flat(out):
        return list(out) if isinstance(out, tuple) else [out]

    def checked(fn, sig, body):
        if (fn, sig) in results or (fn, sig) not in eng._programs.progs:
            return run(fn, sig, body)
        live = state()
        saved = [t.clone() for t in live]
        with launch_tally() as extra:
            direct = [t.clone() for t in flat(body())]
        for f, n in extra.items():
            f.launches -= n
        after = [t.clone() for t in live]
        for t, v in zip(live, saved):
            t.copy_(v)
        got = run(fn, sig, body)
        torch.cuda.synchronize()
        results[(fn, sig)] = (
            all(torch.equal(a, b) for a, b in zip(direct, flat(got))),
            all(torch.equal(a, b) for a, b in zip(after, live)))
        return got

    eng._programs.run = checked
    g = torch.Generator().manual_seed(7)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=g)
               for n in (9, 30, 41, 64, 17, 50)]
    try:
        paged_mod.paged_attention.launches = 0
        _in_order(eng, prompts, 24)
        torch.cuda.synchronize()
        info = eng.Info()
        replayed = {k for k, p in eng._programs.progs.items() if p.replays}
    finally:
        eng.close()
    plain = info["engine_steps"] - info.get("spec_windows", 0)
    assert paged_mod.paged_attention.launches == plain * cfg.n_layers
    assert set(results) == replayed and results, (results, replayed)
    assert all(a and b for a, b in results.values()), results
    fns = {fn for fn, _ in results}
    assert ("serve.spec_window" in fns) == spec, fns


#: Sampling of the sampled-program tests: temperature, top-k and top-p.
SAMPLED = dict(temperature=0.8, top_k=20, top_p=0.9)


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
def test_a_sampled_replay_equals_its_eager_body_on_the_card(cuda, spec):
    """f32, a narrow config, 4 slots, four sampled requests (their own
    seeds) and two greedy ones, with and without a 1-layer draft (k=3):
    at each sampled program's first replay the banks, the mirror and
    every slot generator's state are kept, the body runs directly, all
    is put back and the graph replays. Its tokens (a plain step's logits
    and tokens, a window's tokens and accept counts), and the banks,
    mirror and generator states after, are bitwise the direct call's.
    Each sampled key is captured once and replayed after; paged
    launches count every plain step, replays included."""
    from ptype_tpu_torch.models.weights import init_params
    from ptype_tpu_torch.ops import launch_tally

    params = init_params(torch.Generator(device="cuda").manual_seed(0),
                         NARROW)
    sc = None
    if spec:
        dp, dc = gen_mod.truncated_draft_params(params, NARROW, 1)
        sc = SpecConfig(dp, dc, k=3, adaptive=False)
    eng = PagedGeneratorActor(NARROW, params=params, device="cuda",
                              n_slots=4, block_tokens=16, attn="kernel",
                              spec=sc)
    run, results, calls = eng._programs.run, {}, {}
    gens = eng._slot_gens + eng._slot_dgens + eng._slot_agens

    def state():
        pools = [eng.pool] + ([eng._dpool] if spec else [])
        return ([t for p in pools for t in (p.k, p.v)]
                + list(eng._sbuf.values()))

    def flat(out):
        return list(out) if isinstance(out, tuple) else [out]

    def checked(fn, sig, body, *generators):
        key = (fn, sig)
        calls[key] = calls.get(key, 0) + 1
        if (not sig.endswith("sampled=True") or key in results
                or key not in eng._programs.progs):
            return run(fn, sig, body, *generators)
        live, drawn = state(), [g.get_state() for g in gens]
        saved = [t.clone() for t in live]
        with launch_tally() as extra:
            direct = [t.clone() for t in flat(body())]
        for f, n in extra.items():
            f.launches -= n
        after = [t.clone() for t in live] + [g.get_state() for g in gens]
        for t, v in zip(live, saved):
            t.copy_(v)
        for g, v in zip(gens, drawn):
            g.set_state(v)
        got = run(fn, sig, body, *generators)
        torch.cuda.synchronize()
        results[key] = (
            all(torch.equal(a, b) for a, b in zip(direct, flat(got))),
            all(torch.equal(a, b) for a, b in
                zip(after, live + [g.get_state() for g in gens])))
        return got

    eng._programs.run = checked
    g = torch.Generator().manual_seed(7)
    prompts = [torch.randint(1, NARROW.vocab_size, (n,), generator=g)
               for n in (9, 30, 41, 64, 17, 50)]
    kws = [dict(SAMPLED, seed=s) for s in (1, 2, 3, 4)] + [{}, {}]
    try:
        paged_mod.paged_attention.launches = 0
        _in_order(eng, prompts, 24, kws)
        torch.cuda.synchronize()
        info = eng.Info()
        sampled = {k: p.replays for k, p in eng._programs.progs.items()
                   if k[1].endswith("sampled=True")}
    finally:
        eng.close()
    plain = info["engine_steps"] - info.get("spec_windows", 0)
    assert paged_mod.paged_attention.launches == plain * NARROW.n_layers
    assert sampled and all(n == calls[k] - 1 for k, n in sampled.items())
    assert set(results) == {k for k, n in sampled.items() if n}, results
    assert all(a and b for a, b in results.values()), results
    assert ("serve.spec_window" in {fn for fn, _ in results}) == spec


def test_a_replay_after_a_readmission_follows_the_new_seed(cuda):
    """f32, a narrow config, one slot: request A (seed 1) captures the
    sampled step, then request B (seed 2) decodes on replays alone, its
    stream copied into the slot's registered generator in place; B's
    tokens equal B's on a fresh engine, where its first sampled step is
    the eager warm-up that precedes the capture."""
    from ptype_tpu_torch.models.weights import init_params

    params = init_params(torch.Generator(device="cuda").manual_seed(0),
                         NARROW)
    g = torch.Generator().manual_seed(9)
    pa, pb = (torch.randint(1, NARROW.vocab_size, (1, n), generator=g)
              for n in (11, 23))

    def engine():
        return PagedGeneratorActor(NARROW, params=params, device="cuda",
                                   n_slots=1, block_tokens=16,
                                   attn="kernel")

    key = ("serve.decode", "B=1,dtype=float32,attn=kernel,sampled=True")
    eng = engine()
    try:
        a = eng.Generate(pa.cuda(), 16, seed=1, **SAMPLED)
        replays = eng._programs.progs[key].replays
        b = eng.Generate(pb.cuda(), 16, seed=2, **SAMPLED)
        assert eng._programs.progs[key].replays == replays + 15
    finally:
        eng.close()
    fresh = engine()
    try:
        want = fresh.Generate(pb.cuda(), 16, seed=2, **SAMPLED)
    finally:
        fresh.close()
    assert torch.equal(b, want), (b, want)
    assert not torch.equal(a[:, :8], b[:, :8])


def test_chunk_programs_replay_their_bodies_bitwise_on_the_card(cuda):
    """bf16, a narrow config with a 1-layer draft (k=3): prompts whose
    chunks fall in every target bucket from 16 to 256 twice (16 three
    times). At each chunk program's first replay the banks, the mirror
    and the chunk inputs are cloned, the body runs directly, the state
    is put back and the graph replays: logits and the banks after are
    bitwise equal for every target bucket and the draft's. Each bucket
    is captured once (booked once as a compile) and replayed at its
    later chunks, and a replayed chunk's dispatch is one graph launch,
    no kernel launch and one copy to the card."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from ptype_tpu_torch import jitwatch
    from ptype_tpu_torch.models.weights import init_params
    from ptype_tpu_torch.ops import launch_tally

    cfg = dataclasses.replace(NARROW, dtype=torch.bfloat16)
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    dp, dc = gen_mod.truncated_draft_params(params, cfg, 1)
    eng = PagedGeneratorActor(cfg, params=params, device="cuda", n_slots=2,
                              block_tokens=16, attn="kernel",
                              prefill_chunk=256,
                              spec=SpecConfig(dp, dc, k=3, adaptive=False))
    run, results, calls = eng._programs.run, {}, {}
    chunk_fns = ("serve.prefill_chunk", "serve.draft_chunk")

    def state():
        return [t for p in (eng.pool, eng._dpool) for t in (p.k, p.v)] + \
            list(eng._sbuf.values()) + [eng._cbuf]

    def checked(fn, sig, body):
        calls[(fn, sig)] = calls.get((fn, sig), 0) + 1
        if (fn not in chunk_fns or (fn, sig) in results
                or (fn, sig) not in eng._programs.progs):
            return run(fn, sig, body)
        # The comparison reads the card: the test's own sanctioned pass.
        with jitwatch.sanctioned_transfer("test.replay_check"):
            return compare(fn, sig, body)

    def compare(fn, sig, body):
        live = state()
        saved = [t.clone() for t in live]
        with launch_tally() as extra:
            direct = body().clone()
        for f, n in extra.items():
            f.launches -= n
        after = [t.clone() for t in live]
        for t, v in zip(live, saved):
            t.copy_(v)
        got = run(fn, sig, body)
        torch.cuda.synchronize()
        results[(fn, sig)] = (torch.equal(direct, got),
                              all(torch.equal(a, b)
                                  for a, b in zip(after, live)))
        return got

    chunk, prof = eng._chunk, {}

    def profiled(draft, toks, start, table):
        C = max(16, 1 << (len(toks) - 1).bit_length())
        key = ("serve.prefill_chunk", f"C={C},dtype=bfloat16")
        if draft or prof or key not in results:  # checked: replays only
            return chunk(draft, toks, start, table)
        out = []
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as p:
            out.append(chunk(draft, toks, start, table))
            torch.cuda.synchronize()
        prof["events"] = p.key_averages()
        return out[0]

    eng._programs.run, eng._chunk = checked, profiled
    g = torch.Generator().manual_seed(11)
    # Two prompts a bucket (a capture, then the checked replay), and a
    # third of bucket 16 whose replay is profiled.
    lens = (9, 13, 20, 30, 40, 60, 100, 120, 200, 250, 11)
    jw = jitwatch.enable()
    try:
        for n in lens:
            eng.Generate(torch.randint(1, cfg.vocab_size, (1, n),
                                       generator=g), 4)
        compiles = jw.compiles()
        replays = {k: p.replays for k, p in eng._programs.progs.items()}
    finally:
        jitwatch.disable()
        eng.close()
    target = {sig for fn, sig in results if fn == "serve.prefill_chunk"}
    assert target == {f"C={C},dtype=bfloat16"
                      for C in (16, 32, 64, 128, 256)}, results
    assert any(fn == "serve.draft_chunk" for fn, _ in results), results
    assert all(a and b for a, b in results.values()), results
    assert set(replays) == set(calls)
    for key, n in calls.items():
        assert replays[key] == n - 1, (key, n)
    for fn in chunk_fns:
        assert compiles.get(fn) == sum(f == fn for f, _ in replays), compiles
    dev = [e for e in prof["events"]
           if "CUDA" in str(getattr(e, "device_type", ""))]
    assert sum(e.count for e in dev if "Memcpy HtoD" in e.key) == 1, \
        [e.key for e in dev]
    launched = {}
    for e in prof["events"]:
        if e not in dev and e.key.startswith(("cudaGraphLaunch",
                                              "cudaLaunchKernel")):
            name = e.key.split("_v")[0]
            launched[name] = launched.get(name, 0) + e.count
    assert launched == {"cudaGraphLaunch": 1}, launched


def test_audit_sees_a_host_read_in_a_backward_on_the_card(cuda):
    """Autograd runs a CUDA graph's backward on its device thread and
    carries the dispatch-mode stack there: an ``.item()`` inside a custom
    Function's backward is a host synchronisation of the audited
    program."""
    import threading

    from ptype_tpu_torch import progaudit

    threads = []

    class ReadsInBackward(torch.autograd.Function):
        @staticmethod
        def forward(ctx, a):
            return a * 2

        @staticmethod
        def backward(ctx, g):
            threads.append(threading.get_ident())
            g.sum().item()
            return g * 2

    a = torch.ones(4, device="cuda", requires_grad=True)

    def step(a):
        ReadsInBackward.apply(a).sum().backward()
        return a.grad

    rep = progaudit.audit(step, (a,), name="bwd")
    assert rep.callbacks == ["aten::_local_scalar_dense"], rep.to_dict()
    assert threads and threads[0] != threading.get_ident()
