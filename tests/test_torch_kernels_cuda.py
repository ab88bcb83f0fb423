"""The port's CUDA kernels on the card: each held against its plain
PyTorch version, and the serving and training paths' launch counts.
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
