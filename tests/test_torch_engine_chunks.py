"""The paged engine's prefill chunk programs on the CPU, in f32 at
``tiny`` and ``tiny-moe``.

``prefill_paged_chunk`` with 0-d tensor ``start``/``length`` (the
reference's ``jnp.int32``s) against the reference's, chunk by chunk: a
chunk split by the admission budget, a chunk starting past reused
prefix blocks, and every bucket from 16 up, each padded to its bucket.
Then the engine: every target and draft chunk of ``n`` tokens asks the
engine's programs for the key of its bucket ``max(16, pow2(n))``, and
with the chunk programs captured once and replayed over new inputs
(stub graphs that replay by running the captured body again, as the
CPU has no CUDA graphs) the engine's greedy tokens equal the reference
engine's: the plain engine with prefix reuse, the speculative engine
with its draft caught up after forced plain steps, MoE, and a
``Prefill`` → ``MigrateDecode`` pair. Armed, a chunk's dispatch makes
no host read (jitwatch's CPU detector)."""

import threading
from contextlib import nullcontext

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptype_tpu.metrics import MetricsRegistry as JRegistry
from ptype_tpu.models import generate as jgen
from ptype_tpu.models import transformer as jtfm
from ptype_tpu.serve_engine import PagedGeneratorActor as JPaged
from ptype_tpu_torch import jitwatch
from ptype_tpu_torch.metrics import MetricsRegistry
from ptype_tpu_torch.models import generate as tgen
from ptype_tpu_torch.models import transformer as ttfm
from ptype_tpu_torch.models.weights import params_from_numpy
from ptype_tpu_torch.ops import launch_tally
from ptype_tpu_torch.serve import _pow2
from ptype_tpu_torch.serve_engine import PagedGeneratorActor, SpecConfig
from ptype_tpu_torch.serve_engine import programs as programs_mod

#: The tolerance of ``tests/test_torch_generate.py``'s paged chunk test.
TOL = dict(rtol=1e-4, atol=1e-4)
BT = 16
NB = 8
CHUNK_FNS = ("serve.prefill_chunk", "serve.draft_chunk")


def _trees(name, seed=0):
    jcfg = jtfm.preset(name, dtype=jnp.float32)
    cfg = ttfm.preset(name, dtype=torch.float32)
    pj = jtfm.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, cfg, pj, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, pj), cfg)


TREES = {name: _trees(name) for name in ("tiny", "tiny-moe")}


def _toks(seed, n, vocab=256):
    return np.random.default_rng(seed).integers(1, vocab, n)


def _bucket(n):
    return max(16, _pow2(n))


# --------------------------------------------------- function (unit)

#: (start, length) chunk sequences over one prompt: the buckets 16 to
#: 128 from position 0; a prompt split by a 24-token admission budget
#: (24 → bucket 32, the 5-token remainder → 16); a chunk starting past
#: two reused prefix blocks.
CASES = {"bucket16": [(0, 9)], "bucket32": [(0, 17)],
         "bucket64": [(0, 33)], "bucket128": [(0, 100)],
         "budget_split": [(0, 24), (24, 5)],
         "prefix_reuse": [(2 * BT, 7)]}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("name", ["tiny", "tiny-moe"])
def test_prefill_paged_chunk_with_tensor_start_matches_reference(name, case):
    """Each chunk padded to its bucket, ``start``/``length`` as 0-d
    tensors: logits and the written banks equal the reference's within
    ``TOL`` (block 0 is the trash block, read by nobody), and equal the
    same call with Python ints bit for bit."""
    jcfg, cfg, pj, pt = TREES[name]
    rng = np.random.default_rng(5)
    shape = (cfg.n_layers, NB + 2, BT, cfg.kv_heads, cfg.head_dim)
    kb = rng.normal(size=shape).astype(np.float32)
    vb = rng.normal(size=shape).astype(np.float32)
    kbj, vbj = jnp.asarray(kb), jnp.asarray(vb)
    kbt, vbt = torch.tensor(kb), torch.tensor(vb)
    kbi, vbi = kbt.clone(), vbt.clone()
    table = np.array([3, 7, 1, 9, 2, 4, 5, 6], np.int32)
    prompt = _toks(6, 128)
    for start, n in CASES[case]:
        C = _bucket(n)
        chunk = np.zeros((1, C), np.int64)
        chunk[0, :n] = prompt[start:start + n]
        lj, kbj, vbj = jgen.prefill_paged_chunk(
            pj, jnp.asarray(chunk), jnp.int32(start), jnp.int32(n), jcfg,
            kbj, vbj, jnp.asarray(table))
        lt, _, _ = tgen.prefill_paged_chunk(
            pt, torch.tensor(chunk), torch.tensor(start, dtype=torch.int32),
            torch.tensor(n, dtype=torch.int32), cfg, kbt, vbt,
            torch.tensor(table))
        li, _, _ = tgen.prefill_paged_chunk(
            pt, torch.tensor(chunk), start, n, cfg, kbi, vbi,
            torch.tensor(table))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
        assert torch.equal(lt, li)
    np.testing.assert_allclose(kbt[:, 1:].numpy(), np.asarray(kbj)[:, 1:],
                               **TOL)
    np.testing.assert_allclose(vbt[:, 1:].numpy(), np.asarray(vbj)[:, 1:],
                               **TOL)
    assert torch.equal(kbt, kbi) and torch.equal(vbt, vbi)
    # A pad column wrote nothing new: the trash block is as it was.
    assert torch.equal(kbt[:, 0], torch.tensor(kb)[:, 0])


# ----------------------------------------------- engine (stub graphs)


class _ReplayGraph:
    """A CUDA graph's stand-in that replays by running the captured body
    again and writing its results into the capture's outputs, as a
    real replay overwrites them: a body that kept a Python value of one
    chunk's inputs would replay that chunk."""

    def __init__(self, body, outputs):
        self.body, self.outputs = body, outputs

    def replay(self):
        out = self.body()
        for dst, src in zip(*(o if isinstance(o, tuple) else (o,)
                              for o in (self.outputs, out))):
            dst.copy_(src)


class _Stream:
    def wait_stream(self, other):
        pass


@pytest.fixture
def stub_graphs(monkeypatch):
    """:class:`Programs` on its CUDA path on the CPU: the stream calls
    stubbed, and ``capture`` recording the body into a
    :class:`_ReplayGraph` (it runs the body once, as a chunk body
    rewrites the same K/V). Returns the captured graphs."""
    graphs = []

    def capture(body, pool, stream, generators=()):
        with launch_tally() as launches:
            outputs = body()
        graphs.append(_ReplayGraph(body, outputs))
        return programs_mod.Program(graphs[-1], outputs, launches)

    monkeypatch.setattr(programs_mod, "capture", capture)
    monkeypatch.setattr(torch.cuda, "Stream", lambda *a: _Stream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: nullcontext())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: ("pool",))
    return graphs


def _chunk_programs(eng):
    """Send ``eng``'s chunk programs through a CUDA-path
    :class:`Programs` (the stub graphs); its steps and windows keep the
    engine's own. Returns the programs and the calls, each (fn, sig,
    start, length) read from the static chunk inputs."""
    progs = programs_mod.Programs(torch.device("cuda"))
    run, calls = eng._programs.run, []

    def run_(fn, sig, body):
        if fn not in CHUNK_FNS:
            return run(fn, sig, body)
        with jitwatch.sanctioned_transfer("test.chunk_inputs"):
            calls.append((fn, sig, int(eng._cbuf[0]), int(eng._cbuf[1])))
        return progs.run(fn, sig, body)

    eng._programs.run = run_
    return progs, calls


def _check_buckets(progs, calls, dtype="float32"):
    """Every chunk asked for its bucket's key; each key captured once and
    replayed at each later call."""
    assert calls
    for fn, sig, _, n in calls:
        assert sig == f"C={_bucket(n)},dtype={dtype}", (fn, sig, n)
    keys = {(fn, sig) for fn, sig, _, _ in calls}
    assert set(progs.progs) == keys
    for key, prog in progs.progs.items():
        assert prog.replays == sum((f, s) == key
                                   for f, s, _, _ in calls) - 1, key


def _together(fn, prompts):
    out = [None] * len(prompts)

    def call(i):
        out[i] = fn(prompts[i])

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert all(o is not None for o in out)
    return out


def _reference_tokens(name, prompts, max_new, **kw):
    """The reference engine's greedy tokens, the requests sent one after
    another (later prompts reuse earlier ones' blocks)."""
    jcfg, _, pj, _ = TREES[name]
    ref = JPaged(jcfg, params=pj, n_slots=2, block_tokens=BT,
                 metrics_registry=JRegistry(), **kw)
    try:
        return [np.asarray(ref.Generate(jnp.asarray(p[None]), max_new))[0]
                for p in prompts]
    finally:
        ref.close()


def _engine(name, spec=None, **kw):
    _, cfg, _, pt = TREES[name]
    return PagedGeneratorActor(cfg, params=pt, device="cpu", n_slots=2,
                               block_tokens=BT, spec=spec,
                               metrics_registry=MetricsRegistry(), **kw)


def _friendly_spec(name="tiny", k=3):
    _, cfg, _, pt = TREES[name]
    dp, dc = tgen.truncated_draft_params(pt, cfg, n_layers=1)
    return SpecConfig(draft_params=dp, draft_cfg=dc, k=k, adaptive=False)


#: A 40-token prompt, one sharing its first two blocks, and two short
#: ones: chunks of 32 (the budget), 8, 16, 5 and 9 tokens.
SHARED = _toks(11, 40)
PROMPTS = [SHARED, np.concatenate([SHARED[:32], _toks(12, 9)]),
           _toks(13, 5), _toks(14, 23)]


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
def test_each_chunk_goes_through_its_buckets_program(stub_graphs, spec):
    """Each target chunk of ``n`` tokens runs as ``serve.prefill_chunk``
    of bucket ``max(16, pow2(n))``; under speculation each draft prefill
    is one whole-prompt ``serve.draft_chunk`` of the prompt's bucket.
    A key is captured at its first call (booked as a compile) and
    replayed at every later one."""
    eng = _engine("tiny", _friendly_spec() if spec else None,
                  prefill_chunk=32)
    progs, calls = _chunk_programs(eng)
    jw = jitwatch.enable()
    try:
        for p in PROMPTS:
            eng.Generate(torch.as_tensor(p)[None], 6)
        info = eng.Info()
        books = jw.compiles()
    finally:
        jitwatch.disable()
        eng.close()
    _check_buckets(progs, calls)
    target = [(s, n) for fn, _, s, n in calls if fn == "serve.prefill_chunk"]
    assert len(target) == info["prefill_chunks"]
    assert sum(n for _, n in target) == info["prefill_tokens"]
    # The budget split the 40-token prompt; the second reused two blocks.
    assert target[:3] == [(0, 32), (32, 8), (32, 9)], target
    draft = [(s, n) for fn, _, s, n in calls if fn == "serve.draft_chunk"]
    if spec:
        # Whole prompts from 0 (draft catch-up chunks start later).
        assert [n for s, n in draft if s == 0] == [len(p) for p in PROMPTS]
    else:
        assert draft == []
    assert books == {fn: sum(f == fn for f, _ in progs.progs)
                     for fn, _ in progs.progs}
    assert len(stub_graphs) == len(progs.progs)
    assert sum(p.replays for p in progs.progs.values()) > 0


def test_replayed_chunks_give_the_reference_engines_tokens(stub_graphs):
    """The plain engine, its chunks replayed over new inputs (prefix
    reuse included), against the reference engine."""
    want = _reference_tokens("tiny", PROMPTS, 10, prefill_chunk=32)
    eng = _engine("tiny", prefill_chunk=32)
    progs, calls = _chunk_programs(eng)
    try:
        got = [eng.Generate(torch.as_tensor(p)[None], 10)[0].numpy()
               for p in PROMPTS]
        assert eng.Info()["prefix_hits"] == 2
    finally:
        eng.close()
    _check_buckets(progs, calls)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_replayed_moe_chunks_give_the_reference_engines_tokens(stub_graphs):
    """tiny-moe, co-batched: each chunk at the zero-drop capacity of its
    bucket, replayed, against the reference engine."""
    prompts = [_toks(21, 37), _toks(22, 12), _toks(23, 20)]
    jcfg, _, pj, _ = TREES["tiny-moe"]
    ref = JPaged(jcfg, params=pj, n_slots=2, block_tokens=BT,
                 prefill_chunk=16, metrics_registry=JRegistry())
    try:
        want = _together(lambda p: np.asarray(
            ref.Generate(jnp.asarray(p[None]), 9))[0], prompts)
    finally:
        ref.close()
    eng = _engine("tiny-moe", prefill_chunk=16)
    progs, calls = _chunk_programs(eng)
    try:
        got = _together(lambda p: eng.Generate(
            torch.as_tensor(p)[None], 9)[0].numpy(), prompts)
    finally:
        eng.close()
    _check_buckets(progs, calls)
    assert any(p.replays for p in progs.progs.values())
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_replayed_draft_catch_up_keeps_the_tokens_exact(stub_graphs):
    """Speculation with plain steps forced between windows: each window
    after them first catches the draft up through ``serve.draft_chunk``
    of the span's bucket, replayed; the tokens equal the reference
    engine's and the draft keeps its accept rate."""
    prompts = [_toks(31, 9), _toks(32, 26)]
    want = _reference_tokens("tiny", prompts, 24, prefill_chunk=32)
    eng = _engine("tiny", _friendly_spec(), prefill_chunk=32)
    progs, calls = _chunk_programs(eng)
    orig_k, forced = eng._spec_k_eff, [0]

    def k_eff():
        k = orig_k()
        # Two plain steps after every second window.
        if k and eng._spec_windows % 2 == 0 and eng._spec_windows:
            forced[0] += 1
            if forced[0] % 3:
                return 0
        return k

    eng._spec_k_eff = k_eff
    try:
        got = [eng.Generate(torch.as_tensor(p)[None], 24)[0].numpy()
               for p in prompts]
        info = eng.Info()
    finally:
        eng.close()
    _check_buckets(progs, calls)
    catch_up = [(s, n) for fn, _, s, n in calls
                if fn == "serve.draft_chunk" and s > 0]
    assert len(catch_up) >= 2, calls
    assert progs.progs[("serve.draft_chunk", "C=16,dtype=float32")].replays
    assert info["spec_accept_rate"] > 0.9, info
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_replayed_chunks_serve_a_prefill_then_migrate_decode_pair(
        stub_graphs):
    """A prefill-class engine's chunks and a speculative decode-class
    engine's draft prefill, both replayed: the migrated request's first
    token and tokens equal the reference engines' migration of it."""
    jcfg, _, pj, _ = TREES["tiny"]
    prompt = _toks(41, 45)

    def migrate(pre, dec, p):
        rep = pre.Prefill(p, 8)
        plan = dec.MigratePlan(p, 8)
        dec.ImportBlocks(plan["ticket"], pre.ExportBlocks(
            rep["export_id"], plan["need"], "exact"))
        assert pre.ReleaseExport(rep["export_id"])
        return rep["first_token"], dec.MigrateDecode(plan["ticket"],
                                                     rep["first_token"])

    jpre, jdec = (JPaged(jcfg, params=pj, n_slots=2, block_tokens=BT,
                         prefill_chunk=16, serve_class=c,
                         metrics_registry=JRegistry())
                  for c in ("prefill", "decode"))
    try:
        want = [migrate(jpre, jdec, jnp.asarray(prompt)[None])
                for _ in range(2)]
    finally:
        jpre.close()
        jdec.close()
    pre = _engine("tiny", prefill_chunk=16, serve_class="prefill")
    dec = _engine("tiny", _friendly_spec(), prefill_chunk=16,
                  serve_class="decode")
    (pprogs, pcalls), (dprogs, dcalls) = (_chunk_programs(pre),
                                          _chunk_programs(dec))
    try:
        got = [migrate(pre, dec, torch.as_tensor(prompt)[None])
               for _ in range(2)]
    finally:
        pre.close()
        dec.close()
    assert got == want
    _check_buckets(pprogs, pcalls)
    _check_buckets(dprogs, dcalls)
    assert {f for f, _, _, _ in pcalls} == {"serve.prefill_chunk"}
    # The decode side prefills only its draft, from the prompt, twice.
    assert [(f, s, n) for f, _, s, n in dcalls] == \
        [("serve.draft_chunk", 0, 45)] * 2


def test_an_armed_chunk_dispatch_makes_no_host_read(monkeypatch):
    """jitwatch armed (the CPU detector): every chunk's dispatch runs in
    its hot region and none raises, so a chunk reads nothing back; the
    only reads are the first token's and the steps'."""
    eng = _engine("tiny", _friendly_spec(), prefill_chunk=16)
    regions, hot = [], jitwatch.hot_region

    def counted(name, device=None):
        regions.append(name)
        return hot(name, device)

    monkeypatch.setattr(jitwatch, "hot_region", counted)
    jw = jitwatch.enable(transfer_level="disallow")
    try:
        out = eng.Generate(torch.as_tensor(PROMPTS[0])[None], 12)
        rep = jw.report()
    finally:
        jitwatch.disable()
        eng.close()
    assert out.shape == (1, 12)
    # 40 tokens in chunks of 16, 16 and 8; the draft prefill.
    assert regions.count("serve.prefill_chunk") == 3, regions
    assert regions.count("serve.draft_chunk") >= 1, regions
    assert rep["hot_regions"] == len(regions)
