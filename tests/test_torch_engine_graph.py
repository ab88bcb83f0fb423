"""The paged engine's compiled programs on the CPU, at ``tiny``.

The serving weights are cast to the compute dtype once
(``transformer.compute_params``): at bf16 the paged decode step, the
verify step and the draft's proposals give logits bitwise equal to the
f32 tree's (dense and MoE), and the engine decoding with that tree gives
the reference engine's greedy tokens. A plain step and each window width
go through the engine's programs by their key, greedy and sampled
alike, a sampled one handed the slots' generators. The capture's
launch accounting and generator registration run against stub graphs
(the CPU has no CUDA graphs): a capture tallies its own thread's
launches, takes them back, and each replay adds them; a sampled capture
registers its generators before it begins, and a slot re-admitted with
another seed replays that seed's stream."""

import threading
from contextlib import contextmanager, nullcontext

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptype_tpu.metrics import MetricsRegistry as JRegistry
from ptype_tpu.models import transformer as jtfm
from ptype_tpu.serve_engine import PagedGeneratorActor as JPaged
from ptype_tpu_torch import jitwatch
from ptype_tpu_torch.metrics import MetricsRegistry
from ptype_tpu_torch.models import generate as tgen
from ptype_tpu_torch.models import transformer as ttfm
from ptype_tpu_torch.models.weights import init_params, params_from_numpy
from ptype_tpu_torch.ops import count_launch, launch_tally
from ptype_tpu_torch.ops.flash_attention import flash_attention
from ptype_tpu_torch.ops.paged_attention import paged_attention
from ptype_tpu_torch.serve_engine import PagedGeneratorActor, SpecConfig
from ptype_tpu_torch.serve_engine import programs as programs_mod

BT = 8
NB = 6
B = 3


def _setup(name, seed=0):
    """A bf16 config, its f32 tree and compute tree, random banks, block
    tables and positions."""
    cfg = ttfm.preset(name)
    params = init_params(torch.Generator().manual_seed(seed), cfg)
    g = torch.Generator().manual_seed(seed + 1)
    shape = (cfg.n_layers, B * NB + 1, BT, cfg.kv_heads, cfg.head_dim)
    kb, vb = (torch.randn(shape, generator=g).to(cfg.dtype)
              for _ in range(2))
    tables = (1 + torch.arange(B * NB)).reshape(B, NB).to(torch.int32)
    pos = torch.tensor([3, 17, 30], dtype=torch.int32)
    tok = torch.randint(1, cfg.vocab_size, (B,), generator=g)
    return cfg, params, ttfm.compute_params(params, cfg), kb, vb, tables, \
        pos, tok


def _decode(cfg, params, kb, vb, tables, pos, tok, attn):
    wr_b = tables.long().gather(1, (pos // BT).long()[:, None])[:, 0]
    return tgen.decode_step_paged(params, tok, pos, cfg, kb, vb, tables,
                                  wr_b, pos % BT, attn_impl=attn)[0]


def _verify(cfg, params, kb, vb, tables, pos, tok, W=3):
    toks = torch.stack([tok + j for j in range(W)], 1) % cfg.vocab_size
    ap = pos.long()[:, None] + torch.arange(W)
    wr_b = tables.long().gather(1, ap // BT)
    return tgen.verify_step_paged(params, toks, pos, cfg, kb, vb, tables,
                                  wr_b, ap % BT)[0]


def _draft(cfg, params, kb, vb, tables, pos, tok, W=3):
    ap = pos.long()[:, None] + torch.arange(W)
    wr_b = tables.long().gather(1, ap // BT)
    zeros = np.zeros(B)
    prop, lg, _, _ = tgen.draft_propose_paged(
        params, tok, pos, cfg, kb, vb, tables, wr_b, ap % BT, [None] * B,
        zeros, zeros.astype(np.int32), np.ones(B), n_steps=W,
        sampled=False)
    return prop, lg


PROGRAMS = {"decode_gather": lambda *a: _decode(*a, attn="gather"),
            "decode_kernel": lambda *a: _decode(*a, attn="kernel"),
            "verify": _verify, "draft": _draft}


@pytest.mark.parametrize("name", ["tiny", "tiny-moe"])
@pytest.mark.parametrize("program", sorted(PROGRAMS))
def test_compute_tree_logits_are_bitwise_the_f32_trees(name, program):
    """Each paged program at bf16, from the same banks: the compute tree
    gives the f32 tree's logits (and proposals) bit for bit, and writes
    the same K/V."""
    cfg, params, cparams, kb, vb, tables, pos, tok = _setup(name)
    kb2, vb2 = kb.clone(), vb.clone()
    want = PROGRAMS[program](cfg, params, kb, vb, tables, pos, tok)
    got = PROGRAMS[program](cfg, cparams, kb2, vb2, tables, pos, tok)
    for a, b in zip(*(x if isinstance(x, tuple) else (x,)
                      for x in (want, got))):
        assert a.dtype == b.dtype and torch.equal(a, b), program
    assert torch.equal(kb, kb2) and torch.equal(vb, vb2)


@pytest.mark.parametrize("name", ["tiny", "tiny-moe"])
def test_compute_tree_casts_each_leaf_its_uses_cast(name):
    """The router stays f32 (the router reads it in f32); every other
    leaf is in the compute dtype. At an f32 compute dtype the tree holds
    the parameters' own tensors."""
    cfg, params, cparams, *_ = _setup(name)
    blocks = cparams["blocks"]
    for k, v in blocks.items():
        want = torch.float32 if k == "router" else cfg.dtype
        assert v.dtype == want, k
    assert cparams["embed"].dtype == cparams["final_norm"].dtype == cfg.dtype
    if name == "tiny-moe":
        assert blocks["router"] is params["blocks"]["router"]
    f32 = ttfm.preset(name, dtype=torch.float32)
    same = ttfm.compute_params(params, f32)
    assert all(same["blocks"][k] is v for k, v in params["blocks"].items())


def test_engine_on_the_compute_tree_gives_the_reference_engines_tokens():
    """bf16 on both sides, co-batched requests across block boundaries:
    the port's engine, decoding with its compute tree, emits the
    reference engine's greedy tokens (exactly, as
    ``tests/test_torch_serve_engine.py`` holds the f32 engines)."""
    jcfg, cfg = jtfm.preset("tiny"), ttfm.preset("tiny")
    pj = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    # The blocks' projections scaled up (as test_torch_engine_mirror.py
    # does): at the init's scale the tied head repeats the last token.
    pj = dict(pj, blocks={k: v if k.endswith("norm") else v * 6.0
                          for k, v in pj["blocks"].items()})
    pt = params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), cfg)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab_size, n) for n in (5, 17, 30)]
    ref = JPaged(jcfg, params=pj, n_slots=4, block_tokens=BT,
                 metrics_registry=JRegistry())
    try:
        want = _together(lambda p: np.asarray(
            ref.Generate(jnp.asarray(p[None]), 20))[0], prompts)
    finally:
        ref.close()
    eng = PagedGeneratorActor(cfg, params=pt, device="cpu", n_slots=4,
                              block_tokens=BT,
                              metrics_registry=MetricsRegistry())
    try:
        assert eng._cparams["blocks"]["wq"].dtype == torch.bfloat16
        got = _together(lambda p: eng.Generate(
            torch.as_tensor(p)[None], 20)[0].numpy(), prompts)
    finally:
        eng.close()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


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


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
def test_greedy_steps_and_windows_go_through_their_programs(spec):
    """Every plain step asks the engine's programs for ``serve.decode``
    at the engine's signature of its sampling mode, every window for
    ``serve.spec_window`` at its width and mode: ``sampled=False`` while
    every live row is greedy, ``sampled=True`` while a sampled row is
    live, a sampled program handed the slots' generators (a window's
    acceptance and draft ones) to draw from. No step or window body runs
    outside its program. Off CUDA a program runs its body, so nothing is
    captured."""
    cfg = ttfm.preset("tiny", dtype=torch.float32)
    params = init_params(torch.Generator().manual_seed(0), cfg)
    sc = None
    if spec:
        dp, dc = tgen.truncated_draft_params(params, cfg, n_layers=1)
        sc = SpecConfig(draft_params=dp, draft_cfg=dc, k=3, adaptive=False)
    eng = PagedGeneratorActor(cfg, params=params, device="cpu", n_slots=2,
                              block_tokens=BT, spec=sc,
                              metrics_registry=MetricsRegistry())
    calls, bodies, inside = [], [], [False]
    run, decode, window = (eng._programs.run, eng._decode_body,
                           eng._window_body)

    def run_(fn, sig, body, generators=()):
        if fn.endswith("_chunk"):  # prefill chunks: their own test
            return run(fn, sig, body)
        calls.append((fn, sig, tuple(generators)))
        inside[0] = True
        try:
            return run(fn, sig, body, generators)
        finally:
            inside[0] = False

    def decode_(sampled):
        bodies.append((sampled, inside[0]))
        return decode(sampled)

    def window_(W, sampled):
        bodies.append((sampled, inside[0]))
        return window(W, sampled)

    eng._programs.run = run_
    eng._decode_body, eng._window_body = decode_, window_
    p = torch.as_tensor(np.random.default_rng(1).integers(1, 256, 9))[None]
    try:
        eng.Generate(p, 12)
        n_greedy = len(calls)
        eng.Generate(p, 12, temperature=0.8, seed=3)
    finally:
        eng.close()
    assert eng._programs.progs == {}
    assert len(bodies) == len(calls) > n_greedy > 0
    assert all(ran_inside for _, ran_inside in bodies)
    assert [s for s, _ in bodies] == [False] * n_greedy + [True] * (
        len(calls) - n_greedy)
    greedy, sampled = set(calls[:n_greedy]), set(calls[n_greedy:])
    sig = "B=2,dtype=float32,attn=gather,sampled={}"
    gens = {"serve.decode": eng._slot_gens,
            "serve.spec_window": eng._slot_agens + eng._slot_dgens}
    for mode, got in ((False, greedy), (True, sampled)):
        plain = ("serve.decode", sig.format(mode),
                 gens["serve.decode"] if mode else ())
        if spec:
            # Windows of k + 1, and the plain step of a one-token tail.
            assert ("serve.spec_window",
                    f"B=2,W=4,dtype=float32,sampled={mode}",
                    gens["serve.spec_window"] if mode else ()) in got
            assert {c[0] for c in got - {plain}} == {"serve.spec_window"}
        else:
            assert got == {plain}
        assert all(g == (gens[fn] if mode else ()) for fn, _, g in got)


class _StubGraph:
    """A CUDA graph's stand-in: counts its captures and replays, and
    records the generators registered on it and those registered when
    its capture began."""

    def __init__(self):
        self.replays = 0
        self.captured = 0
        self.generators = []
        self.at_capture = None

    def register_generator_state(self, generator):
        self.generators.append(generator)

    def replay(self):
        self.replays += 1


class _StubStream:
    def wait_stream(self, other):
        pass


@pytest.fixture
def stub_cuda(monkeypatch):
    """``torch.cuda``'s graph and stream calls replaced by stubs, so
    :class:`Programs` takes its CUDA path on the CPU."""
    graphs, modes = [], []

    @contextmanager
    def graph(g, pool=None, stream=None, capture_error_mode="global"):
        modes.append((pool, capture_error_mode))
        g.captured += 1
        g.at_capture = list(g.generators)
        yield

    def new_graph():
        graphs.append(_StubGraph())
        return graphs[-1]

    monkeypatch.setattr(torch.cuda, "CUDAGraph", new_graph)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(torch.cuda, "Stream", lambda *a: _StubStream())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: _StubStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: nullcontext())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: ("pool",))
    return graphs, modes


def _fake_step(n_paged, calls):
    """A body whose kernel wrappers count ``n_paged`` paged launches."""
    def body():
        calls.append(1)
        for _ in range(n_paged):
            count_launch(paged_attention)
        return torch.full((2,), float(len(calls)))
    return body


def test_a_capture_takes_its_launches_back_and_each_replay_adds_them(
        stub_cuda):
    graphs, modes = stub_cuda
    progs = programs_mod.Programs(torch.device("cuda"))
    calls = []
    body = _fake_step(12, calls)
    jw = jitwatch.enable()
    before = paged_attention.launches
    try:
        first = progs.run("serve.decode", "B=8", body)
        # The warm-up ran and counted; the capture recorded and took its
        # count back.
        assert len(calls) == 2 and graphs[0].captured == 1
        assert paged_attention.launches - before == 12
        assert float(first[0]) == 1.0  # the warm-up's result
        prog = progs.progs[("serve.decode", "B=8")]
        assert prog.launches == {paged_attention: 12}
        for _ in range(3):
            out = progs.run("serve.decode", "B=8", body)
        assert out is prog.outputs and float(out[0]) == 2.0
        assert len(calls) == 2 and graphs[0].replays == prog.replays == 3
        assert paged_attention.launches - before == 12 * 4
        progs.run("serve.spec_window", "B=8,W=3", _fake_step(0, calls))
        assert len(graphs) == 2
        assert progs.progs[("serve.spec_window", "B=8,W=3")].launches == {}
        books = jw.compiles()
    finally:
        jitwatch.disable()
        paged_attention.launches = before
    assert books == {"serve.decode": 1, "serve.spec_window": 1}
    assert [m for _, m in modes] == ["thread_local"] * 2
    assert len({p for p, _ in modes}) == 1  # one pool for the engine
    progs.close()
    assert progs.progs == {}


def test_a_captures_tally_is_its_own_threads():
    """Another thread's launches during a capture stay counted and out
    of the capture's tally."""
    before = paged_attention.launches, flash_attention.launches
    other = threading.Thread(target=lambda: [count_launch(flash_attention)
                                             for _ in range(5)])
    try:
        with launch_tally() as mine:
            count_launch(paged_attention)
            other.start()
            other.join()
            count_launch(paged_attention)
        assert mine == {paged_attention: 2}
        assert flash_attention.launches - before[1] == 5
        assert paged_attention.launches - before[0] == 2
    finally:
        paged_attention.launches, flash_attention.launches = before


def test_a_sampled_capture_registers_its_generators_before_it_begins(
        stub_cuda):
    """The generators handed to :meth:`Programs.run` are registered on
    the key's graph, every one, before its capture begins; a greedy key
    registers none."""
    graphs, _ = stub_cuda
    progs = programs_mod.Programs(torch.device("cuda"))
    gens = tuple(torch.Generator().manual_seed(s) for s in (1, 2, 3))
    calls = []
    progs.run("serve.decode", "B=3,sampled=True", _fake_step(0, calls),
              gens)
    progs.run("serve.decode", "B=3,sampled=False", _fake_step(0, calls))
    progs.run("serve.decode", "B=3,sampled=True", _fake_step(0, calls),
              gens)
    assert len(graphs) == 2 and graphs[0].replays == 1
    assert len(graphs[0].at_capture) == len(gens)
    assert all(a is b for a, b in zip(graphs[0].at_capture, gens))
    assert graphs[1].at_capture == []


class _RerunGraph:
    """A CUDA graph's stand-in whose capture records nothing (as a real
    one runs nothing) and whose replay runs the body again into its
    program's outputs; it keeps the generators registered on it."""

    def __init__(self, body, generators):
        self.body, self.generators = body, tuple(generators)
        self.program = None

    def replay(self):
        self.program.outputs = self.body()


def test_a_readmitted_slot_draws_its_new_seed_on_replay(monkeypatch):
    """A one-slot f32 engine on the programs' CUDA path (stub graphs that
    replay by running the body again): the sampled step's capture
    registers the slot's generator, and two sampled requests with other
    seeds, one after the other in that slot, each equal their solo
    ``generate``. The second runs on replays only: its stream was copied
    into the registered generator in place at its admission."""
    graphs = []

    def capture(body, pool, stream, generators=()):
        graphs.append(_RerunGraph(body, generators))
        graphs[-1].program = programs_mod.Program(graphs[-1], None, {})
        return graphs[-1].program

    monkeypatch.setattr(programs_mod, "capture", capture)
    monkeypatch.setattr(torch.cuda, "Stream", lambda *a: _StubStream())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: _StubStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: nullcontext())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: ("pool",))
    cfg = ttfm.preset("tiny", dtype=torch.float32)
    params = init_params(torch.Generator().manual_seed(0), cfg)
    eng = PagedGeneratorActor(cfg, params=params, device="cpu", n_slots=1,
                              block_tokens=BT,
                              metrics_registry=MetricsRegistry())
    eng._programs = programs_mod.Programs(torch.device("cuda"))
    rng = np.random.default_rng(4)
    kw = dict(temperature=0.9, top_k=40, top_p=0.9)
    reqs = [(torch.as_tensor(rng.integers(1, 256, n))[None], seed)
            for n, seed in ((9, 5), (13, 9))]
    try:
        got = [eng.Generate(p, 10, seed=seed, **kw) for p, seed in reqs]
        key = ("serve.decode", "B=1,dtype=float32,attn=gather,sampled=True")
        prog = eng._programs.progs[key]
    finally:
        eng.close()
    assert prog.replays == 2 * 9 - 1  # captured at the first step
    reg = prog.graph.generators
    assert len(reg) == 1 and reg[0] is eng._slot_gens[0]
    for (p, seed), out in zip(reqs, got):
        want = tgen.generate(params, cfg, p, 10,
                             generator=torch.Generator().manual_seed(seed),
                             **kw)
        assert torch.equal(out, want), seed
