"""The paged engine's device mirror of its slot state, in f32 on the CPU
at ``tiny``: at the start of every plain step and every speculation
window a built mirror equals the host arrays, a mirror is built exactly
after an admission, a retire, a window or a block allocation, into the
same device buffers every time (a captured step reads their addresses),
and the greedy tokens equal the reference engine's. The workload crosses block
boundaries many times (``block_tokens`` 8, the smallest the pool
takes), admits rows while others decode, stops a row on its stop token,
cancels a live row, lands a migrated request, and under speculation
forces plain steps between windows through the ``serve.spec`` chaos
seam."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptype_tpu.metrics import MetricsRegistry as JRegistry
from ptype_tpu.models import transformer as jtfm
from ptype_tpu.serve_engine import PagedGeneratorActor as JPaged
from ptype_tpu_torch import chaos
from ptype_tpu_torch.metrics import MetricsRegistry
from ptype_tpu_torch.models import generate as tgen
from ptype_tpu_torch.models import transformer as ttfm
from ptype_tpu_torch.models.weights import params_from_numpy
from ptype_tpu_torch.serve_engine import PagedGeneratorActor, SpecConfig

JCFG = jtfm.preset("tiny", dtype=jnp.float32)
CFG = ttfm.preset("tiny", dtype=torch.float32)
BT = 8
N_SLOTS = 4
#: (prompt length, max_new, seed) of each request: A and B start the
#: engine, C, D, E (migrated) and F join while they decode; D is
#: cancelled live, B stops on its stop token.
REQUESTS = {"A": (5, 30, 1), "B": (11, 26, 2), "C": (17, 20, 3),
            "D": (7, 40, 4), "E": (13, 18, 5), "F": (9, 22, 6)}
#: The mirror's arrays and their host types.
MIRROR = {"tables": np.int32, "nalloc": np.int32, "active": np.bool_,
          "tok": np.int64, "pos": np.int32, "temps": np.float32,
          "topk": np.int32, "topp": np.float32}
DRAFT_MIRROR = {"dtables": np.int32, "dnalloc": np.int32}
#: The blocks' projections scaled up from the init: at the init's scale
#: the tied head repeats the last token whatever the context, so a
#: misrouted write or a stale position would not show in the tokens.
SHARPEN = 6.0


@pytest.fixture(scope="module")
def trees():
    pj = jtfm.init_params(jax.random.PRNGKey(0), JCFG)
    pj = dict(pj, blocks={k: v if k.endswith("norm") else v * SHARPEN
                          for k, v in pj["blocks"].items()})
    return pj, params_from_numpy(jax.tree_util.tree_map(np.asarray, pj),
                                 CFG)


def _prompt(name):
    n, _, seed = REQUESTS[name]
    return np.random.default_rng(seed).integers(1, CFG.vocab_size, n)


def _stop_token(toks):
    """The token at the first position from 6 on that is neither the
    pad (0) nor one that came before."""
    return int(next(t for i, t in enumerate(toks)
                    if i >= 6 and t and t not in toks[:i]))


class MirrorWatch:
    """Wraps one engine's steps and the events that drop its mirror.

    At each step's start a built mirror must equal the host arrays, in
    the host's types, and every build fills the first build's buffers.
    A step builds the mirror exactly when an admission, a retire or a
    window came since the last step, or the step itself allocated a
    block. ``counts`` tallies the events and the steps."""

    def __init__(self, eng):
        self.eng = eng
        self.keys = dict(MIRROR, **(DRAFT_MIRROR if eng._spec else {}))
        self.counts = dict(admit=0, retire=0, window=0, plain=0,
                           boundary=0, builds=0, steady=0,
                           plain_after_window=0)
        self.dirty = False
        self.last = None
        self.ptrs = None
        take, retire = eng._take_slot, eng._retire
        plain, spec, mirror = eng._plain_step, eng._spec_step, eng._mirror

        def take_slot(*a):
            take(*a)
            self._event("admit")

        def retire_(*a):
            retire(*a)
            self._event("retire")

        def mirror_():
            built = eng._sdev is None
            sd = mirror()
            if built:
                self.counts["builds"] += 1
                self._check(sd)
            return sd

        eng._take_slot, eng._retire, eng._mirror = take_slot, retire_, mirror_
        eng._plain_step = lambda: self._step(plain, "plain")
        eng._spec_step = lambda k: self._step(lambda: spec(k), "window")

    def _event(self, name):
        self.counts[name] += 1
        self.dirty = True

    def _check(self, sd):
        e = self.eng
        assert sorted(sd) == sorted(self.keys), sorted(sd)
        ptrs = {k: v.data_ptr() for k, v in sd.items()}
        self.ptrs = self.ptrs or ptrs
        assert ptrs == self.ptrs, "the mirror moved"
        for k, dt in self.keys.items():
            host = getattr(e, "_" + k)
            dev = sd[k].cpu().numpy()
            assert dev.dtype == dt and host.dtype == dt, (k, dev.dtype)
            np.testing.assert_array_equal(dev, host, err_msg=k)

    def _step(self, run, kind):
        e = self.eng
        if e._sdev is not None:
            self._check(e._sdev)
        before = e._nalloc.copy(), e._dnalloc.copy()
        due, self.dirty = self.dirty, False
        builds = self.counts["builds"]
        run()
        grew = (not np.array_equal(before[0], e._nalloc)
                or not np.array_equal(before[1], e._dnalloc))
        self.counts["boundary"] += grew
        built = self.counts["builds"] - builds
        assert built == (due or grew), (kind, due, grew, built)
        self.counts["steady"] += not built
        self.counts[kind] += 1
        if kind == "plain" and self.last == "window":
            self.counts["plain_after_window"] += 1
        if kind == "window":
            self.dirty = True
        self.last = kind


def _wait(pred, what, timeout=60):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, f"timed out: {what}"
        time.sleep(0.002)


def _reference(pj, attn, stop_b=None):
    """Every request's tokens from the reference engine: B stopped at
    ``stop_b`` when given, E decoded whole (its port twin migrates)."""
    ref = JPaged(JCFG, params=pj, n_slots=N_SLOTS, block_tokens=BT,
                 attn=attn, metrics_registry=JRegistry())
    out = {}
    try:
        def call(name):
            _, new, _ = REQUESTS[name]
            kw = ({"stop_token": stop_b}
                  if name == "B" and stop_b is not None else {})
            out[name] = np.asarray(ref.Generate(
                jnp.asarray(_prompt(name)[None]), new, **kw))[0]

        threads = [threading.Thread(target=call, args=(n,))
                   for n in REQUESTS]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
    finally:
        ref.close()
    assert sorted(out) == sorted(REQUESTS)
    return out


@pytest.fixture(scope="module", params=["gather", "kernel"])
def reference(request, trees):
    """(attn, the reference engine's tokens, B's stop token)."""
    pj, _ = trees
    stop_b = _stop_token(list(_reference(pj, request.param)["B"]))
    return request.param, _reference(pj, request.param, stop_b), stop_b


def _drive(eng, pre, stop_b):
    """The mixed workload; returns each request's tokens and D's
    emitted count at its cancel."""
    out, errs = {}, []
    steps = lambda: eng._steps  # noqa: E731

    def gen(name, **kw):
        _, new, _ = REQUESTS[name]
        try:
            out[name] = eng.Generate(torch.as_tensor(_prompt(name))[None],
                                     new, **kw)[0].numpy()
        except Exception as e:  # noqa: BLE001 — asserted below
            errs.append((name, repr(e)))

    def migrate():
        _, new, _ = REQUESTS["E"]
        p = torch.as_tensor(_prompt("E"))[None]
        try:
            rep = pre.Prefill(p, new)
            plan = eng.MigratePlan(p, new)
            wire = pre.ExportBlocks(rep["export_id"], plan["need"], "exact")
            eng.ImportBlocks(plan["ticket"], wire)
            pre.ReleaseExport(rep["export_id"])
            out["E"] = np.asarray(eng.MigrateDecode(plan["ticket"],
                                                    rep["first_token"]))
        except Exception as e:  # noqa: BLE001 — asserted below
            errs.append(("E", repr(e)))

    threads = []

    def start(fn, *a, **kw):
        threads.append(threading.Thread(target=fn, args=a, kwargs=kw))
        threads[-1].start()

    start(gen, "A")
    start(gen, "B", stop_token=stop_b)
    _wait(lambda: steps() >= 4, "A and B decoding")
    start(gen, "C")
    start(gen, "D")
    _wait(lambda: any(len(r.emitted) >= 5 and len(r.prompt) == 7
                      for r in list(eng._slot_state.values())),
          "D live with 5 tokens")
    d_row = next(r for r in list(eng._slot_state.values())
                 if len(r.prompt) == REQUESTS["D"][0])
    eng._cancel_rows([d_row])
    start(migrate)
    s0 = steps()
    _wait(lambda: steps() >= s0 + 2, "decoding after the cancel")
    start(gen, "F")
    for t in threads:
        t.join(timeout=600)
    assert errs == [] and not any(t.is_alive() for t in threads), errs
    return out, len(d_row.emitted)


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
def test_mirror_equals_host_state_through_a_mixed_workload(trees,
                                                           reference,
                                                           spec):
    """Mirror against host at every step's start, builds against the
    counted events, tokens against the reference engine's."""
    _, pt = trees
    attn, want, stop_b = reference
    spec_cfg = None
    if spec:
        dp, dc = tgen.truncated_draft_params(pt, CFG, n_layers=1)
        spec_cfg = SpecConfig(draft_params=dp, draft_cfg=dc, k=3,
                              adaptive=False)
    eng = PagedGeneratorActor(CFG, params=pt, device="cpu",
                              n_slots=N_SLOTS, block_tokens=BT, attn=attn,
                              spec=spec_cfg, prefill_chunk=16,
                              metrics_registry=MetricsRegistry())
    pre = PagedGeneratorActor(CFG, params=pt, device="cpu", n_slots=1,
                              block_tokens=BT, serve_class="prefill",
                              metrics_registry=MetricsRegistry())
    watch = MirrorWatch(eng)
    # Two windows, then two plain steps, over and over.
    plan = chaos.FaultPlan([
        chaos.FaultSpec(site="serve.spec", action="reject", after=a,
                        times=2) for a in range(2, 200, 4)])
    try:
        with chaos.armed(plan):
            got, d_emitted = _drive(eng, pre, stop_b)
    finally:
        eng.close()
        pre.close()
    for name in "ABCF":
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    np.testing.assert_array_equal(got["E"], want["E"])
    # D was cancelled live: its emitted prefix is the reference's.
    assert 5 <= d_emitted < REQUESTS["D"][1]
    np.testing.assert_array_equal(got["D"][:d_emitted],
                                  want["D"][:d_emitted])
    assert not got["D"][d_emitted:].any()
    assert got["B"][-1] == 0 and stop_b in got["B"]
    c = watch.counts
    assert c["admit"] == c["retire"] == len(REQUESTS), c
    assert c["boundary"] >= 10, c
    if spec:
        # A window drops the mirror: of two windows and two plain steps,
        # the second plain step is the steady one.
        assert c["window"] >= 4 and c["plain_after_window"] >= 2, c
        assert c["steady"] >= 2, c
    else:
        assert c["window"] == 0 and c["steady"] >= 5, c


def steady_stream_books(seed=5):
    """Armed, a `tiny` f32 engine of 4 slots serves six staggered
    40-token requests: the books, the steps, the steps that followed an
    admission, a retire or a block boundary, the steps that found a
    built mirror unequal to the host arrays, and the distinct address
    sets the mirror's buffers had. It reads only what the engine had
    since its mirror, so any such checkout's package runs it."""
    from ptype_tpu_torch import jitwatch
    from ptype_tpu_torch.models.weights import init_params

    params = init_params(torch.Generator().manual_seed(0), CFG)
    jw = jitwatch.enable()
    eng = PagedGeneratorActor(CFG, params=params, device="cpu", n_slots=4,
                              block_tokens=16)
    ev = {"steps": 0, "event_steps": 0, "mirror_unequal": 0}
    addresses = set()
    dirty = [False]
    take, retire, step = eng._take_slot, eng._retire, eng._plain_step

    def take_(*a):
        take(*a)
        dirty[0] = True

    def retire_(*a):
        retire(*a)
        dirty[0] = True

    def step_():
        live = np.flatnonzero(eng._active)
        cross = (eng._pos[live] == eng._nalloc[live] * eng.block_tokens)
        ev["event_steps"] += bool(dirty[0] or cross.any())
        ev["steps"] += 1
        dirty[0] = False
        sd = eng._sdev
        if sd is not None:
            addresses.add(tuple(sorted((k, v.data_ptr())
                                       for k, v in sd.items())))
            ev["mirror_unequal"] += not all(
                np.array_equal(v.numpy(), getattr(eng, "_" + k))
                for k, v in sd.items())
        step()

    eng._take_slot, eng._retire, eng._plain_step = take_, retire_, step_
    rng = np.random.default_rng(seed)
    try:
        threads = [threading.Thread(target=eng.Generate, args=(
            torch.as_tensor(rng.integers(1, 256, n))[None], 40))
            for n in (5, 21, 37, 12, 9, 30)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        eng.close()
        jitwatch.disable()
    return {**ev, "mirror_addresses": len(addresses),
            "books": jw.sanctioned()}


def test_a_steady_stream_refills_one_mirror_in_place():
    """Admissions, retires and block boundaries refill the mirror's
    buffers: one set of addresses through the stream, equal to the host
    arrays at every step that finds it built, one upload an array of the
    mirror (eight) a refill."""
    got = steady_stream_books()
    assert got["mirror_addresses"] == 1, got
    assert got["mirror_unequal"] == 0, got
    assert got["books"]["serve.decode_read"] == got["steps"] > 0, got
    assert got["books"]["serve.slot_state"] == (len(MIRROR)
                                                * got["event_steps"]), got


if __name__ == "__main__":
    # PYTHONPATH=CHECKOUT python tests/test_torch_engine_mirror.py: the
    # armed books of a steady stream on CHECKOUT's package.
    print(steady_stream_books())
