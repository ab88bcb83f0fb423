"""The batched sampler the engine's sampled programs run, on the CPU at
``tiny`` f32: the per-row filters against the reference's
``_filter_logits_traced`` vmapped over rows (exact masks), each row's
draw against the solo ``generate`` at B=1 with the same seed, and a
co-batched acceptance window against each row's own. Inputs are made
from numpy seeds."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptype_tpu.models import generate as jgen
from ptype_tpu.models import transformer as jtfm
from ptype_tpu_torch.models import generate as tgen
from ptype_tpu_torch.models import transformer as ttfm
from ptype_tpu_torch.models.weights import params_from_numpy

JCFG = jtfm.preset("tiny", dtype=jnp.float32)
TCFG = ttfm.preset("tiny", dtype=torch.float32)
V = TCFG.vocab_size
PT = params_from_numpy(jax.tree_util.tree_map(
    np.asarray, jtfm.init_params(jax.random.PRNGKey(0), JCFG)), TCFG)
#: Every pair of the per-row filters: top_k off, 1, 50 and V; top_p
#: 0.5, 0.95 and off.
FILTERS = list(itertools.product((0, 1, 50, V), (0.5, 0.95, 1.0)))


def _logits(seed, shape):
    return (np.random.default_rng(seed).normal(size=shape) * 3).astype(
        np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("window", [False, True], ids=["step", "window"])
def test_batched_filter_gives_the_references_masks(seed, window):
    """One row a filter pair, in one (B, V) call — or (B, 3, V), a
    window's logits, the filters broadcast over its positions: every
    kept logit and every mask equal the reference's, row by row."""
    B = len(FILTERS)
    tk = np.array([k for k, _ in FILTERS], np.int32)
    tp = np.array([p for _, p in FILTERS], np.float32)
    shape = (B, 3, V) if window else (B, V)
    logits = _logits(seed, shape)
    one = jax.vmap(jgen._filter_logits_traced)
    if window:
        want = jax.vmap(lambda lg, k, p: jax.vmap(
            lambda x: jgen._filter_logits_traced(x, k, p))(lg))(
            jnp.asarray(logits), jnp.asarray(tk), jnp.asarray(tp))
        got = tgen._filter_logits_traced(torch.tensor(logits),
                                         torch.tensor(tk)[:, None],
                                         torch.tensor(tp)[:, None])
    else:
        want = one(jnp.asarray(logits), jnp.asarray(tk), jnp.asarray(tp))
        got = tgen._filter_logits_traced(torch.tensor(logits),
                                         torch.tensor(tk), torch.tensor(tp))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    kept = np.isfinite(got.numpy()).sum(-1)
    for i, (k, p) in enumerate(FILTERS):
        if p == 1.0:
            assert (kept[i] == (k if k else V)).all(), (k, p, kept[i])


def _first_logits(prompt):
    cache = tgen.init_cache(TCFG, 1, max_seq=128)
    return tgen.prefill(PT, torch.as_tensor(prompt)[None], TCFG, cache)[0]


@pytest.mark.parametrize("seed", [0, 1])
def test_batched_rows_draw_their_solo_tokens(seed):
    """Rows of mixed temperatures and filters, one generator each (a
    greedy row none), sampled in one call twice — each row's two tokens
    are the first token of ``generate`` at B=1 with the row's seed and
    its second draw over the same logits (the solo path's second
    step draws once more from the same generator)."""
    rng = np.random.default_rng(seed)
    rows = [(0.8, 50, 0.95), (1.0, 0, 1.0), (0.0, 0, 1.0), (0.6, V, 0.5),
            (1.3, 1, 1.0), (0.9, 12, 0.9)]
    prompts = [rng.integers(1, V, n) for n in (5, 9, 12, 7, 16, 3)]
    logits = torch.cat([_first_logits(p) for p in prompts])
    seeds = [int(s) for s in rng.integers(0, 2**31, len(rows))]
    gens = [torch.Generator().manual_seed(s) if t > 0 else None
            for s, (t, _, _) in zip(seeds, rows)]
    temps, ks, ps = (torch.tensor([r[i] for r in rows]) for i in range(3))
    first = tgen.sample_token_rows(logits, gens, temps.float(),
                                   ks.to(torch.int32), ps.float())
    again = tgen.sample_token_rows(logits, gens, temps.float(),
                                   ks.to(torch.int32), ps.float())
    for i, (t, k, p) in enumerate(rows):
        g = torch.Generator().manual_seed(seeds[i])
        want = tgen.generate(PT, TCFG, torch.as_tensor(prompts[i])[None],
                             1, temperature=t, generator=g, top_k=k,
                             top_p=p)
        assert int(first[i]) == int(want[0, 0]), (i, rows[i])
        x = tgen._filter_logits(logits[i:i + 1] / t, k, p) if t else None
        if t:
            u = torch.rand((1, V), generator=g)
            second = int(torch.argmax(x + tgen._gumbel(u), dim=-1)[0])
        else:
            second = int(torch.argmax(logits[i]))
        assert int(again[i]) == second, (i, rows[i])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_a_cobatched_window_accepts_as_each_row_alone(seed):
    """``spec_accept_rows`` over rows of mixed modes (two greedy, the
    others sampled with their own filters) gives each row what the row
    gets alone, and leaves each acceptance generator where the row alone
    leaves it: k uniforms and one (V,) vector drawn."""
    rng = np.random.default_rng(seed)
    k = 3
    rows = [(0.0, 0, 1.0), (0.8, 50, 0.95), (1.0, 0, 1.0), (0.0, 5, 0.5),
            (0.7, V, 0.9)]
    B = len(rows)
    t_lg = torch.tensor(_logits(seed, (B, k + 1, V)))
    d_lg = t_lg[:, :k] + torch.tensor(_logits(seed + 10, (B, k, V))) * 0.3
    d_toks = torch.argmax(d_lg + torch.tensor(
        rng.gumbel(size=(B, k, V)).astype(np.float32)), dim=-1)
    d_toks[0] = torch.argmax(t_lg[0, :k], -1)  # a greedy row accepted whole
    seeds = [int(s) for s in rng.integers(0, 2**31, B)]

    def gens():
        return [tgen.folded_generator(s, tgen._ACCEPT_FOLD, "cpu")
                for s in seeds]

    temps = np.array([r[0] for r in rows], np.float32)
    ks = np.array([r[1] for r in rows], np.int32)
    ps = np.array([r[2] for r in rows], np.float32)
    together = gens()
    out, acc = tgen.spec_accept_rows(d_toks, d_lg, t_lg, together, temps,
                                     ks, ps)
    for b in range(B):
        alone = gens()[b]
        o, a = tgen.spec_accept_rows(d_toks[b:b + 1], d_lg[b:b + 1],
                                     t_lg[b:b + 1], [alone], temps[b:b + 1],
                                     ks[b:b + 1], ps[b:b + 1])
        assert torch.equal(out[b], o[0]) and int(acc[b]) == int(a[0]), b
        assert torch.equal(together[b].get_state(), alone.get_state()), b
    assert int(acc[0]) == k
