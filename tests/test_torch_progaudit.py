"""The port's progaudit, case for case with ``tests/test_progaudit.py``:
the detectors on synthetic programs (host synchronisations, sanctioned
ones reported but passing, f64 drift and its waiver, donation consumed
in place against dropped, copied and replaced), the registry, the real
hot programs auditing clean, and the parity bar — for each of the
fourteen ``DEFAULT_PROGRAMS`` the port's report and the reference's
``audit_registered(name)`` agree on ``ok``, on ``collectives`` (the
c10d ops mapped onto the reference's primitive names), on callbacks
(both empty) and on the donation counts.

The reference audits its programs on the conftest's eight CPU devices
(its pins do not depend on the device count: one launch a bucket; at
eight devices its two-leg programs run on ``Topology(2, 4)``). The
port's serving and grad programs run here in f32 at ``tiny``; its
collective and ZeRO programs, and the synthetic un-fusions that must
break their pins, run on 1, 2 and 4 gloo ranks (``progaudit_suite`` in
``tests/torch_ranks.py``). The two-leg pins compare with the
reference's at 4 ranks, where ``Topology(2, 2)`` has both legs; at 2
ranks the outer leg has size 1 and at 1 rank both legs do, and a
size-1 leg launches nothing. Counts are exact."""

import pytest
import torch

from ptype_tpu import progaudit as jaudit
from ptype_tpu_torch import jitwatch, progaudit
from torch_ranks import Ranks

LOCAL = ("train.grads", "serve.decode_step", "serve.spec_window",
         "serve.kv_pack", "serve.kv_unpack")
RANKED = tuple(p for p in progaudit.DEFAULT_PROGRAMS if p not in LOCAL)
HIER = ("collectives.hier_allreduce", "collectives.hier_reduce_scatter")
#: The two-leg programs' per-leg launches by world size (a size-1 leg
#: launches nothing).
HIER_PINS = {
    1: ({}, {}),
    2: ({"reduce_scatter": 1, "all_gather": 1}, {"reduce_scatter": 1}),
    4: ({"reduce_scatter": 1, "psum": 1, "all_gather": 1},
        {"reduce_scatter": 2}),
}
F32 = torch.float32


@pytest.fixture(scope="module")
def reference():
    jaudit.register_default_programs()
    return {n: jaudit.audit_registered(n) for n in jaudit.DEFAULT_PROGRAMS}


@pytest.fixture(scope="module")
def local():
    progaudit.register_default_programs(device="cpu")
    return progaudit.audit_all(names=LOCAL)


@pytest.fixture(scope="module")
def ranked(tmp_path_factory):
    """world -> rank 0's output of ``progaudit_suite`` (every rank's
    reports are checked equal). One world at a time: at most 4 rank
    processes beside the other test workers."""
    out = {}
    for n in (1, 2, 4):
        outs = Ranks("progaudit", n, tmp_path_factory.mktemp(f"pa{n}"),
                     {"programs": RANKED}).join(300)
        assert all(o == outs[0] for o in outs), n
        out[n] = outs[0]
    return out


def _vec(n):
    return torch.arange(n, dtype=F32) + 1.0


# ------------------------------------------------------------ detectors


def test_clean_program_audits_clean():
    rep = progaudit.audit(lambda x: x * 2 + 1, (_vec(8),), name="clean",
                          expect_collectives=0)
    assert rep.ok and rep.collectives == {} and rep.eqns >= 2
    assert rep.raise_if_failed() is rep


def test_host_read_in_program_is_flagged():
    def noisy(x):
        if x.sum() > 0:  # a host read of a device value
            x = x + 1
        return x

    rep = progaudit.audit(noisy, (_vec(4),), name="noisy")
    assert not rep.ok and rep.callbacks == ["aten::_local_scalar_dense"]
    with pytest.raises(progaudit.AuditError, match="noisy"):
        rep.raise_if_failed()


def test_data_dependent_shape_is_flagged():
    rep = progaudit.audit(lambda x: x[x > 2], (_vec(4),))
    assert not rep.ok and rep.callbacks == ["aten::index (boolean mask)"]


def test_sanctioned_sync_is_reported_not_a_problem():
    def metered(x):
        y = x * 2
        with jitwatch.sanctioned_transfer("test.meter"):
            y.sum().item()
        return y

    rep = progaudit.audit(metered, (_vec(4),), name="metered")
    assert rep.ok and rep.callbacks == []
    assert rep.sanctioned == ["aten::_local_scalar_dense (test.meter)"]


def test_f64_drift_is_flagged_and_allow_f64_waives():
    def drift(x):
        return x.to(torch.float64).sum()

    rep = progaudit.audit(drift, (_vec(4),), name="drift")
    assert not rep.ok and rep.f64_sites[0] == "aten::_to_copy -> f64"
    assert progaudit.audit(drift, (_vec(4),), allow_f64=True).ok
    rep = progaudit.audit(lambda x: x * 2, (_vec(4).double(),))
    assert not rep.ok and rep.f64_sites[0] == "f64 program input"


@pytest.mark.parametrize("case", ["not_written", "fresh_return",
                                  "copied_back"])
def test_dropped_donation_is_flagged(case):
    """A donated buffer the program never writes, one it replaces with a
    fresh tensor of its shape, and one it copies whole before writing it
    back: each is not consumed."""
    def copied_back(x):
        y = x.clone()
        return x.copy_(y * 2)

    fn = {"not_written": lambda x: x.sum(),
          "fresh_return": lambda x: x.clone().mul_(2),
          "copied_back": copied_back}[case]
    rep = progaudit.audit(fn, (_vec(16),), name="dropped",
                          donate_argnums=(0,))
    assert not rep.ok and rep.donated_consumed < rep.donated_expected == 1
    assert any("donation" in p for p in rep.problems), rep.problems


def test_consumed_donation_passes():
    rep = progaudit.audit(lambda x: x.mul_(2), (_vec(16),),
                          donate_argnums=(0,))
    assert rep.ok and rep.donated_consumed == rep.donated_expected == 1


def test_collect_primitives_counts_the_ops_of_a_run():
    counts = progaudit.collect_primitives(lambda x: (x * 2) * 3, (_vec(3),))
    assert counts == {"aten::mul": 2}


# ------------------------------------------------------------- registry


def test_unknown_program_raises_keyerror():
    with pytest.raises(KeyError, match="no registered hot program"):
        progaudit.audit_registered("no.such.program")


def test_default_registry_covers_the_hot_programs():
    progaudit.register_default_programs(device="cpu")
    assert set(progaudit.DEFAULT_PROGRAMS) <= set(progaudit.registered())
    assert progaudit.DEFAULT_PROGRAMS == jaudit.DEFAULT_PROGRAMS


def test_real_hot_programs_audit_clean(local, ranked):
    """THE acceptance: every program of the registry — the serving and
    grad programs here, the collective and ZeRO programs on 1, 2 and 4
    ranks — runs with no host synchronisation, no f64 outside the CPU's
    AdamW root, its pinned launch counts and consumed donations."""
    for rep in local.values():
        rep.raise_if_failed()
    for n, out in ranked.items():
        assert set(out["programs"]) == set(RANKED)
        for name, rep in out["programs"].items():
            assert rep["ok"], (n, name, rep["problems"])
    dec, win = local["serve.decode_step"], local["serve.spec_window"]
    assert dec.donated_consumed == dec.donated_expected == 2
    assert win.donated_consumed == win.donated_expected == 4
    assert win.collectives == {} and dec.collectives == {}


@pytest.mark.parametrize("n", [1, 2, 4])
def test_collective_and_zero_programs_pin_their_launches(ranked, n):
    """One launch a bucket at every world size — at world 1 too: the
    flat programs call the collective on a group of one — and the
    two-leg programs one launch a leg of size > 1."""
    progs = ranked[n]["programs"]
    assert progs["collectives.bucket_allreduce"]["collectives"] == \
        {"psum": 1}
    assert progs["collectives.bucket_reduce_scatter"]["collectives"] == \
        {"reduce_scatter": 1}
    for name in ("zero.shard_apply", "zero1.shard_apply",
                 "zero3.param_gather"):
        assert progs[name]["collectives"] == {"all_gather": 1}, name
    assert progs["zero2.grad_reduce_scatter"]["collectives"] == \
        {"reduce_scatter": 1}
    ap3 = progs["zero3.shard_apply"]
    assert ap3["collectives"] == {}
    assert ap3["donated_consumed"] == ap3["donated_expected"] == 3
    for name, want in zip(HIER, HIER_PINS[n]):
        assert progs[name]["collectives"] == want, name


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("case", ["per_leaf_psum", "split_rs",
                                  "rs_then_gather", "per_leaf_gather"])
def test_synthetic_unfusions_break_their_pins(ranked, n, case):
    """Per-leaf psums where the bucket says ONE; the same flat reduced as
    two half-bucket reduce-scatters; a reduce-scatter gathered straight
    back (ZeRO-2's point defeated); per-leaf param gathers."""
    rep = ranked[n]["unfusions"][case]
    assert not rep["ok"], rep
    want = {"per_leaf_psum": {"psum": 2}, "split_rs": {"reduce_scatter": 2},
            "rs_then_gather": {"reduce_scatter": 1, "all_gather": 1},
            "per_leaf_gather": {"all_gather": 2}}[case]
    assert rep["collectives"] == want
    assert ranked[n]["unfusions"]["per_leaf_psum_pinned_2"]["ok"]


# ------------------------------------------------------ reference parity


def _same(port: dict, ref) -> None:
    assert port["ok"] == ref.ok is True, (port["problems"], ref.problems)
    assert port["collectives"] == ref.collectives
    assert port["callbacks"] == ref.callbacks == []
    assert (port["donated_expected"], port["donated_consumed"]) == \
        (ref.donated_expected, ref.donated_consumed)


@pytest.mark.parametrize("name", LOCAL)
def test_serving_and_grad_programs_equal_the_reference(local, reference,
                                                       name):
    _same(local[name].to_dict(), reference[name])


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", RANKED)
def test_collective_and_zero_programs_equal_the_reference(ranked,
                                                          reference, n,
                                                          name):
    """The reference's pins hold at every device count; its two-leg
    programs have both legs, which the port's have at 4 ranks."""
    if name in HIER and n == 2:
        assert ranked[n]["programs"][name]["collectives"] == \
            HIER_PINS[2][HIER.index(name)]
        return
    _same(ranked[n]["programs"][name], reference[name])
