"""The port's witness (``ptype_tpu_torch/coord/witness.py``) against the
reference's (``ptype_tpu/coord/witness.py``).

The eight lease truths of ``tests/test_witness.py`` run on every pairing
of a server and a client package — the port's client on the port's
witness, the reference's client on the port's witness and the port's
client on the reference's witness — since the two share one JSON wire.
The restart case crosses packages through the persisted state file:
one package's witness writes ``witness.json``, the other's reads it.
"""

import time

import pytest

from ptype_tpu.coord import witness as jw
from ptype_tpu_torch.coord import witness as tw

PKG = {"port": tw, "ref": jw}
#: (server package, client package) of each pairing.
PAIRS = [("port", "port"), ("port", "ref"), ("ref", "port")]
PAIR_IDS = [f"{s}-server-{c}-client" for s, c in PAIRS]


@pytest.fixture(params=PAIRS, ids=PAIR_IDS)
def witness(request):
    """(a running witness at TTL 0.4 s, the client module)."""
    server, client = request.param
    srv = PKG[server].WitnessServer(ttl=0.4)
    yield srv, PKG[client]
    srv.close()


def test_renew_vacant_lease_adopts_holder(witness):
    srv, w = witness
    r = w.renew(srv.address, holder="p1", term=0)
    assert r["granted"]
    st = w.status(srv.address)
    assert st["holder"] == "p1"
    assert st["remaining"] > 0


def test_renew_refused_for_non_holder_while_active(witness):
    srv, w = witness
    assert w.renew(srv.address, holder="p1", term=0)["granted"]
    r = w.renew(srv.address, holder="p2", term=0)
    assert not r["granted"]
    assert r["holder"] == "p1"


def test_acquire_refused_while_lease_active(witness):
    srv, w = witness
    assert w.renew(srv.address, holder="p1", term=0)["granted"]
    r = w.acquire(srv.address, candidate="s1", term=1)
    assert not r["granted"]
    assert r["reason"] == "lease active"


def test_acquire_after_expiry_requires_term_bump(witness):
    srv, w = witness
    assert w.renew(srv.address, holder="p1", term=3)["granted"]
    time.sleep(0.6)  # > ttl: lease expired
    # Equal term: two racing challengers must not both win on ties.
    r = w.acquire(srv.address, candidate="s1", term=3)
    assert not r["granted"]
    assert "term" in r["reason"]
    r = w.acquire(srv.address, candidate="s1", term=4)
    assert r["granted"]
    assert r["term"] == 4


def test_superseded_holder_renewal_refused_forever(witness):
    srv, w = witness
    assert w.renew(srv.address, holder="p1", term=0)["granted"]
    time.sleep(0.6)
    assert w.acquire(srv.address, candidate="s1", term=1)["granted"]
    # The old primary comes back from its partition: refused, and told
    # who superseded it.
    r = w.renew(srv.address, holder="p1", term=0)
    assert not r["granted"]
    assert r["holder"] == "s1"
    assert r["term"] == 1
    # The successor's renewals keep working.
    assert w.renew(srv.address, holder="s1", term=1)["granted"]


def test_reacquire_by_holder_is_idempotent(witness):
    srv, w = witness
    assert w.acquire(srv.address, candidate="s1", term=1)["granted"]
    assert w.acquire(srv.address, candidate="s1", term=1)["granted"]


@pytest.mark.parametrize("first,second",
                         [("port", "port"), ("ref", "port"),
                          ("port", "ref")],
                         ids=["port-then-port", "ref-then-port",
                              "port-then-ref"])
def test_restart_keeps_holder_and_rearms_full_ttl(tmp_path, first, second):
    """A witness restarted over the same data_dir keeps its holder and
    term — also when the other package's witness wrote the state."""
    data = str(tmp_path / "w")
    srv = PKG[first].WitnessServer(ttl=0.5, data_dir=data)
    try:
        assert PKG[first].acquire(srv.address, candidate="p1",
                                  term=2)["granted"]
    finally:
        srv.close()
    w = PKG[second]
    srv = w.WitnessServer(ttl=0.5, data_dir=data)
    try:
        st = w.status(srv.address)
        assert st["holder"] == "p1"
        assert st["term"] == 2
        # Freshly restarted: the deadline is re-armed to a FULL ttl,
        # so a challenger cannot exploit the restart window.
        r = w.acquire(srv.address, candidate="s1", term=3)
        assert not r["granted"]
        # And the incumbent's renewals resume seamlessly.
        assert w.renew(srv.address, holder="p1", term=2)["granted"]
    finally:
        srv.close()


@pytest.mark.parametrize("client", ["port", "ref"])
def test_unreachable_witness_raises_not_grants(client):
    with pytest.raises(OSError):
        PKG[client].renew("127.0.0.1:1", holder="p1", term=0, timeout=0.3)


def test_persisted_state_file_is_byte_identical(tmp_path):
    """The two packages persist the same ``witness.json`` for the same
    grant: the file is the cross-package contract."""
    files = {}
    for name, mod in PKG.items():
        data = tmp_path / name
        srv = mod.WitnessServer(ttl=5.0, data_dir=str(data))
        try:
            assert mod.acquire(srv.address, candidate="s1",
                               term=7)["granted"]
        finally:
            srv.close()
        files[name] = (data / "witness.json").read_bytes()
    assert files["port"] == files["ref"]


def test_port_witness_imports_no_torch():
    """A witness is a control-plane process: the port's witness module
    (and the coord package) load without torch."""
    import os
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parents[1]
    code = ("import sys\n"
            "sys.modules['torch'] = None\n"
            "from ptype_tpu_torch.coord import witness\n"
            "srv = witness.WitnessServer(ttl=1.0)\n"
            "assert witness.renew(srv.address, 'p', 0)['granted']\n"
            "srv.close()\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         env=dict(os.environ, PYTHONPATH=str(root)),
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
