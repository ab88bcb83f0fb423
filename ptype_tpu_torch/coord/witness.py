"""Witness node: the third vote that closes the partition hole; the
port's copy of ``ptype_tpu/coord/witness.py``, with the same wire and
state file, so either package's client talks to either witness.

The primary + WAL-standby pair covers crash failover, but a LIVE network
partition leaves a linearizability hole raft never had: a superseded
primary that can still reach *some* clients keeps serving them stale
state, because the term fence only helps clients that have SEEN the new
term. The reference embedded a raft member in every process
(the reference cluster.go:161-196) and proved real quorum
behavior under partition (cluster_test.go:47-167): the minority side
cannot serve.

This module is the cluster's quorum element — a deliberately tiny
lease server, not a consensus log (the WAL stream already replicates
state; what was missing is only the MAJORITY VOTE):

- The serving primary must hold a renewable lease here (or be in live
  round-trip contact with its WAL follower — either grants the second
  vote of the {primary, standby, witness} majority;
  :class:`~ptype_tpu_torch.coord.service.CoordServer` ``witness_addr``).
  A primary that can reach NEITHER is the minority side of a partition
  and self-fences when the lease TTL lapses — refusing its clients
  rather than serving possibly-superseded state.
- A standby may only promote after acquiring the lease, which the
  witness grants only once the primary's lease has EXPIRED — so at most
  one side of a partition can ever hold it (the fencing-token pattern;
  same shape as a chubby/etcd election lease).

Timing safety: the primary stamps its quorum deadline BEFORE sending a
renewal, the witness stamps the lease deadline AT receipt — so the
primary's self-fence always fires at or before the moment the witness
could hand the lease to a challenger. Only clock RATE drift (not
offset) could narrow that margin.

The witness persists ``(holder, term)`` when given a ``data_dir`` so a
witness restart cannot be tricked into granting a second, lower-term
lease; on restart the lease deadline is re-armed to a full TTL (it
cannot know how fresh the incumbent is, so it assumes the newest).
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time

from ptype_tpu_torch import lockcheck

from ptype_tpu_torch import logs
from ptype_tpu_torch.coord import wire

log = logs.get_logger("coord.witness")

#: Default lease TTL (seconds). Renewals should run at ~ttl/3.
DEFAULT_TTL = 3.0


class WitnessServer:
    """Single-lease vote server. Ops (all fire one reply):

    - ``vote_renew   {holder, term}`` — extend the lease iff ``holder``
      is the incumbent (or the lease is vacant) and ``term`` is not
      behind. Refusal tells a superseded primary it must HARD-fence.
    - ``vote_acquire {candidate, term}`` — take the lease iff vacant,
      expired, or already held by ``candidate``; a takeover from a
      different holder additionally requires ``term`` strictly above
      the recorded one (the promotion bump).
    - ``vote_status  {}`` — introspection: holder/term/remaining.
    """

    def __init__(self, address: str = "127.0.0.1:0",
                 ttl: float = DEFAULT_TTL,
                 data_dir: str | None = None):
        self.ttl = ttl
        self._data_dir = data_dir
        self._lock = lockcheck.lock("coord.witness")
        self._holder: str | None = None
        self._term = 0
        self._deadline = 0.0  # monotonic; 0 = vacant/expired
        if data_dir:
            os.makedirs(data_dir, exist_ok=True)
            self._load()
        host, _, port = address.rpartition(":")
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host or "127.0.0.1", int(port)))
        self._sock.listen(64)
        self.address = (f"{self._sock.getsockname()[0]}:"
                        f"{self._sock.getsockname()[1]}")
        self._closed = threading.Event()
        threading.Thread(target=self._accept_loop, name="witness-accept",
                         daemon=True).start()
        log.info("witness listening",
                 kv={"addr": self.address, "ttl": ttl,
                     "holder": self._holder, "term": self._term})

    # ------------------------------------------------------------ state

    def _state_path(self) -> str:
        return os.path.join(self._data_dir, "witness.json")

    def _load(self) -> None:
        try:
            with open(self._state_path(), encoding="utf-8") as f:
                st = json.load(f)
        except (OSError, ValueError):
            return
        self._holder = st.get("holder")
        self._term = int(st.get("term", 0))
        if self._holder is not None:
            # Can't know how stale the incumbent is across a restart:
            # assume freshest (full TTL) so a restart never hands the
            # lease to a challenger early.
            self._deadline = time.monotonic() + self.ttl

    def _persist_locked(self) -> None:
        if not self._data_dir:
            return
        tmp = self._state_path() + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"holder": self._holder, "term": self._term}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._state_path())
        # Always durable (writes happen only at holder/term changes —
        # rare): a restart that forgot the lease would grant a second,
        # lower-term one, exactly the split brain persistence prevents.
        from ptype_tpu_torch.coord.core import fsync_dir

        fsync_dir(self._data_dir)

    # ------------------------------------------------------------- votes

    def _vote(self, msg: dict) -> dict:
        op = msg.get("op")
        now = time.monotonic()
        with self._lock:
            if op == "vote_renew":
                holder, term = msg["holder"], int(msg.get("term", 0))
                vacant = (self._holder is None or now > self._deadline)
                if ((self._holder == holder or vacant)
                        and term >= self._term):
                    changed = (self._holder != holder
                               or term > self._term)
                    self._holder, self._term = holder, max(
                        term, self._term)
                    self._deadline = now + self.ttl
                    if changed:
                        self._persist_locked()
                    return {"granted": True, "term": self._term}
                return {"granted": False, "term": self._term,
                        "holder": self._holder}
            if op == "vote_acquire":
                cand, term = msg["candidate"], int(msg.get("term", 0))
                if self._holder == cand and term >= self._term:
                    pass  # idempotent re-acquire
                elif self._holder is None or now > self._deadline:
                    if term <= self._term and self._holder is not None:
                        # A takeover must carry the promotion bump:
                        # equal-term challengers (two juniors racing)
                        # must not both get a grant.
                        return {"granted": False, "term": self._term,
                                "holder": self._holder,
                                "reason": "term not above incumbent"}
                else:
                    return {"granted": False, "term": self._term,
                            "holder": self._holder,
                            "reason": "lease active"}
                self._holder = cand
                self._term = max(term, self._term)
                self._deadline = now + self.ttl
                self._persist_locked()
                log.info("witness lease granted",
                         kv={"holder": cand, "term": self._term})
                return {"granted": True, "term": self._term}
            if op == "vote_status":
                return {"holder": self._holder, "term": self._term,
                        "remaining": max(0.0, self._deadline - now)}
        raise ValueError(f"unknown witness op {op!r}")

    # --------------------------------------------------------- transport

    def _accept_loop(self) -> None:
        while not self._closed.is_set():
            try:
                conn, peer = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve_conn, args=(conn,),
                             name=f"witness-conn-{peer[1]}",
                             daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        lock = threading.Lock()
        try:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            while not self._closed.is_set():
                try:
                    msg = wire.recv_msg(conn)
                except (wire.WireError, OSError):
                    return
                try:
                    reply = self._vote(msg)
                    reply.update({"id": msg.get("id"), "ok": True})
                except Exception as e:  # noqa: BLE001 — serve on
                    reply = {"id": msg.get("id"), "ok": False,
                             "error": str(e)}
                try:
                    wire.send_msg(conn, lock, reply)
                except (wire.WireError, OSError):
                    return
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def close(self) -> None:
        self._closed.set()
        try:
            self._sock.close()
        except OSError:
            pass


def _witness_call(address: str, msg: dict, timeout: float) -> dict:
    """One short-lived request/reply to the witness. Raises OSError /
    WireError on unreachability — callers treat that as a missing vote,
    never as a grant."""
    host, _, port = address.rpartition(":")
    sock = socket.create_connection((host, int(port)), timeout=timeout)
    try:
        sock.settimeout(timeout)
        wire.send_msg(sock, threading.Lock(), dict(msg, id=1))
        reply = wire.recv_msg(sock)
        if not reply.get("ok"):
            raise wire.WireError(
                f"witness error: {reply.get('error')}")
        return reply
    finally:
        try:
            sock.close()
        except OSError:
            pass


def renew(address: str, holder: str, term: int,
          timeout: float = 1.0) -> dict:
    return _witness_call(
        address, {"op": "vote_renew", "holder": holder, "term": term},
        timeout)


def acquire(address: str, candidate: str, term: int,
            timeout: float = 2.0) -> dict:
    return _witness_call(
        address,
        {"op": "vote_acquire", "candidate": candidate, "term": term},
        timeout)


def status(address: str, timeout: float = 2.0) -> dict:
    return _witness_call(address, {"op": "vote_status"}, timeout)
