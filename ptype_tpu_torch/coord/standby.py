"""Warm-standby coordinator — failover, not just restart; the port's
copy of ``ptype_tpu/coord/standby.py``, whole, so a port standby
mirrors and takes over from either package's seed.

The reference got control-plane availability from raft quorum: any
member's death left the registry/store served by the survivors
(the reference cluster.go:120-147). This rebuild's seed is a
single coordination service with a WAL (coord/core.py), which makes it
survive its own *restart*; a permanently dead coordinator would still
take registry, leases, KV and barriers with it.

:class:`Standby` closes that gap in two deployment shapes — a shared
``data_dir`` (same host, or any shared filesystem), or, with
``replicate=True``, a LOCAL ``data_dir`` kept current by streaming the
primary's WAL over TCP (:class:`WalFollower` — cross-host failover
with no shared storage):

- it health-probes the primary on a short interval;
- after ``failure_threshold`` consecutive probe failures it PROMOTES:
  starts a :class:`CoordServer` on its own address over the shared
  ``data_dir``, replaying snapshot + WAL — registrations, leases, KV
  and membership reappear (leases get one fresh TTL of grace, so live
  clients' keepalives reclaim them before expiry);
- clients constructed with the endpoint list (``RemoteCoord([primary,
  standby])`` — ``cluster.join`` wires this from
  ``initial_cluster_client_urls``) ride their reconnect loop onto the
  standby with no client-side action; re-watch + snapshot-then-delta
  semantics make watch consumers whole.

Split-brain scope: ONE standby per primary. Promotion bumps the
persisted fencing *term* (coord/core.py) — the epoch raft's leader
election gave the reference for free
(the reference cluster.go:120-147). Clients stamp the
highest term they have seen on every request, so an old primary
restarted on its old address after a takeover (stale WAL, stale term)
refuses them and they re-dial to the current primary
(coord/remote.py). In shared-dir mode the WAL-dir flock additionally
fences a wedged-but-alive primary at the filesystem. The residual gap
is inherent to two nodes: during a live network partition, clients
that can ONLY reach the old primary (and have never seen the new
term) keep being served by it — resolving that needs a quorum tier,
which is why auto-promotion still requires a synced mirror and the
operator path refuses while the primary answers.
"""

from __future__ import annotations

import json
import os
import socket
import threading

from ptype_tpu_torch import chaos, logs, retry
from ptype_tpu_torch.coord import wire
from ptype_tpu_torch.coord.core import fsync_dir
from ptype_tpu_torch.coord.service import CoordServer

log = logs.get_logger("coord.standby")


class WalFollower:
    """Streams the primary's WAL into a LOCAL data_dir.

    The shared-``data_dir`` standby assumes one filesystem; this is the
    cross-host variant: subscribe to the primary's replication feed
    (``repl_subscribe`` — coord/core.py), write the initial snapshot to
    ``coord.snap``, append every subsequent WAL record to ``coord.wal``
    — exactly the files :class:`~ptype_tpu_torch.coord.core.CoordState`
    replays, so a promotion over the mirror recovers the full registry/
    lease/KV/member state with no shared storage. On any disconnect it
    re-subscribes: the fresh head snapshot replaces the mirror
    atomically, so a missed-records gap can never go unnoticed.
    ``synced`` is set once the first snapshot has been mirrored.
    """

    def __init__(self, primary_address: str, data_dir: str,
                 reconnect_delay: float = 0.5,
                 connect_timeout: float = 2.0,
                 fsync: bool = False):
        self.primary_address = primary_address
        self.data_dir = data_dir
        self.reconnect_delay = reconnect_delay
        self.connect_timeout = connect_timeout
        #: fsync mirror writes before acknowledging them. Required in
        #: wal_fsync deployments: a sync-put ack asserts the record is
        #: DURABLE on this host, which a page-cache flush() is not
        #: under power loss.
        self._fsync = fsync
        self.synced = threading.Event()
        self._closed = threading.Event()
        self._sock: socket.socket | None = None
        os.makedirs(data_dir, exist_ok=True)
        self._thread = threading.Thread(
            target=self._run, name="coord-wal-follower", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._closed.is_set():
            try:
                self._follow_once()
            except (wire.WireError, OSError) as e:
                log.debug("wal follower disconnected; retrying",
                          kv={"err": str(e)})
            self._closed.wait(self.reconnect_delay)

    def _follow_once(self) -> None:
        host, _, port = self.primary_address.rpartition(":")
        sock = socket.create_connection((host, int(port)),
                                        timeout=self.connect_timeout)
        self._sock = sock
        wal = None
        try:
            sock.settimeout(self.connect_timeout)
            lock = threading.Lock()
            wire.send_msg(sock, lock, {"op": "repl_subscribe", "id": 1})
            reply = wire.recv_msg(sock)
            if not reply.get("ok"):
                raise wire.WireError(
                    f"repl_subscribe refused: {reply.get('error')}")
            # Our feed id: stamped on every ack so the primary credits
            # exactly this feed (a connection may carry several).
            feed_id = reply.get("result")
            # Stream forever; recv blocks until the primary pushes (the
            # pump batches). Timeout only guards the handshake — a
            # quiet-but-alive primary must not look dead here.
            sock.settimeout(None)
            while not self._closed.is_set():
                msg = wire.recv_msg(sock)
                # Re-check AFTER the blocking recv: close() may have
                # promoted this data_dir to a live CoordState while we
                # were parked — one more mirror write would truncate
                # the WAL underneath the new primary.
                if self._closed.is_set():
                    return
                if "repl_hb" in msg:
                    # Liveness heartbeat: the round-trip is our vote
                    # for the primary in the witness quorum — answer
                    # promptly, mirror nothing.
                    wire.send_msg(sock, lock,
                                  {"op": "repl_pong", "feed": feed_id})
                    continue
                last_seq = None
                for item in msg.get("items", ()):
                    if item["kind"] == "snap":
                        wal = self._mirror_snapshot(item["data"], wal)
                        self.synced.set()
                    else:
                        if wal is None:
                            wal = open(self._wal_path, "a",
                                       encoding="utf-8")
                        wal.write(json.dumps(
                            item["data"], separators=(",", ":")) + "\n")
                        wal.flush()
                    if item.get("seq") is not None:
                        last_seq = item["seq"]
                if last_seq is not None:
                    if self._fsync and wal is not None:
                        # The ack asserts durability; in fsync
                        # deployments flush-to-page-cache isn't it.
                        os.fsync(wal.fileno())
                    # Everything through last_seq is durable in the
                    # mirror: acknowledge so the primary's sync-put
                    # barrier (state.wait_replicated) can release.
                    wire.send_msg(sock, lock,
                                  {"op": "repl_ack", "seq": last_seq,
                                   "feed": feed_id})
        finally:
            self._sock = None
            if wal is not None:
                wal.close()
            try:
                sock.close()
            except OSError:
                pass

    @property
    def _wal_path(self) -> str:
        return os.path.join(self.data_dir, "coord.wal")

    def _mirror_snapshot(self, snap: dict, wal):
        """Replace the mirror: truncate the WAL (stamping the
        snapshot's generation header) BEFORE replacing the snapshot. A
        crash between the two leaves the OLD snapshot with a
        new-generation empty WAL — replay skips the mismatched WAL and
        recovers the stale-but-consistent old snapshot; the follower
        re-syncs from a fresh snapshot on its next connect anyway. The
        reverse order (new snap + old records) would re-apply folded
        records and diverge on replay."""
        if wal is not None:
            wal.close()
        gen = snap.get("wal_gen", 0)
        wal = open(self._wal_path, "w", encoding="utf-8")
        wal.write(json.dumps({"o": "hdr", "gen": gen},
                             separators=(",", ":")) + "\n")
        wal.flush()
        if self._fsync:
            os.fsync(wal.fileno())
        tmp = os.path.join(self.data_dir, "coord.snap.tmp")
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(snap, f)
            if self._fsync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self.data_dir, "coord.snap"))
        if self._fsync:
            # The rename itself lives in the directory entry; without
            # this the mirrored snapshot can vanish on power loss.
            fsync_dir(self.data_dir)
        return wal

    @property
    def closed(self) -> bool:
        return self._closed.is_set()

    def close(self) -> bool:
        """Stop mirroring. Returns True when the follower thread has
        actually exited — promotion must not serve over this data_dir
        while a parked reader could still wake up and truncate it."""
        self._closed.set()
        sock = self._sock
        if sock is not None:
            try:
                # shutdown() interrupts a thread parked in recv(2);
                # close() alone does not.
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
        self._thread.join(timeout=5)
        return not self._thread.is_alive()


class Standby:
    """Monitor ``primary_address``; take over on ``listen_address``.

    ``data_dir`` must be the primary's coordination data dir (the seed
    passes ``<platform.data_dir>/coord`` — cluster.py). Promotion is
    observable via :attr:`promoted` (a ``threading.Event``) and
    :attr:`server` (the live :class:`CoordServer` after takeover).
    """

    def __init__(self, primary_address: str, listen_address: str,
                 data_dir: str, check_interval: float = 1.0,
                 failure_threshold: int = 3,
                 probe_timeout: float = 2.0,
                 replicate: bool = False,
                 register: bool = True,
                 succession_grace: float = 10.0,
                 fsync: bool = False,
                 witness_addr: str | None = None,
                 witness_ttl: float = 3.0):
        self.primary_address = primary_address
        self.listen_address = listen_address
        self.data_dir = data_dir
        self.check_interval = check_interval
        self.failure_threshold = failure_threshold
        self.probe_timeout = probe_timeout
        self.promoted = threading.Event()
        self.server: CoordServer | None = None
        self._closed = threading.Event()
        # Learner lifecycle (ref: memberAdd-as-learner → catch up →
        # MemberPromote, cluster.go:120-147, 183-195): the standby
        # joins the primary's membership as a learner, and is promoted
        # to a promote-eligible member only once its mirror caught up —
        # making "which standbys can take over right now" observable
        # through member_list, and letting clients' endpoint discovery
        # pick up standbys attached at runtime.
        self._register = register
        self.member_id: int | None = None
        self._member_promoted = False
        self._admin = None  # lazy RemoteCoord to the primary
        #: Promote-eligible peer standbys [(member_id, addr), ...],
        #: cached from the live primary's membership each probe round.
        #: On primary death this is the succession list: the LOWEST
        #: member id (most senior attach) promotes; juniors defer,
        #: adopt the winner as their new primary, and keep guarding —
        #: deterministic election without a quorum tier (the raft-
        #: election analog; ref cluster.go:120-147).
        self._peer_standbys: list[tuple[int, str]] = []
        self._defer_deadline: float | None = None
        #: Per-senior grace window (seconds) before a junior stops
        #: waiting for an unresponsive senior and promotes itself;
        #: floored at 2 full detection periods.
        self.succession_grace = succession_grace
        #: WAL durability mode for the server this standby starts at
        #: promotion (match the primary's ``wal_fsync`` setting).
        self._fsync = fsync
        #: Witness (coord/witness.py): promotion additionally requires
        #: acquiring the witness lease — the second vote of the
        #: {primary, standby, witness} majority. Without it a standby
        #: partitioned AWAY from a healthy primary could promote and
        #: split the brain for clients that can reach only one side.
        self._witness_addr = witness_addr
        self._witness_ttl = witness_ttl
        # replicate=True: ``data_dir`` is LOCAL and a WalFollower
        # mirrors the primary's WAL into it over TCP — the cross-host
        # deployment. False: ``data_dir`` IS the primary's (shared
        # filesystem), and the WAL-dir flock doubles as the
        # split-brain fence.
        self._replicate = replicate
        self.follower: WalFollower | None = None
        self._thread: threading.Thread | None = None
        self._start_guarding()  # creates the follower in wal-stream mode
        log.info("standby watching primary",
                 kv={"primary": primary_address,
                     "standby": listen_address,
                     "mode": "wal-stream" if replicate else "shared-dir"})

    def _ensure_follower(self) -> None:
        """wal-stream mode: make sure a LIVE follower is mirroring —
        replaces one closed by a failed/deferred promotion attempt
        (guarding with a frozen mirror would promote stale state on
        the next primary death)."""
        if not self._replicate:
            return
        if self.follower is not None and not self.follower.closed:
            return
        if self.follower is not None and not self.follower.close():
            # The old reader thread hasn't exited: a replacement would
            # make TWO writers on one mirror (the zombie can wake and
            # truncate coord.wal mid-write). Retry on the next probe
            # round instead.
            log.warning("follower re-arm deferred: old reader thread "
                        "still live")
            return
        self.follower = WalFollower(self.primary_address, self.data_dir,
                                    fsync=self._fsync)

    def _start_guarding(self) -> None:
        """(Re)arm everything a guarding standby needs: the probe
        monitor, and in wal-stream mode a live follower. Called at
        construction and after every failed promotion path — partial
        re-arms (monitor without follower) would leave the standby
        silently guarding with a frozen mirror."""
        self._ensure_follower()
        self._closed.clear()
        self._thread = threading.Thread(
            target=self._monitor, name="coord-standby", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------ probes

    def _probe(self, address: str | None = None) -> bool:
        """One liveness probe: full request/response, not just a TCP
        accept — a wedged primary that accepts but never answers is
        dead for clients and must fail the probe too."""
        host, _, port = (address or self.primary_address).rpartition(":")
        try:
            sock = socket.create_connection(
                (host, int(port)), timeout=self.probe_timeout)
        except OSError:
            return False
        try:
            sock.settimeout(self.probe_timeout)
            wire.send_msg(sock, threading.Lock(),
                          {"op": "member_list", "id": 1})
            wire.recv_msg(sock)
            return True
        except (wire.WireError, OSError):
            return False
        finally:
            try:
                sock.close()
            except OSError:
                pass

    @property
    def promote_eligible(self) -> bool:
        """True when promotion would recover full cluster state: always
        in shared-dir mode (the data_dir IS the primary's), and once
        the WAL mirror has received its first snapshot in wal-stream
        mode. The learner→member transition in the primary's
        membership mirrors this flag."""
        if self.promoted.is_set():
            return True
        if self.follower is not None:
            return self.follower.synced.is_set()
        return not self._replicate

    def _sync_membership(self) -> None:
        """Keep the standby's learner/member record on the (live)
        primary current. Called from the monitor after each successful
        probe; every step is retried on the next round on failure."""
        if not self._register:
            return
        from ptype_tpu_torch.coord.remote import RemoteCoord
        from ptype_tpu_torch.errors import CoordinationError

        try:
            if self._admin is not None and self._admin.closed:
                # The client gave up for good during a primary outage
                # that outlasted its reconnect window — it can never
                # serve another call; rebuild now that probes succeed.
                self._close_admin()
            if self._admin is None:
                self._admin = RemoteCoord(
                    [self.primary_address], dial_timeout=2.0,
                    request_timeout=5.0, reconnect_timeout=5.0)
            if self.member_id is None:
                # A previous incarnation of this standby (same address)
                # may still be registered: replace it, don't accumulate.
                for m in self._admin.member_list():
                    md = m.metadata or {}
                    if (md.get("role") == "standby"
                            and m.peer_addr == self.listen_address):
                        self._admin.member_remove(m.id)
                member = self._admin.member_add(
                    f"standby:{self.listen_address}", self.listen_address,
                    metadata={"role": "standby", "learner": True,
                              "mode": ("wal-stream" if self._replicate
                                       else "shared-dir")})
                self.member_id = member.id
                log.info("standby joined membership as learner",
                         kv={"member": member.id,
                             "addr": self.listen_address})
            if not self._member_promoted and self.promote_eligible:
                try:
                    self._admin.member_promote(self.member_id)
                except CoordinationError as e:
                    if "not found" in str(e):
                        # Our record was removed out from under us
                        # (operator cleanup, or a same-address dedup):
                        # forget the stale id so the next round
                        # re-registers instead of retrying it forever.
                        self.member_id = None
                    raise
                self._member_promoted = True
                log.info("standby promoted to member: mirror caught up",
                         kv={"member": self.member_id})
            # Refresh the succession list while the primary can still
            # tell us — it is read AFTER the primary dies.
            self._peer_standbys = [
                (m.id, m.peer_addr) for m in self._admin.member_list()
                if (m.metadata or {}).get("role") == "standby"
                and (m.metadata or {}).get("learner") is False
                and m.peer_addr != self.listen_address]
        except CoordinationError as e:
            log.debug("standby membership sync failed; retrying",
                      kv={"err": str(e)})

    def _close_admin(self) -> None:
        if self._admin is not None:
            self._admin.close()
            self._admin = None

    def _monitor(self) -> None:
        failures = 0
        while not self._closed.is_set():
            if self._probe():
                failures = 0
                self._defer_deadline = None
                # The primary is back after a failed/deferred promotion
                # attempt that closed the follower: resume mirroring.
                self._ensure_follower()
                self._sync_membership()
            else:
                failures += 1
                log.debug("primary probe failed",
                          kv={"n": failures,
                              "threshold": self.failure_threshold})
                if failures >= self.failure_threshold:
                    verdict = self._defer_to_senior()
                    if verdict == "adopted":
                        # Fresh primary: it must fail threshold
                        # CONSECUTIVE probes of its own before we act
                        # on it (a single slow post-takeover probe is
                        # not a death).
                        failures = 0
                    elif verdict == "defer":
                        pass
                    elif self._promote():
                        return
                    # Promotion refused (WAL fence held by a live
                    # primary) or failed (port busy): keep monitoring
                    # and retry — a dying monitor thread would leave
                    # the cluster with no failover coverage at all.
            self._closed.wait(self.check_interval)

    # ------------------------------------------------------- succession

    def _seniors(self) -> list[tuple[int, str]]:
        """Promote-eligible peer standbys senior to us (lower member
        id = earlier attach), in succession order. The current primary
        is excluded defensively — a stale cache entry for it must not
        make us "re-adopt" our own primary."""
        peers = [(mid, a) for mid, a in self._peer_standbys
                 if a != self.primary_address]
        if self.member_id is None:
            # We never registered: every known eligible peer outranks
            # us — promoting over their heads would split the brain.
            return sorted(peers)
        return sorted((mid, a) for mid, a in peers
                      if mid < self.member_id)

    def _defer_to_senior(self) -> str | None:
        """Succession arbitration for MULTIPLE standbys on one primary
        (reachable since standbys attach dynamically): only the most
        senior eligible standby promotes; juniors defer — and when the
        winner starts serving, they ADOPT it as their new primary and
        keep guarding (the self-healing chain). Returns "adopted" when
        a promoted senior became our new primary, "defer" while inside
        a senior's grace window, and None when this standby should
        promote."""
        seniors = self._seniors()
        if not seniors:
            self._defer_deadline = None
            return None
        for _, addr in seniors:
            if self._probe(addr):
                self._adopt_primary(addr)
                return "adopted"
        # No senior is serving yet. Give each of them a staggered
        # grace window to come up before assuming they died with the
        # primary and promoting anyway — deterministic, no
        # coordination needed. The window floor is generous (a
        # senior's promotion replays its whole mirror, which can take
        # tens of seconds at scale) — and even if we DO promote while
        # a slow senior is mid-replay, our rank-based term bump
        # (_promote) lands us on a strictly higher term, so clients
        # fence whichever of us is superseded rather than splitting.
        import time as _time

        if self._defer_deadline is None:
            grace = max(
                self.succession_grace,
                2 * self.failure_threshold * self.check_interval)
            self._defer_deadline = (_time.monotonic()
                                    + len(seniors) * grace)
            log.info("standby deferring to senior peers",
                     kv={"seniors": [a for _, a in seniors],
                         "window_s": round(len(seniors) * grace, 1)})
        if _time.monotonic() < self._defer_deadline:
            return "defer"
        # Window expired: promote. Deliberately NOT clearing the
        # deadline — a transiently failed promotion must retry next
        # round, not re-arm a fresh multi-second window with nobody
        # serving. (It clears on probe success or adoption.)
        log.warning("senior standbys never took over; promoting",
                    kv={"seniors": [a for _, a in seniors]})
        return None

    def _adopt_primary(self, addr: str) -> None:
        """A senior peer has promoted: re-point at it and keep
        guarding — the standby chain re-forms without an operator."""
        log.info("adopting promoted peer as new primary",
                 kv={"old": self.primary_address, "new": addr})
        self.primary_address = addr
        self._defer_deadline = None
        self._close_admin()  # rebuilt against the new primary
        # Our member record rode the WAL mirror into the winner's
        # state, so member_id/_member_promoted stay valid.
        if self.follower is not None and self.follower.close():
            self.follower = None
        # A reader thread that refused to die leaves self.follower set
        # (closed, thread live): _ensure_follower's re-arm deferral
        # machinery retries on later rounds rather than risking two
        # writers on one mirror.
        self._ensure_follower()

    def _mirror_term(self) -> int:
        """Fencing term recorded in the mirrored snapshot (the
        primary's current term — terms only change at promotions,
        which always write a snapshot). 0 when unreadable."""
        try:
            with open(os.path.join(self.data_dir, "coord.snap"),
                      encoding="utf-8") as f:
                return int(json.load(f).get("term", 0))
        except (OSError, ValueError):
            return 0

    def _acquire_witness(self) -> bool:
        """Take the witness lease for the about-to-promote server (its
        bumped term). Grant = we are the majority side; refusal or an
        unreachable witness = no majority, DON'T promote: a healthy
        primary may be serving clients we cannot see."""
        if self._witness_addr is None:
            return True
        from ptype_tpu_torch.coord import witness as _witness

        new_term = self._mirror_term() + 1 + len(self._seniors())
        try:
            reply = _witness.acquire(
                self._witness_addr, candidate=self.listen_address,
                term=new_term, timeout=max(1.0, self._witness_ttl))
        except (wire.WireError, OSError) as e:
            log.warning(
                "standby refusing promotion: witness unreachable "
                "(no majority)", kv={"err": str(e)})
            return False
        if not reply.get("granted"):
            log.warning(
                "standby refusing promotion: witness lease refused — "
                "the primary (or a peer) still holds it",
                kv={"holder": reply.get("holder"),
                    "term": reply.get("term"),
                    "reason": reply.get("reason")})
            return False
        return True

    def _promote(self) -> bool:
        if self._closed.is_set():
            return True
        if self.follower is not None and not self.follower.synced.is_set():
            # The mirror never received a snapshot (primary died inside
            # the first connect window, or was never reachable from
            # this host): promoting would serve EMPTY cluster state —
            # silently wiping the control plane. Refuse and keep
            # probing; an operator can still force it via promote().
            # Checked BEFORE the witness acquire: this standby is not
            # going to promote, so it must not consume the lease/term —
            # a lease taken here would brand a later-returning primary
            # "superseded" by a successor that never serves, turning a
            # recoverable outage into a permanently fenced cluster.
            log.warning("standby refusing auto-promotion: WAL mirror "
                        "never synced", kv={"primary":
                                            self.primary_address})
            return False
        if not self._acquire_witness():
            # Keep guarding; the witness grants once the primary's
            # lease truly lapses (it is still renewing = still alive).
            return False
        log.info("promoting standby: primary declared dead",
                 kv={"primary": self.primary_address,
                     "standby": self.listen_address})
        if self.follower is not None:
            # Stop mirroring before serving over the mirror: the
            # follower's reconnect loop re-truncating coord.wal under
            # a live CoordState would corrupt the new primary.
            if not self.follower.close():
                # A reader refusing to die (wedged primary holding the
                # TCP stream mid-push) could wake and truncate the
                # mirror under the promoted server — retry next probe
                # round instead of serving over contested files.
                log.warning("standby promotion deferred: follower "
                            "thread still live")
                return False
            self.follower = None
        try:
            # The WAL-dir flock (coord/core.py) is the shared-dir
            # fence: if the primary is wedged-but-alive and still holds
            # it, this raises instead of double-writing the WAL — probes
            # keep running and promotion retries once the primary truly
            # dies. bump_term marks this server the successor so
            # clients refuse any stale primary (the wal-stream fence);
            # a junior promoting past unresponsive seniors skips their
            # term slots so a slow senior finishing its own promotion
            # later can never land on the same term.
            self.server = CoordServer(self.listen_address,
                                      data_dir=self.data_dir,
                                      bump_term=1 + len(self._seniors()),
                                      fsync=self._fsync,
                                      witness_addr=self._witness_addr,
                                      witness_ttl=self._witness_ttl,
                                      witness_holder=self.listen_address)
        except Exception as e:  # noqa: BLE001 — retried by the monitor
            log.warning("standby promotion failed; will retry",
                        kv={"err": str(e)})
            # Resume mirroring (wal-stream): the primary may come back
            # (no takeover happened) and a monitor guarding a frozen
            # mirror would promote stale state on the NEXT death.
            self._ensure_follower()
            return False
        self.promoted.set()
        chaos.note_ok("coord.failover", self.listen_address)
        self._close_admin()  # it pointed at the dead primary
        self._retire_own_member_record()
        return True

    # ------------------------------------------------------------- admin

    def promote(self, timeout: float = 30.0,
                force: bool = False) -> "CoordServer":
        """Operator-triggered switchover — the analog of the reference's
        learner PROMOTE (cluster.go:183-195): stop monitoring, wait for
        the primary to release the WAL fence (shut it down first), and
        serve. Returns the live server; raises on fence timeout.
        ``force=True`` overrides the never-synced-mirror refusal (for
        deliberately bootstrapping an empty control plane)."""
        import time as _time

        if self.promoted.is_set() and self.server is not None:
            return self.server  # idempotent: already serving
        self._closed.set()  # stop the monitor; we promote deliberately
        self._thread.join(timeout=5)
        if self._thread.is_alive():
            # The monitor is MID-automatic-promotion (CoordServer
            # construction can replay a large WAL); racing it would
            # spin against our own server's flock and misdiagnose as
            # "primary still alive". Wait for its outcome — but a
            # monitor whose attempt FAILS exits cleanly (it saw
            # _closed) without promoting: fall through to the
            # deliberate promotion below rather than misdiagnosing a
            # healthy standby as wedged.
            deadline = _time.monotonic() + timeout
            while (self._thread.is_alive()
                   and _time.monotonic() < deadline):
                if self.promoted.wait(timeout=0.2):
                    break
            if self._thread.is_alive() and not self.promoted.is_set():
                raise RuntimeError(
                    "promote: standby monitor wedged mid-promotion — "
                    "inspect the coordinator data_dir before retrying")
        # The monitor may have completed an AUTOMATIC promotion while we
        # were joining/waiting on it.
        if self.promoted.is_set() and self.server is not None:
            return self.server
        if self.follower is not None:
            if not force and not self.follower.synced.is_set():
                # Same refusal as auto-promotion: a mirror that never
                # received a snapshot holds NOTHING — serving it would
                # silently wipe the control plane.
                self._start_guarding()
                raise RuntimeError(
                    "promote: WAL mirror never synced — promoting would "
                    "serve an empty control plane (force=True overrides)")
            # Cross-host mode has no flock fence to refuse a split
            # brain — the probe is the only guard. Refuse while the
            # primary still answers, and keep guarding.
            if self._probe():
                self._start_guarding()
                raise RuntimeError(
                    "promote: primary is still alive — shut it down "
                    "first (wal-stream mode has no fence)")
            if not self.follower.close():
                self._start_guarding()
                raise RuntimeError(
                    "promote: follower reader thread still live — a "
                    "late wake-up would truncate the mirror under the "
                    "promoted server; retry once it exits")
            self.follower = None
        deadline = _time.monotonic() + timeout
        # Deliberate switchover still takes the witness vote (unless
        # forced): the lease frees one TTL after the primary was shut
        # down, so retry within the operator's timeout.
        if self._witness_addr is not None and not force:
            witness_bo = retry.Backoff(
                base=min(1.0, self._witness_ttl / 2), cap=1.0)
            while not self._acquire_witness():
                if _time.monotonic() > deadline:
                    self._start_guarding()
                    raise RuntimeError(
                        "promote: witness lease not acquired — the "
                        "primary still holds it (shut it down and let "
                        "its TTL lapse) or the witness is unreachable "
                        "(force=True overrides)")
                witness_bo.sleep()
        start_bo = retry.Backoff(base=0.2, cap=1.0)
        while True:
            try:
                self.server = CoordServer(
                    self.listen_address, data_dir=self.data_dir,
                    bump_term=1 + len(self._seniors()),
                    fsync=self._fsync,
                    witness_addr=self._witness_addr,
                    witness_ttl=self._witness_ttl,
                    witness_holder=self.listen_address)
                break
            except Exception as e:  # noqa: BLE001 — fence / transient
                if _time.monotonic() > deadline:
                    # Re-arm automatic failover (monitor + follower)
                    # before surfacing the error: a caller that
                    # catches it expects the standby to keep guarding
                    # the (still-live) primary.
                    self._start_guarding()
                    if self._replicate:
                        # wal-stream: the mirror dir is LOCAL — no
                        # flock contention with the primary is
                        # possible, so the failure is this host's own
                        # (port bind, replay error). Say so; "primary
                        # holds the fence" would send the operator to
                        # the wrong host.
                        raise RuntimeError(
                            f"promote: standby server failed to start "
                            f"after {timeout}s (wal-stream mode; local "
                            f"cause — last error: {e})"
                        ) from e
                    raise RuntimeError(
                        f"promote: primary still holds the WAL fence "
                        f"after {timeout}s — shut it down first "
                        f"(last error: {e})"
                    ) from e
                start_bo.sleep()
        self.promoted.set()
        chaos.note_ok("coord.failover", self.listen_address)
        self._close_admin()  # it pointed at the superseded primary
        self._retire_own_member_record()
        log.info("standby promoted by operator",
                 kv={"standby": self.listen_address})
        return self.server

    def _retire_own_member_record(self) -> None:
        """We are the primary now: drop our own role=standby member
        record from OUR state (it rode the mirror in). Leaving it
        would poison peers' succession lists with the current primary
        posing as an eligible standby — every later failover would
        burn a grace window probing it (or worse, 're-adopt' it)."""
        if self.member_id is None or self.server is None:
            return
        try:
            self.server.state.member_remove(self.member_id)
        except Exception as e:  # noqa: BLE001 — cosmetic cleanup
            log.debug("could not retire own standby member record",
                      kv={"err": str(e)})
        self.member_id = None
        self._member_promoted = False

    def close(self) -> None:
        """Stop monitoring; shut the promoted server down if any.
        Deregisters from the (live) primary's membership — a detached
        standby must not look promote-eligible to endpoint discovery."""
        self._closed.set()
        self._thread.join(timeout=5)
        if self._admin is not None and self.member_id is not None:
            from ptype_tpu_torch.errors import CoordinationError

            try:
                self._admin.member_remove(self.member_id)
            except CoordinationError:
                pass  # best-effort: primary may already be gone
        self._close_admin()
        if self.follower is not None:
            self.follower.close()
            self.follower = None
        if self.server is not None:
            self.server.close()
