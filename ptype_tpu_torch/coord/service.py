"""TCP coordination service — hosted by the seed node; the port's copy
of ``ptype_tpu/coord/service.py``, with the same protocol, so either
package's clients dial it.

The multi-process deployment model: the coordinator process (platform config
``is_coordinator: true``) starts a :class:`CoordServer` over its
:class:`CoordState`; every process (including the coordinator itself)
connects with :class:`ptype_tpu_torch.coord.remote.RemoteCoord` or, on the
coordinator, may use :class:`LocalCoord` directly. This mirrors how the JAX
distributed coordination service is deployed (process 0 hosts), replacing
the reference's every-process-embeds-etcd model (cluster.go:161-196).

The WAL ``data_dir``, the ``sync`` put's replication feeds and the
quorum self-fence are copied whole. Given a ``witness_addr``, the server
renews its lease at the witness (``coord/witness.py``) and self-fences
when it holds neither that lease nor a live follower round trip.
"""

from __future__ import annotations

import socket
import threading
import time

from ptype_tpu_torch import chaos, logs, retry, trace
from ptype_tpu_torch.coord import wire
from ptype_tpu_torch.coord.core import CoordState, RangeOptions, Watch

log = logs.get_logger("coord.service")


def _item_wire(it) -> dict:
    return {
        "key": it.key,
        "value": it.value,
        "create_rev": it.create_rev,
        "mod_rev": it.mod_rev,
        "version": it.version,
        "lease": it.lease,
    }


def _member_wire(m) -> dict:
    return {
        "id": m.id,
        "name": m.name,
        "peer_addr": m.peer_addr,
        "metadata": m.metadata,
    }


def _repl_idle_tick(witness_ttl: float) -> float:
    """Idle-heartbeat period for the repl pump, derived from the
    configured TTL. The follower's repl_pong round-trip is the liveness
    proof the quorum loop counts as the standby's vote — with the old
    fixed 1.0 s tick, any ``witness_ttl`` ≲ 1 s starved a quiet
    cluster's follower of heartbeats within the TTL window and flapped
    its vote. Three ticks per TTL matches the quorum loop's own cadence
    (``_quorum_loop``); 1.0 s stays the ceiling so big TTLs don't slow
    feed-close detection."""
    return min(1.0, witness_ttl / 3)


class CoordServer:
    """Serves a CoordState over TCP. One instance per cluster seed."""

    def __init__(self, address: str = "127.0.0.1:0",
                 state: CoordState | None = None,
                 data_dir: str | None = None,
                 bump_term: bool | int = False,
                 fsync: bool = False,
                 witness_addr: str | None = None,
                 witness_ttl: float = 3.0,
                 witness_holder: str | None = None):
        # bump_term marks this server a PROMOTED successor: the
        # recovered state's fencing term is incremented (by that many
        # slots — juniors promoting past unresponsive seniors skip
        # their slots) so clients that adopt it refuse any superseded
        # primary (coord/standby).
        self.state = state or CoordState(data_dir=data_dir,
                                         bump_term=bump_term,
                                         fsync=fsync)
        self._owns_state = state is None
        host, _, port = address.rpartition(":")
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            # Bind retries: a restarting seed can race its own clients'
            # reconnect loops — a loopback dial to the (momentarily
            # free) port can TCP-self-connect and squat it as the
            # dialer's ephemeral port for an instant. SO_REUSEADDR
            # doesn't cover an ACTIVE squatter; a short retry does.
            bind_bo = retry.Backoff(base=0.1, cap=0.2)
            for attempt in range(50):
                try:
                    self._sock.bind((host or "127.0.0.1", int(port)))
                    break
                except OSError:
                    if attempt == 49:
                        raise
                    bind_bo.sleep()
            self._sock.listen(128)
        except OSError:
            # A leaked CoordState would hold the WAL-dir flock forever
            # (its sweeper thread pins it against GC), wedging every
            # future promotion in this process — release it.
            self._sock.close()
            if self._owns_state:
                self.state.close()
            raise
        self.address = f"{self._sock.getsockname()[0]}:{self._sock.getsockname()[1]}"
        self._closed = threading.Event()
        self._conns: set[socket.socket] = set()
        self._conns_lock = threading.Lock()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="coordd-accept", daemon=True
        )
        self._accept_thread.start()
        # Quorum self-fencing (coord/witness.py): with a witness
        # configured, this primary serves only while it holds a second
        # vote of the {primary, standby, witness} majority — a witness
        # lease renewal OR a live follower heartbeat round-trip within
        # the TTL. The minority side of a partition therefore refuses
        # its clients instead of serving possibly-superseded state
        # (raft partition behavior, ref cluster_test.go:47-167).
        self._witness_addr = witness_addr
        self._witness_ttl = witness_ttl
        #: The identity renewals run under. A promoted standby MUST
        #: pass the exact string it acquired the lease with (its
        #: configured listen address) — the getsockname-derived
        #: self.address can differ ('0.0.0.0' binds, hostnames), and a
        #: mismatched renewal would read as a different holder and
        #: hard-fence the fresh primary within one TTL.
        self._witness_holder = witness_holder or self.address
        #: Monotonic deadline until which this server may serve. One
        #: boot-time TTL of grace so a seed can start while the
        #: witness is briefly unreachable.
        self._quorum_until = time.monotonic() + witness_ttl
        #: Set when the witness refused renewal with a STRICTLY higher
        #: term: permanent — a promoted successor exists, so this
        #: server must never serve again. Same-term refusals are
        #: retriable (see _quorum_round) and counted here instead.
        self._superseded = None  # (holder, term) | None
        self._refusals = 0
        if witness_addr is not None:
            # The seed's co-located application talks to this state
            # IN-PROCESS (LocalCoord) — hook the fence into the state
            # itself so those callers are refused exactly like remote
            # clients when quorum is lost.
            self.state.fence = self._fenced
            threading.Thread(target=self._quorum_loop,
                             name="coordd-quorum", daemon=True).start()
        log.info("coordination service listening", kv={"addr": self.address})

    # ------------------------------------------------------------- quorum

    def _quorum_round(self) -> None:
        """One vote-collection round. Each vote extends the serving
        deadline only as far as the EVIDENCE behind it reaches:

        - the witness vote stamps ``t0 + ttl`` with ``t0`` taken BEFORE
          the renewal RPC, so the self-fence always fires at or before
          the moment the witness could hand the lease away;
        - the follower vote stamps ``last_round_trip + ttl`` — the
          follower's actual last contact, NOT "now". Granting a fresh
          full TTL against an almost-TTL-old heartbeat let a primary
          serve up to ~2×TTL after its last real round-trip, inside
          which a partitioned-away standby holding the (vacant) witness
          lease could already be serving — the ADVICE.md self-fence
          window. Anchored, the primary's window always ends within one
          TTL of evidence a majority peer could corroborate.

        The deadline never moves backwards: an older-evidence vote must
        not shrink a window a better vote already granted.
        """
        from ptype_tpu_torch.coord import witness as _witness

        t0 = time.monotonic()
        grant_until = None
        try:
            reply = _witness.renew(
                self._witness_addr, holder=self._witness_holder,
                term=self.state.term,
                timeout=max(0.3, self._witness_ttl / 3))
            if reply.get("granted"):
                grant_until = t0 + self._witness_ttl
                self._refusals = 0
            else:
                r_term = reply.get("term")
                if r_term is not None and r_term <= self.state.term:
                    # Refusal WITHOUT a successor term: a holder-string
                    # mismatch (restart under a different address, a
                    # witness that lost state) — retriable, not proof a
                    # successor exists. Deny the vote; the next round
                    # retries one TTL-third later. Permanent fencing is
                    # reserved for a strictly higher term below.
                    self._refusals += 1
                    if self._refusals == 1 or self._refusals % 10 == 0:
                        log.warning(
                            "witness refused renewal at same term; "
                            "retrying (holder mismatch, not a "
                            "successor)",
                            kv={"holder": reply.get("holder"),
                                "term": r_term,
                                "refusals": self._refusals})
                else:
                    self._superseded = (reply.get("holder"), r_term)
                    log.warning(
                        "witness refused lease renewal: superseded — "
                        "hard-fencing this coordinator",
                        kv={"holder": reply.get("holder"),
                            "term": r_term})
                    return
        except (wire.WireError, OSError):
            pass  # witness unreachable: no vote, not a refusal
        hb = self.state.last_follower_contact(within=self._witness_ttl)
        if hb is not None:
            follower_until = hb + self._witness_ttl
            if grant_until is None or follower_until > grant_until:
                grant_until = follower_until
        if grant_until is not None:  # plus our own vote = majority of 3
            self._quorum_until = max(self._quorum_until, grant_until)

    def _quorum_loop(self) -> None:
        interval = self._witness_ttl / 3
        while not self._closed.wait(interval):
            self._quorum_round()
            if self._superseded is not None:
                return

    def _fenced(self) -> str | None:
        """Non-None (the refusal message) when this server must not
        serve: it lost the majority vote or was outright superseded."""
        if self._witness_addr is None:
            return None
        if self._superseded is not None:
            holder, term = self._superseded
            return (f"fenced: superseded by {holder} (term {term}); "
                    f"this coordinator will never serve again")
        if time.monotonic() > self._quorum_until:
            return ("fenced: lost quorum (no witness lease and no "
                    "live follower) — likely the minority side of a "
                    "partition; refusing to serve possibly-stale state")
        return None

    def _accept_loop(self) -> None:
        while not self._closed.is_set():
            try:
                conn, peer = self._sock.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._conns_lock:
                self._conns.add(conn)
            threading.Thread(
                target=self._serve_conn,
                args=(conn, peer),
                name=f"coordd-conn-{peer[1]}",
                daemon=True,
            ).start()

    def _serve_conn(self, conn: socket.socket, peer) -> None:
        send_lock = threading.Lock()
        watches: dict[int, Watch] = {}
        # Repl feeds ride the same per-connection registry so a dropped
        # follower connection cancels its subscription — otherwise the
        # primary would append every future mutation to an orphaned
        # in-memory feed forever.
        feeds: dict[int, object] = {}
        watches_lock = threading.Lock()
        try:
            while not self._closed.is_set():
                try:
                    msg = wire.recv_msg(conn)
                except (wire.WireError, OSError):
                    return
                if msg.get("op") == "repl_ack":
                    # Unsolicited fire-and-forget from a WAL follower:
                    # record the mirrored-through sequence (wakes
                    # sync-put waiters). Routed by feed id — the
                    # protocol permits several repl_subscribe feeds per
                    # connection, and crediting them all would let one
                    # feed's acks falsely release barriers for records
                    # a slower sibling never mirrored. No reply, no
                    # handler thread.
                    fid = msg.get("feed")
                    with watches_lock:
                        if fid is not None:
                            acked_feeds = ([feeds[fid]]
                                           if fid in feeds else [])
                        else:  # legacy follower: sole-feed conns only
                            acked_feeds = list(feeds.values())
                    for feed in acked_feeds:
                        self.state.note_repl_ack(feed, int(msg["seq"]))
                    continue
                if msg.get("op") == "repl_pong":
                    # Heartbeat round-trip from a follower: proof of
                    # LIVE two-way contact (a half-dead TCP connection
                    # can't produce one), counted as the standby's
                    # vote in the witness quorum (_quorum_round).
                    fid = msg.get("feed")
                    with watches_lock:
                        feed = feeds.get(fid)
                    if feed is not None:
                        self.state.note_repl_hb(feed)
                    continue
                # Blocking ops (barrier, watch pumps) must not stall the
                # reader; dispatch every request to its own thread — control
                # plane volume is low enough that this is simpler and safer
                # than a pool.
                threading.Thread(
                    target=self._handle,
                    args=(conn, send_lock, watches, feeds, watches_lock,
                          msg),
                    daemon=True,
                ).start()
        finally:
            with watches_lock:
                for w in watches.values():
                    w.cancel()
                for feed in feeds.values():
                    feed.cancel()
            with self._conns_lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _handle(self, conn, send_lock, watches, feeds, watches_lock,
                msg: dict) -> None:
        req_id = msg.get("id")
        op = msg.get("op", "")
        # Wire trace context (coord/wire.py injects "_tp"): popped
        # unconditionally so op handlers never see it; adopted around
        # the dispatch below so coordinator work joins the caller's
        # trace.
        tp = msg.pop("_tp", None)
        pump_watch: Watch | None = None
        pump_feed = None
        # Quorum fence BEFORE anything else: a minority-partition or
        # superseded primary must refuse every client — including ones
        # that never saw the successor's term (the hole the term fence
        # alone cannot close). stale=True makes clients bounce to the
        # other endpoints where the real primary lives.
        #
        # Exception: repl_subscribe passes a SOFT (quorum-lost) fence —
        # a returning follower's round-trips ARE the second vote, so
        # refusing the subscription would make the fence permanent even
        # with a healthy primary+standby pair (witness down + one
        # follower blip). A hard-superseded primary still refuses: a
        # successor exists and mirrors must re-home to it.
        fence = self._fenced()
        if (fence is not None and op == "repl_subscribe"
                and self._superseded is None):
            fence = None
        if fence is not None:
            try:
                wire.send_msg(conn, send_lock, {
                    "id": req_id, "ok": False, "stale": True,
                    "fenced": True, "term": self.state.term,
                    "error": fence})
            except (wire.WireError, OSError):
                pass
            return
        # Fencing check BEFORE any dispatch: a client that has seen a
        # newer primary (higher term) must get refused here — this
        # server is a superseded primary still running on stale state
        # (wal-stream failover has no shared flock; the client-carried
        # term is the fence, mirroring raft's leader epoch —
        # the reference cluster.go:120-147).
        min_term = msg.get("min_term", 0)
        my_term = self.state.term
        if min_term > my_term:
            try:
                wire.send_msg(conn, send_lock, {
                    "id": req_id, "ok": False, "stale": True,
                    "term": my_term,
                    "error": (f"stale coordinator: term {my_term} is "
                              f"behind client fence {min_term}")})
            except (wire.WireError, OSError):
                pass
            return
        try:
            if op == "watch":
                # The pump must not start until the create-reply is on the
                # wire: the client registers the watch id only after the
                # reply, and events sent before that would be dropped.
                # (Replay-from-start_rev events are queued IN the Watch
                # atomically with the arm, so they also flow after the
                # reply, in order.)
                pump_watch = self.state.watch(
                    msg["prefix"], start_rev=msg.get("start_rev", 0))
                with watches_lock:
                    watches[pump_watch.id] = pump_watch
                # arm_rev, NOT state.revision: a put can land between
                # the arm and this read — its event is queued in the
                # watch, and a floor above the arm revision would skip
                # it on a reconnect before the pump delivers.
                result = {"id": pump_watch.id,
                          "rev": pump_watch.arm_rev}
            elif op == "repl_subscribe":
                # Same ordering contract as watch: the snapshot that
                # heads the feed must not hit the wire before the
                # create-reply the follower is blocking on.
                pump_feed = self.state.repl_subscribe()
                with watches_lock:
                    feeds[pump_feed.id] = pump_feed
                result = pump_feed.id
            elif tp is not None and trace.enabled():
                # Request-scoped op carrying trace context: run it as a
                # child span of the caller's rpc/train span. Untraced
                # callers skip the span (no per-keepalive root-trace
                # noise in the flight recorder).
                with trace.attach(tp), trace.span(f"coord.{op}", op=op):
                    result = self._dispatch(conn, send_lock, watches,
                                            watches_lock, op, msg)
            else:
                result = self._dispatch(conn, send_lock, watches,
                                        watches_lock, op, msg)
            reply = {"id": req_id, "ok": True, "result": result,
                     "term": my_term}
        except Exception as e:  # noqa: BLE001 — remote surface must not die
            reply = {"id": req_id, "ok": False, "error": str(e),
                     "term": my_term}
        try:
            wire.send_msg(conn, send_lock, reply)
        except (wire.WireError, OSError):
            # The connection died under the reply: nothing will pump
            # these — cancel now rather than waiting for the reader
            # thread's cleanup to notice.
            if pump_watch is not None:
                pump_watch.cancel()
            if pump_feed is not None:
                pump_feed.cancel()
            return
        if pump_watch is not None:
            threading.Thread(
                target=self._pump_watch,
                args=(conn, send_lock, watches, watches_lock, pump_watch),
                name=f"coordd-watch-{pump_watch.id}",
                daemon=True,
            ).start()
        if pump_feed is not None:
            threading.Thread(
                target=self._pump_repl,
                args=(conn, send_lock, feeds, watches_lock, pump_feed),
                name=f"coordd-repl-{pump_feed.id}",
                daemon=True,
            ).start()

    def _dispatch(self, conn, send_lock, watches, watches_lock, op: str, msg: dict):
        st = self.state
        if op == "put":
            f = chaos.hit("coord.put", msg.get("key", ""))
            if f is not None and f.action == "kill_primary":
                # Die mid-write: the put IS applied (WAL flushed before
                # ack — same durability a SIGKILL after fs flush gives)
                # but no ack ever leaves and the whole server goes down
                # with it. Clients see a dead primary; a standby's
                # probes start failing from this instant.
                st.put(msg["key"], msg["value"], msg.get("lease", 0))
                threading.Thread(target=self.close,
                                 name="chaos-kill-primary",
                                 daemon=True).start()
                raise OSError("chaos: primary killed mid-write")
            rev = st.put(msg["key"], msg["value"], msg.get("lease", 0))
            if msg.get("sync"):
                # Synchronous replication (the raft-commit analog): ack
                # only after every WAL follower attached at the barrier
                # mirrored the write. Conservative: waits through the
                # current sequence, which includes this record.
                timeout = msg.get("sync_timeout")
                if not st.wait_replicated(
                        timeout=None if timeout is None
                        else float(timeout),
                        min_followers=int(
                            msg.get("sync_min_followers", 0))):
                    raise RuntimeError(
                        f"sync put {msg['key']!r}: replication not "
                        f"acknowledged in time (write IS applied on "
                        f"the primary; a failover before the mirror "
                        f"catches up may lose it)")
            return rev
        if op == "range":
            res = st.range(msg["key"], RangeOptions.from_wire(msg.get("options", {})))
            return {
                "items": [_item_wire(it) for it in res.items],
                "count": res.count,
                "revision": res.revision,
            }
        if op == "delete":
            return st.delete(msg["key"], RangeOptions.from_wire(msg.get("options", {})))
        if op == "grant":
            return st.grant(msg["ttl"])
        if op == "keepalive":
            return st.keepalive(msg["lease"])
        if op == "revoke":
            st.revoke(msg["lease"])
            return None
        if op == "watch_cancel":
            with watches_lock:
                w = watches.pop(msg["watch"], None)
            if w is not None:
                w.cancel()
            return None
        if op == "member_add":
            m = st.member_add(msg["name"], msg["peer_addr"], msg.get("metadata") or {})
            return _member_wire(m)
        if op == "member_promote":
            return _member_wire(st.member_promote(msg["member"]))
        if op == "member_remove":
            return st.member_remove(msg["member"])
        if op == "member_list":
            return [_member_wire(m) for m in st.member_list()]
        if op == "barrier":
            return st.barrier(msg["name"], msg["count"], msg.get("timeout"))
        if op == "ping":
            return "pong"
        raise ValueError(f"unknown op {op!r}")

    def _pump_watch(self, conn, send_lock, watches, watches_lock, w: Watch) -> None:
        while True:
            batch = w.get(timeout=1.0)
            if w.closed and not batch:
                return
            if not batch:
                continue
            push = {
                "watch": w.id,
                "events": [
                    {"type": ev.type.value, "key": ev.key, "value": ev.value,
                     "mod_rev": ev.mod_rev}
                    for ev in batch
                ],
            }
            try:
                wire.send_msg(conn, send_lock, push)
            except (wire.WireError, OSError):
                w.cancel()
                with watches_lock:
                    watches.pop(w.id, None)
                return

    def _pump_repl(self, conn, send_lock, feeds, watches_lock,
                   feed) -> None:
        """Stream a ReplFeed to a WAL follower. A follower that stops
        draining eventually backs TCP up; a send failure cancels the
        feed (it re-syncs from a fresh snapshot on reconnect). The idle
        tick is TTL-derived (:func:`_repl_idle_tick`) so small
        ``witness_ttl`` configs don't flap the follower vote."""
        tick = _repl_idle_tick(self._witness_ttl)
        while True:
            batch = feed.get(timeout=tick)
            if feed.closed and not batch:
                return
            if not batch:
                # Idle tick: heartbeat the follower. Its repl_pong
                # round-trip is the liveness proof the quorum loop
                # counts as the standby's vote — a quiet cluster must
                # not look like a partitioned one.
                try:
                    wire.send_msg(conn, send_lock,
                                  {"repl_hb": feed.id})
                except (wire.WireError, OSError):
                    feed.cancel()
                    with watches_lock:
                        feeds.pop(feed.id, None)
                    return
                continue
            push = {"repl": feed.id,
                    "items": [{"kind": k, "data": d, "seq": s}
                              for k, d, s in batch]}
            try:
                wire.send_msg(conn, send_lock, push)
            except (wire.WireError, OSError):
                feed.cancel()
                with watches_lock:
                    feeds.pop(feed.id, None)
                return

    def close(self) -> None:
        if self._closed.is_set():
            return
        self._closed.set()
        # shutdown() before close() throughout: accept/recv-parked
        # threads are not woken by close() alone and would linger as
        # wedged daemons (the chaos soak's thread-hygiene invariant).
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        self.state.close()
