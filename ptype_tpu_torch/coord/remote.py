"""TCP client for the coordination service — the port's copy of
``ptype_tpu/coord/remote.py``: it dials either package's
``CoordServer``."""

from __future__ import annotations

import atexit
import socket
import threading
import time

from ptype_tpu_torch import lockcheck
import weakref

from ptype_tpu_torch import chaos, logs, retry
from ptype_tpu_torch.coord import wire
from ptype_tpu_torch.coord.api import CoordBackend
from ptype_tpu_torch.coord.core import (
    Event,
    EventType,
    KVItem,
    Member,
    RangeOptions,
    RangeResult,
    Watch,
)
from ptype_tpu_torch.errors import CoordinationError

log = logs.get_logger("coord.remote")

#: Live clients, quiesced at interpreter exit: reconnect/rewatch/
#: discovery threads that outlive logging teardown die loudly. Weak so
#: the set never pins a client.
_live_clients: "weakref.WeakSet[RemoteCoord]" = weakref.WeakSet()


@atexit.register
def _quiesce_clients() -> None:
    for c in list(_live_clients):
        c._closed.set()


class _Pending:
    __slots__ = ("event", "reply", "sock")

    def __init__(self, sock):
        self.event = threading.Event()
        self.reply: dict | None = None
        #: The socket this request was sent on. After a reconnect, any
        #: pending still tagged with an OLD socket was sent into the
        #: void (a half-closed socket accepts exactly one post-FIN
        #: write) — its reply can never come and it must be failed
        #: rather than left to burn the full request timeout.
        self.sock = sock


class _StaleCoordinator(CoordinationError):
    """The endpoint answered but is a SUPERSEDED primary (its fencing
    term is behind this client's). The request was refused before
    execution, so retrying against another endpoint is always safe.
    Carries the endpoint that refused, so concurrent callers bounce
    it exactly once."""

    def __init__(self, msg: str, endpoint: str | None = None):
        super().__init__(msg)
        self.endpoint = endpoint


class _SendFailed(CoordinationError):
    """The request never left this client (send error, or the bytes
    went into a socket the reader had already replaced). The server
    cannot have executed it, so the fence-bounce loop may re-send;
    a timeout or lost-mid-request is NOT this — the op may have
    executed, and only the caller knows whether a retry is safe."""


class RemoteCoord(CoordBackend):
    """Client over one persistent connection; safe for concurrent use.

    ``address`` may be a list of endpoints: the client dials the first
    reachable one and, on connection loss, cycles through ALL of them —
    so a warm standby (coord.standby) that takes over on a different
    address picks up the clientele without any client-side action.

    Fencing: every reply carries the server's promotion ``term``; the
    client remembers the highest it has seen and stamps it on every
    request (``min_term``). A superseded primary — e.g. the old seed
    restarted on its old address after a wal-stream takeover — refuses
    the request, and the client abandons that endpoint and re-dials
    until it finds the current primary. This is the client half of the
    epoch fence raft gave the reference for free
    (the reference cluster.go:120-147).

    Dial timeout defaults to the reference's 5 s (registry.go:37,
    store.go:25, cluster.go:53).
    """

    def __init__(self, address: str | list[str], dial_timeout: float = 5.0,
                 request_timeout: float = 30.0,
                 reconnect_timeout: float = 30.0,
                 discovery_interval: float = 0.0):
        eps = [address] if isinstance(address, str) else list(address)
        if not eps:
            raise CoordinationError("RemoteCoord: no endpoints")
        self.endpoints = eps
        #: The configured endpoints — never pruned by discovery
        #: (discovered standbys come and go; the static list is the
        #: operator's contract).
        self._seed_endpoints = list(eps)
        #: Guards endpoints/address against the discovery thread: a
        #: remove() between _dial's membership check and .index(), or
        #: between a len() and the modular index, would raise out of
        #: the reader's reconnect path. Created before the first _dial.
        self._endpoints_lock = lockcheck.lock("coord.remote.endpoints")
        self.address = eps[0]
        self._dial_timeout = dial_timeout
        self._request_timeout = request_timeout
        #: How long to re-dial a lost coordinator before giving up
        #: (covers a seed restart from its WAL data_dir, or a standby
        #: takeover on another endpoint); 0 disables.
        self._reconnect_timeout = reconnect_timeout
        try:
            self._sock = self._dial()
        except OSError as e:
            raise CoordinationError(
                f"failed to dial coordination service at {eps}: {e}"
            ) from e
        self._send_lock = lockcheck.lock("coord.remote.send")
        #: Highest fencing term seen in any reply (never decreases).
        self._term = 0
        #: Set while a dialed connection is live; cleared on loss and
        #: by a stale-endpoint bounce, so fence retries can wait for
        #: the reader's re-dial instead of spinning on a dead socket.
        self._connected = threading.Event()
        self._connected.set()
        self._pending: dict[int, _Pending] = {}
        self._pending_lock = lockcheck.lock("coord.remote.pending")
        self._watches: dict[int, Watch] = {}
        #: Watch pushes that arrived before their watch id was
        #: registered (see _dispatch_watch); drained at registration.
        self._orphan_events: dict[int, list] = {}
        self._watches_lock = lockcheck.lock("coord.remote.watches")
        self._next_id = 1
        self._id_lock = lockcheck.lock("coord.remote.id")
        self._closed = threading.Event()
        #: Cleared while watches are being re-armed after a reconnect;
        #: ordinary calls wait on it so a caller cannot slip a write in
        #: before the re-watch and silently miss its own event.
        self._rewatch_gate = threading.Event()
        self._rewatch_gate.set()
        self._rewatch_thread: threading.Thread | None = None
        self._reader = threading.Thread(
            target=self._read_loop, name=f"coord-client-{self.address}",
            daemon=True
        )
        self._reader.start()
        # discovery_interval > 0: periodically merge promote-eligible
        # standbys from the membership into the endpoint list, so this
        # client can fail over to standbys attached after it connected.
        if discovery_interval > 0:
            threading.Thread(
                target=self._discovery_loop, args=(discovery_interval,),
                name=f"coord-discovery-{self.address}", daemon=True,
            ).start()
        _live_clients.add(self)

    # ------------------------------------------------------------- plumbing

    def _cur_addr(self) -> str:
        """The active endpoint, read under the endpoints lock — the
        discovery thread and stale-bounces rewrite ``self.address``
        concurrently, and log/error paths must not read it torn
        against the endpoint list."""
        with self._endpoints_lock:
            return self.address

    def _dial(self) -> socket.socket:
        """Dial the endpoint list in order, starting at the currently
        active one; first success wins and becomes ``self.address``.
        Works off a snapshot so concurrent discovery churn can't shift
        indices mid-iteration."""
        with self._endpoints_lock:
            eps = list(self.endpoints)
            addr = self.address
        start = eps.index(addr) if addr in eps else 0
        last: OSError | None = None
        for i in range(len(eps)):
            ep = eps[(start + i) % len(eps)]
            host, _, port = ep.rpartition(":")
            try:
                sock = socket.create_connection(
                    (host, int(port)), timeout=self._dial_timeout
                )
            except OSError as e:
                last = e
                continue
            if sock.getsockname() == sock.getpeername():
                # TCP simultaneous-open self-connect: dialing a loopback
                # ephemeral port with no listener can connect the socket
                # to itself — not a coordinator.
                sock.close()
                last = OSError("self-connected (no listener)")
                continue
            sock.settimeout(None)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            # Under the lock: _bounce_endpoint's single-advance guard
            # and discovery's keep-current-address prune both read
            # address under it — an unlocked write here could let a
            # stale-reply bounce shut down this fresh connection.
            with self._endpoints_lock:
                self.address = ep
            return sock
        raise last or OSError("no endpoints")

    def _read_loop(self) -> None:
        try:
            while not self._closed.is_set():
                try:
                    msg = wire.recv_msg(self._sock)
                except (wire.WireError, OSError):
                    # Connection lost: fail outstanding requests (their
                    # callers retry — registry keepalive, balancer),
                    # mark every watch dis-armed, and try to reach a
                    # coordinator again (seed restarting from its WAL,
                    # or a standby taking over). Deliberate close()
                    # skips the re-dial.
                    self._connected.clear()
                    self._fail_pending()
                    with self._watches_lock:
                        for w in self._watches.values():
                            w._armed = False
                        # Stashed pushes are scoped to the DEAD
                        # connection's watch-id space: after a failover
                        # a fresh CoordState numbers watches from
                        # scratch, and a stale stash could drain into
                        # an unrelated (wrong-prefix) new watch.
                        self._orphan_events.clear()
                    if self._closed.is_set() or not self._try_reconnect():
                        break
                    continue
                if "watch" in msg and "id" not in msg:
                    self._dispatch_watch(msg)
                    continue
                with self._pending_lock:
                    p = self._pending.pop(msg.get("id"), None)
                if p is not None:
                    p.reply = msg
                    p.event.set()
        finally:
            # Giving up for good — including via an UNEXPECTED
            # exception: the cleanup must still run, or the client is
            # left half-alive (reader dead, _closed unset, every
            # future call burning its full timeout on a dead socket).
            self._closed.set()
            self._fail_pending()
            with self._watches_lock:
                watches, self._watches = list(self._watches.values()), {}
                self._orphan_events.clear()
            for w in watches:
                w.cancel()

    def _fail_pending(self, keep_sock=None) -> None:
        """Fail outstanding requests. ``keep_sock``: spare requests
        sent on that (current) socket — used after a re-dial to reap
        only the stragglers that raced the reconnect onto the old
        socket."""
        with self._pending_lock:
            doomed = [(i, p) for i, p in self._pending.items()
                      if keep_sock is None or p.sock is not keep_sock]
            for i, _ in doomed:
                del self._pending[i]
        for _, p in doomed:
            p.event.set()

    def _try_reconnect(self) -> bool:
        if not self._reconnect_timeout:
            return False
        deadline = time.monotonic() + self._reconnect_timeout
        bo = retry.Backoff(base=0.2, cap=2.0)
        while not self._closed.is_set():
            try:
                self._sock = self._dial()
            except OSError:
                delay = bo.next_delay()
                if time.monotonic() + delay > deadline:
                    log.warning("coordination reconnect gave up",
                                kv={"addr": self._cur_addr()})
                    return False
                bo.sleep(delay)
                continue
            addr = self._cur_addr()
            log.info("coordination connection re-established",
                     kv={"addr": addr})
            chaos.note_ok("coord.reconnect", addr)
            # Reap requests that were sent while we were re-dialing:
            # they went into the OLD socket (its first post-FIN write
            # "succeeds" locally) after the loss-path _fail_pending had
            # already run, so nothing else will ever complete them.
            self._fail_pending(keep_sock=self._sock)
            # Re-arm watches on a fresh thread — _call needs this read
            # loop back in recv. The rewatch gate holds OTHER callers'
            # requests until re-arm completes, so a client's own
            # post-reconnect write can't race ahead of its watches;
            # events produced by third parties during the outage are
            # still missed (watch consumers re-list — the
            # registry.WatchService snapshot-then-delta contract).
            # Gen bump + gate clear are atomic (watches lock): a
            # superseded rewatch thread checking its generation must
            # never interleave with this clear and re-open the gate.
            with self._watches_lock:
                self._rewatch_gen = getattr(self, "_rewatch_gen", 0) + 1
                gen = self._rewatch_gen
                self._rewatch_gate.clear()
            t = threading.Thread(target=self._rewatch,
                                 args=(gen,), daemon=True)
            self._rewatch_thread = t
            t.start()
            self._connected.set()
            return True
        return False

    def _rewatch(self, gen: int) -> None:
        """Re-arm every dis-armed watch, RETRYING until all are live (a
        one-shot attempt whose failure waits for the *next* disconnect
        leaves watches dead forever on a healthy connection). A newer
        reconnect's rewatch (gen bump) supersedes this one — watches it
        didn't finish stay dis-armed and the successor picks them up."""
        def current() -> bool:
            return gen == getattr(self, "_rewatch_gen", gen)

        bo = retry.Backoff(base=0.5, cap=1.0)
        try:
            while not self._closed.is_set() and current():
                failed = False
                with self._watches_lock:
                    todo = [w for w in self._watches.values()
                            if not w.closed
                            and not getattr(w, "_armed", True)]
                for w in todo:
                    # Resume from the last DELIVERED revision: the
                    # server replays the missed interval from its MVCC
                    # event history — no events lost, no re-list. Only
                    # when that interval has been compacted (outage
                    # outlived the history window) fall back to a
                    # fresh watch + epoch bump (consumers re-list:
                    # snapshot-then-delta).
                    replayed = True
                    try:
                        try:
                            res = self._call("watch", prefix=w.prefix,
                                             start_rev=w.last_rev + 1)
                        except CoordinationError as e:
                            if "compacted" not in str(e):
                                raise
                            replayed = False
                            res = self._call("watch", prefix=w.prefix)
                    except CoordinationError:
                        failed = True
                        continue  # retried next round (backoff below)
                    new_id = res["id"]
                    with self._watches_lock:
                        if self._watches.pop(w.id, None) is not None:
                            w.id = new_id
                            w._armed = True
                            if not replayed:
                                # Events in the gap are gone for good:
                                # signal consumers to re-list.
                                w.epoch += 1
                                if res.get("rev", 0) > w.last_rev:
                                    w.last_rev = res["rev"]
                            self._watches[new_id] = w
                            for _, m in self._orphan_events.pop(
                                    new_id, []):
                                w._push(self._wire_events(m))
                            continue
                    # The local watch was closed concurrently: the
                    # server-side watch we just created is orphaned —
                    # cancel it or it pumps events nobody reads for
                    # the connection's lifetime.
                    try:
                        self._call("watch_cancel", watch=new_id)
                    except CoordinationError:
                        pass  # connection died; server cleans up
                # Open the gate only once every watch re-armed — the
                # gate's contract is that a caller's post-reconnect
                # write cannot race ahead of its own watches, which a
                # partially-armed set would silently break. (Callers
                # have a bounded gate wait, so a persistently failing
                # re-arm degrades to that timeout, not a deadlock.)
                if not failed:
                    with self._watches_lock:
                        if current():
                            self._rewatch_gate.set()
                with self._watches_lock:
                    if not any(not w.closed
                               and not getattr(w, "_armed", True)
                               for w in self._watches.values()):
                        return
                bo.sleep()
        finally:
            # A superseded generation must NOT open the gate — its
            # successor cleared it and is still re-arming; opening it
            # here would let a caller's write race ahead of its watches.
            # (Atomic with the successor's bump+clear via the lock.)
            with self._watches_lock:
                if self._closed.is_set() or current():
                    self._rewatch_gate.set()

    @staticmethod
    def _wire_events(msg: dict) -> list[Event]:
        return [
            Event(
                type=EventType(ev["type"]),
                key=ev["key"],
                value=ev["value"],
                mod_rev=ev["mod_rev"],
            )
            for ev in msg.get("events", [])
        ]

    def _dispatch_watch(self, msg: dict) -> None:
        with self._watches_lock:
            w = self._watches.get(msg["watch"])
            if w is None:
                # The server starts pumping the moment the create-reply
                # is sent, so a push can reach this reader BEFORE the
                # calling thread registers the new watch id — a hot
                # race for replay-from-revision re-arms (their events
                # are pre-queued). Stash briefly; _register_watch
                # drains under this same lock, preserving order.
                now = time.monotonic()
                self._orphan_events.setdefault(
                    msg["watch"], []).append((now, msg))
                for wid in list(self._orphan_events):
                    self._orphan_events[wid] = [
                        (t, m) for t, m in self._orphan_events[wid]
                        if now - t < 30.0]
                    if not self._orphan_events[wid]:
                        del self._orphan_events[wid]
                return
            events = self._wire_events(msg)
        w._push(events)

    def _register_watch(self, w: Watch) -> None:
        """Register a (re)armed watch id and drain any pushes that
        outran the registration (under the watches lock, so no later
        push can interleave ahead of the drained ones)."""
        with self._watches_lock:
            self._watches[w.id] = w
            for _, msg in self._orphan_events.pop(w.id, []):
                w._push(self._wire_events(msg))

    def _call(self, op: str, reply_timeout: float | None = None, **kwargs):
        """One request/response, with fence-aware endpoint cycling: a
        ``stale`` refusal (superseded primary — the op was NOT
        executed) bounces to the next endpoint and retries until the
        current primary is found or the endpoint list is exhausted."""
        stale: _StaleCoordinator | None = None
        bo = retry.Backoff(base=0.3, cap=1.0)
        for _ in range(2 * len(self.endpoints) + 2):
            if stale is not None:
                # Wait for the reader's re-dial after the bounce.
                self._connected.wait(timeout=5.0)
            try:
                return self._call_once(op, reply_timeout, kwargs)
            except _StaleCoordinator as e:
                stale = e
                self._bounce_endpoint(e.endpoint)
            except _SendFailed:
                if stale is None:
                    raise  # ordinary failure: callers own the retry
                bo.sleep()  # mid-re-dial; let the reader land
            # Any other CoordinationError (timeout, lost mid-request)
            # propagates even after a bounce: the op may have EXECUTED
            # on the current primary, and re-sending a non-idempotent
            # op (grant, member_add) here would double-apply it.
        raise CoordinationError(
            f"no current-term coordinator among {self.endpoints}: {stale}")

    def _bounce_endpoint(self, stale_ep: str | None) -> None:
        """Abandon a superseded primary: advance the endpoint cursor so
        the reader's re-dial starts at the NEXT endpoint, then drop the
        socket to trigger the reconnect loop. Concurrent callers whose
        stale replies came from the same endpoint bounce it ONCE — a
        double advance could skip straight past the current primary."""
        with self._endpoints_lock:
            if stale_ep is not None and self.address != stale_ep:
                return  # another caller (or the reader) already moved on
            try:
                idx = self.endpoints.index(self.address)
            except ValueError:
                idx = -1
            stale_ep = self.address
            self.address = self.endpoints[(idx + 1) % len(self.endpoints)]
            nxt = self.address
        self._connected.clear()
        log.info("abandoning superseded coordinator",
                 kv={"stale": stale_ep, "next": nxt,
                     "fence_term": self._term})
        sock = self._sock
        try:
            # shutdown() interrupts the reader parked in recv(2) on this
            # socket; close() alone does not (same reason as
            # WalFollower.close) — without it the reconnect loop never
            # runs and the bounce strands the client.
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            sock.close()
        except OSError:
            pass

    def _call_once(self, op: str, reply_timeout: float | None, kwargs):
        addr = self._cur_addr()
        if self._closed.is_set():
            raise CoordinationError(
                f"coordination connection to {addr} closed")
        if (not self._connected.is_set()
                and threading.current_thread() is not self._rewatch_thread):
            # The reader is mid-re-dial: a send into the dead socket
            # can "succeed" locally and then park this op until the
            # whole reconnect window lapses. Fail fast instead — the
            # op never left this client, so callers retry safely
            # (exactly the outage contract the registry keepalive and
            # failover tests already code against).
            raise _SendFailed(
                f"connection to {addr} down (reconnect in flight)")
        if (not self._rewatch_gate.is_set()
                and threading.current_thread() is not self._rewatch_thread):
            # A reconnect is re-arming watches; hold ordinary traffic so
            # callers observe their own effects through their watches.
            self._rewatch_gate.wait(timeout=5.0)
        with self._id_lock:
            req_id = self._next_id
            self._next_id += 1
        sock = self._sock
        p = _Pending(sock)
        with self._pending_lock:
            self._pending[req_id] = p
        try:
            wire.send_msg(sock, self._send_lock,
                          {"id": req_id, "op": op,
                           "min_term": self._term, **kwargs})
        except (wire.WireError, OSError) as e:
            with self._pending_lock:
                self._pending.pop(req_id, None)
            raise _SendFailed(f"send to {addr} failed: {e}") from e
        if sock is not self._sock and not p.event.is_set():
            # The reader replaced the connection while we were sending:
            # the bytes went into the dead socket (a kill's RST races
            # the local send buffer, so send() "succeeds") and
            # _fail_pending has already run — this reply can never
            # arrive. Fail fast; callers retry like any connection loss.
            with self._pending_lock:
                self._pending.pop(req_id, None)
            raise _SendFailed(
                f"connection to {addr} replaced mid-request")
        if not p.event.wait(reply_timeout if reply_timeout is not None
                            else self._request_timeout):
            with self._pending_lock:
                self._pending.pop(req_id, None)
            raise CoordinationError(
                f"request {op!r} to {addr} timed out")
        if p.reply is None:
            raise CoordinationError(
                f"connection to {addr} lost mid-request")
        t = p.reply.get("term")
        if isinstance(t, int) and t > self._term:
            self._term = t  # adopt the newest primary's fence
        if not p.reply.get("ok"):
            if p.reply.get("stale"):
                raise _StaleCoordinator(
                    p.reply.get("error", "stale coordinator"),
                    endpoint=addr)
            raise CoordinationError(p.reply.get("error", "unknown coordination error"))
        chaos.note_ok("coord.op", op)
        return p.reply.get("result")

    # ------------------------------------------------------------------- KV

    def put(self, key: str, value: str, lease: int = 0,
            sync: bool = False,
            sync_timeout: float | None = None,
            sync_min_followers: int = 0) -> int:
        if sync_min_followers and not sync:
            raise ValueError(
                "sync_min_followers requires sync=True — without the "
                "barrier the floor would be silently ignored")
        if sync:
            extra = {"sync": True}
            if sync_timeout is not None:
                extra["sync_timeout"] = sync_timeout
            if sync_min_followers:
                extra["sync_min_followers"] = sync_min_followers
            return self._call("put", key=key, value=value, lease=lease,
                              **extra)
        return self._call("put", key=key, value=value, lease=lease)

    def range(self, key: str, options: RangeOptions | None = None) -> RangeResult:
        res = self._call("range", key=key, options=(options or RangeOptions()).to_wire())
        return RangeResult(
            items=[KVItem(**it) for it in res["items"]],
            count=res["count"],
            revision=res["revision"],
        )

    def delete(self, key: str, options: RangeOptions | None = None) -> int:
        return self._call("delete", key=key, options=(options or RangeOptions()).to_wire())

    # --------------------------------------------------------------- leases

    def grant(self, ttl: float) -> int:
        return self._call("grant", ttl=ttl)

    def keepalive(self, lease_id: int) -> float:
        return self._call("keepalive", lease=lease_id)

    def revoke(self, lease_id: int) -> None:
        self._call("revoke", lease=lease_id)

    # -------------------------------------------------------------- watches

    def watch(self, prefix: str, start_rev: int = 0) -> Watch:
        res = self._call("watch", prefix=prefix, start_rev=start_rev)
        w = Watch(res["id"], prefix, self._cancel_watch)
        # Resume floor: for a fresh watch the server's arm-time head
        # (nothing before it was promised); start_rev watches resume
        # from the caller's own floor. Advances only as events are
        # actually DELIVERED (Watch._push) — so a reconnect mid-replay
        # can never skip undelivered events.
        w.last_rev = (start_rev - 1) if start_rev else res.get("rev", 0)
        self._register_watch(w)
        return w

    def _cancel_watch(self, w: Watch) -> None:
        with self._watches_lock:
            self._watches.pop(w.id, None)
        if not self._closed.is_set():
            try:
                self._call("watch_cancel", watch=w.id)
            except CoordinationError:
                pass

    # -------------------------------------------------------------- members

    def member_add(self, name: str, peer_addr: str, metadata: dict | None = None) -> Member:
        m = self._call("member_add", name=name, peer_addr=peer_addr,
                       metadata=metadata or {})
        return Member(**m)

    def member_promote(self, member_id: int) -> Member:
        return Member(**self._call("member_promote", member=member_id))

    def member_remove(self, member_id: int) -> bool:
        return self._call("member_remove", member=member_id)

    def member_list(self) -> list[Member]:
        return [Member(**m) for m in self._call("member_list")]

    def discover_endpoints(self) -> list[str]:
        """Merge promote-eligible standbys from the membership into the
        failover endpoint list — how a client learns about a standby
        attached AFTER this client was constructed (the dynamic
        counterpart of the static initial_cluster_client_urls list;
        ref: learner add→promote, cluster.go:120-147). Learners are
        skipped: failing over to a standby whose mirror never caught up
        would serve stale or empty state."""
        members = self.member_list()  # network call: outside the lock
        eligible = set()
        added, pruned = [], []
        for m in members:
            md = m.metadata or {}
            if (md.get("role") == "standby"
                    and md.get("learner", True) is False and m.peer_addr):
                eligible.add(m.peer_addr)
        with self._endpoints_lock:
            for addr in eligible:
                if addr not in self.endpoints:
                    self.endpoints.append(addr)
                    added.append(addr)
            # Reconcile removals: a decommissioned standby
            # (Standby.close deregisters it) must not linger as a dead
            # dial target — each stale entry can burn a full
            # dial_timeout per reconnect cycle. Configured seeds and
            # the endpoint currently in use are kept.
            for addr in list(self.endpoints):
                if (addr not in eligible
                        and addr not in self._seed_endpoints
                        and addr != self.address):
                    self.endpoints.remove(addr)
                    pruned.append(addr)
            out = list(self.endpoints)
        for addr in added:
            log.info("discovered standby endpoint", kv={"addr": addr})
        for addr in pruned:
            log.info("pruned decommissioned standby endpoint",
                     kv={"addr": addr})
        return out

    def _discovery_loop(self, interval: float) -> None:
        while not self._closed.wait(interval):
            try:
                self.discover_endpoints()
            except CoordinationError:
                pass  # transient (reconnect in flight); next round

    # ------------------------------------------------------------- barriers

    def barrier(self, name: str, count: int, timeout: float | None = None) -> bool:
        # Give the server-side wait headroom beyond the barrier timeout;
        # the wire field "timeout" is the barrier's own deadline.
        reply_timeout = (timeout + 5.0) if timeout is not None else None
        return self._call("barrier", reply_timeout=reply_timeout,
                          name=name, count=count, timeout=timeout)

    # ---------------------------------------------------------------- misc

    @property
    def term(self) -> int:
        """Highest coordinator fencing term this client has seen."""
        return self._term

    @property
    def closed(self) -> bool:
        """True once the client is closed for good (deliberate close,
        or the reconnect window lapsed) — no call can ever succeed."""
        return self._closed.is_set()

    def ping(self, timeout: float = 5.0) -> bool:
        try:
            return self._call("ping", reply_timeout=timeout) == "pong"
        except CoordinationError:
            return False

    def close(self) -> None:
        if self._closed.is_set():
            return
        self._closed.set()
        try:
            # shutdown() wakes the reader parked in recv(2); close()
            # alone leaves it wedged until process exit.
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
