"""The coordination state machine: KV + revisions, leases, watches, members.

The port's copy of ``ptype_tpu/coord/core.py``, whole, with its chaos
seams ``coord.wal_append`` and ``coord.keepalive``. It is the
authoritative store behind the in-process backend
(:mod:`ptype_tpu_torch.coord.local`) and the TCP service
(:mod:`ptype_tpu_torch.coord.service`), and the ground the standby
(:mod:`ptype_tpu_torch.coord.standby`) mirrors. Linearizability is by construction — every
mutation takes one lock and bumps one revision counter — which is the role
raft quorum played for the reference's Store (SURVEY.md §3.4).

Capability parity targets (all behaviors the reference's tests encode):
- lease-expiry liveness: key granted under a TTL lease disappears after the
  TTL unless kept alive (ref: registry.go:58-83, registry_test.go:135-147);
- watch streams that fire on any change under a prefix
  (ref: registry.go:119-150);
- range queries with prefix/limit/sort/keys-only/count-only options
  (ref: store_config.go:33-103).
"""

from __future__ import annotations

import enum
import threading
import time

from ptype_tpu_torch import lockcheck
from collections import deque
from dataclasses import dataclass, field, replace

from ptype_tpu_torch import chaos, logs
from ptype_tpu_torch.errors import CoordinationError

log = logs.get_logger("coord")


def fsync_dir(path: str) -> None:
    """fsync a directory so a just-``os.replace``d entry survives host
    power loss — the rename lives in the directory's metadata, not in
    the file that was renamed (etcd fsyncs the dir on snapshot rename;
    without this the wal_fsync durability claim is overstated)."""
    import os

    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)

#: One default for the sync-put replication barrier everywhere (wire
#: dispatch, LocalCoord, the backend API) — three hardcoded copies
#: would drift.
DEFAULT_SYNC_TIMEOUT = 5.0


class EventType(enum.Enum):
    PUT = "put"
    DELETE = "delete"


class SortOrder(enum.Enum):
    NONE = "none"
    ASCEND = "ascend"
    DESCEND = "descend"


class SortTarget(enum.Enum):
    KEY = "key"
    VERSION = "version"
    CREATE = "create"
    MOD = "mod"
    VALUE = "value"


@dataclass(frozen=True)
class KVItem:
    key: str
    value: str
    create_rev: int
    mod_rev: int
    version: int  # number of writes to this key since creation
    lease: int = 0  # 0 = no lease


@dataclass(frozen=True)
class Event:
    type: EventType
    key: str
    value: str  # empty for DELETE
    mod_rev: int


@dataclass
class Lease:
    id: int
    ttl: float
    expires_at: float
    keys: set[str] = field(default_factory=set)


@dataclass(frozen=True)
class Member:
    id: int
    name: str
    peer_addr: str
    metadata: dict = field(default_factory=dict)


def prefix_range_end(prefix: str) -> str:
    """Smallest key greater than every key with this prefix.

    Mirrors clientv3.GetPrefixRangeEnd (ref: store_config.go:41-58) at the
    granularity of this keyspace: the reference bumped the last non-0xff
    *byte*; our keys are unicode strings, so bump the last non-maximal
    *code point*. Empty / unbumpable prefixes mean "to the end".
    """
    for i in reversed(range(len(prefix))):
        c = ord(prefix[i])
        if c < 0x10FFFF:
            return prefix[:i] + chr(c + 1)
    return "\0"  # etcd's "range to end" sentinel


@dataclass
class RangeOptions:
    """Query modifiers (ref: store_config.go:33-103 re-exports)."""

    prefix: bool = False
    range_end: str = ""  # explicit [key, range_end) range
    from_key: bool = False  # [key, end-of-keyspace)
    limit: int = 0  # 0 = no limit
    sort_order: SortOrder = SortOrder.NONE
    sort_target: SortTarget = SortTarget.KEY
    keys_only: bool = False
    count_only: bool = False
    serializable: bool = False  # no-op here: every read is linearizable
    min_mod_rev: int = 0
    #: Read AT this historical revision (etcd WithRev,
    #: store_config.go:71-73): the result is the state as of revision
    #: ``rev``, served from the bounded MVCC history. 0 = head. Raises
    #: when the revision is compacted or in the future.
    rev: int = 0

    def to_wire(self) -> dict:
        return {
            "prefix": self.prefix,
            "range_end": self.range_end,
            "from_key": self.from_key,
            "limit": self.limit,
            "sort_order": self.sort_order.value,
            "sort_target": self.sort_target.value,
            "keys_only": self.keys_only,
            "count_only": self.count_only,
            "serializable": self.serializable,
            "min_mod_rev": self.min_mod_rev,
            "rev": self.rev,
        }

    @staticmethod
    def from_wire(d: dict) -> "RangeOptions":
        return RangeOptions(
            prefix=d.get("prefix", False),
            range_end=d.get("range_end", ""),
            from_key=d.get("from_key", False),
            limit=d.get("limit", 0),
            sort_order=SortOrder(d.get("sort_order", "none")),
            sort_target=SortTarget(d.get("sort_target", "key")),
            keys_only=d.get("keys_only", False),
            count_only=d.get("count_only", False),
            serializable=d.get("serializable", False),
            min_mod_rev=d.get("min_mod_rev", 0),
            rev=d.get("rev", 0),
        )


@dataclass(frozen=True)
class RangeResult:
    items: list[KVItem]
    count: int
    revision: int


class Watch:
    """A stream of events for keys under a prefix.

    Consumers iterate or call :meth:`get`; producers (CoordState) push.
    Closing is idempotent; a closed watch raises ``StopIteration`` once
    drained.
    """

    _CLOSED = object()

    def __init__(self, watch_id: int, prefix: str, cancel_fn):
        self.id = watch_id
        self.prefix = prefix
        #: Bumped by RemoteCoord when a watch re-arm could NOT replay
        #: the missed interval (history compacted): events between the
        #: loss and the re-arm are gone and consumers that see the bump
        #: must re-list to resync (the snapshot-then-delta contract's
        #: resync point). Since round 5 a reconnect that resumes from
        #: ``last_rev`` via the MVCC event history does NOT bump.
        self.epoch = 0
        #: Highest mod_rev delivered through this watch (or the arm-
        #: time head revision) — the resume point for reconnect replay.
        self.last_rev = 0
        #: Head revision at arm time, IMMUTABLE after arming — what a
        #: remote client may safely adopt as its initial resume floor.
        #: (last_rev races live pushes by the pump; reading it outside
        #: the state lock could skip an event queued-but-undelivered.)
        self.arm_rev = 0
        self._cancel_fn = cancel_fn
        self._cond = lockcheck.condition("coord.watch")
        self._events: list[Event] = []
        self._closed = False

    def _push(self, events: list[Event]) -> None:
        with self._cond:
            if self._closed:
                return
            self._events.extend(events)
            if events and events[-1].mod_rev > self.last_rev:
                self.last_rev = events[-1].mod_rev
            self._cond.notify_all()

    def get(self, timeout: float | None = None) -> list[Event]:
        """Block for the next batch of events; [] on timeout or close."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while not self._events and not self._closed:
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return []
                self._cond.wait(remaining)
            batch, self._events = self._events, []
            return batch

    def cancel(self) -> None:
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
        self._cancel_fn(self)

    close = cancel

    @property
    def closed(self) -> bool:
        with self._cond:
            return self._closed

    def __iter__(self):
        while True:
            batch = self.get()
            if not batch:
                if self.closed:
                    return
                continue
            for ev in batch:
                yield ev


class ReplFeed:
    """A follower's view of the primary's WAL: one ``("snap", dict)``
    item with the full state at subscribe time (and after each
    compaction), then a ``("rec", dict)`` item per mutation, in commit
    order. Consumed by the WAL-shipping standby
    (:class:`ptype_tpu_torch.coord.standby.WalFollower`). The queue is
    bounded at :data:`MAX_BUFFER` items and SELF-CANCELS on overflow
    (see below) — a cancelled follower re-syncs from a fresh snapshot
    on reconnect, so dropping the feed is always safe; a follower that
    stops draining without wedging simply loses its connection
    (service.py pump), which also cancels the feed.
    """

    #: Max buffered items before the feed self-cancels. A follower
    #: whose process is wedged (SIGSTOP, stuck disk) keeps its TCP
    #: window open, so the pump blocks in sendall and never errors —
    #: without this bound every mutation would accumulate in the
    #: feed's list and the COORDINATOR would OOM. A cancelled follower
    #: re-syncs from a fresh snapshot on reconnect, so dropping the
    #: feed is always safe.
    MAX_BUFFER = 100_000

    def __init__(self, feed_id: int, cancel_fn):
        self.id = feed_id
        self._cancel_fn = cancel_fn
        self._cond = lockcheck.condition("coord.repl_feed")
        self._items: list[tuple[str, dict, int]] = []
        self._closed = False
        #: Highest replication sequence this follower has ACKNOWLEDGED
        #: mirroring (durable on its side). A snapshot ack covers every
        #: record folded into it. Read by CoordState.wait_replicated —
        #: the sync-put (raft-commit-analog) barrier.
        self.acked = 0
        #: Last heartbeat/ack ROUND-TRIP from this follower
        #: (monotonic). A live round-trip within the witness TTL is
        #: the standby's vote in the partition-tolerance quorum
        #: (service.CoordServer._quorum_round) — a half-dead TCP
        #: connection cannot fake it.
        self.last_hb = time.monotonic()

    def _push(self, kind: str, data: dict, seq: int) -> None:
        overflow = False
        with self._cond:
            if self._closed:
                return
            self._items.append((kind, data, seq))
            if len(self._items) > self.MAX_BUFFER:
                overflow = True
            self._cond.notify_all()
        if overflow:
            log.warning("replication feed overflowed; cancelling "
                        "(follower will re-sync on reconnect)",
                        kv={"feed": self.id, "buffered": self.MAX_BUFFER})
            self.cancel()

    def get(self, timeout: float | None = None
            ) -> list[tuple[str, dict, int]]:
        """Block for the next batch; [] on timeout or close."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while not self._items and not self._closed:
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return []
                self._cond.wait(remaining)
            batch, self._items = self._items, []
            return batch

    def cancel(self) -> None:
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
        self._cancel_fn(self)

    close = cancel

    @property
    def closed(self) -> bool:
        with self._cond:
            return self._closed


class CoordState:
    """Single-lock linearizable KV + leases + watches + members + barriers.

    Durability (VERDICT r1 missing #1 — the reference's store survived
    restarts via etcd's raft log + data-dir, testdata/node1.yml): pass
    ``data_dir`` and every mutation is appended to ``coord.wal`` before
    it is acknowledged; a restarted coordinator replays snapshot + WAL
    and resumes with identical revisions, lease ids, and member ids.
    Scope: the WAL is flushed (not fsynced) per record — it survives
    coordinator *process* death (the elastic story's failure mode), not
    host power loss; etcd's raft log fsyncs and does cover that.
    Leases are re-armed at ``now + ttl`` on restart (a grace window for
    clients to reconnect and resume keepalives — dead clients still
    expire one TTL later). The WAL is compacted into ``coord.snap``
    every ``compact_every`` records. Barriers and watches are ephemeral
    rendezvous state and are deliberately not persisted.
    """

    def __init__(self, sweep_interval: float = 0.25,
                 data_dir: str | None = None,
                 compact_every: int = 10_000,
                 bump_term: bool | int = False,
                 fsync: bool = False,
                 history_window: int = 10_000):
        self._lock = lockcheck.rlock("coord.state")
        self._kv: dict[str, KVItem] = {}
        self._rev = 0
        #: Promotion generation (fencing token). Persisted in the
        #: snapshot; bumped when a standby takes over (``bump_term``).
        #: Clients carry the highest term they have seen and a
        #: superseded primary — lower term — refuses their requests,
        #: the role raft's leader epoch played for the reference
        #: (/root/reference/cluster/cluster.go:120-147).
        self._term = 0
        self._leases: dict[int, Lease] = {}
        self._next_lease = 1
        self._watches: list[Watch] = []
        self._next_watch = 1
        self._members: dict[int, Member] = {}
        self._next_member = 1
        self._barriers: dict[str, dict] = {}
        self._barrier_cond = threading.Condition(self._lock)
        self._closed = threading.Event()
        self._sweep_interval = sweep_interval
        self._wal = None
        self._wal_count = 0
        self._wal_gen = 0
        #: fsync per appended record (and through compaction). Off =
        #: flush-only: survives process death, not host power loss —
        #: the documented default scope. On = etcd raft-log parity.
        self._fsync = fsync
        self._compact_every = compact_every
        self._data_dir = data_dir
        self._flock = None
        self._repl_feeds: list[ReplFeed] = []
        self._next_repl = 1
        #: Monotonic replication sequence: one per feed-visible event
        #: (mutation record or snapshot). Follower acks reference it;
        #: wait_replicated barriers on it.
        self._repl_seq = 0
        self._ack_cond = threading.Condition(self._lock)
        #: Quorum fence hook: a callable returning a refusal message
        #: (or None) checked at every public entry point. Installed by
        #: CoordServer when a witness is configured so in-process
        #: callers fence like remote ones (see _check_fence).
        self.fence = None
        # ---- bounded MVCC history (etcd WithRev + watch-start-rev
        # parity, store_config.go:71-73). Two structures, one feed
        # point (_notify):
        #: Global event log for watch replay-from-revision, bounded at
        #: ``history_window`` events; ``_event_floor`` = mod_rev of the
        #: newest EVICTED event (resume below it must re-list).
        self._event_log: deque[Event] = deque()
        self._event_floor = 0
        #: Per-key version chains for read-at-revision:
        #: key -> [(mod_rev, KVItem|None)] (None = tombstone), oldest
        #: first. Eviction keeps the newest entry at-or-below the
        #: compaction floor as each key's base version (what etcd's
        #: compaction keeps), so any revision in
        #: [_compacted_rev, head] reconstructs exactly.
        self._hist: dict[str, list] = {}
        self._hist_log: deque = deque()  # (mod_rev, key) eviction order
        self._compacted_rev = 0
        self._history_window = history_window
        if data_dir:
            import fcntl
            import os

            os.makedirs(data_dir, exist_ok=True)
            # Single-writer fence on the WAL dir: a standby promoting
            # against a wedged-but-alive primary (or an operator
            # double-starting the seed) must fail here instead of
            # interleaving two coordinators' appends into one WAL.
            # The kernel releases the lock on crash/SIGKILL, so a truly
            # dead primary never blocks takeover.
            self._flock = open(os.path.join(data_dir, ".lock"), "w")
            try:
                fcntl.flock(self._flock, fcntl.LOCK_EX | fcntl.LOCK_NB)
            except OSError as e:
                self._flock.close()
                self._flock = None
                raise RuntimeError(
                    f"coordination data_dir {data_dir!r} is locked by a "
                    "live coordinator — refusing to double-write the WAL"
                ) from e
            self._replay(data_dir)
            if bump_term:
                # Promotion: supersede every prior primary BEFORE the
                # compact below persists the new term — a crash after
                # serving even one request must not resurrect at the
                # old term. May bump by >1: a junior standby promoting
                # past unresponsive seniors jumps their term slots so
                # a slow senior finishing its own promotion later can
                # never land on the SAME term (coord/standby.py
                # succession).
                self._term += int(bump_term)
                log.info("coordination term bumped (promotion)",
                         kv={"term": self._term, "by": int(bump_term)})
            self._wal = open(self._wal_path(), "a", encoding="utf-8")
            # Compact-on-start: fold the recovered state into a fresh
            # snapshot + truncated WAL. Appending to the replayed file
            # would be wrong in the stale-generation case (a crash
            # between _compact's snapshot-replace and WAL-truncate):
            # new records after a mismatched header would be skipped
            # wholesale by the NEXT replay. Rewriting both files makes
            # every start leave a consistent (snap, WAL-gen) pair —
            # and bounds future replay work as a side effect.
            self._compact_locked()
        elif bump_term:
            self._term += int(bump_term)
        self._publish_term()
        self._sweeper = threading.Thread(
            target=self._sweep_loop, name="coord-lease-sweeper", daemon=True
        )
        self._sweeper.start()

    def _publish_term(self) -> None:
        """Stamp the term into the ``coord.term`` gauge so the health
        plane's sampler turns promotions into a series — the
        coord-flap alert rule counts its increases. Only when metrics
        is ALREADY loaded: the module imports jax, and a lean
        coordinator/standby (deliberately jax-free, and on the
        promotion path latency-critical) must not pay a cold jax
        import for a gauge no sampler in that process would read."""
        import sys

        metrics_mod = sys.modules.get("ptype_tpu_torch.metrics")
        if metrics_mod is None:
            return
        metrics_mod.metrics.gauge("coord.term").set(float(self._term))

    # ------------------------------------------------------------ WAL
    def _wal_path(self) -> str:
        import os

        return os.path.join(self._data_dir, "coord.wal")

    def _snap_path(self) -> str:
        import os

        return os.path.join(self._data_dir, "coord.snap")

    def _append_locked(self, rec: dict) -> None:
        """Log one mutation (called under the lock, before ack)."""
        # Key is "<kind>:<kv-key>" (e.g. "p:services/x") so plans can
        # target one record precisely — bare kind codes collide as
        # substrings ("p" is inside "mp").
        f = chaos.hit("coord.wal_append",
                      f"{rec.get('o', '')}:{rec.get('k', '')}")
        if f is not None and f.action == "delay":
            # Deliberately sleeps UNDER the state lock: every op —
            # including probe-serving member_list — wedges for the
            # duration, which is how a drill makes a standby's probes
            # time out and promote while this primary is alive-but-hung.
            f.sleep()
        self._repl_seq += 1
        # Copy: an overflowing feed self-cancels INSIDE _push, which
        # removes it from this list mid-iteration — a sibling feed
        # would silently miss this record (divergent mirror).
        for feed in list(self._repl_feeds):
            feed._push("rec", rec, self._repl_seq)
        if self._wal is None:
            return
        import json

        self._wal.write(json.dumps(rec, separators=(",", ":")) + "\n")
        self._wal.flush()
        if self._fsync:
            import os

            os.fsync(self._wal.fileno())
        self._wal_count += 1
        if self._wal_count >= self._compact_every:
            self._compact_locked()

    def _snapshot_dict_locked(self, wal_gen: int | None = None) -> dict:
        """Full state in ``coord.snap`` format (called under the lock).

        ``wal_gen`` is the generation of WAL records that FOLLOW this
        snapshot: replay accepts a WAL only when its header generation
        matches the snapshot's. This closes the crash window between
        "snapshot replaced" and "WAL truncated" — a stale WAL paired
        with a fresh snapshot would re-apply already-folded records
        and diverge (grant ids, revisions).
        """
        return {
            "wal_gen": self._wal_gen if wal_gen is None else wal_gen,
            "term": self._term,
            "rev": self._rev,
            "next_lease": self._next_lease,
            "next_member": self._next_member,
            "kv": [
                {"k": it.key, "v": it.value, "cr": it.create_rev,
                 "mr": it.mod_rev, "ver": it.version, "l": it.lease}
                for it in self._kv.values()
            ],
            "leases": [
                {"id": l.id, "ttl": l.ttl, "keys": sorted(l.keys)}
                for l in self._leases.values()
            ],
            "members": [
                {"id": m.id, "n": m.name, "a": m.peer_addr,
                 "md": m.metadata}
                for m in self._members.values()
            ],
        }

    def _compact_locked(self) -> None:
        """Snapshot full state, truncate the WAL (under the lock)."""
        import json
        import os

        new_gen = self._wal_gen + 1
        snap = self._snapshot_dict_locked(wal_gen=new_gen)
        # A snapshot folds every record through the current seq, so a
        # follower's ack of it covers them all.
        for feed in list(self._repl_feeds):  # _push may self-cancel
            feed._push("snap", snap, self._repl_seq)
        tmp = self._snap_path() + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(snap, f)
            if self._fsync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, self._snap_path())
        if self._fsync:
            fsync_dir(self._data_dir)
        # Crash here leaves the new snapshot with the OLD-generation
        # WAL — replay sees the header mismatch and skips it (those
        # records are already folded into the snapshot).
        self._wal.close()
        self._wal = open(self._wal_path(), "w", encoding="utf-8")
        self._wal_gen = new_gen
        self._wal.write(json.dumps({"o": "hdr", "gen": new_gen},
                                   separators=(",", ":")) + "\n")
        self._wal.flush()
        self._wal_count = 0

    def _replay(self, data_dir: str) -> None:
        """Load snapshot + WAL; re-arm surviving leases."""
        import json
        import os

        snap_path = os.path.join(data_dir, "coord.snap")
        snap_gen = 0
        if os.path.exists(snap_path):
            with open(snap_path, encoding="utf-8") as f:
                snap = json.load(f)
            snap_gen = snap.get("wal_gen", 0)
            self._term = snap.get("term", 0)
            self._rev = snap["rev"]
            self._next_lease = snap["next_lease"]
            self._next_member = snap["next_member"]
            for r in snap["kv"]:
                self._kv[r["k"]] = KVItem(
                    key=r["k"], value=r["v"], create_rev=r["cr"],
                    mod_rev=r["mr"], version=r["ver"], lease=r["l"])
            for r in snap["leases"]:
                self._leases[r["id"]] = Lease(
                    id=r["id"], ttl=r["ttl"], expires_at=0.0,
                    keys=set(r["keys"]))
            for r in snap["members"]:
                self._members[r["id"]] = Member(
                    id=r["id"], name=r["n"], peer_addr=r["a"],
                    metadata=r["md"])
            # History below the snapshot revision is unknowable: set
            # the MVCC floors there and seed each key's base version,
            # so [snap_rev, head] reconstructs exactly (WAL replay
            # appends the rest through the normal mutation paths).
            self._compacted_rev = self._event_floor = self._rev
            for k, it in self._kv.items():
                self._hist[k] = [(it.mod_rev, it)]
        self._wal_gen = snap_gen
        wal_path = os.path.join(data_dir, "coord.wal")
        if os.path.exists(wal_path):
            with open(wal_path, encoding="utf-8") as f:
                first = True
                skip = False
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        break  # torn tail write from a crash — stop here
                    if first:
                        first = False
                        if rec.get("o") == "hdr":
                            if rec["gen"] != snap_gen:
                                # Stale WAL beside a newer snapshot (a
                                # crash between snapshot-replace and
                                # WAL-truncate): every record here is
                                # already folded into the snapshot.
                                skip = True
                            continue
                        # Headerless WAL (pre-compaction, or legacy):
                        # belongs to generation 0 — apply only if the
                        # snapshot agrees.
                        skip = snap_gen != 0
                    if not skip:
                        self._apply(rec)
        now = time.monotonic()
        for lease in self._leases.values():
            lease.expires_at = now + lease.ttl
        if self._kv or self._members:
            log.info("coordination state recovered", kv={
                "rev": self._rev, "keys": len(self._kv),
                "leases": len(self._leases), "members": len(self._members),
            })

    def _apply(self, rec: dict) -> None:
        """Replay one WAL record through the normal mutation paths
        (``self._wal`` is still None, so nothing re-logs)."""
        op = rec["o"]
        if op == "p":
            self.put(rec["k"], rec["v"], rec.get("l", 0))
        elif op == "d":
            self._delete_keys(rec["ks"])
        elif op == "g":
            got = self.grant(rec["ttl"])
            if got != rec["id"]:
                raise CoordinationError(
                    f"WAL replay diverged: granted lease {got}, "
                    f"log says {rec['id']} — refusing to recover from a "
                    "corrupt log")
        elif op == "r" or op == "x":
            self.revoke(rec["id"])
        elif op == "ma":
            self.member_add(rec["n"], rec["a"], rec.get("md") or {})
        elif op == "mp":
            self.member_promote(rec["id"])
        elif op == "mr":
            self.member_remove(rec["id"])

    # ------------------------------------------------------------------ KV

    def _check_fence(self) -> None:
        """Refuse the operation when a quorum fence is active. Set by
        CoordServer when a witness is configured, so the seed's OWN
        in-process callers (LocalCoord — registry, store) fence
        exactly like remote clients do: a minority-partition primary
        must not keep serving its co-located application either."""
        f = self.fence
        if f is not None:
            msg = f()
            if msg:
                raise CoordinationError(msg)

    def put(self, key: str, value: str, lease: int = 0) -> int:
        self._check_fence()
        if not key:
            raise CoordinationError("put: empty key")
        with self._lock:
            if lease:
                lr = self._leases.get(lease)
                if lr is None:
                    raise CoordinationError(f"put: lease {lease} not found")
                lr.keys.add(key)
            self._rev += 1
            prev = self._kv.get(key)
            item = KVItem(
                key=key,
                value=value,
                create_rev=prev.create_rev if prev else self._rev,
                mod_rev=self._rev,
                version=(prev.version + 1) if prev else 1,
                lease=lease,
            )
            self._kv[key] = item
            self._append_locked({"o": "p", "k": key, "v": value, "l": lease})
            self._notify([Event(EventType.PUT, key, value, self._rev)])
            return self._rev

    def range(self, key: str, options: RangeOptions | None = None) -> RangeResult:
        self._check_fence()
        opts = options or RangeOptions()
        with self._lock:
            lo, hi = self._bounds(key, opts)
            if opts.rev:
                if opts.rev > self._rev:
                    raise CoordinationError(
                        f"range: revision {opts.rev} is in the future "
                        f"(head {self._rev})")
                if opts.rev < self._compacted_rev:
                    raise CoordinationError(
                        f"range: revision {opts.rev} has been "
                        f"compacted (floor {self._compacted_rev})")
                items = []
                for k in self._hist:
                    if lo <= k and (hi is None or k < hi):
                        it = self._item_at(k, opts.rev)
                        if it is not None:
                            items.append(it)
            else:
                items = [
                    it for k, it in self._kv.items()
                    if lo <= k and (hi is None or k < hi)
                ]
            if opts.min_mod_rev:
                items = [it for it in items if it.mod_rev >= opts.min_mod_rev]
            items = self._sort(items, opts)
            count = len(items)
            if opts.limit > 0:
                items = items[: opts.limit]
            if opts.count_only:
                items = []
            elif opts.keys_only:
                items = [replace(it, value="") for it in items]
            return RangeResult(items=items, count=count, revision=self._rev)

    def delete(self, key: str, options: RangeOptions | None = None) -> int:
        self._check_fence()
        opts = options or RangeOptions()
        with self._lock:
            lo, hi = self._bounds(key, opts)
            doomed = [
                k for k in self._kv
                if lo <= k and (hi is None or k < hi)
            ]
            if not doomed:
                return 0
            n = self._delete_keys(doomed)
            self._append_locked({"o": "d", "ks": doomed})
            return n

    def _delete_keys(self, doomed: list[str]) -> int:
        """Remove resolved keys + bump rev once (live delete + replay)."""
        with self._lock:
            self._rev += 1
            events = []
            for k in doomed:
                item = self._kv.pop(k, None)
                if item is None:
                    continue
                if item.lease and item.lease in self._leases:
                    self._leases[item.lease].keys.discard(k)
                events.append(Event(EventType.DELETE, k, "", self._rev))
            self._notify(events)
            return len(events)

    @staticmethod
    def _bounds(key: str, opts: RangeOptions) -> tuple[str, str | None]:
        """Resolve (lo, hi) key bounds; hi=None means single exact key."""
        if opts.prefix:
            end = prefix_range_end(key)
            return key, (None if end == "\0" else end) or "￿" * 8
        if opts.range_end:
            return key, opts.range_end
        if opts.from_key:
            return key, "￿" * 8
        # exact key: model as [key, key+minimal-successor)
        return key, key + "\0"

    @staticmethod
    def _sort(items: list[KVItem], opts: RangeOptions) -> list[KVItem]:
        keyfns = {
            SortTarget.KEY: lambda it: it.key,
            SortTarget.VERSION: lambda it: it.version,
            SortTarget.CREATE: lambda it: it.create_rev,
            SortTarget.MOD: lambda it: it.mod_rev,
            SortTarget.VALUE: lambda it: it.value,
        }
        if opts.sort_order is SortOrder.NONE:
            # etcd returns key-ascending by default
            return sorted(items, key=lambda it: it.key)
        return sorted(
            items,
            key=keyfns[opts.sort_target],
            reverse=opts.sort_order is SortOrder.DESCEND,
        )

    # --------------------------------------------------------------- leases

    def grant(self, ttl: float) -> int:
        self._check_fence()
        if ttl <= 0:
            raise CoordinationError("grant: ttl must be > 0")
        with self._lock:
            lease_id = self._next_lease
            self._next_lease += 1
            self._leases[lease_id] = Lease(
                id=lease_id, ttl=ttl, expires_at=time.monotonic() + ttl
            )
            self._append_locked({"o": "g", "id": lease_id, "ttl": ttl})
            return lease_id

    def keepalive(self, lease_id: int) -> float:
        """Refresh a lease; returns the new TTL. Raises if expired/unknown."""
        self._check_fence()
        f = chaos.hit("coord.keepalive", str(lease_id))
        if f is not None and f.action == "revoke":
            # Lease-revoke a member the SIGKILL way: the lease dies
            # server-side and this keepalive fails exactly like one for
            # an expired lease ("not found" routes the registration to
            # its re-register path).
            self.revoke(lease_id)
            raise CoordinationError(
                f"chaos: keepalive: lease {lease_id} not found "
                f"(revoked by fault injection)")
        with self._lock:
            lease = self._leases.get(lease_id)
            if lease is None:
                raise CoordinationError(f"keepalive: lease {lease_id} not found")
            lease.expires_at = time.monotonic() + lease.ttl
            return lease.ttl

    def revoke(self, lease_id: int) -> None:
        self._check_fence()
        with self._lock:
            lease = self._leases.pop(lease_id, None)
            if lease is None:
                return
            self._append_locked({"o": "r", "id": lease_id})
            self._expire_keys_locked(lease)

    def _expire_keys_locked(self, lease: Lease) -> None:
        events = []
        if lease.keys:
            self._rev += 1
        for k in sorted(lease.keys):
            if k in self._kv and self._kv[k].lease == lease.id:
                del self._kv[k]
                events.append(Event(EventType.DELETE, k, "", self._rev))
        if events:
            self._notify(events)

    def _sweep_loop(self) -> None:
        while not self._closed.wait(self._sweep_interval):
            now = time.monotonic()
            with self._lock:
                expired = [
                    l for l in self._leases.values() if l.expires_at <= now
                ]
                for lease in expired:
                    del self._leases[lease.id]
                    self._append_locked({"o": "x", "id": lease.id})
                    self._expire_keys_locked(lease)

    # -------------------------------------------------------------- watches

    def watch(self, prefix: str, start_rev: int = 0) -> Watch:
        """Stream events under ``prefix``. ``start_rev`` > 0 first
        replays every retained event with ``mod_rev >= start_rev``
        (etcd watch start-revision semantics) atomically with the
        arm — the reconnect-resume primitive: a client that saw
        through revision R re-watches with ``start_rev=R+1`` and
        misses nothing, without a snapshot re-list. Raises when the
        requested interval has been compacted (caller falls back to
        snapshot-then-delta)."""
        self._check_fence()
        with self._lock:
            if start_rev and start_rev <= self._event_floor:
                raise CoordinationError(
                    f"watch: start revision {start_rev} has been "
                    f"compacted (floor {self._event_floor + 1})")
            if start_rev > self._rev + 1:
                # The interval [head+1, start_rev) is not covered by
                # this state's history — the client is resuming
                # against a RESET state (fresh data_dir). Claiming
                # continuity would silently skip the gap; report it as
                # compacted so the client re-lists.
                raise CoordinationError(
                    f"watch: start revision {start_rev} is ahead of "
                    f"head {self._rev} — uncovered interval, treat "
                    f"as compacted")
            w = Watch(self._next_watch, prefix, self._remove_watch)
            w.last_rev = w.arm_rev = self._rev
            self._next_watch += 1
            if start_rev:
                replay = [ev for ev in self._event_log
                          if ev.mod_rev >= start_rev
                          and ev.key.startswith(prefix)]
                if replay:
                    w._push(replay)
            self._watches.append(w)
            return w

    def _remove_watch(self, w: Watch) -> None:
        with self._lock:
            if w in self._watches:
                self._watches.remove(w)

    # ---------------------------------------------------------- replication

    def repl_subscribe(self) -> ReplFeed:
        """Subscribe a WAL follower: the feed's first item is a full
        state snapshot taken atomically with the subscription (no
        mutation can fall between the snapshot and the record stream),
        then every subsequent mutation's WAL record in commit order.
        The standby's :class:`~ptype_tpu_torch.coord.standby.WalFollower`
        mirrors these into its own data_dir so promotion replays
        locally — control-plane failover without a shared filesystem.
        """
        with self._lock:
            feed = ReplFeed(self._next_repl, self._remove_repl)
            self._next_repl += 1
            feed._push("snap", self._snapshot_dict_locked(), self._repl_seq)
            self._repl_feeds.append(feed)
            return feed

    def _remove_repl(self, feed: ReplFeed) -> None:
        with self._lock:
            if feed in self._repl_feeds:
                self._repl_feeds.remove(feed)
            # A sync-put waiter blocked on this (now dead) feed must
            # re-evaluate against the surviving membership.
            self._ack_cond.notify_all()

    def note_repl_ack(self, feed: ReplFeed, seq: int) -> None:
        """A follower acknowledged mirroring through ``seq``."""
        with self._lock:
            feed.last_hb = time.monotonic()  # an ack proves liveness too
            if seq > feed.acked:
                feed.acked = seq
                self._ack_cond.notify_all()

    def note_repl_hb(self, feed: ReplFeed) -> None:
        """A follower answered a heartbeat (live round-trip)."""
        feed.last_hb = time.monotonic()

    def has_live_follower(self, within: float) -> bool:
        """True when some follower completed a round-trip within
        ``within`` seconds — the standby's quorum vote."""
        return self.last_follower_contact(within) is not None

    def last_follower_contact(self, within: float) -> float | None:
        """Monotonic stamp of the NEWEST follower round-trip no older
        than ``within`` seconds, or None. The quorum loop anchors the
        follower vote's serving window to this stamp (not to "now"):
        granting a fresh full TTL against an almost-TTL-old heartbeat
        let a primary serve up to ~2×TTL past its last real contact —
        overlapping a successor's lease (ADVICE.md, quorum self-fence
        window)."""
        now = time.monotonic()
        with self._lock:
            stamps = [f.last_hb for f in self._repl_feeds
                      if not f.closed and now - f.last_hb <= within]
        return max(stamps) if stamps else None

    def wait_replicated(self, seq: int | None = None,
                        timeout: float | None = None,
                        min_followers: int = 0) -> bool:
        """Block until every replication follower that was attached AT
        BARRIER START has acknowledged mirroring through ``seq``
        (default: everything so far) — the sync-put barrier, the
        closest 2-node analog of a raft quorum commit. With no
        followers attached it returns True immediately (there is
        nobody to replicate to) — but a follower that dies or
        overflows MID-barrier without acking fails the barrier: its
        mirror may not hold the record, and "success because the
        witness vanished" is exactly the silent loss this feature
        exists to prevent. False on timeout/death: the mutation IS
        applied locally; only the replication guarantee is unmet.

        ``min_followers``: RAISE (rather than trivially succeed) when
        fewer than this many live followers are attached at barrier
        start — the zero-follower windows (follower reconnect after a
        drop, post-overflow re-sync) are exactly when a deployment
        that RUNS a standby must not get an indistinguishable
        unreplicated ack. The refusal is a distinct error (not the
        timeout's False): the record is definitely unreplicated and
        the mirror is DOWN, which an operator debugs differently from
        a slow mirror. Degraded acks with min_followers unset are
        logged (rate-limited) so they are at least observable."""
        if timeout is None:
            timeout = DEFAULT_SYNC_TIMEOUT
        deadline = time.monotonic() + timeout
        degraded = False
        with self._ack_cond:
            if seq is None:
                seq = self._repl_seq
            waiting = [f for f in self._repl_feeds if not f.closed]
            if len(waiting) < min_followers:
                raise CoordinationError(
                    f"sync barrier refused: {len(waiting)} live "
                    f"follower(s) attached, {min_followers} required "
                    f"(record is NOT replicated; the standby is down "
                    f"or mid-reconnect)")
            degraded = not waiting
            ok = False
            while True:
                if all(f.acked >= seq for f in waiting):
                    ok = True
                    break
                if any(f.closed and f.acked < seq for f in waiting):
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._ack_cond.wait(remaining)
        if degraded:
            # Outside the lock (a stalling log sink must not serialize
            # the whole coordinator) and rate-limited (a standby-less
            # deployment sync-putting in a loop would emit thousands).
            now = time.monotonic()
            if now - getattr(self, "_degraded_log_t", 0.0) > 10.0:
                self._degraded_log_t = now
                log.warning(
                    "sync put acked with ZERO followers attached "
                    "(unreplicated; set sync_min_followers to fail "
                    "instead)", kv={"seq": seq})
        return ok

    def _notify(self, events: list[Event]) -> None:
        # called under self._lock
        for ev in events:
            self._record_event_locked(ev)
        for w in self._watches:
            batch = [ev for ev in events if ev.key.startswith(w.prefix)]
            if batch:
                w._push(batch)

    def _record_event_locked(self, ev: Event) -> None:
        """Feed the bounded MVCC history (under the lock). Every
        mutation path funnels through _notify, so this is the single
        point where both the watch-replay log and the per-key version
        chains grow — and where they are compacted."""
        self._event_log.append(ev)
        item = self._kv.get(ev.key) if ev.type is EventType.PUT else None
        self._hist.setdefault(ev.key, []).append((ev.mod_rev, item))
        self._hist_log.append((ev.mod_rev, ev.key))
        while len(self._event_log) > self._history_window:
            self._event_floor = self._event_log.popleft().mod_rev
        while len(self._hist_log) > self._history_window:
            m, k = self._hist_log.popleft()
            if m > self._compacted_rev:
                self._compacted_rev = m
            lst = self._hist.get(k)
            if not lst:
                continue
            # Keep only the NEWEST entry at-or-below the floor as the
            # key's base version (etcd compaction semantics) …
            while len(lst) > 1 and lst[1][0] <= m:
                lst.pop(0)
            # … and a tombstone base is indistinguishable from "no
            # history" (the key is absent either way): drop it fully.
            if lst and lst[0][0] <= m and lst[0][1] is None:
                lst.pop(0)
            if not lst:
                del self._hist[k]

    def _item_at(self, key: str, rev: int) -> KVItem | None:
        """The key's state as of ``rev`` (under the lock): the newest
        version chained at-or-below it. None = absent (never existed
        in the retained window, or tombstoned)."""
        best = None
        for r, item in self._hist.get(key, ()):
            if r > rev:
                break
            best = item
        return best

    # -------------------------------------------------------------- members

    def member_add(self, name: str, peer_addr: str, metadata: dict | None = None) -> Member:
        self._check_fence()
        with self._lock:
            m = Member(
                id=self._next_member,
                name=name,
                peer_addr=peer_addr,
                metadata=metadata or {},
            )
            self._next_member += 1
            self._members[m.id] = m
            self._append_locked({"o": "ma", "id": m.id, "n": m.name,
                          "a": m.peer_addr, "md": m.metadata})
            return m

    def member_promote(self, member_id: int) -> Member:
        """Clear a member's ``learner`` flag — the analog of the
        reference's MemberPromote in the learner add→catch-up→promote
        lifecycle (cluster.go:120-147, 183-195). Idempotent; WAL-logged
        so the promoted status survives coordinator restart."""
        self._check_fence()
        with self._lock:
            m = self._members.get(member_id)
            if m is None:
                raise CoordinationError(
                    f"member_promote: member {member_id} not found")
            md = dict(m.metadata)
            md["learner"] = False
            promoted = replace(m, metadata=md)
            self._members[member_id] = promoted
            self._append_locked({"o": "mp", "id": member_id})
            return promoted

    def member_remove(self, member_id: int) -> bool:
        self._check_fence()
        with self._lock:
            gone = self._members.pop(member_id, None) is not None
            if gone:
                self._append_locked({"o": "mr", "id": member_id})
            return gone

    def member_list(self) -> list[Member]:
        self._check_fence()
        with self._lock:
            return sorted(self._members.values(), key=lambda m: m.id)

    # ------------------------------------------------------------- barriers

    def barrier(self, name: str, count: int, timeout: float | None = None) -> bool:
        """Block until ``count`` participants reach the named barrier.

        The reference got step-ordering for free from raft linearizability;
        collective Store epochs need an explicit rendezvous (SURVEY.md §7
        hard part: "barrier/epoch notion absent from the reference").
        """
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._barrier_cond:
            b = self._barriers.setdefault(name, {"arrived": 0, "gen": 0})
            gen = b["gen"]
            b["arrived"] += 1
            if b["arrived"] >= count:
                b["arrived"] = 0
                b["gen"] += 1
                self._barrier_cond.notify_all()
                return True
            while b["gen"] == gen:
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        b["arrived"] = max(0, b["arrived"] - 1)
                        return False
                self._barrier_cond.wait(remaining)
            return True

    # ---------------------------------------------------------------- misc

    @property
    def revision(self) -> int:
        with self._lock:
            return self._rev

    @property
    def term(self) -> int:
        with self._lock:
            return self._term

    def close(self) -> None:
        self._closed.set()
        with self._lock:
            watches = list(self._watches)
            feeds = list(self._repl_feeds)
            if self._wal is not None:
                try:
                    self._wal.close()
                except OSError:
                    pass
                self._wal = None
            if self._flock is not None:
                try:
                    self._flock.close()  # releases the WAL-dir fence
                except OSError:
                    pass
                self._flock = None
        for w in watches:
            w.cancel()
        for feed in feeds:
            feed.cancel()
