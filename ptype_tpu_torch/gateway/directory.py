"""Global prefix directory: the fleet's KV cache as ONE index — the
port's copy of ``ptype_tpu/gateway/directory.py``.

Disaggregated serving makes the decode pick a cache-
placement decision: the router should land a migration on the decode
replica that already holds the prompt's prefix blocks, so the wire
ships only the divergent tail. Per-replica prefix caches answer "do
*I* hold this block"; this directory answers "who in the FLEET holds
it" — keyed by the same FNV-1a chain-hash family
(:func:`~ptype_tpu_torch.serve_engine.blocks.block_hashes`) the pools dedup
with, so a directory hit and a pool hit are the same statement about
the same bytes.

Three contracts, each the fleet-level twin of a :class:`BlockPool`
invariant:

- **content-verified lookup** — a chain hash is 32 bits; the
  directory stores ``hash -> content`` per replica and a lookup
  whose content mismatches is a MISS, never a wrong route (the exact
  ``BlockPool.lookup`` collision contract).
- **eviction coherence** — a decode replica frees blocks under LRU
  pressure without telling anyone. Every replica exports a
  monotonic ``kv_evictions`` counter (``BlockPool.stats``); the
  router feeds the latest observed value through
  :meth:`note_evictions` BEFORE trusting the replica's entries, and
  any advance drops them all — conservative (the directory cannot
  know WHICH block the LRU reclaimed), so a stale entry can cost a
  re-send but never a mis-route.
- **death/restart coherence** — entries for a dead replica are
  harmless (the router only scores healthy candidates) and are
  reaped by :meth:`drop_replica` when the fleet watcher confirms the
  departure. A replica that RESTARTS under the same key comes back
  with a fresh pool and an eviction counter reset to 0 — observed as
  ``evictions < seen``, which also drops the stale entries (the same
  counter-went-backwards reset the pool's TTFT drain applies).

Everything here is advisory: the decode replica's ``MigratePlan``
re-verifies residency against its own pool (content-checked ref or
nothing), so a wrong directory answer degrades bandwidth, never
correctness.
"""

from __future__ import annotations

import collections

from ptype_tpu_torch import lockcheck, logs

log = logs.get_logger("gateway.directory")


class PrefixDirectory:
    """``chain hash -> content`` per replica, bounded LRU per replica.

    ``max_blocks`` bounds each replica's entry count (oldest published
    first out) — the directory is a routing accelerator, not a mirror
    of every pool's full residency.
    """

    def __init__(self, max_blocks: int = 4096):
        self.max_blocks = int(max_blocks)
        self._lock = lockcheck.lock("gateway.directory")
        #: replica key -> OrderedDict[hash, content tuple] (LRU).
        self._blocks: dict[str, collections.OrderedDict] = {}
        #: replica key -> kv_evictions counter at last coherence check.
        self._seen_evictions: dict[str, int] = {}

    # ------------------------------------------------------------ publish

    def publish(self, replica: str, entries) -> int:
        """Record that ``replica`` holds ``entries`` — an iterable of
        ``(chain_hash, content)`` pairs (content: the block's token
        tuple, the pool's own verify key). Returns how many entries
        the replica now has."""
        with self._lock:
            d = self._blocks.setdefault(replica,
                                        collections.OrderedDict())
            for h, content in entries:
                h = int(h)
                d.pop(h, None)
                d[h] = tuple(int(t) for t in content)
            while len(d) > self.max_blocks:
                d.popitem(last=False)
            return len(d)

    # ---------------------------------------------------------- coherence

    def note_evictions(self, replica: str,
                       evictions: int | None) -> bool:
        """Feed the replica's latest reported ``kv_evictions``.
        Returns True when the counter moved (forward = LRU freed
        blocks; backward = the replica restarted with a fresh pool)
        and the replica's entries were dropped — the router must call
        this before trusting :meth:`holders`/:meth:`overlap` for the
        replica."""
        if evictions is None:
            return False
        evictions = int(evictions)
        with self._lock:
            seen = self._seen_evictions.get(replica)
            self._seen_evictions[replica] = evictions
            if seen is None or evictions == seen:
                return False
            dropped = self._blocks.pop(replica, None)
        log.info("prefix directory dropped replica entries",
                 kv={"replica": replica,
                     "entries": len(dropped or ()),
                     "evictions": evictions, "seen": seen,
                     "why": ("restart" if evictions < seen
                             else "lru eviction")})
        return True

    def drop_replica(self, replica: str) -> None:
        """The replica left the fleet: reap its entries (its state is
        gone with it; a restart re-publishes from scratch)."""
        with self._lock:
            self._blocks.pop(replica, None)
            self._seen_evictions.pop(replica, None)

    # ------------------------------------------------------------- lookup

    def holders(self, h: int, content) -> list[str]:
        """Replica keys holding the block — content-verified: a hash
        hit with different content is a collision and a MISS, the
        ``BlockPool.lookup`` contract fleet-wide."""
        want = tuple(int(t) for t in content)
        with self._lock:
            return sorted(
                r for r, d in self._blocks.items()
                if d.get(int(h)) == want)

    def overlap(self, replica: str, hashes, contents) -> int:
        """How many of the request's full blocks ``replica`` already
        holds (content-verified) — the decode-pick score."""
        with self._lock:
            d = self._blocks.get(replica)
            if not d:
                return 0
            n = 0
            for h, content in zip(hashes, contents):
                if d.get(int(h)) == tuple(int(t) for t in content):
                    n += 1
            return n

    # ---------------------------------------------------------- readouts

    def n_blocks(self, replica: str | None = None) -> int:
        with self._lock:
            if replica is not None:
                return len(self._blocks.get(replica, ()))
            return sum(len(d) for d in self._blocks.values())

    def stats(self) -> dict:
        with self._lock:
            return {"replicas": {r: len(d)
                                 for r, d in self._blocks.items()},
                    "blocks": sum(len(d)
                                  for d in self._blocks.values())}
