"""Block pool: device-resident paged KV storage + content addressing —
the port of ``ptype_tpu/serve_engine/blocks.py``.

One bank of fixed-size KV blocks ``(L, n_blocks, block_tokens, Kh,
Dh)`` backs every live sequence. Sequences hold block tables; position
``p`` lives in table entry ``p // block_tokens`` at offset
``p % block_tokens``. A block is active (refcount > 0), cached
(refcount 0, content-hashed, in an LRU for prefix reuse) or free.
Admission reserves a request's worst-case block count up front, so a
decode step never finds the pool empty. Block 0 is the trash block that
masked lanes write to.

Content addressing is a hash chain over block tokens built on FNV-1a
(:func:`fnv32a`, a copy of the reference's ``rpc.fnv32a``), so the keys
equal the reference's; lookups verify the stored tokens, so a 32-bit
collision is a miss, never silent reuse.
"""

from __future__ import annotations

import collections

import torch

from ptype_tpu_torch import lockcheck
from ptype_tpu_torch.models import transformer as tfm

#: block_tokens must divide by this (the reference's sublane alignment;
#: kept so both packages accept the same geometries).
SUBLANES = 8


def fnv32a(data: str) -> int:
    """FNV-1a 32-bit over the UTF-8 bytes of ``data``."""
    h = 0x811C9DC5
    for byte in data.encode("utf-8"):
        h ^= byte
        h = (h * 0x01000193) & 0xFFFFFFFF
    return h


def block_hashes(tokens, block_tokens: int) -> list[int]:
    """Chain hashes for every FULL block of ``tokens``: ``h_i`` commits
    to tokens ``[0, (i+1)·block_tokens)``."""
    out: list[int] = []
    h: int | None = None
    for i in range(len(tokens) // block_tokens):
        blk = tokens[i * block_tokens:(i + 1) * block_tokens]
        body = ",".join(str(int(t)) for t in blk)
        prefix = "" if h is None else f"{h:08x}|"
        h = fnv32a(prefix + body)
        out.append(h)
    return out


def prefix_affinity_key(tokens, block_tokens: int) -> str | None:
    """Routing key for a prompt: its first full block's chain hash."""
    hs = block_hashes(tokens[:block_tokens], block_tokens)
    return f"kv:{hs[0]:08x}" if hs else None


class BlockPool:
    """Ref-counted, content-addressed pool of KV blocks on ``device``.

    Mutating calls come from the engine thread; :meth:`stats` and
    :meth:`free_blocks` from others — all state sits under one lock.
    """

    def __init__(self, cfg: tfm.TransformerConfig, n_blocks: int,
                 block_tokens: int, device="cpu"):
        if block_tokens % SUBLANES:
            raise ValueError(
                f"block_tokens {block_tokens} must divide by {SUBLANES}")
        if n_blocks < 2:
            raise ValueError("n_blocks must be >= 2 (block 0 is the "
                             "reserved trash block)")
        self.block_tokens = int(block_tokens)
        self.n_blocks = int(n_blocks)
        shape = (cfg.n_layers, n_blocks, block_tokens, cfg.kv_heads,
                 cfg.head_dim)
        #: The banks, written in place by the engine's steps.
        self.k = torch.zeros(shape, dtype=cfg.dtype, device=device)
        self.v = torch.zeros(shape, dtype=cfg.dtype, device=device)
        self._lock = lockcheck.lock("serve_engine.pool")
        self._free: list[int] = list(range(1, n_blocks))
        self._cached: collections.OrderedDict[int, None] = \
            collections.OrderedDict()
        self._ref: dict[int, int] = {}
        self._hash_of: dict[int, int] = {}
        self._by_hash: dict[int, int] = {}
        self._content: dict[int, tuple] = {}
        self._reserved = 0
        self.evictions = 0
        self.sealed = 0

    @property
    def capacity(self) -> int:
        return self.n_blocks - 1

    def _available(self) -> int:
        return len(self._free) + len(self._cached)

    def free_blocks(self) -> int:
        with self._lock:
            return max(0, self._available() - self._reserved)

    def used_blocks(self) -> int:
        """Blocks held by live sequences (refcount > 0)."""
        with self._lock:
            return len(self._ref)

    def try_reserve(self, n: int) -> bool:
        with self._lock:
            if self._available() - self._reserved < n:
                return False
            self._reserved += n
            return True

    def unreserve(self, n: int) -> None:
        with self._lock:
            self._reserved = max(0, self._reserved - n)

    def alloc(self) -> int:
        """Materialize one reserved unit: free list first, else evict
        the LRU cached block."""
        with self._lock:
            if self._free:
                bid = self._free.pop()
            elif self._cached:
                bid, _ = self._cached.popitem(last=False)
                h = self._hash_of.pop(bid, None)
                if h is not None:
                    self._by_hash.pop(h, None)
                self._content.pop(bid, None)
                self.evictions += 1
            else:
                raise RuntimeError(
                    "block pool exhausted despite reservation — "
                    "reserve/acquire accounting is broken")
            self._ref[bid] = 1
            self._reserved = max(0, self._reserved - 1)
            return bid

    def ref(self, bid: int) -> None:
        """Reference a looked-up block (prefix reuse), consuming one
        reserved unit."""
        with self._lock:
            if self._ref.get(bid, 0) == 0:
                self._cached.pop(bid, None)
                self._ref[bid] = 1
            else:
                self._ref[bid] += 1
            self._reserved = max(0, self._reserved - 1)

    def deref(self, bid: int) -> None:
        """Drop a reference; at zero a hashed block parks in the LRU and
        an unhashed one frees."""
        with self._lock:
            n = self._ref.get(bid, 0) - 1
            if n > 0:
                self._ref[bid] = n
                return
            self._ref.pop(bid, None)
            if bid in self._hash_of:
                self._cached[bid] = None
                self._cached.move_to_end(bid)
            else:
                self._free.append(bid)

    def seal(self, bid: int, h: int, content) -> None:
        """Publish a fully written prompt block; first writer wins."""
        with self._lock:
            if h in self._by_hash:
                return
            self._hash_of[bid] = h
            self._by_hash[h] = bid
            self._content[bid] = tuple(int(t) for t in content)
            self.sealed += 1

    def lookup(self, h: int, content) -> int | None:
        with self._lock:
            bid = self._by_hash.get(h)
            if bid is None:
                return None
            want = tuple(int(t) for t in content)
            return bid if self._content.get(bid) == want else None

    def stats(self) -> dict:
        with self._lock:
            used = len(self._ref)
            cached = len(self._cached)
            free = len(self._free)
            return {
                "kv_total_blocks": self.capacity,
                "kv_used_blocks": used,
                "kv_cached_blocks": cached,
                "kv_free_blocks": max(0, free + cached - self._reserved),
                "kv_reserved_blocks": self._reserved,
                "kv_evictions": self.evictions,
                "kv_sealed_blocks": self.sealed,
                "kv_util_pct": round(100.0 * used / self.capacity, 2)
                if self.capacity else 0.0,
            }

    def check_invariants(self, spec_rows=()) -> list[str]:
        """Consistency audit: every block in exactly one lifetime, the
        hash index bijective, the reservation covered.

        ``spec_rows`` (speculative decoding): per live row ``(pos,
        nalloc, reserve_left, advance)``; each row's remaining
        reservation must cover the blocks of its worst-case
        ``advance``-token window from ``pos`` (block crossings inside
        the window included), so a verify step never finds the pool
        empty. ``PagedGeneratorActor.check_spec_reservations`` builds
        them."""
        bad: list[str] = []
        bt = self.block_tokens
        for i, (pos, nalloc, reserve_left, advance) in enumerate(spec_rows):
            need = -(-(int(pos) + int(advance)) // bt) - int(nalloc)
            if need > int(reserve_left):
                bad.append(
                    f"row {i}: reservation does not cover a {advance}-token "
                    f"advance from pos {pos} (needs {need} new blocks past "
                    f"its {nalloc} allocated, holds {reserve_left} reserved)")
        with self._lock:
            free, cached, active = (set(self._free), set(self._cached),
                                    set(self._ref))
            if free & cached or free & active or cached & active:
                bad.append("block in two lifetime sets")
            if len(free) + len(cached) + len(active) != self.capacity:
                bad.append(
                    f"lost blocks: {len(free)}+{len(cached)}+"
                    f"{len(active)} != {self.capacity}")
            if any(n <= 0 for n in self._ref.values()):
                bad.append("non-positive refcount")
            for h, bid in self._by_hash.items():
                if self._hash_of.get(bid) != h:
                    bad.append(f"hash index not bijective at {bid}")
            if not set(self._hash_of) >= cached:
                bad.append("cached block without a hash")
            if self._reserved > len(free) + len(cached):
                bad.append("reservation exceeds available blocks")
        return bad
