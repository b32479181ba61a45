"""HARQ chase-combining cache: LLR accumulation across retransmissions.

Host copy of ``ria_tpu/fec/chase.py`` (numpy and a clock only).

Contract from the reference (src/fec/chase_cache.{hpp,cpp}):
- keyed by (seq, src_hash, dst_hash); per-codeword 648-LLR accumulators;
- store() of a failed CW ADDS LLRs elementwise (chase_cache.cpp:81) —
  ~3 dB gain per doubling of combines; MAX_COMBINES=4 per CW;
- per-CW decoded flags stop further combining; 16 entries, 30 s TTL with
  LRU-style eviction; hit/miss/store/combine/recovery stats.

The TTL runs on ``clock`` (seconds): ``time.monotonic`` when none is given,
as in the reference, and a station's own protocol time when a ``Station``
owns the cache.  The reference's stations keep the wall clock, so in its
simulator a slower host expires entries after fewer simulated blocks and a
session's outcome depends on the host's speed; the port's does not.

Host-side state (protocol control plane); the LLR adds are numpy on 648-float
vectors — negligible next to decode, which stays batched on the device.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

LDPC_BLOCK_SIZE = 648
MAX_COMBINES = 4


@dataclass(frozen=True)
class ChaseKey:
    seq: int
    src_hash: int
    dst_hash: int


@dataclass
class ChaseEntry:
    total_cw: int
    frame_type: int
    cw_soft: dict = field(default_factory=dict)       # cw_idx -> np[648]
    cw_combines: dict = field(default_factory=dict)   # cw_idx -> int
    cw_decoded: set = field(default_factory=set)
    created: float = 0.0
    last_access: float = 0.0


@dataclass
class ChaseStats:
    cache_hits: int = 0
    cache_misses: int = 0
    stores: int = 0
    combines: int = 0
    entries_evicted: int = 0
    entries_expired: int = 0
    recoveries: int = 0


class ChaseCache:
    def __init__(self, enabled: bool = True, max_entries: int = 16,
                 entry_ttl_s: float = 30.0, clock=None):
        self.enabled = enabled
        self.clock = clock
        self.max_entries = max_entries
        self.entry_ttl_s = entry_ttl_s
        self._cache: dict[ChaseKey, ChaseEntry] = {}
        self.stats = ChaseStats()

    def _now(self) -> float:
        return time.monotonic() if self.clock is None else self.clock()

    def _prune(self, now: float) -> None:
        expired = [k for k, e in self._cache.items()
                   if now - e.last_access > self.entry_ttl_s]
        for k in expired:
            del self._cache[k]
            self.stats.entries_expired += 1
        while len(self._cache) >= self.max_entries:
            oldest = min(self._cache, key=lambda k: self._cache[k].last_access)
            del self._cache[oldest]
            self.stats.entries_evicted += 1

    def store(self, key: ChaseKey, cw_index: int, soft_bits: np.ndarray,
              total_cw: int, frame_type: int) -> bool:
        """Store/combine soft bits from a failed CW decode. Returns stored?"""
        if not self.enabled:
            return False
        now = self._now()
        entry = self._cache.get(key)
        if entry is None:
            self._prune(now)
            entry = ChaseEntry(total_cw=total_cw, frame_type=frame_type, created=now)
            self._cache[key] = entry
        entry.last_access = now
        if cw_index in entry.cw_decoded:
            return False
        count = entry.cw_combines.get(cw_index, 0)
        if count >= MAX_COMBINES:
            return False
        soft = np.asarray(soft_bits, np.float32)[:LDPC_BLOCK_SIZE]
        if cw_index in entry.cw_soft:
            entry.cw_soft[cw_index] = entry.cw_soft[cw_index] + soft
            self.stats.combines += 1
        else:
            entry.cw_soft[cw_index] = soft.copy()
        entry.cw_combines[cw_index] = count + 1
        self.stats.stores += 1
        return True

    def get_combined(self, key: ChaseKey, cw_index: int) -> np.ndarray | None:
        entry = self._cache.get(key)
        if entry is None or cw_index not in entry.cw_soft:
            self.stats.cache_misses += 1
            return None
        entry.last_access = self._now()
        self.stats.cache_hits += 1
        return entry.cw_soft[cw_index]

    def get_combine_count(self, key: ChaseKey, cw_index: int) -> int:
        entry = self._cache.get(key)
        return entry.cw_combines.get(cw_index, 0) if entry else 0

    def mark_decoded(self, key: ChaseKey, cw_index: int) -> None:
        entry = self._cache.get(key)
        if entry:
            entry.cw_decoded.add(cw_index)

    def remove(self, key: ChaseKey) -> None:
        self._cache.pop(key, None)

    def clear(self) -> None:
        self._cache.clear()

    def __len__(self) -> int:
        return len(self._cache)
