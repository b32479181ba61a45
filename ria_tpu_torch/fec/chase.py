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

:func:`chase_round` is the same walk for a batch of channels on the device,
every copy of a frame at hand at once (``phy/pipeline.py::HarqRxPipeline``):
the cache's adds and decisions as ``where``s over fixed-width tensors, with
no read back to the host.  :data:`CHASE_ROUNDS` counts its rounds, the
copies they held and the sum rows they handed the decoder.
"""

from __future__ import annotations

import collections
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, NamedTuple

import numpy as np
import torch

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


# Rounds of :func:`chase_round` since start-up (or since a caller last
# cleared it): "rounds", the channels' "copies" and the "sum_rows" handed to
# the decoder.  Every number is known on the host, so counting costs no
# device sync; it moves under a lock, as stations decode from threads.
CHASE_ROUNDS: collections.Counter[str] = collections.Counter()
_ROUNDS_LOCK = threading.Lock()


class ChaseOutcome(NamedTuple):
    cw_success: torch.Tensor  # [B, NCW] bool
    info_bits: torch.Tensor   # [B, NCW, k] uint8
    iterations: torch.Tensor  # [B, NCW] int32
    source: torch.Tensor      # [B, NCW] int8: the walk position that decoded, -1 none


def walk_position(copy: int, combined: bool) -> int:
    """The place in the walk of copy ``copy`` (0-based) decoded alone, or of
    the sum of the copies up to it: copy 1, copy 2, sum 1-2, copy 3, ..."""
    return 2 * copy if combined else max(2 * copy - 1, 0)


def chase_round(llrs: torch.Tensor, received: torch.Tensor, alone,
                decode: Callable[[torch.Tensor], object]) -> ChaseOutcome:
    """One HARQ round over every channel's copies of one frame, as
    ``wave/api.py::_chase_combine`` walks them through a :class:`ChaseCache`.

    ``llrs`` [B, R, NCW, n] are each copy's codeword LLRs in arrival order
    (1 <= R <= :data:`MAX_COMBINES`), ``received`` [B, R] whether the sync
    found the copy, ``alone`` the decode of every copy's rows on its own
    (``llrs`` flattened, one call), and ``decode`` ([rows, n] -> a result
    with ``success``, ``info_bits``, ``iterations``) decodes the sums.

    For each codeword the walk runs: copy 1 alone; then, for r = 2..R, copy
    r alone and the sum of the copies received up to r (where r itself was
    received and the sum holds two or more), stopping at the first decode
    that succeeds.  A copy not received is no decode: it adds nothing to a
    sum.  Sums add left to right in float32, the first term copied, as
    :meth:`ChaseCache.store` adds.  The outcome is the decode that stopped
    the walk or, where none succeeded, the last one tried (copy 1 alone
    where none was); ``source`` is its :func:`walk_position`, -1 where none
    succeeded.  Each sum is one ``decode`` call of B * NCW rows, those that
    need no sum zeroed, so R - 1 calls in all."""
    B, R, ncw, n = llrs.shape
    if not 1 <= R <= MAX_COMBINES:
        raise ValueError(f"{R} copies; a codeword combines at most {MAX_COMBINES}")
    with _ROUNDS_LOCK:
        CHASE_ROUNDS["rounds"] += 1
        CHASE_ROUNDS["copies"] += B * R
        CHASE_ROUNDS["sum_rows"] += (R - 1) * B * ncw
    k = alone.info_bits.shape[-1]
    got = received[:, :, None].expand(B, R, ncw)
    ok = alone.success.reshape(B, R, ncw) & got
    bits = alone.info_bits.reshape(B, R, ncw, k)
    its = alone.iterations.reshape(B, R, ncw)

    done = ok[:, 0]
    source = torch.where(done, 0, -1).to(torch.int8)
    info, iters = bits[:, 0], its[:, 0]
    acc = torch.where(got[:, 0, :, None], llrs[:, 0], 0.0)
    held = got[:, 0].int()

    def settle(tried, success, new_bits, new_its, position):
        nonlocal done, source, info, iters
        info = torch.where(tried[..., None], new_bits, info)
        iters = torch.where(tried, new_its, iters)
        won = tried & success
        source = torch.where(won, position, source)
        done = done | won

    for r in range(1, R):
        now = got[:, r]
        settle(now & ~done, ok[:, r], bits[:, r], its[:, r], walk_position(r, False))
        acc = torch.where(now[..., None], torch.where(held[..., None] > 0, acc + llrs[:, r],
                                                      llrs[:, r]), acc)
        held = held + now.int()
        need = now & ~done & (held >= 2)
        rows = torch.where(need[..., None], acc, 0.0).reshape(B * ncw, n)
        s = decode(rows)
        settle(need, s.success.reshape(B, ncw), s.info_bits.reshape(B, ncw, k),
               s.iterations.reshape(B, ncw), walk_position(r, True))
    return ChaseOutcome(done, info, iters, source)
