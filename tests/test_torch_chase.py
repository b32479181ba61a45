"""The port's chase-combining cache (``ria_tpu_torch.fec.chase``) against ``ria_tpu.fec.chase``.

Mirrors ``tests/test_chase.py``: the cache operations, ``MAX_COMBINES``,
the TTL and LRU eviction (on a stubbed clock), and LLR combining that
rescues a decode, here through the port's plain decoder.  The same
operation sequence on both caches gives the same results, LLRs and stats.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ria_tpu.fec import chase as J
from ria_tpu_torch.fec import chase as T
from ria_tpu_torch.fec.ldpc import make_decoder
from ria_tpu_torch.fec.ldpc_matrix import encode_np, get_code

torch.set_num_threads(1)


class Clock:
    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    monkeypatch.setattr(T.time, "monotonic", c)
    return c


def test_constants_and_types():
    assert (T.LDPC_BLOCK_SIZE, T.MAX_COMBINES) == (J.LDPC_BLOCK_SIZE, J.MAX_COMBINES) == (648, 4)
    assert T.ChaseKey(1, 2, 3) == T.ChaseKey(1, 2, 3) and hash(T.ChaseKey(1, 2, 3))
    assert [f.name for f in dataclasses.fields(T.ChaseStats)] == \
        [f.name for f in dataclasses.fields(J.ChaseStats)]


def test_cache_ops():
    c = T.ChaseCache(max_entries=2, entry_ttl_s=30.0)
    k1 = T.ChaseKey(1, 0xAAA, 0xBBB)
    soft = np.ones(648, np.float32)
    assert c.store(k1, 0, soft, total_cw=4, frame_type=0x30)
    got = c.get_combined(k1, 0)
    assert got is not None and np.allclose(got, soft)
    assert c.store(k1, 0, soft * 2, total_cw=4, frame_type=0x30)     # combine adds
    assert np.allclose(c.get_combined(k1, 0), soft * 3)
    assert c.get_combine_count(k1, 0) == 2
    c.mark_decoded(k1, 0)                                            # decoded stops combining
    assert not c.store(k1, 0, soft, 4, 0x30)
    c.store(T.ChaseKey(2, 1, 1), 0, soft, 4, 0x30)                   # eviction at max_entries
    c.store(T.ChaseKey(3, 1, 1), 0, soft, 4, 0x30)
    assert len(c) <= 2
    assert c.get_combined(T.ChaseKey(9, 9, 9), 0) is None
    assert c.get_combine_count(T.ChaseKey(9, 9, 9), 0) == 0
    c.remove(T.ChaseKey(3, 1, 1))
    c.clear()
    assert len(c) == 0
    assert not T.ChaseCache(enabled=False).store(k1, 0, soft, 4, 0x30)


def test_max_combines_and_truncation():
    c = T.ChaseCache()
    k = T.ChaseKey(5, 1, 2)
    for _ in range(6):
        c.store(k, 0, np.ones(700, np.float64), 4, 0x30)
    assert c.get_combine_count(k, 0) == T.MAX_COMBINES
    got = c.get_combined(k, 0)
    assert got.dtype == np.float32 and got.shape == (648,) and np.all(got == 4.0)


def test_ttl_and_lru_eviction(clock):
    c = T.ChaseCache(max_entries=3, entry_ttl_s=30.0)
    soft = np.ones(648, np.float32)
    for seq in range(3):
        clock.now += 1.0
        c.store(T.ChaseKey(seq, 0, 0), 0, soft, 1, 0x30)
    clock.now += 1.0
    c.get_combined(T.ChaseKey(0, 0, 0), 0)              # key 0 becomes the newest
    clock.now += 1.0
    c.store(T.ChaseKey(3, 0, 0), 0, soft, 1, 0x30)      # evicts key 1, the oldest
    assert c.get_combine_count(T.ChaseKey(1, 0, 0), 0) == 0
    assert c.get_combine_count(T.ChaseKey(0, 0, 0), 0) == 1
    assert c.stats.entries_evicted == 1
    clock.now += 31.0                                   # everything expires
    c.store(T.ChaseKey(4, 0, 0), 0, soft, 1, 0x30)
    assert len(c) == 1 and c.stats.entries_expired == 3


def test_same_results_as_reference(clock, monkeypatch):
    monkeypatch.setattr(J.time, "monotonic", clock)
    rng = np.random.default_rng(0)
    caches = (T.ChaseCache(max_entries=4, entry_ttl_s=5.0),
              J.ChaseCache(max_entries=4, entry_ttl_s=5.0))
    for step in range(300):
        clock.now += float(rng.uniform(0, 0.5))
        op = int(rng.integers(0, 4))
        seq, cw = int(rng.integers(0, 7)), int(rng.integers(0, 3))
        soft = rng.normal(size=648).astype(np.float32)
        outs = []
        for mod, cache in zip((T, J), caches):
            key = mod.ChaseKey(seq, 1, 2)
            if op == 0:
                outs.append(cache.store(key, cw, soft, 3, 0x30))
            elif op == 1:
                outs.append(cache.get_combined(key, cw))
            elif op == 2:
                cache.mark_decoded(key, cw)
                outs.append(cache.get_combine_count(key, cw))
            else:
                outs.append(len(cache))
        if isinstance(outs[1], np.ndarray):
            assert np.array_equal(outs[0], outs[1])
        else:
            assert outs[0] == outs[1], step
    assert dataclasses.asdict(caches[0].stats) == dataclasses.asdict(caches[1].stats)


def test_chase_combining_rescues_decode():
    """Two failed receptions at 2 dB (R1/2 needs ~6 dB alone) combine into a
    decode, through the port's plain decoder."""
    rate = "R1_2"
    rng = np.random.default_rng(0)
    info = rng.integers(0, 2, size=(1, get_code(rate).k)).astype(np.uint8)
    coded = encode_np(info, rate)[0]
    decoder = make_decoder(rate, device="cpu")
    sigma = 10 ** (-2.0 / 20)
    cache = T.ChaseCache()
    key = T.ChaseKey(7, 0x111, 0x222)
    single = combined = 0
    trials = 6
    for _ in range(trials):
        cache.remove(key)
        llrs = [(2.0 * ((1.0 - 2.0 * coded) + rng.normal(0, sigma, coded.shape)) / sigma**2)
                .astype(np.float32) for _ in range(2)]
        single += int(decoder(torch.as_tensor(llrs[0][None])).success[0])
        for llr in llrs:
            cache.store(key, 0, llr, 1, 0x30)
        res = decoder(torch.as_tensor(cache.get_combined(key, 0)[None]))
        combined += int(res.success[0])
        if res.success[0]:
            assert np.array_equal(res.info_bits.numpy()[0], info[0])
    assert combined > single and combined >= trials - 1, (single, combined)
