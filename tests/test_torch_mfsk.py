"""The port's MFSK (``ria_tpu_torch.wave.mfsk``) against ``ria_tpu.wave.mfsk``.

Mirrors ``tests/test_mfsk.py``: 2 (the BFSK preset), 4, 8 and 16 tones
through sweep sync and demodulation, the rejection of other sweeping
signals, and the reference's rule that a batched (not 1-D) window reads as
not detected.  The port and the jitted reference see the same numpy-noised
window: detected and start exact, score within 1e-3; soft bits within 2e-3
with equal signs, SNR within 1e-3, tone powers within 1e-5 of their
largest.  The TX is bit-equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ria_tpu.wave import mfsk as J
from ria_tpu_torch.fec.ldpc import decode_batch
from ria_tpu_torch.fec.ldpc_matrix import encode_np
from ria_tpu_torch.sync.chirp import ChirpConfig, generate
from ria_tpu_torch.wave import mc_dpsk
from ria_tpu_torch.wave import mfsk as T

torch.set_num_threads(1)

WINDOW = 96000


def _jcfg(cfg):
    return J.MFSKConfig(**dataclasses.asdict(cfg))


def _assert_sync_same(window, cfg):
    got = T.find_preamble(torch.as_tensor(window), cfg)
    want = J.find_preamble(window, _jcfg(cfg))
    assert bool(got.detected) == bool(want.detected)
    assert int(got.data_start) == int(want.data_start)
    assert abs(float(got.score) - float(want.score)) <= 1e-3
    return got


def _assert_demod_same(chunks, cfg, num_bits):
    got = T.demodulate(torch.as_tensor(chunks), cfg, num_bits)
    want = J.demodulate(chunks, _jcfg(cfg), num_bits)
    soft, w_soft = got.soft_bits.numpy(), np.asarray(want.soft_bits)
    assert soft.shape == w_soft.shape
    assert np.abs(soft - w_soft).max() <= 2e-3
    assert np.array_equal(np.sign(soft), np.sign(w_soft))
    assert np.allclose(got.snr_estimate_db.numpy(), np.asarray(want.snr_estimate_db),
                       rtol=0, atol=1e-3)
    w_pow = np.asarray(want.tone_powers)
    assert np.abs(got.tone_powers.numpy() - w_pow).max() <= 1e-5 * w_pow.max()
    return got


def test_tx_bit_equal():
    bits = np.random.default_rng(0).integers(0, 2, 651)
    for cfg in (T.MFSKConfig(num_tones=t) for t in (2, 4, 8, 16, 32)):
        assert np.array_equal(T.tx_frame(bits, cfg), J.tx_frame(bits, _jcfg(cfg)))
        assert np.array_equal(T._tone_bank(cfg), J._tone_bank(_jcfg(cfg)))
    assert dataclasses.asdict(T.bfsk_config()) == dataclasses.asdict(J.bfsk_config())
    assert T.bfsk_config(2, 3) == T.MFSKConfig(num_tones=2, repetition=2, preamble_cycles=3)


@pytest.mark.parametrize("tones,snr_db", [(8, -2.0), (4, -6.0), (16, 2.0), (2, -4.0)])
def test_loopback_matches_jax(tones, snr_db):
    """Two channels at random leads: sync on the first 96,000 samples (one
    channel at a time), demod of one R1/4 codeword, decode."""
    cfg = T.bfsk_config() if tones == 2 else T.MFSKConfig(num_tones=tones)
    rng = np.random.default_rng(tones)
    info = rng.integers(0, 2, (2, 162))
    frames = [T.tx_frame(c, cfg) for c in encode_np(info, "R1_4")]
    leads = rng.integers(0, 8000, 2)
    audio = np.zeros((2, len(frames[0]) + 8000), np.float32)
    for b in range(2):
        audio[b, leads[b] : leads[b] + len(frames[b])] = frames[b]
    rms = np.sqrt(np.mean(frames[0] ** 2))
    audio += rng.normal(0, rms * 10 ** (-snr_db / 20), audio.shape).astype(np.float32)
    need = cfg.num_symbols_for_bits(648) * cfg.repetition * cfg.samples_per_symbol
    chunks = np.zeros((2, need), np.float32)
    for b in range(2):
        sync = _assert_sync_same(audio[b, :WINDOW], cfg)
        assert bool(sync.detected)
        start = int(sync.data_start)
        assert abs(start - (leads[b] + cfg.preamble_samples)) <= cfg.samples_per_symbol // 2
        avail = audio[b, start : start + need]
        chunks[b, : len(avail)] = avail
    demod = _assert_demod_same(chunks, cfg, 648)
    dec = decode_batch(demod.soft_bits, np.full(2, 0.75, np.float32), "R1_4", device="cpu")
    assert dec.success.all() and np.array_equal(dec.info_bits.numpy(), info)


def test_batched_window_is_not_detected():
    cfg = T.MFSKConfig()
    audio = np.zeros((2, WINDOW), np.float32)
    frame = T.tx_frame(np.random.default_rng(5).integers(0, 2, 60), cfg)
    audio[:, 3000 : 3000 + len(frame)] = frame
    audio += np.random.default_rng(5).normal(0, 0.2, audio.shape).astype(np.float32)
    got = T.find_preamble(torch.as_tensor(audio), cfg)
    want = J.find_preamble(audio, _jcfg(cfg))
    assert got.detected.shape == (2,) and not got.detected.any()
    assert not np.asarray(want.detected).any()
    assert (got.data_start == -1).all()
    # Each row alone is found.
    assert bool(_assert_sync_same(audio[0], cfg).detected)
    # The detector module itself is batched, row by row.
    rows = T.mfsk_preamble_detector(cfg, WINDOW, "cpu")(torch.as_tensor(audio))
    assert rows.detected.all()
    assert (abs(rows.data_start - (3000 + cfg.preamble_samples)) <= 384).all()


def test_rejects_sweeping_interferers():
    """An up-chirp and an MC-DPSK preamble fail the sweep-match gate, while
    a true MFSK sweep at -8 dB is found."""
    cfg = T.MFSKConfig()
    rng = np.random.default_rng(3)

    def put(sig, snr_db):
        a = np.zeros(WINDOW, np.float32)
        n = min(len(sig), WINDOW - 2000)
        a[2000 : 2000 + n] = sig[:n]
        rms = np.sqrt(np.mean(sig[:n] ** 2))
        return a + rng.normal(0, rms * 10 ** (-snr_db / 20), WINDOW).astype(np.float32)

    for sig, snr, expect in [(T.generate_preamble(cfg), -8.0, True),
                             (generate(ChirpConfig()), 5.0, False),
                             (mc_dpsk.preamble(mc_dpsk.MCDPSKConfig()), 5.0, False)]:
        assert bool(_assert_sync_same(put(sig, snr), cfg).detected) == expect


def test_demod_noise_only_and_short_window():
    cfg = T.MFSKConfig(num_tones=4)
    rng = np.random.default_rng(8)
    noise = rng.normal(0, 0.3, (2, 3, 100 * cfg.repetition * cfg.samples_per_symbol))
    _assert_demod_same(noise.astype(np.float32), cfg, 200)
    short = rng.normal(0, 0.3, cfg.preamble_samples).astype(np.float32)
    assert not bool(_assert_sync_same(short, cfg).detected)
