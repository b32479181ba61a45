"""The port's ZC sync (``ria_tpu_torch.sync.zc``) against ``ria_tpu.sync.zc``.

Mirrors ``tests/test_zc_sync.py``: the four roots, CFOs inside the +-23.6 Hz
unambiguous range, noise-only and silent windows, the CFAR regime at -8 and
-10 dB and ``root_mask``.  The reference's tests draw from ``jax.random``;
here numpy noise is added and the port is held against the jitted reference
on the same array: detected, frame type, start and root index exact,
correlation and SNR within 1e-3, CFO within 1e-3 Hz.  The TX tables are
bit-equal.
"""

import numpy as np
import pytest
import torch

from ria_tpu.sync import zc as J
from ria_tpu_torch.sync import zc as T

torch.set_num_threads(1)

JCFG, TCFG = J.ZCConfig(), T.ZCConfig()


def _awgn(x, snr_db, rng):
    nz = np.abs(x) > 1e-6
    rms = np.sqrt(np.mean(x[nz] ** 2)) if nz.any() else 0.1
    return x + rng.normal(0, rms * 10 ** (-snr_db / 20), x.shape).astype(np.float32)


def _frame(ftype, lead, tail, snr_db, rng, cfo_hz=0.0):
    pre = J.generate_preamble(JCFG, ftype)
    if cfo_hz:
        # Analytic-signal frequency shift, as dsp.nco.freq_shift_real does.
        spec = np.fft.fft(pre.astype(np.float64))
        h = np.zeros(len(pre))
        h[0] = 1.0
        h[1 : (len(pre) + 1) // 2] = 2.0
        if len(pre) % 2 == 0:
            h[len(pre) // 2] = 1.0
        z = np.fft.ifft(spec * h)
        t = np.arange(len(pre)) / JCFG.sample_rate
        pre = np.real(z * np.exp(2j * np.pi * cfo_hz * t)).astype(np.float32)
    audio = np.concatenate([np.zeros(lead, np.float32), pre, np.zeros(tail, np.float32)])
    return _awgn(audio, snr_db, rng)


def _assert_same(audio, root_mask=J.ROOT_MASK_ALL, known_cfo_hz=0.0):
    got = T.detect(torch.as_tensor(audio), TCFG, root_mask, known_cfo_hz)
    want = J.detect(audio, JCFG, root_mask=root_mask, known_cfo_hz=known_cfo_hz)
    for name in ("detected", "frame_type", "start_sample", "root_index"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape and np.array_equal(g, w), name
    for name in ("correlation", "snr_estimate", "cfo_hz"):
        assert np.allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                           rtol=0, atol=1e-3), name
    return got


def test_tables_bit_equal():
    for root in (1, 3, 5, 7, 2):
        assert np.array_equal(T.zc_sequence(root, 127), J.zc_sequence(root, 127))
        assert np.array_equal(T._upsampled_template(TCFG, root),
                              J._upsampled_template(JCFG, root))
    assert np.array_equal(T.zc_sequence(3, 64), J.zc_sequence(3, 64))
    for ftype in (0, 1, 2, 3, 255):
        assert np.array_equal(T.generate_preamble(TCFG, ftype), J.generate_preamble(JCFG, ftype))
    assert (TCFG.preamble_samples, TCFG.roots) == (JCFG.preamble_samples, JCFG.roots)


@pytest.mark.parametrize("ftype", [T.ZC_PING, T.ZC_PONG, T.ZC_DATA, T.ZC_CONTROL])
def test_root_discrimination(ftype):
    rng = np.random.default_rng(ftype)
    audio = _frame(ftype, 1000, 2000, 10.0, rng)
    got = _assert_same(audio)
    assert bool(got.detected) and int(got.frame_type) == ftype
    assert abs(int(got.start_sample) - (1000 + TCFG.preamble_samples)) <= 8


@pytest.mark.parametrize("snr_db", [10.0, 0.0, -3.0, -8.0])
def test_detection_floor_batch(snr_db):
    """Five windows at once (batched over a leading axis); -8 dB is the CFAR
    regime."""
    rng = np.random.default_rng(42)
    audio = np.stack([_frame(T.ZC_DATA, 1500, 1500, snr_db, rng) for _ in range(5)])
    got = _assert_same(audio)
    hits = int((got.detected & (got.frame_type == T.ZC_DATA)).sum())
    assert hits >= 4, f"{hits}/5 at {snr_db} dB"


@pytest.mark.parametrize("cfo", [5.0, -10.0, 20.0, -18.0, -23.0])
def test_cfo_estimation(cfo):
    """Parity everywhere; the estimate itself within 2.5 Hz up to 20 Hz (at
    -23 Hz the reference's correlation is smeared below the timing-refinement
    gate and its estimate is off too)."""
    rng = np.random.default_rng(3)
    got = _assert_same(_frame(T.ZC_DATA, 1200, 1200, 15.0, rng, cfo_hz=cfo))
    assert bool(got.detected)
    if abs(cfo) <= 20.0:
        assert abs(float(got.cfo_hz) - cfo) < 2.5


def test_known_cfo_and_leading_axes():
    rng = np.random.default_rng(5)
    audio = np.stack([_frame(t, 600 + 300 * t, 1800 - 300 * t, 6.0, rng) for t in range(4)])
    got = _assert_same(audio.reshape(2, 2, -1), known_cfo_hz=-4.25)
    assert got.detected.shape == (2, 2) and got.detected.all()


def test_noise_only_silent_and_short_windows():
    rng = np.random.default_rng(9)
    noise = rng.normal(0, 0.1, (3, 8000)).astype(np.float32)
    noise[1] = 0.0                                   # digital silence
    noise[2, :5000] = 0.0                            # silence, then noise
    got = _assert_same(noise)
    assert not got.detected.any()
    assert (got.frame_type == T.ZC_UNKNOWN).all() and (got.start_sample == -1).all()
    short = _assert_same(rng.normal(0, 0.1, TCFG.preamble_samples + 63).astype(np.float32))
    assert not bool(short.detected) and int(short.root_index) == -1


def test_cfar_low_snr_timing_and_root():
    rng = np.random.default_rng(77)
    pre = T.generate_preamble(TCFG, T.ZC_DATA)
    audio = np.zeros(5000 + len(pre) + 20000, np.float32)
    audio[5000 : 5000 + len(pre)] = pre
    got = _assert_same(_awgn(audio, -10.0, rng))
    assert bool(got.detected) and int(got.frame_type) == T.ZC_DATA
    assert abs(int(got.start_sample) - (5000 + TCFG.preamble_samples)) <= 8


def test_cfar_no_false_alarm_on_noise_batch():
    noise = np.random.default_rng(13).normal(0, 0.1, (20, 30000)).astype(np.float32)
    assert not _assert_same(noise).detected.any()


@pytest.mark.parametrize("mask", [T.ROOT_MASK_DATA | T.ROOT_MASK_CONTROL, T.ROOT_MASK_PING,
                                  T.ROOT_MASK_PONG | T.ROOT_MASK_DATA])
def test_root_mask(mask):
    rng = np.random.default_rng(11)
    audio = np.stack([_frame(t, 800, 800, 15.0, rng) for t in range(4)])
    got = _assert_same(audio, root_mask=mask)
    allowed = [i for i in range(4) if mask & (1 << i)]
    for t in range(4):
        if t in allowed:
            assert bool(got.detected[t]) and int(got.frame_type[t]) == t
        else:
            assert not bool(got.detected[t]) or int(got.frame_type[t]) in allowed
