"""The port's CSS sync (``ria_tpu_torch.sync.css``) against ``ria_tpu.sync.css``.

Mirrors the CSS tests of ``tests/test_css_afdm.py``: the four cyclic shifts,
plus a partially visible preamble, a noise-only window, a window too short
for the preamble and leading batch axes.  The port and the jitted reference
see the same numpy-noised array: detected, frame type and start exact,
correlation within 1e-3.  The TX tables are bit-equal.
"""

import numpy as np
import pytest
import torch

from ria_tpu.sync import css as J
from ria_tpu_torch.sync import css as T

torch.set_num_threads(1)

JCFG, TCFG = J.CSSConfig(), T.CSSConfig()


def _awgn(x, snr_db, rng):
    nz = np.abs(x) > 1e-6
    rms = np.sqrt(np.mean(x[nz] ** 2)) if nz.any() else 0.1
    return x + rng.normal(0, rms * 10 ** (-snr_db / 20), x.shape).astype(np.float32)


def _assert_same(audio):
    got = T.detect(torch.as_tensor(audio), TCFG)
    want = J.detect(audio, JCFG)
    for name in ("detected", "frame_type", "start_sample"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape and np.array_equal(g, w), name
    assert np.allclose(got.correlation.numpy(), np.asarray(want.correlation), rtol=0, atol=1e-3)
    return got


def test_tables_bit_equal():
    assert np.array_equal(T._base_phase(TCFG), J._base_phase(JCFG))
    for shift in range(4):
        assert np.array_equal(T._shifted_chirp(TCFG, shift), J._shifted_chirp(JCFG, shift))
        assert np.array_equal(T._shifted_template(TCFG, shift),
                              J._shifted_template(JCFG, shift))
    for ftype in (0, 1, 2, 3, 7):
        assert np.array_equal(T.generate_preamble(TCFG, ftype), J.generate_preamble(JCFG, ftype))
    assert np.array_equal(T.generate_preamble(TCFG, 1, 0.3), J.generate_preamble(JCFG, 1, 0.3))
    assert TCFG.preamble_samples == JCFG.preamble_samples == 57600


@pytest.mark.parametrize("ftype", [T.CSS_PING, T.CSS_PONG, T.CSS_DATA, T.CSS_CONTROL])
def test_frame_type_discrimination(ftype):
    rng = np.random.default_rng(ftype)
    pre = T.generate_preamble(TCFG, ftype)
    audio = _awgn(np.concatenate([np.zeros(4000, np.float32), pre,
                                  np.zeros(3000, np.float32)]), 5.0, rng)
    got = _assert_same(audio)
    assert bool(got.detected) and int(got.frame_type) == ftype
    assert int(got.start_sample) == 4000 + TCFG.preamble_samples


def test_batch_of_shifts_at_0_db():
    """The four shifts as one [2, 2, n] batch at 0 dB, leads in [0, 8000)."""
    rng = np.random.default_rng(7)
    audio = np.zeros((4, 96000), np.float32)
    for t in range(4):
        lead = int(rng.integers(0, 8000))
        pre = T.generate_preamble(TCFG, t)
        audio[t, lead : lead + len(pre)] = pre
    audio = _awgn(audio, 0.0, rng)
    got = _assert_same(audio.reshape(2, 2, -1))
    assert got.detected.all() and np.array_equal(got.frame_type.numpy().ravel(), np.arange(4))


def test_partial_preamble():
    """Only the second chirp and the gap are in the window: the full
    two-chirp template still has one peak, and port and reference agree."""
    rng = np.random.default_rng(3)
    pre = T.generate_preamble(TCFG, T.CSS_CONTROL)
    cut = TCFG.chirp_samples + TCFG.gap_samples
    audio = np.concatenate([pre[cut:], np.zeros(60000, np.float32)])
    got = _assert_same(_awgn(audio, 10.0, rng))
    assert float(got.correlation) < 0.9


def test_noise_only_and_short_windows():
    rng = np.random.default_rng(9)
    noise = rng.normal(0, 0.1, (2, 70000)).astype(np.float32)
    noise[1, :30000] = 0.0
    assert not _assert_same(noise).detected.any()
    short = _assert_same(rng.normal(0, 0.1, TCFG.preamble_samples + 63).astype(np.float32))
    assert not bool(short.detected) and int(short.frame_type) == T.CSS_UNKNOWN
