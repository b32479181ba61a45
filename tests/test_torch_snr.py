"""``ria_tpu_torch.dsp.snr`` (host numpy) against ``ria_tpu.dsp.snr``.

The same seeded audio goes through both: the estimates agree to 1e-6
relative (they are the same numpy code; the grid guards the copy).
"""

import numpy as np
import pytest
import torch

from ria_tpu.dsp import snr as J
from ria_tpu_torch.dsp import snr as T

torch.set_num_threads(1)

REL = 1e-6


def _tone_in_noise(seed: int, snr_db: float, n: int = 40000) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 48000.0
    sig = sum(np.sin(2 * np.pi * f * t + rng.uniform(0, 6.28)) for f in (700.0, 1500.0, 2300.0))
    sig = (sig / np.sqrt(np.mean(sig ** 2))).astype(np.float32)
    noise = rng.normal(0, 10 ** (-snr_db / 20), n).astype(np.float32)
    return sig * 0.3 + noise * 0.3


@pytest.mark.parametrize("snr_db", [-10.0, 0.0, 12.0, 30.0])
@pytest.mark.parametrize("mode", ["out_of_band", "noise_ref", "prior"])
def test_spectral_snr_matches_reference(snr_db, mode):
    audio = _tone_in_noise(int(snr_db) + 50, snr_db)
    rng = np.random.default_rng(7)
    kw = {}
    if mode == "noise_ref":
        kw["noise_ref"] = (rng.normal(0, 10 ** (-snr_db / 20), 12000) * 0.3).astype(np.float32)
    elif mode == "prior":
        kw["noise_bin_prior"] = J.measure_noise_floor(
            (rng.normal(0, 10 ** (-snr_db / 20), 12000) * 0.3).astype(np.float32))
    want, want_floor = J.spectral_snr_db(audio, return_floor=True, **kw)
    got, got_floor = T.spectral_snr_db(audio, return_floor=True, **kw)
    assert got == pytest.approx(want, rel=REL, abs=1e-9)
    assert got_floor == pytest.approx(want_floor, rel=REL, abs=1e-30)
    assert T.spectral_snr_db(audio, **kw) == pytest.approx(J.spectral_snr_db(audio, **kw), rel=REL)


@pytest.mark.parametrize("n", [1000, 4096, 24000])
def test_measure_noise_floor_matches_reference(n):
    window = np.random.default_rng(n).normal(0, 0.05, n).astype(np.float32)
    want, got = J.measure_noise_floor(window), T.measure_noise_floor(window)
    if want is None:
        assert got is None
    else:
        assert got == pytest.approx(want, rel=REL)


def test_short_audio_and_silence():
    short = np.zeros(100, np.float32)
    assert T.spectral_snr_db(short) == J.spectral_snr_db(short)
    silence = np.zeros(20000, np.float32)
    assert T.spectral_snr_db(silence) == J.spectral_snr_db(silence)
