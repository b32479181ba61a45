"""The port's phy/adaptive.py against ``ria_tpu.phy.adaptive`` on the same
sequences: the pilot-SNR ladder and its controller, the in-session link
adapter, carrier sense, and the TX post-processing on the CPU."""

import numpy as np
import pytest
import torch

from ria_tpu.phy import adaptive as J
from ria_tpu.phy.frame_v2 import WaveformMode as JMode
from ria_tpu_torch.phy import adaptive as T
from ria_tpu_torch.phy.frame_v2 import WaveformMode as TMode

torch.set_num_threads(1)


def _snr_walk(seed: int, n: int = 120) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.normal(0, 1.5, n)) + rng.uniform(-5, 35)


@pytest.mark.parametrize("seed", range(4))
def test_adaptive_mode_controller_matches_reference(seed):
    j, t = J.AdaptiveModeController(), T.AdaptiveModeController()
    for snr in _snr_walk(seed):
        assert t.update(float(snr)) == j.update(float(snr))
        assert (t.modulation, t.rate, t.frames_at_current) == (j.modulation, j.rate,
                                                               j.frames_at_current)
    for snr in np.linspace(-10, 45, 111):
        assert T.recommend_mode(float(snr)) == J.recommend_mode(float(snr))


@pytest.mark.parametrize("waveform", ["OFDM_CHIRP", "MC_DPSK", "OTFS_EQ"])
@pytest.mark.parametrize("seed", range(3))
def test_link_adapter_matches_reference(waveform, seed):
    rng = np.random.default_rng(100 + seed)
    j, t = J.LinkAdapter(), T.LinkAdapter()
    mod, rate = {"OFDM_CHIRP": ("DQPSK", "R1_4"), "MC_DPSK": ("DBPSK", "R1_4"),
                 "OTFS_EQ": ("QPSK", "R1_2")}[waveform]
    decisions = 0
    for i, snr in enumerate(_snr_walk(seed, 200)):
        fading = float(rng.uniform(0.0, 0.6))
        now = 700.0 * (i + 1)
        dj = j.feed(float(snr), fading, now, JMode[waveform], mod, rate)
        dt = t.feed(float(snr), fading, now, TMode[waveform], mod, rate)
        assert dt == dj
        if dj is not None:
            decisions += 1
            (mod, rate, _), _, _, _ = dj
    assert decisions >= 1


def test_carrier_sense_matches_reference():
    rng = np.random.default_rng(5)
    j, t = J.CarrierSense(0.05), T.CarrierSense(0.05)
    for i in range(50):
        block = rng.normal(0, 0.02 + 0.1 * (i % 7 == 0), 4800).astype(np.float32)
        j.update(block)
        t.update(block)
        assert (t.energy, t.busy) == (j.energy, j.busy)
    t.update(np.zeros(0, np.float32))
    assert t.energy == j.energy


@pytest.mark.parametrize("lead_ms,scale", [(0.0, 1.0), (50.0, 0.8)])
def test_tx_post_process_matches_reference(lead_ms, scale):
    rng = np.random.default_rng(7)
    x = rng.normal(0, 0.2, 30001).astype(np.float32)
    want = J.tx_post_process(x, lead_in_ms=lead_ms, scale=scale)
    got = T.tx_post_process(x, lead_in_ms=lead_ms, scale=scale, device="cpu")
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.max(np.abs(got - want)) <= 1e-5
