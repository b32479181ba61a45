"""``ria_tpu_torch.wave.selection`` against ``ria_tpu.wave.selection``: the
decision tables are data, so every answer is equal over the whole grid."""

import itertools

import numpy as np
import pytest
import torch

from ria_tpu.phy.frame_v2 import WaveformMode as JMode
from ria_tpu.wave import selection as J
from ria_tpu_torch.phy.frame_v2 import WaveformMode as TMode
from ria_tpu_torch.wave import selection as T

torch.set_num_threads(1)

SNRS = [float(s) for s in np.arange(-16.0, 32.0, 1.5)]
FADINGS = [0.0, 0.1, 0.15, 0.4, 0.65, 0.9, 1.10, 1.5]
RATES = ["R1_4", "R1_2", "R2_3", "R3_4", "R5_6"]
MODS = ["DBPSK", "DQPSK", "D8PSK", "BPSK", "QPSK", "QAM16", "QAM32", "QAM64", "QAM256"]


def _rec(r):
    d = dict(vars(r))
    d["waveform"] = d["waveform"].name
    return d


@pytest.mark.parametrize("fading", FADINGS)
def test_recommend_waveform_and_rate(fading):
    for snr in SNRS:
        assert _rec(T.recommend_waveform_and_rate(snr, fading)) == \
            _rec(J.recommend_waveform_and_rate(snr, fading)), (snr, fading)


@pytest.mark.parametrize("fading", FADINGS)
def test_ofdm_code_rate_and_cap(fading):
    for snr in SNRS:
        assert T.select_ofdm_code_rate(snr, fading) == J.select_ofdm_code_rate(snr, fading)
        for cand in RATES:
            assert T.cap_initial_ofdm_rate(snr, fading, cand) == \
                J.cap_initial_ofdm_rate(snr, fading, cand), (snr, fading, cand)


@pytest.mark.parametrize("mode", [m.name for m in JMode])
def test_recommend_data_mode(mode):
    for snr, fading in itertools.product(SNRS, FADINGS):
        assert T.recommend_data_mode(snr, TMode[mode], fading) == \
            J.recommend_data_mode(snr, JMode[mode], fading), (mode, snr, fading)


def test_pilot_spacings_and_profiles():
    for mod, rate in itertools.product(MODS, RATES):
        assert T.recommended_pilot_spacing(mod, rate) == J.recommended_pilot_spacing(mod, rate)
        assert T.sparse_pilot_spacing(mod, rate) == J.sparse_pilot_spacing(mod, rate)
    for snr in SNRS:
        assert T.recommend_otfs_mode(snr) == J.recommend_otfs_mode(snr)
        assert T.recommend_mc_dpsk_carriers(snr) == J.recommend_mc_dpsk_carriers(snr)
        for fading in FADINGS:
            assert T.recommend_mc_profile(snr, fading) == J.recommend_mc_profile(snr, fading)


def test_waveform_modes_are_the_same_enum():
    assert {m.name: m.value for m in TMode} == {m.name: m.value for m in JMode}
