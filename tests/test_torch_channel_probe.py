"""``ria_tpu_torch.phy.channel_probe`` (host numpy) against
``ria_tpu.phy.channel_probe``: the report's bytes exact, the estimates to
1e-6 relative, over a parametrised grid of synthetic channels."""

import numpy as np
import pytest
import torch

from ria_tpu.phy import channel_probe as J
from ria_tpu.wave.mc_dpsk import MCDPSKConfig as JConfig
from ria_tpu_torch.phy import channel_probe as T
from ria_tpu_torch.wave.mc_dpsk import MCDPSKConfig as TConfig

torch.set_num_threads(1)

REL = 1e-6
FIELDS = ("delay_spread_ms", "doppler_spread_hz", "snr_db")


def _same(got, want):
    for f in FIELDS:
        assert getattr(got, f) == pytest.approx(getattr(want, f), rel=REL, abs=1e-9), f
    for method in ("is_good", "is_moderate", "is_poor", "is_flutter", "recommended_mode"):
        assert getattr(got, method)() == getattr(want, method)(), method
    assert got.condition_name == want.condition_name


def _channel(seed: int, delay_ms: float, doppler_hz: float, S: int = 12, C: int = 40):
    rng = np.random.default_rng(seed)
    f = np.arange(C) * 46.875
    t = np.arange(S) * 0.012
    h = 1.0 + 0.6 * np.exp(-2j * np.pi * f[None, :] * delay_ms * 1e-3
                           + 2j * np.pi * doppler_hz * t[:, None])
    h = h + 0.02 * (rng.normal(size=h.shape) + 1j * rng.normal(size=h.shape))
    return h.astype(np.complex64)


@pytest.mark.parametrize("delay_ms", [0.2, 1.0, 2.5])
@pytest.mark.parametrize("doppler_hz", [0.1, 1.0, 6.0])
def test_estimate_channel_matches_reference(delay_ms, doppler_hz):
    h = _channel(int(delay_ms * 10 + doppler_hz), delay_ms, doppler_hz)
    _same(T.estimate_channel(h, 46.875, 0.012, 0.001), J.estimate_channel(h, 46.875, 0.012, 0.001))


@pytest.mark.parametrize("bps,spreading,snr_db", [(1, 1, 30.0), (2, 1, 8.0), (1, 2, -3.0),
                                                  (2, 4, 15.0)])
def test_estimate_mc_dpsk_matches_reference(bps, spreading, snr_db):
    rng = np.random.default_rng(bps * 10 + spreading)
    S = 9 + 12 * spreading
    phases = rng.integers(0, 4, (S, 10)) * (np.pi / 2)
    z = (np.exp(1j * phases) * (1.0 + 0.3 * np.sin(np.arange(S))[:, None])
         + 0.05 * (rng.normal(size=(S, 10)) + 1j * rng.normal(size=(S, 10)))).astype(np.complex64)
    kw = dict(bits_per_symbol=bps, spreading=spreading)
    _same(T.estimate_mc_dpsk(z, TConfig(**kw), snr_db), J.estimate_mc_dpsk(z, JConfig(**kw), snr_db))


@pytest.mark.parametrize("snr,delay,doppler,mode", [(0.0, 0.0, 0.0, 0), (12.34, 1.26, 0.57, 2),
                                                    (70.0, 40.0, 30.0, 0x1FF), (-4.0, 0.04, 0.09, 5)])
def test_channel_report_bytes_exact(snr, delay, doppler, mode):
    want = J.ChannelReport(snr, delay, doppler, mode).encode()
    got = T.ChannelReport(snr, delay, doppler, mode).encode()
    assert got == want
    assert vars(T.ChannelReport.decode(got)) == vars(J.ChannelReport.decode(want))
    assert vars(T.ChannelReport.decode(b"\x01")) == vars(J.ChannelReport.decode(b"\x01"))
