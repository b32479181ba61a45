"""The functional forms build their module once per static configuration.

The reference compiles each sync and demod function once per static
configuration (``jax.jit`` with ``static_argnames``); the port's functional
forms cache their ``nn.Module`` (tables and device buffers included) by
(config, window or length, other static arguments, device).  A second call
with the same configuration constructs no module and returns what the
first returned; another window builds another module.
"""

import numpy as np
import pytest
import torch
from torch import nn

from ria_tpu_torch.sync import chirp, css, zc
from ria_tpu_torch.wave import dpsk, mfsk, ofdm, otfs

torch.set_num_threads(1)

RNG = np.random.default_rng(0)


def _x(*shape):
    return torch.as_tensor(RNG.normal(0, 0.1, shape).astype(np.float32))


OFDM = ofdm.OFDMConfig(modulation="QPSK", use_pilots=True, pilot_spacing=5)
_D, _P = len(ofdm.carrier_layout(OFDM)[1]), len(ofdm.carrier_layout(OFDM)[2])
_BINS = torch.complex(_x(2, 5, _D), _x(2, 5, _D)), torch.complex(_x(2, 5, _P), _x(2, 5, _P))

CALLS = {
    "detect_dual_chirp": lambda n: chirp.detect_dual_chirp(
        _x(2, n), chirp.ChirpConfig(duration_ms=10.0, gap_ms=2.0)),
    "schmidl_cox_search": lambda n: ofdm.schmidl_cox_search(_x(2, n), OFDM),
    "lts_search": lambda n: ofdm.lts_search(_x(2, n), OFDM, 0.4),
    "ofdm.demodulate_presynced": lambda n: ofdm.demodulate_presynced(
        _x(2, 5 * OFDM.symbol_samples + n), torch.zeros(2), OFDM, 3),
    "ofdm.demodulate_from_bins": lambda n: ofdm.demodulate_from_bins(*_BINS, OFDM, 3),
    "zc.detect": lambda n: zc.detect(_x(2, n), zc.ZCConfig(), zc.ROOT_MASK_DATA),
    "css.detect": lambda n: css.detect(_x(2, 57600 + n), css.CSSConfig()),
    "dpsk.find_preamble": lambda n: dpsk.find_preamble(
        _x(2, n), dpsk.DPSKConfig(samples_per_symbol=128)),
    "dpsk.demodulate": lambda n: dpsk.demodulate(_x(2, 41 * 128 + n),
                                                 dpsk.DPSKConfig(samples_per_symbol=128), 80),
    "mfsk.find_preamble": lambda n: mfsk.find_preamble(
        _x(n), mfsk.MFSKConfig(num_tones=4, samples_per_symbol=256)),
    "mfsk.demodulate": lambda n: mfsk.demodulate(
        _x(2, 40 * 256 + n), mfsk.MFSKConfig(num_tones=4, samples_per_symbol=256), 40),
    "otfs.demodulate_presynced": lambda n: otfs.demodulate_presynced(
        _x(2, 20 * 576 + n), torch.zeros(2), otfs.OTFSConfig(phase_tracking=True)),
}
# Windows that change the module (unused for the functional forms whose
# module depends only on the config and the frame length).
WINDOW_KEYED = {"detect_dual_chirp", "schmidl_cox_search", "lts_search", "zc.detect",
                "css.detect", "dpsk.find_preamble", "mfsk.find_preamble"}


@pytest.fixture
def constructed(monkeypatch):
    """Count nn.Module constructions."""
    count = [0]
    init = nn.Module.__init__

    def counting_init(self, *args, **kwargs):
        count[0] += 1
        init(self, *args, **kwargs)

    monkeypatch.setattr(nn.Module, "__init__", counting_init)
    return count


@pytest.mark.parametrize("name", list(CALLS))
def test_second_call_constructs_no_module(name, constructed):
    window = 9000
    CALLS[name](window)
    before = constructed[0]
    CALLS[name](window)
    CALLS[name](window)
    assert constructed[0] == before, f"{name} built a module on a repeated call"
    if name in WINDOW_KEYED:
        CALLS[name](window + 1000)
        assert constructed[0] == before + 1


def test_cached_module_gives_the_fresh_module_result():
    x = _x(3, 48000)
    cfg = zc.ZCConfig()
    first = zc.detect(x, cfg)
    again = zc.detect(x, cfg)
    fresh = zc.ZCDetector(cfg, 48000, device="cpu")(x)
    for a, b, c in zip(first, again, fresh):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert zc.zc_detector(cfg, 48000, zc.ROOT_MASK_ALL, x.device) is \
        zc.zc_detector(cfg, 48000, zc.ROOT_MASK_ALL, x.device)
