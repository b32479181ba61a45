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

from ria_tpu_torch.phy import frame_v2
from ria_tpu_torch.sync import chirp, css, zc
from ria_tpu_torch.wave import api, dpsk, mc_dpsk, mfsk, ofdm, otfs

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
    "mc_dpsk.demodulate": lambda n: mc_dpsk.demodulate(
        _x(2, 29 * 512 + n), torch.zeros(2), mc_dpsk.MCDPSKConfig(), 20),
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


# (mode, modulation, rate, light, data frame?, detectors a recording length
# builds) of one clean frame per waveform class and preamble.  A QAM16
# waveform's control frame is found by the second LTS template (the control
# profile's pilot layout), so that length builds two LTS detectors.
WAVEFORM_FRAMES = [
    ("MC_DPSK", "DBPSK", "R1_4", False, True, 1),
    ("MC_DPSK", "DQPSK", "R1_4", True, True, 1),
    ("OFDM_CHIRP", "DQPSK", "R1_2", False, True, 1),
    ("OFDM_CHIRP", "QAM16", "R1_2", True, False, 2),
    ("OFDM_COX", "QPSK", "R1_2", False, True, 1),
    ("OTFS_EQ", "QPSK", "R1_4", False, True, 1),
    ("OTFS_RAW", "QPSK", "R1_4", False, False, 1),
    ("DPSK", "DQPSK", "R1_4", False, False, 1),
    ("MFSK", None, "R1_4", False, False, 1),
    ("AFDM", None, "R1_4", False, False, 1),
]


@pytest.mark.parametrize("mode,mod,rate,light,data,detectors", WAVEFORM_FRAMES,
                         ids=[f"{c[0]}-{'light' if c[3] else 'full'}" for c in WAVEFORM_FRAMES])
def test_second_rx_frame_of_a_length_constructs_no_module(mode, mod, rate, light, data,
                                                          detectors, constructed):
    """The waveform classes' call sites: the first ``rx_frame`` of a
    recording length builds the detector and the demodulators (the header
    codeword's and the frame's), the second builds nothing, on a fresh
    waveform object too; ``detect_sync`` and ``peek_header`` reuse them."""
    wm = frame_v2.WaveformMode[mode]
    wf = api.create_waveform(wm, mod, rate, device="cpu")
    if not data or mode == "AFDM":
        fb = frame_v2.ControlFrame.make_ack("W1AW", frame_v2.hash_callsign("VE3ABC"),
                                            seq=3).serialize()
    elif mode.startswith("OFDM"):
        fb = frame_v2.make_fixed_data_frame("W1AW", "VE3ABC", 3, b"cached modules", rate).serialize()
    else:
        fb = frame_v2.DataFrame.make_data("W1AW", "VE3ABC", 3, b"cached modules").serialize()
    tx = wf.tx_frame(fb, light=light)
    audio = np.concatenate([np.zeros(2000, np.float32), tx, np.zeros(2000, np.float32)])
    audio += RNG.normal(0, 1e-3, audio.shape).astype(np.float32)

    def rx(w):
        if mode == "AFDM":
            ok, got, _ = w.rx_frame(audio)
            return ok, got[:20]
        r = w.rx_frame(audio, light=light)
        return r.ok, r.frame_bytes[: len(fb)]

    assert rx(wf) == (True, fb)
    before = constructed[0]
    assert rx(wf) == (True, fb)
    assert rx(api.create_waveform(wm, mod, rate, device="cpu")) == (True, fb)
    if mode != "AFDM":
        sync = wf.detect_sync(audio, light)
        wf.peek_header(audio, sync["start"], sync["cfo_hz"], light)
    assert constructed[0] == before, f"{mode} built a module on a repeated rx_frame"
    # Another recording length: another detector, and only that.
    longer = np.concatenate([audio, np.zeros(1000, np.float32)])
    if mode == "AFDM":
        wf.rx_frame(longer)
    else:
        wf.rx_frame(longer, light=light)
    assert constructed[0] == before + detectors


def test_second_session_constructs_no_module(constructed):
    """A second full session (S1: PING, CONNECT, a message each way,
    DISCONNECT over 12 dB AWGN) meets only windows and frame lengths the
    first one met: its sync searches, demodulators and decoders build no
    module."""
    from ria_tpu_torch.tools import session_paths as S

    first = S.run(S.SESSIONS["S1"], device="cpu")
    before = constructed[0]
    second = S.run(S.SESSIONS["S1"], device="cpu")
    assert constructed[0] == before, f"{constructed[0] - before} modules built"
    assert first["messages"] == second["messages"] == 2 and second["ticks"] == first["ticks"]
