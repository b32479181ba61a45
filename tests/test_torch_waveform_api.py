"""``ria_tpu_torch.wave.api`` against ``ria_tpu.wave.api`` on the CPU.

The cases of tests/test_waveform_api.py for all seven waveform classes, full
and light preambles, data and control frames.  For each case the same frame
bytes go through ``tx_frame`` of both packages (audio within 1e-5), the
reference's audio gets seeded numpy AWGN once, and that one array goes
through ``rx_frame`` of a fresh object of each package: ok, frame bytes,
header, per-CW flags and start exact; soft bits within 2e-3; SNR, CFO,
fading index, delay and Doppler spread within 1e-3.  The reference's
functions are its jitted ones, as its own tests call them.
"""

import numpy as np
import pytest
import torch

from ria_tpu.phy import frame_v2 as JF
from ria_tpu.wave import api as J
from ria_tpu_torch.phy import frame_v2 as TF
from ria_tpu_torch.tools import waveform_frames as FR
from ria_tpu_torch.wave import api as T

torch.set_num_threads(1)

PAYLOAD, VARIABLE_CW, awgn = FR.PAYLOAD, FR.VARIABLE_CW, FR.awgn


def pair(mode: str, mod, rate, **kw):
    """Fresh waveform objects of both packages (they keep state: the
    tracked noise floor, the last symbols)."""
    return (J.create_waveform(JF.WaveformMode[mode], mod, rate, **kw),
            T.create_waveform(TF.WaveformMode[mode], mod, rate, device="cpu", **kw))


def frame_bytes(mode: str, kind: str, rate: str, payload: bytes = PAYLOAD) -> bytes:
    """Serialized frame, equal in both packages."""
    out = []
    for F in (JF, TF):
        if kind == "control":
            fb = F.ControlFrame.make_ack("W1AW", F.hash_callsign("VE3ABC"), seq=99).serialize()
        elif mode in VARIABLE_CW:
            fb = F.DataFrame.make_data("W1AW", "VE3ABC", 3, payload).serialize()
        else:
            fb = F.make_fixed_data_frame("W1AW", "VE3ABC", 3, payload, rate).serialize()
        out.append(fb)
    assert out[0] == out[1]
    return out[0]


def header(h):
    return None if h is None else {k: int(v) for k, v in h.items()}


def same_rx(got, want):
    """The fields by value (``waveform_frames.same_rx``), and their host
    types as the reference's."""
    FR.same_rx(got, want)
    for f in ("ok", "start_sample"):
        assert type(getattr(got, f)) is type(getattr(want, f)), f
    assert isinstance(got.snr_db, float) and isinstance(got.cfo_hz, float)


# (mode, modulation, rate, light, kind, snr_db)
CASES = [
    ("MC_DPSK", "DBPSK", "R1_4", False, "data", -2.0),
    ("MC_DPSK", "DBPSK", "R1_4", True, "data", 3.0),
    ("MC_DPSK", "DQPSK", "R1_4", True, "control", 4.0),
    ("MC_DPSK", "DBPSK", "R1_4", False, "control", -2.0),
    ("OFDM_CHIRP", "DQPSK", "R1_2", False, "data", 15.0),
    ("OFDM_CHIRP", "DQPSK", "R1_2", True, "data", 15.0),
    ("OFDM_CHIRP", "QAM16", "R1_2", True, "control", 10.0),
    ("OFDM_CHIRP", "DQPSK", "R1_4", False, "control", 10.0),
    ("OFDM_COX", "QPSK", "R1_2", False, "data", 20.0),
    ("OFDM_COX", "QAM16", "R1_2", False, "data", 20.0),
    ("OFDM_COX", "QPSK", "R1_2", True, "data", 20.0),
    ("OFDM_COX", "QAM64", "R3_4", False, "control", 10.0),
    ("OTFS_EQ", "QPSK", "R1_4", False, "data", 18.0),
    ("OTFS_EQ", "QPSK", "R1_4", False, "control", 18.0),
    ("OTFS_RAW", "QPSK", "R1_4", False, "data", 18.0),
    ("OTFS_RAW", "QPSK", "R1_2", False, "control", 18.0),
    ("DPSK", "DQPSK", "R1_4", False, "data", -4.0),
    ("DPSK", "DBPSK", "R1_4", False, "control", -6.0),
    ("MFSK", None, "R1_4", False, "control", -2.0),
    ("MFSK", None, "R1_4", False, "data", 0.0),
]
IDS = [f"{m}-{mod}-{r}-{'light' if light else 'full'}-{k}" for m, mod, r, light, k, _ in CASES]


@pytest.mark.parametrize("mode,mod,rate,light,kind,snr_db", CASES, ids=IDS)
def test_roundtrip_matches_reference(mode, mod, rate, light, kind, snr_db):
    jw, tw = pair(mode, mod, rate)
    payload = b"hi" if mode == "MFSK" else PAYLOAD
    fb = frame_bytes(mode, kind, rate, payload)
    want_tx = np.asarray(jw.tx_frame(fb, light=light))
    got_tx = tw.tx_frame(fb, light=light)
    assert got_tx.dtype == np.float32 and got_tx.shape == want_tx.shape
    assert np.max(np.abs(got_tx - want_tx)) <= 1e-5
    ncw = 1 if kind == "control" else 4
    if mode in ("OFDM_CHIRP", "OFDM_COX"):
        assert tw.frame_samples(ncw, control=kind == "control") == \
            jw.frame_samples(ncw, control=kind == "control")
    else:
        assert tw.frame_samples(ncw, light=light) == jw.frame_samples(ncw, light=light)
    assert (tw.search_window(light), tw.search_overlap(light)) == \
        (jw.search_window(light), jw.search_overlap(light))

    lead, tail = (6000, 6000) if mode == "MFSK" else (3000, 4000)
    audio = awgn(want_tx, snr_db, seed=IDS.index(
        f"{mode}-{mod}-{rate}-{'light' if light else 'full'}-{kind}"), lead=lead, tail=tail)
    want = jw.rx_frame(audio, light=light)
    got = tw.rx_frame(audio, light=light)
    assert got.ok, "the port did not decode"
    same_rx(got, want)
    if kind == "control":
        g = TF.ControlFrame.deserialize(got.frame_bytes)
        assert g is not None and g.type == TF.FrameType.ACK and g.seq == 99
    else:
        g = TF.DataFrame.deserialize(got.frame_bytes)
        assert g is not None and g.seq == 3
        assert g.payload.rstrip(b"\x00")[: len(payload)] == payload
    if mode == "MC_DPSK" or (mode in ("OFDM_CHIRP", "OFDM_COX") and kind == "data"):
        assert np.max(np.abs(tw.last_symbols - np.asarray(jw.last_symbols))) <= 2e-3
    # The same buffer as a tensor: the same frame.
    again = tw.rx_frame(torch.as_tensor(audio), light=light)
    assert again.frame_bytes == got.frame_bytes and again.start_sample == got.start_sample


@pytest.mark.parametrize("mode,mod,rate", [("MC_DPSK", "DBPSK", "R1_4"),
                                           ("OFDM_CHIRP", "DQPSK", "R1_2"),
                                           ("OFDM_COX", "QPSK", "R1_2"),
                                           ("OTFS_EQ", "QPSK", "R1_4"),
                                           ("DPSK", "DQPSK", "R1_4"),
                                           ("MFSK", None, "R1_4")])
def test_noise_only_gives_no_frame(mode, mod, rate):
    jw, tw = pair(mode, mod, rate)
    noise = np.random.default_rng(11).normal(0, 0.05, 70000).astype(np.float32)
    for light in (False, True):
        want, got = jw.rx_frame(noise, light=light), tw.rx_frame(noise, light=light)
        assert not got.ok
        same_rx(got, want)
        assert tw.detect_sync(noise, light) == jw.detect_sync(noise, light)


def test_factory_modes_and_defaults():
    for name in ("MC_DPSK", "OFDM_CHIRP", "OFDM_COX", "OTFS_EQ", "OTFS_RAW", "MFSK", "DPSK"):
        jw = J.create_waveform(JF.WaveformMode[name])
        tw = T.create_waveform(TF.WaveformMode[name], device="cpu")
        assert type(tw).__name__ == type(jw).__name__
        assert (tw.mode.name, tw.modulation, tw.rate) == (jw.mode.name, jw.modulation, jw.rate)
        assert (tw.fallback_cw, tw.header_required) == (jw.fallback_cw, jw.header_required)
        assert tw.device.type == "cpu"
    afdm = T.create_waveform(TF.WaveformMode.AFDM, device="cpu")
    assert type(afdm).__name__ == "AFDMWaveform" and not hasattr(afdm, "mode")
    with pytest.raises(NotImplementedError):
        T.create_waveform(TF.WaveformMode.AUTO, device="cpu")


def test_configure_follows_reference():
    jw, tw = pair("MC_DPSK", "DBPSK", "R1_4")
    for w in (jw, tw):
        w.configure("DQPSK", "R1_2", spreading=2, num_carriers=8)
    assert vars(tw.cfg).keys() == vars(jw.cfg).keys()
    assert (tw.cfg.bits_per_symbol, tw.cfg.spreading, tw.cfg.num_carriers, tw.rate) == \
        (jw.cfg.bits_per_symbol, jw.cfg.spreading, jw.cfg.num_carriers, jw.rate)
    jw, tw = pair("OFDM_CHIRP", "DQPSK", "R1_2")
    for w in (jw, tw):
        w.configure("QAM16", "R3_4")
    assert (tw.cfg.modulation, tw.cfg.pilot_spacing, tw._ci_bits) == \
        (jw.cfg.modulation, jw.cfg.pilot_spacing, jw._ci_bits)
    jw, tw = pair("DPSK", "DQPSK", "R1_4")
    for w in (jw, tw):
        w.configure("D8PSK", "R1_2")
    assert tw.cfg.bits_per_symbol == jw.cfg.bits_per_symbol == 3
