"""The other paths of ``ria_tpu_torch.wave.api`` against ``ria_tpu.wave.api``
on the CPU: the CSS preamble, ``detect_sync`` and ``peek_header``, the OFDM
burst (group 4), variable-CW and fixed-frame chase combining (two noisy
copies that each fail alone: the same outcomes and the same ``ChaseStats``
in both packages), the control CRC gate on a codeword whose primary decode
fails the CRC, the try-both interleave fall-back, a fading channel, and
chirp windows under and over 131,072 samples.  Comparison rules as in
tests/test_torch_waveform_api.py, whose helpers this file uses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ria_tpu.fec.chase import ChaseCache as JChase
from ria_tpu.phy import frame_v2 as JF
from ria_tpu.sim import PRESETS, apply_channel, good
from ria_tpu.wave import api as J
from ria_tpu_torch.fec.chase import ChaseCache as TChase
from ria_tpu_torch.phy import frame_v2 as TF
from ria_tpu_torch.sync import chirp as t_chirp
from ria_tpu_torch.wave import api as T
from test_torch_waveform_api import awgn, frame_bytes, header, pair, same_rx

torch.set_num_threads(1)


def through(tx, channel, seed, lead=3000, tail=4000) -> np.ndarray:
    """The reference simulator's channel, once, as a numpy array."""
    audio = np.concatenate([np.zeros(lead, np.float32), tx, np.zeros(tail, np.float32)])
    return np.asarray(apply_channel(jnp.asarray(audio), jax.random.PRNGKey(seed),
                                    channel).samples)


def same_sync(got, want):
    assert (got is None) == (want is None)
    if want is None:
        return
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, float):
            assert isinstance(got[k], float) and got[k] == pytest.approx(v, abs=1e-3), k
        else:
            assert got[k] == v and type(got[k]) is type(v), k


def test_css_preamble_matches_reference():
    jw, tw = pair("MC_DPSK", "DBPSK", "R1_4", use_css=True)
    for kind, css_type in (("data", 2), ("control", 3)):
        fb = frame_bytes("MC_DPSK", kind, "R1_4", b"css preamble frame")
        want_tx = np.asarray(jw.tx_frame(fb))
        assert np.max(np.abs(tw.tx_frame(fb) - want_tx)) <= 1e-5
        audio = awgn(want_tx, 0.0, seed=css_type)
        want_sync, got_sync = jw.detect_sync(audio), tw.detect_sync(audio)
        same_sync(got_sync, want_sync)
        assert got_sync["kind"] == "css" and got_sync["css_type"] == css_type
        want, got = jw.rx_frame(audio), tw.rx_frame(audio)
        assert got.ok
        same_rx(got, want)
    assert tw.frame_samples(3) == jw.frame_samples(3)
    assert tw.search_overlap() == jw.search_overlap()
    assert np.array_equal(tw.acq_preamble(1), np.asarray(jw.acq_preamble(1)))


PEEK = [
    ("MC_DPSK", "DBPSK", "R1_4", False, "data", 0.0, {}),
    ("MC_DPSK", "DQPSK", "R1_4", True, "data", 6.0, {"channel_interleave": True}),
    ("OFDM_CHIRP", "DQPSK", "R1_2", True, "control", 12.0, {}),
    ("OFDM_CHIRP", "DQPSK", "R1_2", True, "data", 15.0, {}),
    ("OFDM_COX", "QPSK", "R1_2", False, "control", 12.0, {}),
    ("OTFS_EQ", "QPSK", "R1_4", False, "data", 18.0, {}),
    ("DPSK", "DQPSK", "R1_4", False, "data", 0.0, {}),
    ("MFSK", None, "R1_4", False, "control", 0.0, {}),
]


@pytest.mark.parametrize("mode,mod,rate,light,kind,snr_db,kw", PEEK,
                         ids=[f"{c[0]}-{'light' if c[3] else 'full'}-{c[4]}" for c in PEEK])
def test_detect_sync_and_peek_header(mode, mod, rate, light, kind, snr_db, kw):
    jw, tw = pair(mode, mod, rate, **kw)
    fb = frame_bytes(mode, kind, rate, b"hi" if mode == "MFSK" else b"peek at the header")
    tx = np.asarray(jw.tx_frame(fb, light=light))
    lead = 6000 if mode == "MFSK" else 3000
    audio = awgn(tx, snr_db, seed=len(mode) + int(light), lead=lead, tail=lead)
    want_sync, got_sync = jw.detect_sync(audio, light), tw.detect_sync(audio, light)
    same_sync(got_sync, want_sync)
    assert got_sync is not None
    want = jw.peek_header(audio, want_sync["start"], want_sync["cfo_hz"], light)
    got = tw.peek_header(audio, want_sync["start"], want_sync["cfo_hz"], light)
    assert header(got) == header(want)
    # OFDM peeks report control frames only (data frames have a fixed length).
    assert (got is None) == (mode.startswith("OFDM") and kind == "data")
    # rx_frame with the sync handed in skips the search and gives the same frame.
    with_sync = tw.rx_frame(audio, light=light, sync=want_sync)
    same_rx(with_sync, jw.rx_frame(audio, light=light, sync=want_sync))
    assert with_sync.ok


def test_ofdm_burst_group4_matches_reference():
    for mode, mod in (("OFDM_CHIRP", "DQPSK"), ("OFDM_COX", "QAM16")):
        jw, tw = pair(mode, mod, "R1_2")
        frames = [JF.make_fixed_data_frame("W1AW", "VE3ABC", i, f"burst frame {i}".encode(),
                                           "R1_2").serialize() for i in range(4)]
        want_tx = np.asarray(jw.tx_burst(frames))
        got_tx = tw.tx_burst(frames)
        assert got_tx.shape == want_tx.shape and np.max(np.abs(got_tx - want_tx)) <= 1e-5
        assert (tw.burst_codewords(4), tw.burst_samples(4)) == \
            (jw.burst_codewords(4), jw.burst_samples(4))
        audio = awgn(want_tx, 15.0, seed=8)
        want, want_snr, want_fading = jw.rx_burst(audio, group=4)
        got, got_snr, got_fading = tw.rx_burst(audio, group=4)
        assert got == want and all(ok for ok, _ in got)
        for i, (_, fb) in enumerate(got):
            g = TF.DataFrame.deserialize(fb)
            assert g.seq == i and g.payload.rstrip(b"\x00") == f"burst frame {i}".encode()
        assert got_snr == pytest.approx(want_snr, abs=1e-3)
        assert got_fading == pytest.approx(want_fading, abs=1e-3)
        sync = tw.detect_sync(audio, light=True)
        assert sync["lts_repeats"] == jw.detect_sync(audio, light=True)["lts_repeats"] == 3
    # A group that is not compressible (frames of two senders) is refused.
    other = JF.make_fixed_data_frame("K9XYZ", "VE3ABC", 1, b"other sender", "R1_2").serialize()
    assert tw.tx_burst([frames[0], other]) is None and jw.tx_burst([frames[0], other]) is None
    noise = np.random.default_rng(2).normal(0, 0.05, 40000).astype(np.float32)
    assert tw.rx_burst(noise, group=4) is None and jw.rx_burst(noise, group=4) is None


def test_variable_cw_chase_matches_reference():
    """MC-DPSK DQPSK at -9 dB: seeds 3 and 5 each lose one of three
    codewords, a different one; the second reception combines and decodes."""
    jw, tw = pair("MC_DPSK", "DQPSK", "R1_4")
    fb = JF.DataFrame.make_data("W1AW", "VE3ABC", 9, b"chase combining over two copies!").serialize()
    tx = np.asarray(jw.tx_frame(fb, light=True))
    copies = [awgn(tx, -9.0, seed) for seed in (3, 5)]
    for audio in copies:
        want, got = jw.rx_frame(audio, light=True), tw.rx_frame(audio, light=True)
        assert not got.ok and got.header is not None
        same_rx(got, want)
    jc, tc = JChase(), TChase()
    for n, audio in enumerate(copies):
        want = jw.rx_frame(audio, light=True, chase=jc)
        got = tw.rx_frame(audio, light=True, chase=tc)
        same_rx(got, want)
        assert got.ok == (n == 1)
        assert vars(tc.stats) == vars(jc.stats)
    assert tc.stats.recoveries == 1 and got.frame_bytes[:len(fb)] == fb


def test_fixed_frame_chase_matches_reference():
    """OFDM fixed frames at Moderate 9 dB (the reference test's seeds 8000
    and 8003): each copy fails alone, the pair combines to the frame."""
    jw, tw = pair("OFDM_CHIRP", "DQPSK", "R1_2")
    fb = JF.make_fixed_data_frame("W1AW", "VE3ABC", 7, bytes(range(100)), "R1_2").serialize()
    tx = np.asarray(jw.tx_frame(fb, light=True))
    copies = [through(tx, PRESETS["moderate"](9.0), seed) for seed in (8000, 8003)]
    for audio in copies:
        want, got = jw.rx_frame(audio, light=True), tw.rx_frame(audio, light=True)
        assert not got.ok
        same_rx(got, want)
    jc, tc = JChase(), TChase()
    for n, audio in enumerate(copies):
        want = jw.rx_frame(audio, light=True, chase=jc)
        got = tw.rx_frame(audio, light=True, chase=tc)
        same_rx(got, want)
        assert got.ok == (n == 1)
        assert vars(tc.stats) == vars(jc.stats)
    assert tc.stats.recoveries == 1 and got.frame_bytes == fb


def test_control_crc_gate_matches_reference():
    fb = JF.ControlFrame.make_ack("W1AW", JF.hash_callsign("VE3ABC"), seq=41).serialize()
    coded = np.asarray(JF.encode_frame_ldpc(fb, "R1_4", None))[0]
    rng = np.random.default_rng(6)
    soft = ((1.0 - 2.0 * coded) * 3.0 + rng.normal(0, 1.5, 648)).astype(np.float32)
    # The primary decode converged to bytes that fail the frame CRC: the
    # gate rescues the frame from the parity-valid candidates.
    wrong = bytearray(fb)
    wrong[5] ^= 0x10
    for primary in (bytes(wrong), None, fb):
        want = J._control_crc_gate(primary, soft, "R1_4")
        got = T._control_crc_gate(primary, soft, "R1_4", device="cpu")
        assert got == want == (True, fb)
    # No candidate passes the CRC: the gate stays shut and returns its input.
    garbage = rng.normal(0, 1.0, 648).astype(np.float32)
    want = J._control_crc_gate(bytes(wrong), garbage, "R1_4")
    got = T._control_crc_gate(bytes(wrong), garbage, "R1_4", device="cpu")
    assert got == want == (False, bytes(wrong))


def test_try_both_interleave_and_fading_match_reference():
    # Sent without the channel interleave, received by a waveform that
    # expects it: the second, raw decode gives the frame.
    jtx, _ = pair("OFDM_CHIRP", "DQPSK", "R1_2", channel_interleave=False)
    jw, tw = pair("OFDM_CHIRP", "DQPSK", "R1_2")
    fb = frame_bytes("OFDM_CHIRP", "data", "R1_2")
    audio = awgn(np.asarray(jtx.tx_frame(fb, light=True)), 15.0, seed=21)
    want, got = jw.rx_frame(audio, light=True), tw.rx_frame(audio, light=True)
    assert got.ok and got.frame_bytes == fb
    same_rx(got, want)
    # tests/test_waveform_api.py::test_ofdm_chirp_fading
    jw, tw = pair("OFDM_CHIRP", "DQPSK", "R1_4")
    fb = JF.make_fixed_data_frame("W1AW", "VE3ABC", 1, bytes(range(61)), "R1_4").serialize()
    want_tx = np.asarray(jw.tx_frame(fb, tx_cfo_hz=7.0))
    assert np.max(np.abs(tw.tx_frame(fb, tx_cfo_hz=7.0) - want_tx)) <= 1e-5
    audio = through(want_tx, good(16.0), seed=5)
    want, got = jw.rx_frame(audio), tw.rx_frame(audio)
    assert got.ok and got.cfo_hz == pytest.approx(7.0, abs=0.5)
    same_rx(got, want)


def test_tracked_noise_floor_follows_reference():
    """Two frames through the same objects: the second reuses or updates
    the floor the first one measured, the same way in both packages."""
    jw, tw = pair("OFDM_CHIRP", "DQPSK", "R1_2")
    fb = frame_bytes("OFDM_CHIRP", "data", "R1_2")
    tx = np.asarray(jw.tx_frame(fb, light=True))
    for seed, lead in ((1, 30000), (2, 300), (3, 30000)):
        audio = awgn(tx, 12.0, seed, lead=lead)
        same_rx(tw.rx_frame(audio, light=True), jw.rx_frame(audio, light=True))
        assert tw._noise_floor == pytest.approx(jw._noise_floor, rel=1e-4)
        assert tw._pre_start == jw._pre_start


@pytest.mark.parametrize("kind,nfft", [("control", 131072), ("data", 262144)])
def test_chirp_window_under_and_over_131072(kind, nfft):
    """A control frame's recording (under 131,072 samples) and a data
    frame's (over): another detector module each, the same sync and frame
    as the reference.  Every window that can hold the 57,600-sample dual
    chirp has nfft >= 131,072, so both run the detector's zoom branch."""
    jw, tw = pair("MC_DPSK", "DBPSK", "R1_4")
    fb = frame_bytes("MC_DPSK", kind, "R1_4", b"a data frame long enough for a window over 131072")
    audio = awgn(np.asarray(jw.tx_frame(fb)), 0.0, seed=nfft % 7)
    assert (len(audio) > 131072) == (kind == "data")
    det = t_chirp.chirp_detector(tw.cfg.chirp, len(audio), torch.device("cpu"))
    assert det.nfft == nfft and det.zoom
    same_sync(tw.detect_sync(audio), jw.detect_sync(audio))
    want, got = jw.rx_frame(audio), tw.rx_frame(audio)
    assert got.ok
    same_rx(got, want)
