"""``ria_tpu_torch.phy.modem`` against ``ria_tpu.phy.modem`` on the CPU.

``MCDPSKModem.tx_frame`` audio within 1e-5 of the reference's for the same
bytes; ``rx_frame`` on the same noisy audio: ok, bytes, header, per-CW flags
and start exact, soft bits within 2e-3, SNR, CFO and fading within 1e-3.
"""

import numpy as np
import pytest
import torch

from ria_tpu.phy import frame_v2 as JF
from ria_tpu.phy.modem import MCDPSKModem as JModem
from ria_tpu.wave.mc_dpsk import MCDPSKConfig as JConfig
from ria_tpu_torch.phy import frame_v2 as TF
from ria_tpu_torch.phy.modem import AudioBuffer, MCDPSKModem, host_scalars
from ria_tpu_torch.tools import waveform_frames as F
from ria_tpu_torch.wave.mc_dpsk import MCDPSKConfig

torch.set_num_threads(1)


CASES = [
    ("dbpsk_data", dict(bits_per_symbol=1), False, "data", 0.0, 0.0),
    ("dqpsk_data_ci", dict(bits_per_symbol=2), True, "data", 3.0, 12.5),
    ("dbpsk_2x_control", dict(bits_per_symbol=1, spreading=2), False, "control", -6.0, -4.0),
]


@pytest.mark.parametrize("name,cfg_kw,ci,kind,snr_db,cfo", CASES, ids=[c[0] for c in CASES])
def test_modem_matches_reference(name, cfg_kw, ci, kind, snr_db, cfo):
    jm = JModem(JConfig(**cfg_kw), "R1_4", channel_interleave=ci)
    tm = MCDPSKModem(MCDPSKConfig(**cfg_kw), "R1_4", channel_interleave=ci, device="cpu")
    if kind == "data":
        fb = JF.DataFrame.make_data("W1AW", "VE3ABC", 4, b"modem parity payload " * 2).serialize()
        assert fb == TF.DataFrame.make_data("W1AW", "VE3ABC", 4,
                                            b"modem parity payload " * 2).serialize()
    else:
        fb = JF.ControlFrame.make_ack("W1AW", JF.hash_callsign("VE3ABC"), seq=21).serialize()
    want_tx = np.asarray(jm.tx_frame(fb, tx_cfo_hz=cfo))
    got_tx = tm.tx_frame(fb, tx_cfo_hz=cfo)
    assert got_tx.shape == want_tx.shape and got_tx.dtype == np.float32
    assert np.max(np.abs(got_tx - want_tx)) <= 1e-5
    assert tm.frame_duration_samples(len(fb)) == jm.frame_duration_samples(len(fb))

    # tx_cfo_hz moves the chirp only (the body keeps its carriers), so the
    # receive comparison runs on the frame sent without it.
    audio = F.awgn(np.asarray(jm.tx_frame(fb)), snr_db, seed=len(name))
    want, got = jm.rx_frame(audio), tm.rx_frame(audio)
    assert got.ok, name
    F.same_rx(got, want)
    # A tensor and a prepared buffer give what the numpy array gave.
    for form in (torch.as_tensor(audio), AudioBuffer(audio, "cpu")):
        again = tm.rx_frame(form)
        assert again.frame_bytes == got.frame_bytes and again.start_sample == got.start_sample
        assert np.array_equal(again.soft_bits, got.soft_bits)


def test_modem_noise_only_and_headerless():
    jm, tm = JModem(), MCDPSKModem(device="cpu")
    noise = np.random.default_rng(3).normal(0, 0.1, 90000).astype(np.float32)
    want, got = jm.rx_frame(noise), tm.rx_frame(noise)
    assert not got.ok and got.frame_bytes is None
    F.same_rx(got, want)
    # A preamble with noise after it: sync, then no header.
    fb = JF.ControlFrame.make_ack("W1AW", JF.hash_callsign("VE3ABC"), seq=2).serialize()
    tx = np.asarray(jm.tx_frame(fb))
    cut = tx.copy()
    pre = jm.cfg.preamble_samples
    cut[pre:] = np.random.default_rng(4).normal(0, 0.2, len(tx) - pre).astype(np.float32)
    audio = F.awgn(cut, 20.0, seed=5)
    want, got = jm.rx_frame(audio), tm.rx_frame(audio)
    assert not got.ok and got.start_sample >= 0
    F.same_rx(got, want)


def test_audio_buffer_uploads_once_and_pads():
    host = np.arange(10, dtype=np.float32)
    buf = AudioBuffer(host, "cpu")
    assert len(buf) == 10 and buf.device.type == "cpu"
    assert buf.chunk(6, 8).tolist() == [6.0, 7.0, 8.0, 9.0, 0.0, 0.0, 0.0, 0.0]
    assert buf.chunk(12, 3).tolist() == [0.0, 0.0, 0.0]
    assert np.array_equal(buf.host(2, 5), host[2:5])
    from_tensor = AudioBuffer(torch.as_tensor(host), "cpu")
    assert np.array_equal(from_tensor.host(2, 5), host[2:5])
    readonly = np.frombuffer(host.tobytes(), np.float32)
    assert AudioBuffer(readonly, "cpu").chunk(0, 2).tolist() == [0.0, 1.0]
    assert host_scalars(torch.tensor(True), torch.tensor(7, dtype=torch.int32),
                        torch.tensor(0.5)) == [1.0, 7.0, 0.5]
