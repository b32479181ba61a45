"""Mirror of tests/test_throughput.py on the port (CPU): the throughput
table of ``ria_tpu_torch/tools/throughput_test.py`` equal to the reference
tool's row for row, the QAM16 R1/2 sparse-pilot layout decoding on the
reference's channels, and the SNR estimator's convention, with the
reference's ``jax.random`` keys replayed as the port's channel draws.
Each test asserts what the reference test asserts.
"""

from dataclasses import replace

import numpy as np
import torch

from test_torch_tools import replayed_draws
from ria_tpu_torch.tools import throughput_test as TT

torch.set_num_threads(1)

REL_TOL = 1e-9


def test_operating_points_meet_reference_net():
    """The reference test's acceptance on the port's rows (every row beats
    the reference binary's net by 5%, none below 0.90 of the published
    table, at least 8 of 12 beat it), and each row equal to the reference
    tool's: every string exact, every number within 1e-9 relative."""
    import tools.throughput_test as ref

    rows = TT.measure_rows("cpu")
    want = ref.measure_rows()
    assert len(rows) == len(want) == 12
    for got, exp in zip(rows, want):
        assert got.keys() == exp.keys()
        for k, v in exp.items():
            if isinstance(v, float):
                assert abs(got[k] - v) <= REL_TOL * abs(v), (got["name"], k, got[k], v)
            else:
                assert got[k] == v, (got["name"], k)
    bad = [(r["name"], r["steady_desc"], round(r["net_vs_binary"], 3))
           for r in rows if r["net_vs_binary"] < 1.05]
    assert not bad, f"rows not beating the reference binary's net: {bad}"
    low = [(r["name"], round(r["net_ratio"], 3)) for r in rows if r["net_ratio"] < 0.90]
    assert not low, f"rows below 0.90x of the published table: {low}"
    beats = sum(1 for r in rows if r["net_ratio"] >= 0.995)
    assert beats >= 8, f"only {beats}/12 rows beat the published table"


def test_qam16_r12_sparse_pilots_decode():
    """The 56+3 sparse pilot layout decodes on the reference test's two
    channels (18 dB AWGN, key 3; the same with 5 Hz CFO, key 4)."""
    from ria_tpu_torch.phy.frame_v2 import DataFrame, WaveformMode, make_fixed_data_frame
    from ria_tpu_torch.sim import apply_channel, awgn
    from ria_tpu_torch.wave import ofdm
    from ria_tpu_torch.wave.api import create_waveform
    from ria_tpu_torch.wave.selection import sparse_pilot_spacing

    wf = create_waveform(WaveformMode.OFDM_CHIRP, "QAM16", "R1_2", device="cpu")
    assert wf.cfg.num_data_carriers == 47  # reference wire layout by default
    wf.cfg = ofdm.OFDMConfig(modulation="QAM16", use_pilots=True,
                             pilot_spacing=sparse_pilot_spacing("QAM16", "R1_2"))
    assert wf.cfg.num_data_carriers == 56  # 3 pilots at spacing 20
    payload = bytes(range(100))
    frame = make_fixed_data_frame("W1AW", "VE3ABC", 2, payload, "R1_2")
    cfo_ch = replace(awgn(18.0), cfo_hz=5.0, cfo_enabled=True)
    for ch, seed in [(awgn(18.0), 3), (cfo_ch, 4)]:
        tx = wf.tx_frame(frame.serialize())
        audio = np.concatenate([np.zeros(3000, np.float32), tx, np.zeros(4000, np.float32)])
        out = apply_channel(audio, ch, replayed_draws(seed, audio.shape, ch), device="cpu")
        rx = wf.rx_frame(out.samples.numpy())
        assert rx.ok, f"QAM16 R1/2 sparse pilots failed on {ch}"
        g = DataFrame.deserialize(rx.frame_bytes)
        assert g.payload[: len(payload)] == payload


def test_snr_estimator_convention():
    """The measured SNR tracks the simulator's definition within 0.7 dB at
    10, 18 and 25 dB (key 1)."""
    from ria_tpu_torch.phy.frame_v2 import ConnectFrame, FrameType
    from ria_tpu_torch.sim import apply_channel, awgn
    from ria_tpu_torch.wave.api import MCDPSKWaveform

    fb = ConnectFrame(type=FrameType.CONNECT, seq=1, src_callsign="W1AW",
                      dst_callsign="VE3ABC").serialize()
    for true_snr in (10.0, 18.0, 25.0):
        wf = MCDPSKWaveform(modulation="DBPSK", rate="R1_4", device="cpu")
        tx = wf.tx_frame(fb)
        audio = np.concatenate([np.zeros(30000, np.float32), tx, np.zeros(4000, np.float32)])
        ch = awgn(true_snr)
        out = apply_channel(audio, ch, replayed_draws(1, audio.shape, ch), device="cpu")
        rx = wf.rx_frame(out.samples.numpy())
        assert rx.ok
        assert abs(rx.snr_db - true_snr) < 0.7, (true_snr, rx.snr_db)
