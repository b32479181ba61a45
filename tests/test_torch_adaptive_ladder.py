"""Mirror of tests/test_adaptive_ladder.py on the port (CPU), ``slow`` as in
the reference: the good-fading SNR sweep of ``tools/adaptive_session_sweep.py``
(every point delivers and negotiates the pinned link) and the in-session
upgrade paths, through the port's sessions with the reference simulator's
``jax.random`` keys replayed (``test_torch_jax_draws.sim_draws``).  Each
test asserts what the reference test asserts.
"""

import pytest
import torch

import test_torch_jax_draws as D
from ria_tpu_torch.phy.frame_v2 import WaveformMode
from ria_tpu_torch.protocol.connection import ConnectionConfig, LinkMode
from ria_tpu_torch.sim.channel import awgn, good
from ria_tpu_torch.sim.simulator import DualStationSim
from ria_tpu_torch.tools.adaptive_session_sweep import session_args
from ria_tpu_torch.tools.cli_simulator import run_session

torch.set_num_threads(1)

# (snr_db, the link negotiated) of the reference's sweep (seed 42, good fading).
SWEEP_POINTS = [
    (-8.0, "MC_DPSK DBPSK R1_4 x2"),
    (-5.0, "MC_DPSK DBPSK R1_4"),
    (0.0, "MC_DPSK DBPSK R1_4"),
    (6.0, "MC_DPSK DQPSK R1_4"),
    (12.0, "OTFS_EQ QPSK R1_2"),
    (18.0, "OFDM_CHIRP DQPSK R1_2"),
    (25.0, "OFDM_CHIRP DQPSK R1_2"),
]


def _link_str(link: LinkMode) -> str:
    s = f"{link.waveform.name} {link.modulation} {link.rate}"
    if link.spreading > 1:
        s += f" x{link.spreading}"
    return s


@pytest.mark.slow
@pytest.mark.parametrize("snr,expected", SWEEP_POINTS,
                         ids=[f"{s:+.0f}dB" for s, _ in SWEEP_POINTS])
def test_good_fading_ladder_point(snr, expected):
    r = run_session(session_args(snr, "good", device="cpu"), 42, draws=D.sim_draws(42))
    assert r["connected"] and r["messages"] == 2, r
    assert r["final_link"] == expected, (r["final_link"], expected)


def _upgrade_session(chan, n_msgs, no_otfs=False, seed=3):
    kw = {}
    if no_otfs:
        caps = (0x3F & ~(1 << int(WaveformMode.OTFS_EQ))
                & ~(1 << int(WaveformMode.OTFS_RAW))) | 0x40
        kw = {"config_a": ConnectionConfig(mode_capabilities=caps),
              "config_b": ConnectionConfig(mode_capabilities=caps)}
    sim = DualStationSim(chan, seed=seed, device="cpu", draws=D.sim_draws(seed), **kw)
    got = []
    sim.bravo.conn.on_message = got.append
    assert sim.alpha.conn.connect("BRAVO")
    assert sim.run_until(sim.both_connected, max_ticks=600)
    for i in range(n_msgs):
        sim.alpha.conn.send_message(b"ladder %02d " % i * 4)
    sim.run_until(lambda: len(got) >= n_msgs, max_ticks=8000)
    return sim, got


@pytest.mark.slow
def test_d8psk_rung_engages_at_15db_awgn():
    """15 dB AWGN bootstraps D8PSK R1/2 and the adapter lifts it to R2/3."""
    sim, got = _upgrade_session(awgn(15.0), 10)
    assert len(got) == 10
    sim.run_until(lambda: sim.alpha.conn.link.rate == "R2_3"
                  and sim.bravo.conn.link.rate == "R2_3", max_ticks=6000)
    link = sim.alpha.conn.link
    assert (link.waveform, link.modulation, link.rate) == \
        (WaveformMode.OFDM_CHIRP, "D8PSK", "R2_3"), _link_str(link)


@pytest.mark.slow
def test_d8psk_fallback_on_fading():
    """A stale D8PSK link on Good-class fading steps down to DQPSK after a
    failure streak, and traffic completes."""
    sim, got = _upgrade_session(good(18.0), 0, seed=4)
    for st in (sim.alpha, sim.bravo):
        st.conn.link = LinkMode(waveform=WaveformMode.OFDM_CHIRP, modulation="D8PSK",
                                rate="R2_3")
        st._on_mode_changed(st.conn.link)
    got2 = []
    sim.bravo.conn.on_message = got2.append
    for i in range(8):
        sim.alpha.conn.send_message(b"fall %d " % i * 4)
    sim.run_until(lambda: len(got2) >= 8, max_ticks=8000)
    assert len(got2) == 8
    assert sim.alpha.conn.link.modulation == "DQPSK"


@pytest.mark.slow
def test_r12_upgrade_at_10db_good_backs_r14_row():
    """At 10 dB Good the steady mode is OFDM DQPSK R1/2."""
    sim, got = _upgrade_session(good(10.0), 12, no_otfs=True)
    assert len(got) == 12
    sim.run_until(lambda: sim.alpha.conn.link.rate == "R1_2"
                  and sim.bravo.conn.link.rate == "R1_2", max_ticks=6000)
    for st in (sim.alpha, sim.bravo):
        link = st.conn.link
        assert (link.waveform, link.modulation, link.rate) == \
            (WaveformMode.OFDM_CHIRP, "DQPSK", "R1_2"), _link_str(link)


@pytest.mark.slow
def test_qam16_r23_upgrade_at_18db_awgn_backs_qam16_row():
    """At 18 dB AWGN the steady mode is OFDM QAM16 R2/3."""
    sim, got = _upgrade_session(awgn(18.0), 10)
    assert len(got) == 10
    link = sim.alpha.conn.link
    assert (link.waveform, link.modulation, link.rate) == \
        (WaveformMode.OFDM_CHIRP, "QAM16", "R2_3"), _link_str(link)
