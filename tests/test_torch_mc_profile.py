"""Mirror of tests/test_mc_profile.py on the port (CPU): the ACK-gated
MC-DPSK profile upgrade (FrameType.MC_PROFILE), through the port's
selection table, waveform and sessions, each test asserting what the
reference test asserts.  The sessions replay the reference simulator's
``jax.random`` keys (``test_torch_jax_draws.sim_draws``); the floor test
uses the reference test's numpy noise.  The 6 dB upgrade is S2 of
``test_torch_session_routing.py``, the ACK sequence range is in
``test_torch_protocol.py``.
"""

import numpy as np
import torch

import test_torch_jax_draws as D
from ria_tpu_torch.sim.channel import awgn, good
from ria_tpu_torch.sim.simulator import DualStationSim
from ria_tpu_torch.wave.api import MCDPSKWaveform
from ria_tpu_torch.wave.selection import recommend_mc_profile

torch.set_num_threads(1)


def test_profile_ladder_table():
    assert recommend_mc_profile(-4.0, 0.2) == (13, "DBPSK", "R1_2")
    assert recommend_mc_profile(4.5, 0.12) == (13, "DQPSK", "R1_2")
    assert recommend_mc_profile(7.0, 0.12) == (16, "DQPSK", "R1_2")
    assert recommend_mc_profile(-5.0, 0.2) is None
    assert recommend_mc_profile(6.0, 0.69) is None


def test_profile_floor_awgn_minus4():
    """13c DBPSK R1/2 decodes 10/10 at -4 dB AWGN."""
    from ria_tpu_torch.phy.frame_v2 import DataFrame

    wf = MCDPSKWaveform(num_carriers=13, modulation="DBPSK", rate="R1_2", device="cpu")
    fr = DataFrame.make_data("W1AW", "VE3ABC", 0, bytes(200)).serialize()
    tx = np.asarray(wf.tx_frame(fr, light=True), np.float32)
    rms = float(np.sqrt(np.mean(tx**2)))
    ok = 0
    for s in range(10):
        rng = np.random.default_rng(1000 + s)
        audio = np.concatenate([np.zeros(4000, np.float32), tx, np.zeros(6000, np.float32)])
        audio += rng.normal(0, rms * 10 ** (4 / 20), audio.shape).astype(np.float32)
        ok += bool(wf.rx_frame(audio, light=True).ok)
    assert ok == 10


def _run_session(chan, n_msgs=8, seed=3, nerf_bravo=False):
    sim = DualStationSim(chan, seed=seed, device="cpu", draws=D.sim_draws(seed))
    got = []
    sim.bravo.conn.on_message = got.append
    if nerf_bravo:
        # A reference peer: drops the unknown MC_PROFILE control type and
        # never proposes one itself.
        sim.bravo.conn._handle_mc_profile = lambda ctrl: None
        sim.bravo.conn.request_mc_profile = lambda *a, **k: False
    assert sim.alpha.conn.connect("BRAVO")
    assert sim.run_until(sim.both_connected, max_ticks=600)
    for i in range(n_msgs):
        sim.alpha.conn.send_message(b"payload %d " % i * 3)
    sim.run_until(lambda: len(got) >= n_msgs, max_ticks=8000)
    return sim, got


def test_session_upgrade_at_minus4_awgn():
    """At -4 dB AWGN both ends converge on the 13-carrier R1/2 profile and
    deliver everything."""
    sim, got = _run_session(awgn(-4.0))
    assert len(got) == 8
    for st in (sim.alpha, sim.bravo):
        link = st.conn.link
        assert (link.mc_carriers, link.modulation, link.rate) == (13, "DBPSK", "R1_2")
        assert st.data_wf.cfg.num_carriers == 13


def test_session_no_upgrade_on_fading():
    """Good-class fading: no upgrade, and traffic flows on the standard
    profile."""
    sim, got = _run_session(good(6.0), n_msgs=6)
    assert len(got) == 6
    assert sim.alpha.conn.link.mc_carriers == 10
    assert sim.alpha.conn.link.rate == "R1_4"


def test_reference_peer_never_upgrades():
    """A peer that ignores MC_PROFILE: the proposer stops after its attempt
    budget, stays on the standard profile, and delivery is unaffected."""
    sim, got = _run_session(awgn(6.0), nerf_bravo=True)
    assert len(got) == 8
    link = sim.alpha.conn.link
    assert link.mc_carriers == 10
    assert link.rate == "R1_4"
    assert sim.alpha.conn._profile_attempts <= sim.alpha.conn.MC_PROFILE_MAX_ATTEMPTS
