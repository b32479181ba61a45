"""The reference's routing decisions, reached by the port in lock step.

Sessions S2 (6 dB AWGN, seed 3, eight messages: both stations move to the
16-carrier DQPSK R1/2 MC-DPSK profile through MC_PROFILE) and S3 (Poor
15 dB, seed 42: the handshake's channel probe routes the link to OTFS) run
in the reference's and the port's ``DualStationSim`` with the reference's
draws replayed, tick for tick as in tests/test_torch_session.py.
"""

import torch

from test_torch_session import lock_step_with_reference

torch.set_num_threads(1)


def test_session_s2_mc_profile_upgrade_tick_for_tick():
    run = lock_step_with_reference("S2")
    out = run["outs"][0]
    assert out["connected"] and out["messages"] == 8, out
    assert out["final_link"] == "MC_DPSK 16c DQPSK R1_2", out
    for sim in run["sims"]:
        for st in (sim.alpha, sim.bravo):
            link = st.conn.link
            assert (link.mc_carriers, link.modulation, link.rate) == (16, "DQPSK", "R1_2")
            assert st.data_wf.cfg.num_carriers == 16
    print(f"S2: {run['ticks']} ticks equal, max |snr err| {run['max_snr_err']:.3g} dB, "
          f"{out['link']} -> {out['final_link']}")


def test_session_s3_otfs_routing_tick_for_tick():
    run = lock_step_with_reference("S3")
    out = run["outs"][0]
    assert out["connected"] and out["messages"] == 2, out
    assert out["link"].startswith("OTFS") and out["final_link"].startswith("OTFS"), out
    last = run["snapshots"][-1]
    assert last["alpha"]["link"].startswith("OTFS") and last["bravo"]["link"].startswith("OTFS")
    print(f"S3: {run['ticks']} ticks equal, max |snr err| {run['max_snr_err']:.3g} dB, "
          f"{out['link']}")
