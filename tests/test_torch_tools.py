"""The port's waveform-level root tools on the CPU, held against the
reference's tools on the same inputs.

- ``verify_cfo_chain``: the dual-chirp estimate and carrier 0's phase slopes
  before and after the correction within 1e-3 Hz of the reference tool's
  (read from inside its ``main``);
- ``otfs_mode_sweep`` at 2 seeds: every arm's per-seed outcome equal to the
  reference tool's, its ``jax.random`` keys replayed (key = seed);
- ``profile_acquisition`` at B = 2, one timed call a row: its six rows.

The acceptance sweep has a file of its own (``test_torch_tools_acceptance.py``),
the goodput tool sits with its mirror (``test_torch_goodput.py``).
"""

import sys

import jax
import numpy as np
import torch

import test_torch_jax_draws as D
from ria_tpu_torch.tools import otfs_mode_sweep, profile_acquisition, verify_cfo_chain

torch.set_num_threads(1)

CFO_TOL_HZ = 1e-3


def replayed_draws(key: int, shape, cfg) -> dict:
    """The normals ``ria_tpu.sim.apply_channel`` draws from ``PRNGKey(key)``."""
    return D.oneshot_draws(jax.random.PRNGKey(key), shape)


def test_verify_cfo_chain_matches_the_reference_tool(monkeypatch, capsys):
    import ria_tpu.sync.chirp as JC
    import tools.verify_cfo_chain as ref

    seen = {"cfo": [], "slopes": []}
    detect, slope = JC.detect_dual_chirp, ref.phase_slope_hz

    def detect_seen(*a, **kw):
        res = detect(*a, **kw)
        seen["cfo"].append(float(res.cfo_hz))
        return res

    def slope_seen(*a, **kw):
        seen["slopes"].append(slope(*a, **kw))
        return seen["slopes"][-1]

    monkeypatch.setattr(JC, "detect_dual_chirp", detect_seen)
    monkeypatch.setattr(ref, "phase_slope_hz", slope_seen)
    monkeypatch.setattr(sys, "argv", ["verify_cfo_chain", "--cfo", "12.0"])
    assert ref.main() == 0
    assert capsys.readouterr().out.strip().endswith("PASS")

    got = verify_cfo_chain.measure(12.0, "cpu")
    want = {"estimate": seen["cfo"][0], "slope_pre": seen["slopes"][0],
            "slope_post": seen["slopes"][1]}
    for k, v in want.items():
        assert abs(got[k] - v) <= CFO_TOL_HZ, (k, got[k], v)
    assert got["ok"]
    assert verify_cfo_chain.main(["--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip().endswith("PASS")


def test_otfs_mode_sweep_matches_the_reference_tool(monkeypatch, capsys):
    """Both tools at ``--seeds 2``; the reference's per-seed outcomes are read
    from its decodes in call order (channel, then mode, then seed)."""
    import ria_tpu.fec as JF
    import ria_tpu.wave.api as JAPI
    import tools.otfs_mode_sweep as ref

    outcomes = []
    decode_soft, create = JF.LDPCCodec.decode_soft, JAPI.create_waveform

    def decode_seen(self, soft):
        ok, dec = decode_soft(self, soft)
        outcomes.append(bool(ok and dec[: len(otfs_mode_sweep.PAYLOAD)]
                             == otfs_mode_sweep.PAYLOAD))
        return ok, dec

    def create_seen(*a, **kw):
        wf = create(*a, **kw)
        rx_frame = wf.rx_frame

        def rx_seen(*a, **kw):
            rx = rx_frame(*a, **kw)
            outcomes.append(bool(rx.ok))
            return rx

        wf.rx_frame = rx_seen
        return wf

    monkeypatch.setattr(JF.LDPCCodec, "decode_soft", decode_seen)
    monkeypatch.setattr(JAPI, "create_waveform", create_seen)
    seeds = 2
    assert ref.main(["--seeds", str(seeds)]) == 0
    ref_table = capsys.readouterr().out

    got = otfs_mode_sweep.sweep(seeds, 20.0, "cpu", replayed_draws)
    port_table = capsys.readouterr().out
    flat = [ok for ch in otfs_mode_sweep.CHANNELS for m in otfs_mode_sweep.MODES
            for ok in got[ch][m]]
    assert flat == outcomes, (port_table, ref_table)
    assert port_table == ref_table


def test_profile_acquisition_prints_its_six_rows(capsys):
    ms = profile_acquisition.profile(batch=2, iters=1, device="cpu")
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "device: cpu  batch: 2  (host clock)"
    assert [line.split()[0] for line in out[1:]] == ["chirp", "ZC", "mc-dpsk", "ofdm",
                                                     "schmidl-cox", "ldpc"]
    assert list(ms) == ["chirp_sync_120k", "zc_sync_48k", "mc_dpsk_demod_4cw",
                        "ofdm_demod_4cw", "schmidl_cox_48k", "ldpc_r14_4b"]
    assert all(np.isfinite(v) and v > 0 for v in ms.values())
    assert "ldpc R1/4     8 cw (noise)" in out[-1]

