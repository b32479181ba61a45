"""The port's goodput tool (``ria_tpu_torch/tools/goodput.py``) on the CPU
against the reference's (``tools/goodput.py``), and the mirror of
tests/test_goodput.py.

Each session replays the reference simulator's ``jax.random`` keys
(``test_torch_jax_draws.sim_draws``).  ``measure_goodput("awgn", 25, 100)``
returns the reference tool's dict, every field equal; the same session
driven by ``session_paths.lock_step`` (as ``chip_smoke.py`` runs it, card
against CPU) is tick-equal to the reference package's simulator.  The
mirror (``slow``, as in the reference) asserts the reference test's proof
points: at AWGN 25 dB and Good 20 dB 10/10 seeds deliver everything, at
Moderate 20 dB at least 6/10, each at a median goodput of at least the
reference's 7.5, 4.9 and 2.7 kbps.
"""

import pytest
import torch

import test_torch_jax_draws as D
from ria_tpu_torch.tools import goodput
from ria_tpu_torch.tools import session_paths as S

torch.set_num_threads(1)


def test_measure_goodput_matches_the_reference_tool():
    from tools.goodput import measure_goodput as ref_measure

    want = ref_measure("awgn", 25.0, 100)
    got = goodput.measure_goodput("awgn", 25.0, 100, draws=D.sim_draws(100), device="cpu")
    assert got == want
    assert got["delivered"] == 1.0 and got["goodput_bps"] >= 7500.0


def test_goodput_session_in_lock_step_with_the_reference():
    """The goodput traffic of ``session_paths`` on both packages' simulators,
    every tick equal, and the port's result that of ``measure_goodput``."""
    from ria_tpu.protocol.connection import ConnectionState as JState
    from ria_tpu.sim.channel import PRESETS as J_PRESETS
    from ria_tpu.sim.simulator import DualStationSim as JSim
    from ria_tpu_torch.protocol.connection import ConnectionState as TState

    s = goodput.session("awgn", 25.0, 100)
    ref = JSim(J_PRESETS[s.channel](s.snr_db), seed=s.seed)
    port = goodput.make_sim(s.channel, s.snr_db, s.seed, "cpu", D.sim_draws(s.seed))
    run = S.lock_step([ref, port], s, [JState, TState])
    out = run["outs"][1]
    want = goodput.measure_goodput("awgn", 25.0, 100, draws=D.sim_draws(100), device="cpu")
    assert {k: out[k] for k in want} == want
    assert run["max_snr_err"] <= S.SNR_TOL_DB
    assert b"".join(out["got_b"]) == b"".join(run["outs"][0]["got_b"])


@pytest.mark.slow
@pytest.mark.parametrize("channel,snr,ref_kbps,min_delivered,n_seeds", [
    ("awgn", 25.0, 7.5, 10, 10),
    ("good", 20.0, 4.9, 10, 10),
    ("moderate", 20.0, 2.7, 6, 10),
])
def test_goodput_proof_point(channel, snr, ref_kbps, min_delivered, n_seeds):
    rs = [goodput.measure_goodput(channel, snr, 100 + s, draws=D.sim_draws(100 + s),
                                  device="cpu") for s in range(n_seeds)]
    full = [r for r in rs if r.get("delivered", 0.0) >= 1.0]
    assert len(full) >= min_delivered, (
        f"{channel}@{snr}: {len(full)}/{n_seeds} delivered (need {min_delivered}): "
        + "; ".join(f"{r.get('delivered', 0):.0%} {r.get('link', '?')}" for r in rs))
    bps = sorted(r["goodput_bps"] for r in full)
    median = bps[len(bps) // 2]
    assert median >= ref_kbps * 1000.0, (
        f"{channel}@{snr}: median goodput {median:.0f} bps < reference "
        f"{ref_kbps} kbps ({[round(b) for b in bps]})")
