"""The port's session on a card's draw stream, run through the reference.

Needs a GPU for the numbers only: a CUDA ``torch.Generator`` (the default
draw source of the port's ``DualStationSim`` on the card) draws a stream the
CPU cannot reproduce.  Session S3 of ``ria_tpu_torch.tools.session_paths``
(Poor 15 dB, seed 42) fed that stream runs in the reference package (its
channel given the same normals, tests/test_torch_jax_draws.py) and in the port
on the CPU, in lock step: every tick equal, so whatever the session's
outcome on that stream, it is the reference protocol's own.  Without a card
the test skips.
"""

import pytest
import torch

import test_torch_jax_draws as D
from ria_tpu.protocol.connection import ConnectionState as JState
from ria_tpu.sim.channel import PRESETS as J_PRESETS
from ria_tpu_torch.protocol.connection import ConnectionState as TState
from ria_tpu_torch.sim.channel import PRESETS as T_PRESETS
from ria_tpu_torch.sim.channel import GeneratorDraws
from ria_tpu_torch.tools import session_paths as S

torch.set_num_threads(1)


@pytest.mark.cuda
def test_s3_on_the_card_generator_stream_is_the_reference_outcome():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the draws come from a CUDA torch.Generator")
    s = S.SESSIONS["S3"]
    shared = [D.SharedDraws(GeneratorDraws(seed, "cpu", generator_device="cuda"))
              for seed in (s.seed, s.seed + 1)]
    ref = D.GivenDrawsSim(J_PRESETS[s.channel](s.snr_db), s.seed,
                          [x.side(0) for x in shared], T_PRESETS[s.channel](s.snr_db))
    port = S.make_sim(s, "cpu", [x.side(1) for x in shared])
    run = S.lock_step([ref, port], s, [JState, TState])
    out = run["outs"][0]
    print(f"S3 on the CUDA generator's stream: {run['ticks']} ticks equal, max |snr err| "
          f"{run['max_snr_err']:.3g} dB; {S.check_outcome(S.SESSIONS['S4'], out)}")
    assert run["max_snr_err"] <= S.SNR_TOL_DB
