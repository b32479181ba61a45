"""The station layer on the card (needs a GPU).

Imports no JAX, so it runs on a GPU host that has none:

    python -m pytest -q -m cuda tests/test_torch_session_cuda.py

Without a card every test skips.  Session S1 of
``ria_tpu_torch.tools.session_paths`` (12 dB AWGN, seed 7) runs on the card
and on the CPU in lock step, both fed one CPU generator's draws: every tick
equal (connection states, links, counters, ring, pending sync, messages;
measured SNR within 1e-3 dB), every K1 launch of the card run held against
the plain decoder on its own LLRs, and no K2 launch.  The card station
against the CPU one, block by block, on the audio of each station scenario
(the port's TX plus seeded noise).  The CPU side is held against the JAX
package by tests/test_torch_session.py and tests/test_torch_station.py.
"""

import pytest
import torch

from ria_tpu_torch.phy import frame_v2 as TF
from ria_tpu_torch.phy import station as TS
from ria_tpu_torch.protocol.connection import ConnectionState
from ria_tpu_torch.tools import session_paths as S
from ria_tpu_torch.tools import waveform_frames as F
from ria_tpu_torch.wave import api as TA

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: every decode of a session is K1, which is CUDA C++")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_session_s1_on_card_matches_cpu(cuda_device):
    s = S.SESSIONS["S1"]
    card = S.make_sim(s, cuda_device, S.generator_draws(s, cuda_device, "cpu"))
    cpu = S.make_sim(s, "cpu", S.generator_draws(s, "cpu", "cpu"))
    assert card.alpha.handshake_wf.device.type == "cuda"
    run, k1, k2, calls = F.counted_k1(
        lambda: S.lock_step([card, cpu], s, [ConnectionState, ConnectionState]))
    S.check_outcome(s, run["outs"][0])
    assert k1 >= 1 and k2 == 0 and len(calls) == k1
    rows = F.hold_k1_calls(calls, "S1")
    assert sum(r["converged"] for r in rows) >= 1
    assert run["max_snr_err"] <= S.SNR_TOL_DB


@pytest.mark.cuda
@pytest.mark.parametrize("name", S.STATION_SCENARIOS)
def test_station_on_card_matches_cpu(name, cuda_device):
    frames, setup = S.station_scenario(name, TA, TF, device="cpu")
    audio = S.scenario_audio(frames, seed=S.STATION_SCENARIOS.index(name))
    card, card_got = S.scenario_station(TS, TA, TF, setup, device=cuda_device)
    cpu, cpu_got = S.scenario_station(TS, TA, TF, setup, device="cpu")
    block = setup.get("block", S.STATION_BLOCK)
    for i, off in enumerate(range(0, len(audio), block)):
        chunk = audio[off : off + block]
        for st in (card, cpu):
            st.feed_audio(chunk)
            st.tick(int(1000 * len(chunk) / 48000))
        want, have = S.station_view(cpu, cpu_got), S.station_view(card, card_got)
        assert have == want, f"{name}: block {i} differs:\n card {have}\n cpu  {want}"
        assert S.floor_close(cpu._noise_floor, card._noise_floor), name
    field, count = S.STATION_EXPECT[name]
    assert S.station_view(card, card_got)["stats"][field] == count


@pytest.mark.cuda
def test_s3_on_the_card_generator_stream_card_matches_cpu(cuda_device):
    """S3 (Poor 15 dB, seed 42) fed a CUDA generator's draws, on the card and
    on the CPU port: every tick equal to the end.  The card's float32 scan
    once made the sliding energy over a search window's zero-padded tail
    nonzero, lowered the ZC floor and detected a preamble the CPU did not,
    mid-session; the sync energies now sum as the CPU does
    (``utils.device.wide_cumsum``)."""
    s = S.SESSIONS["S3"]
    card = S.make_sim(s, cuda_device, S.generator_draws(s, cuda_device, cuda_device))
    cpu = S.make_sim(s, "cpu", S.generator_draws(s, "cpu", cuda_device))
    run = S.lock_step([card, cpu], s, [ConnectionState, ConnectionState])
    assert run["max_snr_err"] <= S.SNR_TOL_DB
