"""The host-control plane on the card (needs a GPU).

Imports no JAX, so it runs on a GPU host that has none:

    python -m pytest -q -m cuda tests/test_torch_host_interface_cuda.py

Without a card every test skips.  H1 of ``ria_tpu_torch.tools.host_paths``
(two modems driven only over TCP) runs with its stations on the card and on
the CPU in lock step, both fed one CPU generator's draws (seeds 42 and 43):
every block equal (stations as in a session snapshot, measured SNR within
1e-3 dB; engine states, command replies, event lines and the bytes out of
each data port exact), every K1 launch of the card run held against the
plain decoder on its own LLRs, and no K2 launch.  H2, the threaded
continuous session, connects and delivers from two station threads on the
card within 120 s, each K1 launch counted and held.  The CPU side is held
against the JAX package by tests/test_torch_host_interface.py.
"""

import pytest
import torch

from ria_tpu_torch.protocol.connection import ConnectionState
from ria_tpu_torch.sim.channel import GeneratorDraws, awgn
from ria_tpu_torch.tools import host_paths as H
from ria_tpu_torch.tools import waveform_frames as F
from ria_tpu_torch.tools.dual_modem_tcp import DualModemTcp

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: every decode of the stations is K1, which is CUDA C++")
    return torch.device("cuda", 0)


def _dual_modem(device):
    draws = tuple(GeneratorDraws(seed, device, "cpu") for seed in (H.H1_SEED, H.H1_SEED + 1))
    return DualModemTcp(awgn(H.H1_SNR_DB), seed=H.H1_SEED, base_port_a=0, base_port_b=0,
                        device=device, draws=draws)


@pytest.mark.cuda
def test_h1_on_card_matches_cpu(cuda_device):
    card, cpu = _dual_modem(cuda_device), _dual_modem("cpu")
    try:
        assert card.sim.alpha.handshake_wf.device.type == "cuda"
        run, k1, k2, calls = F.counted_k1(
            lambda: H.lock_step([card, cpu], [ConnectionState, ConnectionState]))
    finally:
        card.close()
        cpu.close()
    H.check_outcome(run["outs"][0])
    assert run["clients"][0].data_rx[1] == (H.SELF_TEST_PAYLOAD + H.MESSAGE
                                            + H.RAWTX_TEXT.encode())
    assert k1 >= 1 and k2 == 0 and len(calls) == k1
    rows = F.hold_k1_calls(calls, "H1")
    assert sum(r["converged"] for r in rows) >= 1
    assert run["max_snr_err"] <= 1e-3


@pytest.mark.cuda
def test_h2_threaded_session_on_card(cuda_device):
    run, k1, k2, calls = F.counted_k1(lambda: H.threaded_session(cuda_device))
    assert run["ok"], run
    assert run["sim"].alpha.handshake_wf.device.type == "cuda"
    assert k1 >= 1 and k2 == 0 and len(calls) == k1
    F.hold_k1_calls(calls, "H2")
