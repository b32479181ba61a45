"""Mirror of tests/test_session_floors.py on the port (CPU), ``slow`` as in
the reference: complete adaptive sessions (PING, CONNECT with measured-SNR
negotiation, DATA x2, DISCONNECT) through the port's
``tools/cli_simulator.py::run_session``, no forced modes, the reference
simulator's ``jax.random`` keys replayed (``test_torch_jax_draws.sim_draws``).
Each case asserts what the reference case asserts.
"""

import types

import pytest
import torch

import test_torch_jax_draws as D
from ria_tpu_torch.tools.cli_simulator import run_session

torch.set_num_threads(1)


def _run(snr: float, channel: str, cfo: float = 0.0, seed: int = 42) -> dict:
    args = types.SimpleNamespace(snr=snr, channel=channel, waveform="AUTO", mod="AUTO",
                                 rate="AUTO", num_messages=2, file=False, save_signals=None,
                                 cfo=cfo, device="cpu")
    return run_session(args, seed, draws=D.sim_draws(seed))


@pytest.mark.slow
@pytest.mark.parametrize("snr,channel,cfo", [
    (-11.0, "awgn", 0.0),
    (-8.0, "good", 0.0),
    (10.0, "awgn", 8.0),
    (10.0, "awgn", -8.0),
])
def test_session_floor(snr, channel, cfo):
    r = _run(snr, channel, cfo)
    assert r["connected"], f"no connect at {snr} dB {channel} cfo={cfo}"
    assert r["messages"] == 2, f"delivery failed at {snr} dB {channel} cfo={cfo}: {r}"


@pytest.mark.slow
@pytest.mark.parametrize("snr,channel,seed,want_wave", [
    (20.0, "moderate", 42, None),
    (20.0, "moderate", 43, None),
    (20.0, "moderate", 44, None),
    (15.0, "poor", 42, "OTFS"),
    (15.0, "poor", 43, "OTFS"),
    (15.0, "poor", 44, "OTFS"),
    (20.0, "flutter", 42, None),
    (20.0, "flutter", 43, None),
    (20.0, "flutter", 44, None),
])
def test_session_floor_channel_classes(snr, channel, seed, want_wave):
    r = _run(snr, channel, seed=seed)
    assert r["connected"], f"no connect at {snr} dB {channel} seed={seed}"
    assert r["messages"] == 2, f"delivery failed at {snr} dB {channel} seed={seed}: {r}"
    if want_wave is not None:
        link = r.get("final_link") or r.get("link") or ""
        assert want_wave in link, (f"{channel}@{snr} seed={seed}: expected {want_wave} "
                                   f"routing, got {link!r}")
