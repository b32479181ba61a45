"""A full protocol session of the port against the reference package, in
lock step, tick for tick.

Session S1 of ``ria_tpu_torch.tools.session_paths`` (the reference's
``test_full_session_awgn``: 12 dB AWGN, seed 7; PING, CONNECT, a message
each way, DISCONNECT) runs in ``ria_tpu.sim.simulator.DualStationSim`` and
in the port's ``DualStationSim`` on the CPU, the port fed the reference's
``jax.random`` draws (tests/test_torch_jax_draws.py).  After every 200 ms block
both stations' connection state and link, decode counters, ring length,
pending sync start and delivered messages must be equal, and the measured
SNR within 1e-3 dB; the first tick that differs fails the test.
"""

import torch

import test_torch_jax_draws as D
from ria_tpu.protocol.connection import ConnectionState as JState
from ria_tpu.sim.channel import PRESETS as J_PRESETS
from ria_tpu.sim.simulator import DualStationSim as JSim
from ria_tpu_torch.protocol.connection import ConnectionState as TState
from ria_tpu_torch.tools import session_paths as S

torch.set_num_threads(1)


def lock_step_with_reference(name: str) -> dict:
    s = S.SESSIONS[name]
    ref = JSim(J_PRESETS[s.channel](s.snr_db), seed=s.seed)
    port = S.make_sim(s, "cpu", D.sim_draws(s.seed))
    return S.lock_step([ref, port], s, [JState, TState])


def test_session_s1_matches_reference_tick_for_tick():
    run = lock_step_with_reference("S1")
    out = run["outs"][0]
    assert out["connected"] and out["messages"] == 2 and out["disconnected"], out
    assert out["got_b"] == [b"hello from alpha"] and out["got_a"] == [b"hello back"]
    # The reference's own run of this point: connected at tick 48, 82 ticks.
    assert (out["connect_ticks"], run["ticks"]) == (48, 82), (out["connect_ticks"], run["ticks"])
    assert out["link"] == "OFDM_CHIRP 10c D8PSK R1_2"
    print(f"S1: {run['ticks']} ticks equal, max |snr err| {run['max_snr_err']:.3g} dB")
    assert run["max_snr_err"] <= S.SNR_TOL_DB


def test_session_s1_on_torch_generator_draws_matches_reference():
    """S1 as ``chip_smoke.py`` phase 4e runs it on the card, fed CPU torch
    generators' draws (seeds 7 and 8), through the reference package (its
    channel given the same normals) and the port: tick for tick equal, so the
    card's run, held to the CPU port's, is held to the reference's."""
    from ria_tpu_torch.sim.channel import PRESETS as T_PRESETS
    from ria_tpu_torch.sim.channel import GeneratorDraws

    s = S.SESSIONS["S1"]
    shared = [D.SharedDraws(GeneratorDraws(seed, "cpu")) for seed in (s.seed, s.seed + 1)]
    ref = D.GivenDrawsSim(J_PRESETS[s.channel](s.snr_db), s.seed,
                          [x.side(0) for x in shared], T_PRESETS[s.channel](s.snr_db))
    port = S.make_sim(s, "cpu", [x.side(1) for x in shared])
    run = S.lock_step([ref, port], s, [JState, TState])
    S.check_outcome(s, run["outs"][0])
    assert run["max_snr_err"] <= S.SNR_TOL_DB


def test_stage_timer_splits_a_session():
    """The timer chip_smoke.py splits a card session's ticks with, on a CPU
    session: every stage of S1 is met, and the wrapped methods are put back."""
    from ria_tpu_torch.sim.simulator import DualStationSim
    from ria_tpu_torch.wave import api

    inner = (DualStationSim._channel, api.MCDPSKWaveform.detect_sync,
             api._OFDMWaveformBase._rx_at)
    s = S.SESSIONS["S1"]
    with S.StageTimer(lambda: None, device_type="cpu") as timer:
        out = S.run(s, "cpu")
    assert timer.calls["channel"] == 2 * out["ticks"]
    assert min(timer.calls[k] for k in ("detect_sync", "peek_header", "rx_frame")) >= 1
    assert 0 < sum(timer.totals.values()) <= sum(out["tick_ms"]) + 1.0
    assert (DualStationSim._channel, api.MCDPSKWaveform.detect_sync,
            api._OFDMWaveformBase._rx_at) == inner
