"""Mirror of tests/test_burst.py on the port (CPU): the stream-packed burst
(one light preamble, a group of frames packed into one codeword stream
striped across all codewords), through the port's waveform, frame and
station code, each test asserting what the reference test asserts.

The channels replay the reference's ``jax.random`` keys: the 24 dB QAM64
rung ``PRNGKey(200 + s)``, the sessions the reference simulator's keys
(``test_torch_jax_draws.sim_draws``).  The negotiated-burst session runs in
lock step with ``ria_tpu``'s, tick for tick, as S1 does
(``test_torch_session.py``).
"""

import os

import numpy as np
import torch

import test_torch_jax_draws as D
from test_torch_tools import replayed_draws
from ria_tpu_torch.phy.frame_v2 import (WaveformMode, burst_stream_codewords,
                                        make_fixed_data_frame)
from ria_tpu_torch.protocol.connection import (ConnectionConfig, ConnectionState,
                                               burst_group_for_snr)
from ria_tpu_torch.sim.channel import awgn
from ria_tpu_torch.sim.simulator import DualStationSim
from ria_tpu_torch.tools import session_paths as S
from ria_tpu_torch.wave.api import OFDMChirpWaveform

torch.set_num_threads(1)


def _frames(rate="R1_2", n=4):
    return [make_fixed_data_frame("W1AW", "VE3ABC", i, bytes([i]) * 20, rate,
                                  flags_extra=0x20).serialize()
            for i in range(n)]


def test_burst_waveform_roundtrip_and_marker():
    """tx_burst sends a 3-LTS (burst-marked) stream; rx_burst recovers every
    logical frame; a normal frame still reads as 2 repeats."""
    wf = OFDMChirpWaveform(modulation="DQPSK", rate="R1_2", device="cpu")
    frames = _frames()
    rng = np.random.default_rng(0)
    tx = wf.tx_burst(frames)
    audio = np.concatenate([np.zeros(4000, np.float32), tx, np.zeros(4000, np.float32)])
    rms = float(np.sqrt(np.mean(tx**2)))
    audio += rng.normal(0, rms * 10 ** (-18 / 20), audio.shape).astype(np.float32)

    sync = wf.detect_sync(audio, light=True)
    assert sync is not None and sync["lts_repeats"] == 3
    out, snr, _fading = wf.rx_burst(audio, 4, sync=sync)
    assert all(ok for ok, _ in out)
    assert [fb for _, fb in out] == frames

    single = wf.tx_frame(frames[0], light=True)
    a2 = np.concatenate([np.zeros(4000, np.float32), single, np.zeros(4000, np.float32)])
    a2 += rng.normal(0, rms * 10 ** (-18 / 20), a2.shape).astype(np.float32)
    s2 = wf.detect_sync(a2, light=True)
    assert s2 is not None and s2["lts_repeats"] == 2


def test_burst_stream_packs_less_air_than_per_frame():
    for rate, group in (("R1_4", 8), ("R1_2", 8), ("R2_3", 16), ("R3_4", 16)):
        assert burst_stream_codewords(group, rate) < 4 * group


def test_burst_survives_quarter_body_fade():
    """A deep fade over a quarter of the burst body: every logical frame
    still decodes; the same fade on one per-frame TX destroys that frame."""
    wf = OFDMChirpWaveform(modulation="DQPSK", rate="R1_2", device="cpu")
    frames = _frames()
    rng = np.random.default_rng(1)
    tx = wf.tx_burst(frames)
    lead = 4000
    audio = np.concatenate([np.zeros(lead, np.float32), tx, np.zeros(4000, np.float32)])
    rms = float(np.sqrt(np.mean(tx**2)))
    ncw = wf.burst_codewords(4)
    body_syms = wf.cfg.num_symbols_for_bits(ncw * 648)
    sym = wf.cfg.symbol_samples
    wipe_syms = body_syms // 4
    f_start = lead + (3 + 2 * wipe_syms) * sym  # mid-burst span
    audio[f_start : f_start + wipe_syms * sym] = 0.0
    audio += rng.normal(0, rms * 10 ** (-18 / 20), audio.shape).astype(np.float32)

    out, _, _ = wf.rx_burst(audio, 4)
    assert all(ok for ok, _ in out), [ok for ok, _ in out]
    assert [fb for _, fb in out] == frames

    singles = [wf.tx_frame(fb, light=True) for fb in frames]
    a2 = np.concatenate([np.zeros(lead, np.float32)] + singles + [np.zeros(4000, np.float32)])
    pos = lead + sum(len(s) for s in singles[:2])
    a2[pos : pos + len(singles[2])] = 0.0
    a2 += rng.normal(0, rms * 10 ** (-18 / 20), a2.shape).astype(np.float32)
    hit = wf.rx_frame(a2[pos : pos + len(singles[2]) + 2000], light=True)
    assert not hit.ok


def test_burst_group_snr_ladder():
    assert burst_group_for_snr(5.0) == 4
    assert burst_group_for_snr(12.0) == 8
    assert burst_group_for_snr(20.0) == 16


def _burst_traffic(sim, out, ConnectionState):
    """The reference test's session, one block per ``yield``: connect, then
    one message that fragments into exactly ``burst_group`` chunks."""
    got = out.setdefault("got_b", [])
    out.setdefault("got_a", [])
    sim.bravo.conn.on_message = got.append
    assert sim.alpha.conn.connect("BRAVO")
    out["connected"] = yield from S.run_until(sim, sim.both_connected, 300)
    if not out["connected"]:
        return
    out["link"] = S.link_name(sim.alpha.conn.link)
    cap = sim.alpha.conn.message_capacity()
    group = sim.alpha.conn.link.burst_group
    msg = bytes(range(256)) * ((group * cap) // 256 + 1)
    out["msg"] = msg[: group * cap - 10]
    out["sent"] = sim.alpha.conn.send_message(out["msg"])
    yield from S.run_until(sim, lambda: got, 300)


def test_burst_session_negotiated_and_delivers():
    """Both stations enable bursts, CONNECT negotiates them, an 8-chunk
    message rides one burst and is delivered; in lock step with the
    reference package, every tick equal."""
    from ria_tpu.protocol.connection import ConnectionConfig as JConfig
    from ria_tpu.protocol.connection import ConnectionState as JState
    from ria_tpu.sim.channel import awgn as j_awgn
    from ria_tpu.sim.simulator import DualStationSim as JSim

    ref = JSim(channel_cfg=j_awgn(14.0), seed=5, config_a=JConfig(burst_group=8),
               config_b=JConfig(burst_group=8))
    sim = DualStationSim(awgn(14.0), seed=5, config_a=ConnectionConfig(burst_group=8),
                         config_b=ConnectionConfig(burst_group=8), device="cpu",
                         draws=D.sim_draws(5))
    session = S.Session("burst", "awgn", 14.0, 5, "burst", 1)
    run = S.lock_step([ref, sim], session, [JState, ConnectionState], traffic=_burst_traffic)
    out = run["outs"][1]
    assert out["connected"]
    for s in (ref, sim):
        assert s.alpha.conn.link.waveform.name == WaveformMode.OFDM_CHIRP.name
        assert s.alpha.conn.link.burst_group == 8
        assert s.bravo.conn.link.burst_group == 8
        assert s.alpha.conn.link.burst_tx_confirmed  # initiator: from ACK bit0
    assert out["sent"]
    assert out["got_b"] and out["got_b"][0] == out["msg"]
    assert sim.alpha.stats.bursts_tx >= 1
    assert sim.bravo.stats.bursts_rx >= 1
    # responder latch: flips only after a burst is actually received
    assert sim.bravo.conn.link.burst_tx_confirmed
    assert run["max_snr_err"] <= S.SNR_TOL_DB


def test_burst_disabled_when_peer_lacks_support():
    """The initiator wants bursts, the responder does not: both ends land
    on burst_group 0 and traffic flows as single frames."""
    sim = DualStationSim(awgn(18.0), seed=6, config_a=ConnectionConfig(burst_group=4),
                         config_b=ConnectionConfig(burst_group=0), device="cpu",
                         draws=D.sim_draws(6))
    got = []
    sim.bravo.conn.on_message = got.append
    assert sim.alpha.conn.connect("BRAVO")
    assert sim.run_until(sim.both_connected, max_ticks=300)
    assert sim.alpha.conn.link.burst_group == 0
    assert sim.bravo.conn.link.burst_group == 0
    assert sim.alpha.conn.send_message(b"plain frame path")
    assert sim.run_until(lambda: got, max_ticks=200)
    assert got[0] == b"plain frame path"
    assert sim.alpha.stats.bursts_tx == 0


def test_burst_record_isolation_from_frame0_cw_fades():
    """A faded codeword in frame 0's padding costs nothing; one in frame
    0's real bytes past the header loses frame 0 only."""
    from ria_tpu_torch.phy.frame_v2 import (build_burst_stream, bytes_per_codeword,
                                            parse_burst_stream)

    rate, G = "R1_2", 8
    bpc = bytes_per_codeword(rate)
    frames = [make_fixed_data_frame("W1AW", "VE3ABC", i, bytes([i]) * 30, rate).serialize()
              for i in range(G)]
    assert len(frames[0]) == 49  # 17 hdr + 30 payload + 2 CRC, unpadded
    stream = build_burst_stream(frames, rate)
    ncw = burst_stream_codewords(G, rate)
    stream = stream.ljust(ncw * bpc, b"\x00")

    oks = np.ones(ncw, bool)
    oks[2] = False
    res = parse_burst_stream(stream, oks, G, rate)
    assert all(ok for ok, _ in res)
    assert [fb for _, fb in res] == frames

    oks = np.ones(ncw, bool)
    oks[1] = False
    res = parse_burst_stream(stream, oks, G, rate)
    assert not res[0][0]
    assert all(ok for ok, _ in res[1:])
    assert [fb for _, fb in res[1:]] == frames[1:]


def test_qam64_r34_rung_decodes_at_24db_awgn():
    """16-frame QAM64 R3/4 bursts decode 10/10 seeds at a true 24 dB AWGN
    (keys 200-209)."""
    from ria_tpu_torch.sim import apply_channel
    from ria_tpu_torch.wave.api import create_waveform

    for s in range(10):
        wf = create_waveform(WaveformMode.OFDM_CHIRP, "QAM64", "R3_4", device="cpu")
        frames = [make_fixed_data_frame("W1AW", "VE3ABC", i, bytes(200), "R3_4").serialize()
                  for i in range(16)]
        tx = wf.tx_burst(frames)
        audio = np.concatenate([np.zeros(3000, np.float32), tx, np.zeros(4000, np.float32)])
        ch = awgn(24.0)
        out = apply_channel(audio, ch, replayed_draws(200 + s, audio.shape, ch), device="cpu")
        res = wf.rx_burst(out.samples.numpy(), 16)
        assert res is not None, f"seed {s}: no sync"
        frames_rx, _snr, _fad = res
        assert all(okf for okf, _ in frames_rx), f"seed {s}"


def test_single_frame_never_misroutes_to_burst_rx():
    """In a burst-negotiated session a single light frame (the reference
    modem's ``ria ptx`` capture) whose repeat count reads 3 still delivers
    as a single frame."""
    from ria_tpu_torch.phy.station import Station
    from ria_tpu_torch.protocol.connection import LinkMode

    fix = os.path.join(os.path.dirname(__file__), "golden", "interop",
                       "ref_ofdm_dqpsk_r1_4.f32")
    audio = np.fromfile(fix, np.float32)

    st = Station("BRAVO", device="cpu")
    st.conn.state = ConnectionState.CONNECTED
    st.conn.remote_call = "ALPHA"
    link = LinkMode(waveform=WaveformMode.OFDM_CHIRP, modulation="DQPSK", rate="R1_4",
                    burst_group=8)
    st.conn.link = link
    st._on_mode_changed(link)
    delivered = []
    st.on_rx_frame = lambda rx: delivered.append(rx.frame_bytes)

    st.feed_audio(audio)
    st.poll()
    if not delivered and st._pending is not None:
        st._pending["sync"]["lts_repeats"] = 3
        st.poll()
    for _ in range(4):
        if delivered:
            break
        st.feed_audio(np.zeros(48000, np.float32))
        st.poll()
    assert st.stats.frames_rx == 1, (st.stats.frames_rx, st.stats.decode_failures)
    assert st.stats.bursts_rx == 0
    assert delivered and b"HELLO INTEROP" in delivered[0]
