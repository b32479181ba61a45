"""The port's ``Station`` against ``ria_tpu.phy.station.Station`` on the CPU.

The same audio — frames from the reference package's TX plus seeded numpy
noise — is fed block by block to a fresh reference station and a fresh
port station (``device="cpu"``).  After every block the decode counters
(all but the wall-clock ``decode_time_ms_avg``), the connection state, the
frames decoded and the messages delivered, the pending sync, the TX queue
and the tracked noise floor (within 1e-5 relative) must agree.  Scenarios:
a bare-preamble PING, a CONNECT, light OFDM data frames, an OFDM burst
group of 4, an MFSK control frame and a 4x-spread beacon.  Also: one poll uploads
the ring at most once, and the legacy v1 framing round trip
(tests/test_frame_v2.py).
"""

import numpy as np
import pytest
import torch

from ria_tpu.phy import frame_v2 as JF
from ria_tpu.phy import station as JS
from ria_tpu.wave import api as JA
from ria_tpu_torch.phy import frame_v2 as TF
from ria_tpu_torch.phy import modem as t_modem
from ria_tpu_torch.phy import station as TS
from ria_tpu_torch.tools import session_paths as S
from ria_tpu_torch.wave import api as TA

torch.set_num_threads(1)

SCENARIOS = S.STATION_SCENARIOS


def _station(mod, setup: dict, **kw):
    api = JA if mod is JS else TA
    return S.scenario_station(mod, api, JF if mod is JS else TF, setup, **kw)


@pytest.mark.parametrize("name", SCENARIOS)
def test_station_matches_reference(name):
    frames, setup = S.station_scenario(name, JA, JF)
    audio = S.scenario_audio(frames, seed=SCENARIOS.index(name))
    j, jgot = _station(JS, setup)
    t, tgot = _station(TS, setup, device="cpu")
    block = setup.get("block", S.STATION_BLOCK)
    for i, off in enumerate(range(0, len(audio), block)):
        chunk = audio[off : off + block]
        for st in (j, t):
            st.feed_audio(chunk)
            st.tick(int(1000 * len(chunk) / 48000))
        want, have = S.station_view(j, jgot), S.station_view(t, tgot)
        assert have == want, f"{name}: block {i} differs:\n port {have}\n ref  {want}"
        assert S.floor_close(j._noise_floor, t._noise_floor), (
            f"{name}: block {i}: noise floor {t._noise_floor} vs {j._noise_floor}")
        for a, b in zip(j.tx_queue, t.tx_queue):
            assert np.max(np.abs(np.asarray(a) - b)) <= 1e-4, f"{name}: block {i}: TX audio"
    done = S.station_view(j, jgot)
    field, count = S.STATION_EXPECT[name]
    assert done["stats"][field] == count, done
    if name == "connect":
        assert j.stats.frames_tx >= 1 and t.stats.frames_tx == j.stats.frames_tx


def test_one_ring_upload_a_poll(monkeypatch):
    """A poll uploads the ring at most once, as the ``AudioBuffer`` every
    waveform call of the poll reads: the sliding sync windows, the PING
    probe, the header peek and the frame decode."""
    uploads, calls = [], []
    init = t_modem.AudioBuffer.__init__

    def counting(self, audio, device="cuda"):
        if not isinstance(audio, torch.Tensor):
            uploads.append(len(audio))
        init(self, audio, device)

    monkeypatch.setattr(t_modem.AudioBuffer, "__init__", counting)
    for name in ("detect_sync", "peek_header", "rx_frame", "_demod_bits"):
        inner = getattr(TA.MCDPSKWaveform, name)

        def wrapped(self, audio, *a, _inner=inner, _name=name, **kw):
            calls.append((_name, isinstance(audio, (t_modem.AudioBuffer, torch.Tensor))))
            return _inner(self, audio, *a, **kw)

        monkeypatch.setattr(TA.MCDPSKWaveform, name, wrapped)
    frames, setup = S.station_scenario("connect", JA, JF)
    audio = S.scenario_audio(frames, seed=11)
    st, _ = _station(TS, setup, device="cpu")
    per_poll = []
    for off in range(0, len(audio), S.STATION_BLOCK):
        st.feed_audio(audio[off : off + S.STATION_BLOCK])
        n_up, n_calls, ring = len(uploads), len(calls), len(st.rx_buffer)
        st.tick(200)
        per_poll.append((len(uploads) - n_up, len(calls) - n_calls))
        assert uploads[n_up:] in ([], [ring]), (uploads[n_up:], ring)
    assert max(u for u, _ in per_poll) == 1
    assert all(ok for _, ok in calls), "a waveform call got a host array"
    assert {n for n, _ in calls} >= {"detect_sync", "peek_header", "rx_frame"}
    assert max(c for u, c in per_poll if u == 1) >= 3   # several calls, one upload
    assert st.stats.frames_rx == 1


def test_legacy_v1_frame_roundtrip():
    """Mirror of tests/test_frame_v2.py::test_legacy_v1_frame_roundtrip."""
    from ria_tpu.phy import legacy_v1 as J
    from ria_tpu_torch.phy.legacy_v1 import V1ARQ, V1FrameType, build_frame, parse_frame

    f = build_frame(V1FrameType.DATA, 7, b"legacy payload")
    assert f == J.build_frame(J.V1FrameType.DATA, 7, b"legacy payload")
    g = parse_frame(f)
    assert g is not None and g.seq == 7 and g.payload == b"legacy payload"
    bad = bytearray(f)
    bad[10] ^= 0xFF
    assert parse_frame(bytes(bad)) is None

    a, b = V1ARQ(), V1ARQ()
    a.on_transmit = lambda fr: b.on_frame(fr)
    b.on_transmit = lambda fr: a.on_frame(fr)
    got = []
    b.on_data = lambda p: got.append(p)
    assert a.send(b"v1 hello")
    assert got == [b"v1 hello"]
    assert a._pending is None
