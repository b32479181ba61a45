"""The port's protocol layer on the host: the ARQ and connection tests of
tests/test_protocol.py that need no crypto and no protocol engine, and
tests/test_mc_profile.py's profile-ACK seq range, on the port's host copies
(``ria_tpu_torch.protocol``, ``ria_tpu_torch.phy.adaptive``); and the same
ARQ exchanges run through both packages, frame for frame."""

import pytest
import torch

from ria_tpu_torch.phy.frame_v2 import WaveformMode
from ria_tpu_torch.protocol.arq import ARQConfig, ARQMode, SelectiveRepeatARQ, StopAndWaitARQ
from ria_tpu_torch.protocol.connection import ConnectionState

torch.set_num_threads(1)


def _wire_pair(a, b):
    a.set_callsigns("W1AW", "VE3ABC")
    b.set_callsigns("VE3ABC", "W1AW")
    a.on_transmit = lambda fb: b.on_frame_received(fb)
    b.on_transmit = lambda fb: a.on_frame_received(fb)


def test_stop_and_wait_basic():
    a, b = StopAndWaitARQ(), StopAndWaitARQ()
    _wire_pair(a, b)
    got = []
    b.on_data = lambda p, f: got.append(p)
    assert a.send_data(b"hello")
    assert got == [b"hello"]
    assert a.is_ready_to_send()  # ACK came back synchronously
    assert a.stats.acks_received == 1


def test_stop_and_wait_retransmit_on_loss():
    a, b = StopAndWaitARQ(ARQConfig(ack_timeout_ms=1000, max_retries=3)), StopAndWaitARQ()
    a.set_callsigns("W1AW", "VE3ABC")
    b.set_callsigns("VE3ABC", "W1AW")
    drop_next = [True]
    def lossy(fb):
        if drop_next[0]:
            drop_next[0] = False
            return
        b.on_frame_received(fb)
    a.on_transmit = lossy
    b.on_transmit = lambda fb: a.on_frame_received(fb)
    got = []
    b.on_data = lambda p, f: got.append(p)
    a.send_data(b"retry me")
    assert got == []
    a.tick(1000)  # timeout -> retransmit (this one goes through)
    assert got == [b"retry me"]
    assert a.stats.retransmissions == 1


def test_selective_repeat_window_and_order():
    a, b = SelectiveRepeatARQ(), SelectiveRepeatARQ()
    _wire_pair(a, b)
    got = []
    b.on_data = lambda p, f: got.append(p)
    for i in range(4):
        assert a.send_data(f"msg{i}".encode())
    assert got == [b"msg0", b"msg1", b"msg2", b"msg3"]
    # Delayed SACK: the cumulative ACK flushes after sack_delay ticks.
    b.tick(b.config.sack_delay_ms)
    assert a.available_slots() == 4
    assert b.stats.acks_sent >= 1


def test_selective_repeat_reorder_delivery():
    b = SelectiveRepeatARQ()
    b.set_callsigns("VE3ABC", "W1AW")
    sent_acks = []
    b.on_transmit = lambda fb: sent_acks.append(fb)
    got = []
    b.on_data = lambda p, f: got.append(p)
    from ria_tpu_torch.phy.frame_v2 import DataFrame
    f0 = DataFrame.make_data("W1AW", "VE3ABC", 0, b"first").serialize()
    f1 = DataFrame.make_data("W1AW", "VE3ABC", 1, b"second").serialize()
    b.on_frame_received(f1)  # out of order
    assert got == []
    b.on_frame_received(f0)
    assert got == [b"first", b"second"]
    assert b.stats.out_of_order == 1


def test_selective_repeat_sack_hole_nack():
    """Out-of-order burst: SACK carries hole bitmap, TX retransmits it."""
    from ria_tpu_torch.phy.frame_v2 import DataFrame

    a, b = SelectiveRepeatARQ(), SelectiveRepeatARQ()
    a.set_callsigns("W1AW", "VE3ABC")
    b.set_callsigns("VE3ABC", "W1AW")
    drop = {1}
    def lossy(fb):
        f = DataFrame.deserialize(fb)
        if f is not None and 0x30 <= int(f.type) <= 0x33 and f.seq in drop:
            drop.discard(f.seq)
            return
        b.on_frame_received(fb)
    a.on_transmit = lossy
    b.on_transmit = lambda fb: a.on_frame_received(fb)
    got = []
    b.on_data = lambda p, f: got.append(p)
    for i in range(3):
        a.send_data(f"m{i}".encode())
    assert got == [b"m0"]  # m1 lost, m2 buffered
    b.tick(b.config.sack_delay_ms)  # SACK: cum-ack 0 + hole bitmap for seq1
    assert got == [b"m0", b"m1", b"m2"], got
    assert a.stats.retransmissions == 1


def test_selective_repeat_adaptive_rtt():
    a = SelectiveRepeatARQ()
    a.set_callsigns("W1AW", "VE3ABC")
    sent = []
    a.on_transmit = lambda fb: sent.append(fb)
    a.send_data(b"x")
    # Simulate a fast ACK after 500ms; RTT EMA should drop the timeout.
    before = a._ack_timeout_ms
    from ria_tpu_torch.phy.frame_v2 import ControlFrame, hash_callsign
    a.tick(500)
    a.on_frame_received(ControlFrame.make_ack("VE3ABC", hash_callsign("W1AW"), 0).serialize())
    for _ in range(10):
        a.send_data(b"y")
        a.tick(500)
        a.on_frame_received(ControlFrame.make_ack("VE3ABC", hash_callsign("W1AW"),
                                                  a.tx_seq - 1).serialize())
    assert a._ack_timeout_ms < before


def test_manual_accept_reject_flow():
    """auto_accept off: incoming CONNECT parks until accept/reject."""
    from ria_tpu_torch.protocol.connection import Connection, ConnectionConfig
    from ria_tpu_torch.phy.frame_v2 import ConnectFrame, FrameType

    cfg = ConnectionConfig(auto_accept=False)
    c = Connection(cfg)
    c.set_local_callsign("VE3ABC")
    sent = []
    c.on_transmit = lambda fb, hs: sent.append(fb)
    calls = []
    c.on_incoming_call = lambda who: calls.append(who)

    req = ConnectFrame(type=FrameType.CONNECT, src_callsign="W1AW",
                       dst_callsign="VE3ABC", mode_capabilities=0x3F)
    c.on_frame_received(req.serialize())
    assert calls == ["W1AW"]
    assert c.state == ConnectionState.DISCONNECTED
    assert not sent  # nothing sent yet

    c.accept_call()
    assert c.state == ConnectionState.CONNECTED
    ack = ConnectFrame.deserialize(sent[-1])
    assert ack is not None and ack.type == FrameType.CONNECT_ACK

    # reject path
    c2 = Connection(ConnectionConfig(auto_accept=False))
    c2.set_local_callsign("VE3ABC")
    sent2 = []
    c2.on_transmit = lambda fb, hs: sent2.append(fb)
    c2.on_frame_received(req.serialize())
    c2.reject_call()
    nak = ConnectFrame.deserialize(sent2[-1])
    assert nak is not None and nak.type == FrameType.CONNECT_NAK


def test_link_adapter_upgrade_confirmation():
    """Reference App::updateAdaptiveAdvisory: upgrades need a full 5-frame
    window, 4 consecutive candidate windows AND the 8 s hold; downgrades
    confirm after 2 windows."""
    from ria_tpu_torch.phy.adaptive import LinkAdapter
    from ria_tpu_torch.phy.frame_v2 import WaveformMode

    la = LinkAdapter()
    # 25 dB AWGN measurements while running DQPSK R1_4 on OFDM.
    decision = None
    t = 0.0
    for i in range(20):
        t += 1000.0
        decision = la.feed(25.0, 0.05, t, WaveformMode.OFDM_CHIRP, "DQPSK", "R1_4")
        if decision:
            break
    assert decision is not None
    (mod, rate, _), is_upgrade, avg_snr, _ = decision
    assert is_upgrade and mod == "QAM64" and rate == "R3_4"
    assert t >= 8000.0  # held for the upgrade hold time
    # Downgrade confirms faster (2 windows, no hold).
    la2 = LinkAdapter()
    d2 = None
    steps = 0
    for i in range(20):
        steps += 1
        d2 = la2.feed(2.0, 0.3, 1000.0 * steps, WaveformMode.MC_DPSK, "DQPSK", "R1_4")
        if d2:
            break
    assert d2 is not None
    (mod2, _, spread2), up2, _, _ = d2
    assert not up2 and mod2 == "DBPSK"
    assert steps <= 7  # 5-frame window + 2 confirm windows


def test_ctrl_seq_counter_advances():
    """The control seq counter must produce distinct values — the ACK-gated
    MODE_CHANGE/MC_PROFILE proposals key their apply step on seq matches,
    and a pinned counter lets a stale ACK apply a newer proposal."""
    from ria_tpu_torch.protocol.connection import Connection, ConnectionConfig

    c = Connection(ConnectionConfig())
    seqs = [c._next_ctrl_seq() for _ in range(64)]
    assert len(set(seqs)) == 64
    assert 0xFFFF not in seqs


def test_control_ack_never_wipes_data_window():
    """A control-plane ACK (MODE_CHANGE 0xFDxx / MC_PROFILE 0xFExx seq
    range) must not complete data slots: selective repeat's cumulative
    ACK interpreted 0xFDxx as 'everything delivered' and permanently
    stalled bulk transfers at the first in-fade mode change (duplicate
    ACKs from a retransmitted proposal fall past the pending-entry
    check in Connection.on_frame_received)."""
    from ria_tpu_torch.phy.frame_v2 import ControlFrame

    a = SelectiveRepeatARQ()
    a.set_callsigns("W1AW", "VE3ABC")
    a.on_transmit = lambda fb: None
    for i in range(3):
        assert a.send_data(f"d{i}".encode())
    assert len(a.window) == 3
    dup_ctrl_ack = ControlFrame.make_ack("VE3ABC", 0x1234, 0xFD07)
    a.on_frame_received(dup_ctrl_ack.serialize())
    assert len(a.window) == 3, "control-range ACK wiped data slots"
    # Legitimate cumulative data ACK still completes in-order slots.
    a.on_frame_received(ControlFrame.make_ack("VE3ABC", 0x1234, 1).serialize())
    assert sorted(a.window) == [2]


def test_cumulative_ack_wraparound():
    """Cumulative completion follows 16-bit circular order across the
    0xFFFF -> 0 seq wrap (plain <= completed nothing after the wrap and
    deadlocked long transfers)."""
    from ria_tpu_torch.phy.frame_v2 import ControlFrame

    a = SelectiveRepeatARQ()
    a.set_callsigns("W1AW", "VE3ABC")
    a.on_transmit = lambda fb: None
    a.tx_seq = 0xFFFE
    for i in range(4):  # seqs fffe, ffff, 0, 1
        assert a.send_data(b"x")
    a.on_frame_received(ControlFrame.make_ack("VE3ABC", 0x1234, 0).serialize())
    assert sorted(a.window) == [1], f"wrap-ack left {sorted(a.window)}"


def test_data_seq_allocation_skips_ctrl_range():
    """Data tx_seq never lands in 0xFD00-0xFEFF (control-plane ACK seqs):
    after ~64.8k frames in one connection the data seq space would
    otherwise enter the range the connection layer filters, so every
    cumulative ACK for those 512 seqs would be silently dropped —
    retransmit storm, then hard failure at max_retries (advisor r4)."""
    from ria_tpu_torch.protocol.arq import next_seq, prev_seq

    for cls in (StopAndWaitARQ, SelectiveRepeatARQ):
        a = cls()
        a.set_callsigns("W1AW", "VE3ABC")
        a.on_transmit = lambda fb: None
        a.tx_seq = 0xFCFF
        seqs = []
        real_send = a.send_data
        for i in range(3):
            if cls is StopAndWaitARQ:
                a.in_flight = None  # free the single slot
            assert real_send(b"x")
        seqs = sorted(a.window) if cls is SelectiveRepeatARQ else None
        if seqs is not None:
            assert seqs == [0xFCFF, 0xFF00, 0xFF01], seqs
    assert next_seq(0xFCFF) == 0xFF00
    assert prev_seq(0xFF00) == 0xFCFF
    assert next_seq(0xFFFF) == 0x0000


def test_selective_repeat_transfer_across_ctrl_range_skip():
    """An in-order transfer whose seqs straddle the 0xFD00-0xFEFF skip
    delivers everything: RX next-seq advancement, cumulative SACK seq
    and hole bitmaps all count in the same skipped sequence space."""
    a, b = SelectiveRepeatARQ(), SelectiveRepeatARQ()
    a.set_callsigns("W1AW", "VE3ABC")
    b.set_callsigns("VE3ABC", "W1AW")
    a.tx_seq = 0xFCFD
    b.rx_next_seq = 0xFCFD
    a.on_transmit = lambda fb: b.on_frame_received(fb)
    b.on_transmit = lambda fb: a.on_frame_received(fb)
    got = []
    b.on_data = lambda p, f: got.append(p)
    payloads = [f"m{i}".encode() for i in range(6)]
    for p in payloads:
        while not a.is_ready_to_send():
            a.tick(500)
            b.tick(500)
        assert a.send_data(p)
    for _ in range(10):
        a.tick(500)
        b.tick(500)
    assert got == payloads
    assert not a.window, f"unacked slots {sorted(a.window)}"
    assert a.stats.retransmissions == 0


def test_far_future_ack_ignored():
    """An ACK far ahead of the window base (outside window_size+1 steps)
    must not complete in-flight slots — corrupted or foreign seqs (e.g.
    a stale connection's handshake ctrl seqs) could otherwise falsely
    complete data (advisor r4; reference handleAckFrame guard,
    selective_repeat_arq.cpp:216-231)."""
    from ria_tpu_torch.phy.frame_v2 import ControlFrame

    a = SelectiveRepeatARQ()
    a.set_callsigns("W1AW", "VE3ABC")
    a.on_transmit = lambda fb: None
    a.tx_seq = 100
    for _ in range(3):
        assert a.send_data(b"x")  # seqs 100..102
    a.on_frame_received(ControlFrame.make_ack("VE3ABC", 0x1234, 500).serialize())
    assert sorted(a.window) == [100, 101, 102], "far-future ACK completed slots"
    # Stale ACK (behind base) also a no-op.
    a.on_frame_received(ControlFrame.make_ack("VE3ABC", 0x1234, 42).serialize())
    assert sorted(a.window) == [100, 101, 102]
    # In-window cumulative ACK still works.
    a.on_frame_received(ControlFrame.make_ack("VE3ABC", 0x1234, 101).serialize())
    assert sorted(a.window) == [102]


def test_profile_ack_seq_cannot_collide_with_data_acks():
    """The profile is applied by an ACK seq match, so proposal seqs live
    in a dedicated range no data ACK can occupy."""
    from ria_tpu_torch.protocol.connection import Connection, ConnectionConfig

    c = Connection(ConnectionConfig())
    c.local_call = "W1AW"
    c.state = type(c.state).CONNECTED
    c.link.waveform = WaveformMode.MC_DPSK
    sent = []
    c.on_transmit = lambda fb, handshake=False: sent.append(fb)
    c._tx = lambda fb, handshake=False: sent.append(fb)
    assert c.request_mc_profile(13, "DBPSK", "R1_2")
    seq = c._pending_profile[0]
    assert seq >= 0xFE00 and seq != 0xFFFF


def _arq_exchange(arq_mod, frame_mod, cls_name: str) -> list:
    """A 6-message transfer over a link that drops every third data frame
    and delivers each frame after the call that sent it returns: every
    frame each side puts on the air, and what B delivered."""
    cls = getattr(arq_mod, cls_name)
    a = cls(arq_mod.ARQConfig(ack_timeout_ms=1000, max_retries=5))
    b = cls(arq_mod.ARQConfig(ack_timeout_ms=1000, max_retries=5))
    a.set_callsigns("W1AW", "VE3ABC")
    b.set_callsigns("VE3ABC", "W1AW")
    air, got, queue, n_data = [], [], [], [0]

    def a_tx(fb):
        air.append(("a", fb))
        f = frame_mod.DataFrame.deserialize(fb)
        if f is not None and 0x30 <= int(f.type) <= 0x33:
            n_data[0] += 1
            if n_data[0] % 3 == 0:
                return
        queue.append((b, fb))

    def b_tx(fb):
        air.append(("b", fb))
        queue.append((a, fb))

    def pump():
        while queue:
            dst, fb = queue.pop(0)
            dst.on_frame_received(fb)

    a.on_transmit, b.on_transmit = a_tx, b_tx
    b.on_data = lambda p, f: got.append(p)
    for i in range(6):
        while not a.is_ready_to_send():
            a.tick(250)
            b.tick(250)
            pump()
        a.send_data(f"message {i}".encode())
        pump()
    for _ in range(40):
        a.tick(250)
        b.tick(250)
        pump()
    return air + [("delivered", got), ("stats", (a.stats.retransmissions, b.stats.acks_sent))]


@pytest.mark.parametrize("cls_name", ["StopAndWaitARQ", "SelectiveRepeatARQ"])
def test_arq_exchange_matches_the_reference(cls_name):
    from ria_tpu.phy import frame_v2 as j_frame
    from ria_tpu.protocol import arq as j_arq
    from ria_tpu_torch.phy import frame_v2 as t_frame
    from ria_tpu_torch.protocol import arq as t_arq

    want = _arq_exchange(j_arq, j_frame, cls_name)
    got = _arq_exchange(t_arq, t_frame, cls_name)
    assert got == want
    assert got[-2] == ("delivered", [f"message {i}".encode() for i in range(6)])


def _handshake(conn_mod, frame_mod) -> list:
    """A responder's view of CONNECT -> data -> DISCONNECT: what it sends,
    its state after each frame, and its link."""
    c = conn_mod.Connection(conn_mod.ConnectionConfig())
    c.set_local_callsign("VE3ABC")
    sent, log = [], []
    c.on_transmit = lambda fb, hs: sent.append((bytes(fb), bool(hs)))
    c.on_message = lambda m: log.append(("message", m))
    FT = frame_mod.FrameType
    frames = [frame_mod.ConnectFrame(type=FT.CONNECT, src_callsign="W1AW",
                                     dst_callsign="VE3ABC", mode_capabilities=0x3F).serialize()]
    frames += [frame_mod.DataFrame.make_data("W1AW", "VE3ABC", i, b"data %d" % i).serialize()
               for i in range(3)]
    frames.append(frame_mod.ConnectFrame(type=FT.DISCONNECT, src_callsign="W1AW",
                                         dst_callsign="VE3ABC").serialize())
    for fb in frames:
        c.measured_snr_db = 9.5
        c.on_frame_received(fb)
        c.tick(200)
        link = c.link
        log.append((c.state.name, link.waveform.name, link.modulation, link.rate,
                    link.spreading, link.mc_carriers, list(sent)))
    for _ in range(50):
        c.tick(200)
    log.append((c.state.name, list(sent)))
    return log


def test_connection_handshake_matches_the_reference():
    from ria_tpu.phy import frame_v2 as j_frame
    from ria_tpu.protocol import connection as j_conn
    from ria_tpu_torch.phy import frame_v2 as t_frame
    from ria_tpu_torch.protocol import connection as t_conn

    want = _handshake(j_conn, j_frame)
    got = _handshake(t_conn, t_frame)
    assert got == want
    assert want[0][0] == "CONNECTED" and ("message", b"data 0") in want
