"""The port's v2 wire format against ``ria_tpu.phy.frame_v2``.

Host functions (CRC, hashing, frame classes, codeword split and reassembly,
bursts) give equal values and bytes.  ``encode_fixed_frame`` and
``encode_frame_ldpc`` give equal bits (the port encodes on the host).
``decode_fixed_frame`` (the port's on the CPU, plain decoder) returns the
reference's ``oks`` and frame bytes on a clean frame, on noise, and on soft
bits whose primary decode leaves a codeword failed, so that the CRC-aided
list decode runs, with and without a rescue.
"""

import numpy as np
import pytest
import torch

from ria_tpu.phy import frame_v2 as J
from ria_tpu_torch.fec.interleave import apply_perm, channel_perm, frame_deinterleave, frame_perm
from ria_tpu_torch.fec.ldpc import decode_with_retries
from ria_tpu_torch.phy import frame_v2 as T

torch.set_num_threads(1)

RATES = ["R1_4", "R1_2", "R2_3", "R3_4"]


def test_constants_and_helpers():
    for name in ("MAGIC_V2", "DATA_CW_MARKER", "PING_MAGIC", "BROADCAST_HASH",
                 "DISCONNECT_SEQ", "LDPC_CODEWORD_BITS", "LDPC_CODEWORD_BYTES",
                 "RATE_FLAG_TO_NAME", "RATE_NAME_TO_FLAG", "BURST_RECORD_OVERHEAD"):
        assert getattr(T, name) == getattr(J, name), name
    assert {e.name: e.value for e in T.FrameType} == {e.name: e.value for e in J.FrameType}
    assert {e.name: e.value for e in T.WaveformMode} == {e.name: e.value for e in J.WaveformMode}
    rng = np.random.default_rng(0)
    for n in (0, 1, 17, 100):
        data = rng.integers(0, 256, n).astype(np.uint8).tobytes()
        assert T.crc16(data) == J.crc16(data)
    for call in ("W1AW", "ve3abc", "K1ABC/P", "N0CALL-12", ""):
        assert T.hash_callsign(call) == J.hash_callsign(call)
        assert T.sanitize_callsign(call + " x!y") == J.sanitize_callsign(call + " x!y")
    for v in (-20.0, -10.0, 3.3, 53.75, 70.0):
        assert T.encode_snr(v) == J.encode_snr(v)
        assert T.decode_snr(T.encode_snr(v)) == J.decode_snr(J.encode_snr(v))
    for fi in (-1.0, 0.0, 0.37, 3.0):
        assert T.encode_fading_index(fi) == J.encode_fading_index(fi)
        assert T.decode_fading_index(T.encode_fading_index(fi)) == J.decode_fading_index(
            J.encode_fading_index(fi))
    for t in range(256):
        assert T.is_control_frame(t) == J.is_control_frame(t)
        assert T.is_data_frame(t) == J.is_data_frame(t)
        assert T.is_connect_frame(t) == J.is_connect_frame(t)
    for rate in RATES:
        assert T.bytes_per_codeword(rate) == J.bytes_per_codeword(rate)
        assert T.fixed_frame_payload_capacity(rate) == J.fixed_frame_payload_capacity(rate)
        assert T.burst_record_size(rate) == J.burst_record_size(rate)
        for group in (1, 2, 4):
            assert T.burst_stream_bytes(group, rate) == J.burst_stream_bytes(group, rate)
            assert T.burst_stream_codewords(group, rate) == J.burst_stream_codewords(group, rate)
        for size in (0, 6, 100, 300):
            assert T.calculate_codewords(size, rate) == J.calculate_codewords(size, rate)


def _control_frames(P):
    return [
        P.ControlFrame.make_ack("W1AW", P.hash_callsign("VE3ABC"), 17),
        P.ControlFrame.make_nack("W1AW", 0x123456, 5, 0b1010),
        P.ControlFrame.make_keepalive("W1AW", "VE3ABC"),
        P.ControlFrame.make_beacon("K1ABC"),
        P.ControlFrame.make_mode_change("W1AW", 0xABCDEF, 9, 3, "R3_4", 24.5, 0.12, 1,
                                        P.WaveformMode.OFDM_COX),
        P.ControlFrame.make_mode_change("W1AW", 0xABCDEF, 9, 3, "R1_2", -3.0, -1.0, 0),
    ]


def test_control_frames():
    for got, want in zip(_control_frames(T), _control_frames(J)):
        data = got.serialize()
        assert data == want.serialize()
        back = T.ControlFrame.deserialize(data)
        assert back.serialize() == data and back.type == want.type
        bad = data[:5] + bytes([data[5] ^ 1]) + data[6:]
        assert T.ControlFrame.deserialize(bad) is None
        assert J.ControlFrame.deserialize(bad) is None
    assert T.ControlFrame.deserialize(b"\x00" * 10) is None


@pytest.mark.parametrize("rate", RATES)
def test_data_connect_and_nack(rate):
    payload = bytes(range(50))
    got = T.DataFrame.make_data("W1AW", "VE3ABC", 300, payload, T.FrameType.DATA_START, rate)
    want = J.DataFrame.make_data("W1AW", "VE3ABC", 300, payload, J.FrameType.DATA_START, rate)
    assert got.serialize() == want.serialize()
    assert T.DataFrame.deserialize(got.serialize()) == got
    fixed = T.make_fixed_data_frame("W1AW", "VE3ABC", 4, payload * 4, rate, 0x02)
    assert fixed.serialize() == J.make_fixed_data_frame("W1AW", "VE3ABC", 4, payload * 4, rate,
                                                        0x02).serialize()
    for ftype in ("CONNECT", "CONNECT_ACK", "DISCONNECT"):
        c = T.ConnectFrame(type=T.FrameType[ftype], seq=3, src_callsign="W1AW",
                           dst_callsign="VE3ABC", mode_capabilities=0x3F, negotiated_mode=4,
                           initial_modulation=2, initial_code_rate=1, measured_snr=40)
        w = J.ConnectFrame(type=J.FrameType[ftype], seq=3, src_callsign="W1AW",
                           dst_callsign="VE3ABC", mode_capabilities=0x3F, negotiated_mode=4,
                           initial_modulation=2, initial_code_rate=1, measured_snr=40)
        assert c.serialize() == w.serialize()
        assert T.ConnectFrame.deserialize(c.serialize()) == T.ConnectFrame.deserialize(
            w.serialize())
    nack = T.NackPayload(77, 0xDEADBEEF)
    assert nack.encode() == J.NackPayload(77, 0xDEADBEEF).encode()
    assert T.NackPayload.decode(nack.encode()) == nack


@pytest.mark.parametrize("rate", RATES)
def test_split_reassemble_and_header(rate):
    frame = T.DataFrame.make_data("W1AW", "VE3ABC", 1, bytes(range(200)), rate=rate).serialize()
    chunks = T.split_into_codewords(frame, rate)
    assert chunks == J.split_into_codewords(frame, rate)
    assert T.reassemble_codewords(chunks, rate) == J.reassemble_codewords(chunks, rate)
    assert T.reassemble_codewords(chunks, rate, len(frame)) == frame
    assert T.parse_header(frame[:17]) == J.parse_header(frame[:17])
    assert T.parse_header(b"\x00" * 17) is None


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("ci", [None, 118, 306])
def test_encoders_bit_equal(rate, ci):
    frame = T.make_fixed_data_frame("W1AW", "VE3ABC", 2, bytes(range(90)), rate).serialize()
    assert np.array_equal(T.encode_fixed_frame(frame, rate, ci),
                          J.encode_fixed_frame(frame, rate, ci))
    long = T.DataFrame.make_data("W1AW", "VE3ABC", 9, bytes(range(150)), rate=rate).serialize()
    assert np.array_equal(T.encode_frame_ldpc(long, rate, ci), J.encode_frame_ldpc(long, rate, ci))


@pytest.mark.parametrize("rate", ["R1_4", "R3_4"])
def test_decode_codewords(rate):
    frame = T.DataFrame.make_data("W1AW", "VE3ABC", 9, bytes(range(150)), rate=rate).serialize()
    coded = T.encode_frame_ldpc(frame, rate, 12)
    rng = np.random.default_rng(1)
    soft = ((1 - 2.0 * coded) * 2.0 + rng.normal(0, 0.5, coded.shape)).astype(np.float32)
    oks, chunks = T.decode_codewords(soft, rate, 12, device="cpu")
    want_oks, want_chunks = J.decode_codewords(soft, rate, 12)
    assert np.array_equal(oks, np.asarray(want_oks)) and chunks == want_chunks
    assert oks.all()
    assert T.reassemble_codewords(chunks, rate, len(frame)) == frame


def _fixed_soft(rate, ci, seed, bad_sigma, bad_cw=2):
    """A data frame's fixed-frame soft bits (amplitude 3, noise sigma 0.6)
    with extra noise of ``bad_sigma`` on the bits of codeword ``bad_cw``."""
    frame = T.make_fixed_data_frame("W1AW", "VE3ABC", 7, bytes(range(100)), rate).serialize()
    bits = T.encode_fixed_frame(frame, rate, ci)
    rng = np.random.default_rng(seed)
    soft = (1 - 2.0 * bits) * 3.0 + rng.normal(0, 0.6, bits.shape)
    cw_of = np.zeros(2592, int)
    cw_of[frame_perm()] = np.repeat(np.arange(4), 648)
    soft[cw_of == bad_cw] += rng.normal(0, bad_sigma, 648)
    return frame, soft.astype(np.float32)


def _assert_decode_equal(soft, rate, ci):
    oks, fb = T.decode_fixed_frame(soft, rate, ci, device="cpu")
    want_oks, want_fb = J.decode_fixed_frame(soft, rate, ci)
    assert np.array_equal(oks, np.asarray(want_oks))
    assert fb == want_fb
    return oks, fb


@pytest.mark.parametrize("rate,ci", [("R1_2", 118), ("R3_4", 306), ("R1_4", None)])
def test_decode_fixed_frame_clean(rate, ci):
    frame, soft = _fixed_soft(rate, ci, 0, 0.0)
    oks, fb = _assert_decode_equal(soft, rate, ci)
    assert oks.all() and fb == frame
    oks, fb, cw_soft, chunks = T.decode_fixed_frame(soft, rate, ci, return_detail=True,
                                                    device="cpu")
    _, _, want_soft, want_chunks = J.decode_fixed_frame(soft, rate, ci, return_detail=True)
    assert np.array_equal(cw_soft, want_soft) and chunks == want_chunks


def test_decode_fixed_frame_undecodable():
    soft = np.random.default_rng(4).normal(0, 1.0, 2592).astype(np.float32)
    oks, fb = _assert_decode_equal(soft, "R1_2", 118)
    assert not oks.any() and fb is None


@pytest.mark.parametrize("seed,bad_sigma,rescued", [(0, 2.5, False), (1, 3.5, False),
                                                    (2, 3.0, True), (3, 2.0, True)])
def test_decode_fixed_frame_list_decode(seed, bad_sigma, rescued):
    """R3/4 with codeword 2 drowned: the primary decode (the retry ladder)
    leaves it failed and the other three decoded, so the CRC-aided list
    decode runs (frame_v2.py:518-537); in two of the cases it finds the
    frame."""
    rate, ci = "R3_4", 306
    frame, soft = _fixed_soft(rate, ci, seed, bad_sigma)
    cw = apply_perm(frame_deinterleave(soft), channel_perm(ci), inverse=True)
    primary = decode_with_retries(cw, rate, device="cpu").success.numpy()
    assert primary.sum() >= 2 and not primary.all()
    oks, fb = _assert_decode_equal(soft, rate, ci)
    assert (fb == frame) if rescued else (fb is None and not oks.all())


def test_bursts():
    rate = "R1_2"
    frames = [T.make_fixed_data_frame("W1AW", "VE3ABC", s, bytes([s]) * (20 + s), rate)
              .serialize() for s in range(3)]
    stream = T.build_burst_stream(frames, rate)
    assert stream == J.build_burst_stream(frames, rate)
    ok = np.ones(T.burst_stream_codewords(3, rate), bool)
    got = T.parse_burst_stream(stream, ok, 3, rate)
    assert got == J.parse_burst_stream(stream, ok, 3, rate)
    assert [fb for _, fb in got] == frames
    ok[-1] = False
    assert T.parse_burst_stream(stream, ok, 3, rate) == J.parse_burst_stream(stream, ok, 3, rate)
    other = T.make_fixed_data_frame("W1AW", "K1ABC", 9, b"x", rate).serialize()
    assert T.build_burst_stream(frames + [other], rate) is None
    assert J.build_burst_stream(frames + [other], rate) is None
