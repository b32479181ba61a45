"""v2 wire format: frames, codeword layout, CRC, callsign hashing.

Port of ``ria_tpu/phy/frame_v2.py``, copied as host Python so the port
imports no JAX.  Encoding runs on the host (``ldpc_matrix.encode_np``), so
building frames needs no card; the decode calls go to the port's LDPC layer
on ``device`` (the card by default, kernel K1; ``device="cpu"`` for the
plain decoder).

Byte-level contract from the reference (src/protocol/frame_v2.hpp/.cpp):
- magic 0x554C big-endian; control frames exactly 20 bytes
  [magic 2][type 1][flags 1][seq 2][src 3][dst 3][payload 6][crc16 2];
- data frames: 17-byte header [magic 2][type 1][flags 1][seq 2][src 3][dst 3]
  [total_cw 1][len 2][hcrc 2] + payload + frame crc16;
- CRC-16/CCITT poly 0x1021 init 0xFFFF (frame_v2.cpp:113-128);
- 24-bit DJB2-xor callsign hash (frame_v2.cpp:78-84);
- codeword layout: CW0 = first bytes_per_cw bytes of the serialized frame;
  CW1+ = [0xD5][index][payload bytes_per_cw-2] (frame_v2.cpp
  encodeFrameWithLDPC / splitIntoCodewords);
- fixed 4-CW data frames with frame-level interleaving; PING/PONG = raw
  "ULTR" bytes, no LDPC.

This layer is host-side (numpy/python): framing is protocol control flow, not
array compute.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np

import itertools

import torch

from ria_tpu_torch.fec.ldpc import decode_batch, decode_candidates, decode_with_retries
from ria_tpu_torch.fec.ldpc_matrix import (
    CODE_PARAMS,
    MIN_SUM_FACTOR,
    RATE_ENUM,
    RECOMMENDED_ITERS,
    encode_np,
)
from ria_tpu_torch.fec.interleave import (
    FRAME_CODEWORDS,
    channel_perm,
    apply_perm,
    frame_deinterleave,
    frame_interleave,
)
from ria_tpu_torch.utils.bits import bits_to_bytes, bytes_to_bits

MAGIC_V2 = 0x554C
DATA_CW_MARKER = 0xD5
PING_MAGIC = b"ULTR"
CALLSIGN_LEN = 8
BROADCAST_HASH = 0xFFFFFF
DISCONNECT_SEQ = 0xFFFF
LDPC_CODEWORD_BITS = 648
LDPC_CODEWORD_BYTES = 81


class FrameType(enum.IntEnum):
    PING = 0x01
    PONG = 0x02
    PROBE = 0x10
    PROBE_ACK = 0x11
    CONNECT = 0x12
    CONNECT_ACK = 0x13
    CONNECT_NAK = 0x14
    DISCONNECT = 0x15
    KEEPALIVE = 0x16
    MODE_CHANGE = 0x17
    # Extension beyond the reference's wire enum: ACK-gated MC-DPSK profile
    # upgrade (carriers + mod + rate).  The reference pins in-session
    # MC-DPSK at 10 carriers / R1/4 (waveform_selection.hpp:255-257) and
    # silently ignores unknown control types, so a reference peer simply
    # never ACKs this and the proposer keeps the standard profile.
    MC_PROFILE = 0x18
    ACK = 0x20
    NACK = 0x21
    DATA = 0x30
    DATA_START = 0x31
    DATA_CONT = 0x32
    DATA_END = 0x33
    BEACON = 0x40


class Flags:
    NONE = 0x00
    VERSION_V2 = 0x01
    URGENT = 0x02
    COMPRESSED = 0x04
    ENCRYPTED = 0x08
    MORE_FRAG = 0x10
    FINAL = 0x20
    RATE_MASK = 0xC0
    RATE_1_4 = 0x00
    RATE_1_2 = 0x40
    RATE_2_3 = 0x80
    RATE_3_4 = 0xC0


RATE_FLAG_TO_NAME = {0x00: "R1_4", 0x40: "R1_2", 0x80: "R2_3", 0xC0: "R3_4"}
RATE_NAME_TO_FLAG = {v: k for k, v in RATE_FLAG_TO_NAME.items()}


class WaveformMode(enum.IntEnum):
    OFDM_COX = 0x00
    OTFS_EQ = 0x01
    OTFS_RAW = 0x02
    MFSK = 0x03
    MC_DPSK = 0x04
    OFDM_CHIRP = 0x05
    # Extension beyond the reference's wire enum (0x00-0x05): the reference
    # ships single-carrier DPSK only as raw-PING carrier + presets
    # (dpsk.hpp:1118), never factory-reachable; here it is a creatable
    # waveform.  Never auto-negotiated — selection tables don't emit it.
    DPSK = 0x06
    # Extension: experimental AFDM (c1=0 audio profile).  The reference
    # builds AFDM into ultra_core but never reaches it from its factory
    # (SURVEY.md §2.3); here it is factory-creatable for experimentation
    # and never auto-negotiated — selection tables don't emit it.
    AFDM = 0x07
    AUTO = 0xFF


def is_control_frame(t: int) -> bool:
    return t in (FrameType.PROBE, FrameType.PROBE_ACK, FrameType.KEEPALIVE,
                 FrameType.MODE_CHANGE, FrameType.MC_PROFILE, FrameType.ACK,
                 FrameType.NACK, FrameType.DISCONNECT, FrameType.BEACON)


def is_data_frame(t: int) -> bool:
    return 0x30 <= t <= 0x33


def is_connect_frame(t: int) -> bool:
    return t in (FrameType.CONNECT, FrameType.CONNECT_ACK, FrameType.CONNECT_NAK,
                 FrameType.DISCONNECT)


def crc16(data: bytes) -> int:
    """CRC-16/CCITT, poly 0x1021, init 0xFFFF (table-driven)."""
    crc = 0xFFFF
    for b in data:
        crc ^= b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x1021) & 0xFFFF if crc & 0x8000 else (crc << 1) & 0xFFFF
    return crc


def hash_callsign(callsign: str) -> int:
    """24-bit DJB2-xor hash of the uppercased callsign."""
    h = 5381
    for c in callsign:
        h = (((h << 5) + h) ^ ord(c.upper())) & 0xFFFFFFFF
    return h & 0xFFFFFF


def sanitize_callsign(call: str) -> str:
    out = []
    for c in call:
        if len(out) >= CALLSIGN_LEN:
            break
        if c.isalnum() or c in "/-":
            out.append(c.upper())
    return "".join(out)


def encode_snr(snr_db: float) -> int:
    return int((max(-10.0, min(53.75, snr_db)) + 10.0) * 4.0)


def decode_snr(enc: int) -> float:
    return enc / 4.0 - 10.0


def encode_fading_index(fi: float) -> int:
    if fi < 0:
        return 0
    return int(1 + max(0.0, min(2.54, fi)) * 100.0 + 0.5)


def decode_fading_index(enc: int) -> float:
    return -1.0 if enc == 0 else (enc - 1) / 100.0


def bytes_per_codeword(rate: str) -> int:
    return CODE_PARAMS[rate][0] // 8


def calculate_codewords(payload_size: int, rate: str = "R1_4") -> int:
    """Variable-CW count for a DATA frame: ceil(frame_bits / info_bits).

    Matches the reference DataFrame::calculateCodewords (frame_v2.cpp:438-460)
    — the serialized total_cw byte is part of the wire format; fixed 4-CW
    OFDM frames carry the R1/4-based count too (the reference's selective-
    repeat ARQ and CLI use the default-rate variant).
    """
    total_bits = (17 + payload_size + 2) * 8  # header + payload + frame CRC
    info_bits = CODE_PARAMS[rate][0]
    return -(-total_bits // info_bits)


@dataclass
class ControlFrame:
    SIZE = 20
    PAYLOAD_SIZE = 6

    type: FrameType = FrameType.PROBE
    flags: int = Flags.VERSION_V2
    seq: int = 0
    src_hash: int = 0
    dst_hash: int = 0
    payload: bytes = b"\x00" * 6

    def serialize(self) -> bytes:
        out = bytearray(20)
        out[0:2] = MAGIC_V2.to_bytes(2, "big")
        out[2] = int(self.type)
        out[3] = self.flags
        out[4:6] = self.seq.to_bytes(2, "big")
        out[6:9] = (self.src_hash & 0xFFFFFF).to_bytes(3, "big")
        out[9:12] = (self.dst_hash & 0xFFFFFF).to_bytes(3, "big")
        out[12:18] = self.payload[:6].ljust(6, b"\x00")
        out[18:20] = crc16(bytes(out[:18])).to_bytes(2, "big")
        return bytes(out)

    @classmethod
    def deserialize(cls, data: bytes) -> "ControlFrame | None":
        if len(data) < 20 or int.from_bytes(data[0:2], "big") != MAGIC_V2:
            return None
        if crc16(data[:18]) != int.from_bytes(data[18:20], "big"):
            return None
        try:
            ftype = FrameType(data[2])
        except ValueError:
            return None
        return cls(type=ftype, flags=data[3], seq=int.from_bytes(data[4:6], "big"),
                   src_hash=int.from_bytes(data[6:9], "big"),
                   dst_hash=int.from_bytes(data[9:12], "big"), payload=bytes(data[12:18]))

    # --- factories (reference frame_v2.cpp:131-300) ---
    @classmethod
    def make_ack(cls, src: str, dst_hash: int, seq: int) -> "ControlFrame":
        return cls(type=FrameType.ACK, seq=seq, src_hash=hash_callsign(src), dst_hash=dst_hash)

    @classmethod
    def make_nack(cls, src: str, dst_hash: int, seq: int, cw_bitmap: int) -> "ControlFrame":
        payload = seq.to_bytes(2, "big") + cw_bitmap.to_bytes(4, "big")
        return cls(type=FrameType.NACK, seq=seq, src_hash=hash_callsign(src),
                   dst_hash=dst_hash, payload=payload)

    @classmethod
    def make_keepalive(cls, src: str, dst: str) -> "ControlFrame":
        return cls(type=FrameType.KEEPALIVE, src_hash=hash_callsign(src),
                   dst_hash=hash_callsign(dst))

    @classmethod
    def make_beacon(cls, src: str) -> "ControlFrame":
        return cls(type=FrameType.BEACON, src_hash=hash_callsign(src), dst_hash=BROADCAST_HASH)

    @classmethod
    def make_mode_change(cls, src: str, dst_hash: int, seq: int, modulation: int,
                         rate_name: str, snr_db: float, fading_index: float, reason: int,
                         waveform: "WaveformMode | None" = None) -> "ControlFrame":
        wf_enc = 0
        if waveform is not None and waveform != WaveformMode.AUTO:
            wf_enc = 0x80 | (int(waveform) & 0x7F)
        payload = bytes([modulation, RATE_ENUM[rate_name], encode_snr(snr_db), reason,
                         encode_fading_index(fading_index), wf_enc])
        return cls(type=FrameType.MODE_CHANGE, seq=seq, src_hash=hash_callsign(src),
                   dst_hash=dst_hash, payload=payload)


@dataclass
class DataFrame:
    HEADER_SIZE = 17
    CRC_SIZE = 2

    type: FrameType = FrameType.DATA
    flags: int = Flags.VERSION_V2
    seq: int = 0
    src_hash: int = 0
    dst_hash: int = 0
    total_cw: int = 0
    payload: bytes = b""

    def serialize(self) -> bytes:
        total = self.HEADER_SIZE + len(self.payload) + self.CRC_SIZE
        out = bytearray(total)
        out[0:2] = MAGIC_V2.to_bytes(2, "big")
        out[2] = int(self.type)
        out[3] = self.flags
        out[4:6] = self.seq.to_bytes(2, "big")
        out[6:9] = (self.src_hash & 0xFFFFFF).to_bytes(3, "big")
        out[9:12] = (self.dst_hash & 0xFFFFFF).to_bytes(3, "big")
        out[12] = self.total_cw
        out[13:15] = len(self.payload).to_bytes(2, "big")
        out[15:17] = crc16(bytes(out[:15])).to_bytes(2, "big")
        out[17 : 17 + len(self.payload)] = self.payload
        out[-2:] = crc16(bytes(out[:-2])).to_bytes(2, "big")
        return bytes(out)

    @classmethod
    def deserialize(cls, data: bytes) -> "DataFrame | None":
        if len(data) < cls.HEADER_SIZE + cls.CRC_SIZE:
            return None
        if int.from_bytes(data[0:2], "big") != MAGIC_V2:
            return None
        if crc16(data[:15]) != int.from_bytes(data[15:17], "big"):
            return None
        plen = int.from_bytes(data[13:15], "big")
        total = cls.HEADER_SIZE + plen + cls.CRC_SIZE
        if len(data) < total:
            return None
        if crc16(data[: total - 2]) != int.from_bytes(data[total - 2 : total], "big"):
            return None
        try:
            ftype = FrameType(data[2])
        except ValueError:
            return None
        return cls(type=ftype, flags=data[3], seq=int.from_bytes(data[4:6], "big"),
                   src_hash=int.from_bytes(data[6:9], "big"),
                   dst_hash=int.from_bytes(data[9:12], "big"), total_cw=data[12],
                   payload=bytes(data[17 : 17 + plen]))

    @classmethod
    def make_data(cls, src: str, dst: str, seq: int, payload: bytes,
                  ftype: FrameType = FrameType.DATA,
                  rate: str = "R1_4") -> "DataFrame":
        return cls(type=ftype, seq=seq, src_hash=hash_callsign(src),
                   dst_hash=hash_callsign(dst), payload=payload,
                   total_cw=calculate_codewords(len(payload), rate))


@dataclass
class ConnectFrame:
    """CONNECT/CONNECT_ACK/NAK/DISCONNECT with full callsigns (25B payload)."""

    MAX_CALLSIGN_LEN = 10
    PAYLOAD_SIZE = 25

    type: FrameType = FrameType.CONNECT
    flags: int = Flags.VERSION_V2
    seq: int = 0
    src_callsign: str = ""
    dst_callsign: str = ""
    mode_capabilities: int = 0
    negotiated_mode: int = 0xFF
    initial_modulation: int = 0xFF
    initial_code_rate: int = 0xFF
    measured_snr: int = 0
    dst_hash_override: int | None = None

    def serialize(self) -> bytes:
        src = self.src_callsign.encode()[:9].ljust(10, b"\x00")
        dst = self.dst_callsign.encode()[:9].ljust(10, b"\x00")
        payload = src + dst + bytes([self.mode_capabilities, self.negotiated_mode,
                                     self.initial_modulation, self.initial_code_rate,
                                     self.measured_snr])
        dst_hash = (self.dst_hash_override if self.dst_hash_override is not None
                    else hash_callsign(self.dst_callsign))
        df = DataFrame(type=self.type, flags=self.flags,
                       seq=DISCONNECT_SEQ if self.type == FrameType.DISCONNECT else self.seq,
                       src_hash=hash_callsign(self.src_callsign), dst_hash=dst_hash,
                       total_cw=FRAME_CODEWORDS, payload=payload)
        return df.serialize()

    @classmethod
    def deserialize(cls, data: bytes) -> "ConnectFrame | None":
        df = DataFrame.deserialize(data)
        if df is None or len(df.payload) < cls.PAYLOAD_SIZE:
            return None
        p = df.payload
        return cls(type=df.type, flags=df.flags, seq=df.seq,
                   src_callsign=p[0:10].split(b"\x00")[0].decode(errors="replace"),
                   dst_callsign=p[10:20].split(b"\x00")[0].decode(errors="replace"),
                   mode_capabilities=p[20], negotiated_mode=p[21],
                   initial_modulation=p[22], initial_code_rate=p[23], measured_snr=p[24])


@dataclass
class NackPayload:
    frame_seq: int
    cw_bitmap: int

    def encode(self) -> bytes:
        return self.frame_seq.to_bytes(2, "big") + self.cw_bitmap.to_bytes(4, "big")

    @classmethod
    def decode(cls, data: bytes) -> "NackPayload":
        return cls(int.from_bytes(data[0:2], "big"), int.from_bytes(data[2:6], "big"))


# ============================================================================
# Codeword-level encode/decode (LDPC integration)
# ============================================================================

def split_into_codewords(frame_data: bytes, rate: str = "R1_4") -> list[bytes]:
    """Frame bytes -> per-CW info chunks (CW0 raw header, CW1+ 0xD5+idx)."""
    bpc = bytes_per_codeword(rate)
    payload_size = bpc - 2
    chunks = [frame_data[:bpc].ljust(bpc, b"\x00")]
    offset = bpc
    idx = 1
    while offset < len(frame_data):
        chunk = frame_data[offset : offset + payload_size]
        chunks.append((bytes([DATA_CW_MARKER, idx]) + chunk).ljust(bpc, b"\x00"))
        offset += payload_size
        idx += 1
    return chunks


def reassemble_codewords(codewords: list[bytes], rate: str = "R1_4",
                         expected_size: int | None = None) -> bytes:
    """Per-CW decoded info chunks -> frame bytes.

    Marker-aware like the reference (frame_v2.cpp reassembleCodewords): CW1+
    chunks starting with 0xD5 have their 2-byte marker+index stripped; plain
    chunks (fixed 4-CW frames) are concatenated as-is, up to expected_size.
    """
    bpc = bytes_per_codeword(rate)
    out = bytearray()
    limit = expected_size if expected_size is not None else 1 << 30
    for i, cw in enumerate(codewords):
        remaining = limit - len(out)
        if remaining <= 0:
            break
        if i == 0:
            out.extend(cw[:bpc][:remaining])
        elif len(cw) >= 2 and cw[0] == DATA_CW_MARKER:
            out.extend(cw[2:bpc][:remaining])
        else:
            out.extend(cw[:bpc][:remaining])
    return bytes(out)


def _encode_chunks(chunks: list[bytes], rate: str) -> np.ndarray:
    """Info chunks of at most k bits -> codewords [len(chunks), 648] uint8,
    on the host.  Each chunk's bits are zero-padded to k, as
    ``LDPCCodec.encode`` pads a one-block input."""
    k = CODE_PARAMS[rate][0]
    info = np.zeros((len(chunks), k), np.uint8)
    for i, chunk in enumerate(chunks):
        bits = bytes_to_bits(chunk)[:k]
        info[i, : len(bits)] = bits
    return encode_np(info, rate)


def encode_frame_ldpc(frame_data: bytes, rate: str = "R1_4",
                      channel_interleave_bits_per_symbol: int | None = None) -> np.ndarray:
    """Serialized frame -> coded bits [num_cw, 648] (MC-DPSK variable-CW path)."""
    out = _encode_chunks(split_into_codewords(frame_data, rate), rate)
    if channel_interleave_bits_per_symbol:
        perm = channel_perm(channel_interleave_bits_per_symbol)
        out = apply_perm(out, perm)
    return out


def decode_codewords(soft_bits: np.ndarray, rate: str = "R1_4",
                     channel_interleave_bits_per_symbol: int | None = None,
                     device: str | torch.device = "cuda"):
    """Soft bits [num_cw, 648] -> (per-CW ok flags, per-CW info bytes),
    decoded on ``device`` through the serving dispatch (``decode_batch``)."""
    if channel_interleave_bits_per_symbol:
        perm = channel_perm(channel_interleave_bits_per_symbol)
        soft_bits = apply_perm(soft_bits, perm, inverse=True)
    soft_bits = np.asarray(soft_bits, np.float32)
    result = decode_batch(soft_bits,
                          np.full(soft_bits.shape[0], MIN_SUM_FACTOR, np.float32),
                          rate, RECOMMENDED_ITERS[rate], device)
    oks = result.success.cpu().numpy()
    infos = result.info_bits.cpu().numpy()
    chunks = [bits_to_bytes(infos[i]) for i in range(len(infos))]
    return oks, chunks


def encode_fixed_frame(frame_data: bytes, rate: str = "R1_4",
                       channel_interleave_bits_per_symbol: int | None = None) -> np.ndarray:
    """Fixed 4-CW frame with frame-level interleave -> [2592] coded bits.

    Fixed frames split the serialized frame into PLAIN bytes_per_cw chunks
    (no 0xD5 markers — reference encodeFixedFrame, frame_v2.cpp).
    """
    bpc = bytes_per_codeword(rate)
    capacity = FRAME_CODEWORDS * bpc
    padded = frame_data[:capacity].ljust(capacity, b"\x00")
    chunks = [padded[i * bpc : (i + 1) * bpc] for i in range(FRAME_CODEWORDS)]
    cw_bits = _encode_chunks(chunks, rate)
    if channel_interleave_bits_per_symbol:
        perm = channel_perm(channel_interleave_bits_per_symbol)
        cw_bits = apply_perm(cw_bits, perm)
    return frame_interleave(cw_bits)


def decode_fixed_frame(soft: np.ndarray, rate: str = "R1_4",
                       channel_interleave_bits_per_symbol: int | None = None,
                       return_detail: bool = False, device: str | torch.device = "cuda"):
    """[2592] soft bits -> (per-CW ok, reassembled frame bytes or None).

    Uses the fixed-frame decode profile: min-sum 0.9375 with the batched
    factor-diversity/perturbation retry ladder (reference decodeFixedFrame).
    With return_detail, also returns the fully-deinterleaved per-CW soft
    rows [4, 648] and the per-CW info chunks — the inputs HARQ chase
    combining needs (wave/api._chase_combine).  Decodes run on ``device``.
    """
    cw_soft = frame_deinterleave(np.asarray(soft[:2592], np.float32))
    if channel_interleave_bits_per_symbol:
        perm = channel_perm(channel_interleave_bits_per_symbol)
        cw_soft = apply_perm(cw_soft, perm, inverse=True)
    result = decode_with_retries(cw_soft, rate, device=device)
    oks = result.success.cpu().numpy()
    info = result.info_bits.cpu().numpy()
    chunks = [bits_to_bytes(info[i]) for i in range(FRAME_CODEWORDS)]

    def _ret(oks_, fb_):
        if return_detail:
            return oks_, fb_, cw_soft, chunks
        return oks_, fb_

    if oks.all():
        fb = _validate_fixed_chunks(chunks, rate)
        if fb is not None:
            return _ret(oks, fb)
    # CRC-aided list decode: BP can converge to a parity-valid NEIGHBOUR
    # codeword whose LLR correlation matches the truth's (low-weight pairs
    # in the 648-bit code) — and a faded CW may decode only under some
    # perturbations.  Collect distinct candidates per CW and let the frame
    # header/CRC checks arbitrate combination-wise (metric-ordered).
    # Gate on >=2 primary successes: the ambiguity scenario always has most
    # CWs decoding; noise/garbage (0-1 successes) skips the 20x-variant
    # search instead of burning ~seconds per undecodable window.
    if int(oks.sum()) < 2:
        return _ret(oks, None)
    cands = decode_candidates(cw_soft, rate,
                              num_failed=int((~oks).sum()), device=device)
    if all(len(c) > 0 for c in cands):
        combos = sorted(itertools.product(*cands),
                        key=lambda t: -sum(m for m, _ in t))[:64]
        for combo in combos:
            chunks_c = [bits_to_bytes(np.asarray(info)) for _, info in combo]
            fb = _validate_fixed_chunks(chunks_c, rate)
            if fb is not None:
                return _ret(np.ones(FRAME_CODEWORDS, bool), fb)
    return _ret(oks, None)


def _validate_fixed_chunks(chunks: list[bytes], rate: str) -> bytes | None:
    """Header-parse + reassemble + full-frame CRC gate for a 4-CW decode."""
    header = parse_header(chunks[0])
    if header is None:
        return None
    expected = (ControlFrame.SIZE if header["is_control"]
                else DataFrame.HEADER_SIZE + header["payload_len"] + DataFrame.CRC_SIZE)
    fb = reassemble_codewords(chunks, rate, expected)
    if fb is None or len(fb) < expected:
        return None
    if header["is_control"]:
        return fb if ControlFrame.deserialize(fb) is not None else None
    return fb if DataFrame.deserialize(fb) is not None else None


def fixed_frame_payload_capacity(rate: str) -> int:
    return FRAME_CODEWORDS * bytes_per_codeword(rate) - DataFrame.HEADER_SIZE - DataFrame.CRC_SIZE


# ---------------------------------------------------------------- bursts
#
# Stream-packed burst groups (protocol extension; negotiated, see
# protocol/connection.py burst notes).  The reference's burst mode
# (encodeBurstLight + BurstInterleaver, burst_interleaver.hpp:10-31) sends
# `group` complete fixed frames — each carrying the full 17 B header +
# CRC16 — under one light preamble.  Here the group is packed into ONE
# byte stream: frame 0 keeps its full serialized form (so a standalone
# decoder fast path and the burst path share CW0 header semantics), and
# every following frame is compressed to a fixed-size record that drops
# the bytes shared across a connection (magic, src/dst hashes, total_cw,
# header CRC — all reconstructed from frame 0).  The stream is split into
# ceil(len/bpc) codewords and striped across the whole burst
# (interleave.stripe_perm), so a fade of S coded bits costs every CW only
# ~S/ncw bits — the same protection the reference's per-frame byte spread
# provides, with strictly less air time.
#
# Record: [type 1][flags 1][seq 2 BE][plen 1][crc16 2 BE][payload, padded
# to fixed_frame_payload_capacity].  `crc` is the original frame's
# trailing CRC16; reconstruction re-derives every other byte, so
# DataFrame.deserialize on the rebuilt frame validates end-to-end
# integrity exactly as a standalone frame would.  Any frame can still be
# retransmitted standalone (records carry at most the standard fixed-frame
# payload), so ARQ is format-agnostic.

BURST_RECORD_OVERHEAD = 7  # type + flags + seq(2) + plen + crc16(2)


def burst_record_size(rate: str) -> int:
    return BURST_RECORD_OVERHEAD + fixed_frame_payload_capacity(rate)


def burst_stream_bytes(group: int, rate: str) -> int:
    return 4 * bytes_per_codeword(rate) + (group - 1) * burst_record_size(rate)


def burst_stream_codewords(group: int, rate: str) -> int:
    bpc = bytes_per_codeword(rate)
    return -(-burst_stream_bytes(group, rate) // bpc)


def build_burst_stream(frames: list[bytes], rate: str) -> bytes | None:
    """Serialized frames -> packed burst byte stream, or None when a frame
    is not compressible against frame 0 (different src/dst/total_cw, too
    long, or not a data frame) — the caller then falls back to standalone
    TX."""
    bpc = bytes_per_codeword(rate)
    cap = fixed_frame_payload_capacity(rate)
    f0 = frames[0]
    if len(f0) > 4 * bpc or parse_header(f0[:17]) is None:
        return None
    out = bytearray(f0.ljust(4 * bpc, b"\x00"))
    shared = f0[6:12]  # src3 + dst3 (total_cw is derived from plen)
    for fb in frames[1:]:
        h = parse_header(fb[:17]) if len(fb) >= 19 else None
        if (h is None or h["is_control"] or fb[6:12] != shared
                or h["payload_len"] > min(cap, 255)
                or fb[12] != calculate_codewords(h["payload_len"])
                or len(fb) != DataFrame.HEADER_SIZE + h["payload_len"] + 2):
            return None
        plen = h["payload_len"]
        rec = bytearray(burst_record_size(rate))
        rec[0] = fb[2]          # type
        rec[1] = fb[3]          # flags
        rec[2:4] = fb[4:6]      # seq
        rec[4] = plen
        rec[5:7] = fb[-2:]      # original trailing CRC16
        rec[7 : 7 + plen] = fb[17 : 17 + plen]
        out += rec
    return bytes(out)


def parse_burst_stream(stream: bytes, cw_ok: np.ndarray, group: int,
                       rate: str) -> list[tuple[bool, bytes | None]]:
    """Packed stream + per-CW decode flags -> [(ok, frame_bytes)] per
    logical frame.  A frame is delivered only when every codeword covering
    its span decoded AND the reconstructed frame passes its CRC16."""
    bpc = bytes_per_codeword(rate)
    cap = fixed_frame_payload_capacity(rate)
    cw_ok = np.asarray(cw_ok, bool)

    def span_ok(start: int, end: int) -> bool:
        lo, hi = start // bpc, (end - 1) // bpc
        return bool(cw_ok[lo : hi + 1].all())

    out: list[tuple[bool, bytes | None]] = []
    f0_span = 4 * bpc
    # The shared header bytes records rebuild from live entirely in the
    # first 17 bytes (CW0): gating h0 on the whole frame-0 span would fail
    # every continuation frame whenever a frame-0 PADDING codeword faded,
    # defeating the striping's per-frame isolation.
    h0 = parse_header(stream[:17]) if span_ok(0, 17) else None
    f0 = None
    if h0 is not None and not h0["is_control"]:
        want = DataFrame.HEADER_SIZE + h0["payload_len"] + DataFrame.CRC_SIZE
        if (want <= f0_span and span_ok(0, want)
                and DataFrame.deserialize(stream[:want]) is not None):
            f0 = stream[:want]
    out.append((f0 is not None, f0))
    rec_size = burst_record_size(rate)
    for i in range(1, group):
        start = f0_span + (i - 1) * rec_size
        rec = stream[start : start + rec_size]
        fb = None
        if h0 is not None and span_ok(start, start + rec_size) and len(rec) == rec_size:
            plen = rec[4]
            if plen <= cap:
                hdr = bytearray(17)
                hdr[0:2] = MAGIC_V2.to_bytes(2, "big")
                hdr[2] = rec[0]
                hdr[3] = rec[1]
                hdr[4:6] = rec[2:4]
                hdr[6:12] = stream[6:12]  # src/dst from frame 0
                hdr[12] = calculate_codewords(plen)  # derived, same as TX
                hdr[13:15] = plen.to_bytes(2, "big")
                hdr[15:17] = crc16(bytes(hdr[:15])).to_bytes(2, "big")
                cand = bytes(hdr) + rec[7 : 7 + plen] + rec[5:7]
                if DataFrame.deserialize(cand) is not None:
                    fb = cand
        out.append((fb is not None, fb))
    return out


def make_fixed_data_frame(src: str, dst: str, seq: int, payload: bytes, rate: str,
                          flags_extra: int = 0) -> DataFrame:
    """Data frame for the fixed 4-CW OFDM path.

    The payload is NOT padded here — encode_fixed_frame zero-pads at the
    coded level, and the serialized frame keeps the true payload_len +
    frame CRC right after the payload (reference DataFrame::serialize;
    verified against the reference `ria ptx` byte stream).  total_cw carries
    the R1/4 variable-CW count like the reference's makeData default.
    """
    cap = fixed_frame_payload_capacity(rate)
    payload = payload[:cap]
    flags = Flags.VERSION_V2 | RATE_NAME_TO_FLAG.get(rate, 0) | flags_extra
    return DataFrame(type=FrameType.DATA, flags=flags, seq=seq,
                     src_hash=hash_callsign(src), dst_hash=hash_callsign(dst),
                     total_cw=calculate_codewords(len(payload)), payload=payload)


def parse_header(cw0: bytes) -> dict | None:
    """Parse CW0 header info (reference parseHeader, frame_v2.cpp)."""
    if len(cw0) < 17 or int.from_bytes(cw0[0:2], "big") != MAGIC_V2:
        return None
    try:
        ftype = FrameType(cw0[2])
    except ValueError:
        return None
    if is_control_frame(ftype) and not is_connect_frame(ftype):
        return {"type": ftype, "is_control": True, "total_cw": 1, "payload_len": 6,
                "seq": int.from_bytes(cw0[4:6], "big"),
                "src_hash": int.from_bytes(cw0[6:9], "big"),
                "dst_hash": int.from_bytes(cw0[9:12], "big")}
    if crc16(cw0[:15]) != int.from_bytes(cw0[15:17], "big"):
        return None
    return {"type": ftype, "is_control": False, "total_cw": cw0[12],
            "payload_len": int.from_bytes(cw0[13:15], "big"),
            "seq": int.from_bytes(cw0[4:6], "big"),
            "src_hash": int.from_bytes(cw0[6:9], "big"),
            "dst_hash": int.from_bytes(cw0[9:12], "big")}
