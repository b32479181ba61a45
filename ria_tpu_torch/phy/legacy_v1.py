"""Legacy v1 framing + simple stop-and-wait ARQ (compatibility layer).

Host copy of ``ria_tpu/phy/legacy_v1.py``, its imports pointed at the port.

The reference keeps its superseded v1 protocol in the core library
(src/framing/frame_builder.cpp, src/arq/arq_controller.cpp,
include/ultra/arq.hpp); this module provides the same wire format for
interop/testing:

Frame = [type 1][seq u16 BE][len u16 BE][mod_code 1][hcrc u16 over first 6]
        [payload][payload crc16]  (CRC-16/CCITT, init 0xFFFF)

New code should use the v2 protocol (ria_tpu_torch.phy.frame_v2).

RETENTION DECISION (round 2): kept, deliberately unintegrated — exactly
mirroring the reference, whose v1 stays compiled into ultra_core but is
reachable from no v2 code path.  Parity here means "the wire format and
ARQ exist and are tested", not "the product routes through them".
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

from ria_tpu_torch.phy.frame_v2 import crc16

HEADER_SIZE = 8
CRC_SIZE = 2
V1_MAGIC = b"ULTR"


class V1FrameType(enum.IntEnum):
    DATA = 0x01
    ACK = 0x02
    NAK = 0x03
    BEACON = 0x04


@dataclass
class V1Frame:
    type: V1FrameType = V1FrameType.DATA
    seq: int = 0
    mod_code: int = 0
    payload: bytes = b""


def build_frame(ftype: V1FrameType, seq: int, payload: bytes = b"",
                mod_code: int = 0) -> bytes:
    out = bytearray()
    out.append(int(ftype))
    out += seq.to_bytes(2, "big")
    out += len(payload).to_bytes(2, "big")
    out.append(mod_code & 0xFF)
    out += crc16(bytes(out[:6])).to_bytes(2, "big")
    out += payload
    out += crc16(payload).to_bytes(2, "big")
    return bytes(out)


def parse_frame(data: bytes) -> V1Frame | None:
    if len(data) < HEADER_SIZE + CRC_SIZE:
        return None
    if crc16(data[:6]) != int.from_bytes(data[6:8], "big"):
        return None
    plen = int.from_bytes(data[3:5], "big")
    total = HEADER_SIZE + plen + CRC_SIZE
    if len(data) < total:
        return None
    payload = data[HEADER_SIZE : HEADER_SIZE + plen]
    if crc16(payload) != int.from_bytes(data[total - 2 : total], "big"):
        return None
    try:
        ftype = V1FrameType(data[0])
    except ValueError:
        return None
    return V1Frame(type=ftype, seq=int.from_bytes(data[1:3], "big"),
                   mod_code=data[5], payload=payload)


class V1ARQ:
    """Minimal v1 stop-and-wait (src/arq/arq_controller.cpp behavior)."""

    def __init__(self, timeout_ms: int = 2000, max_retries: int = 8):
        self.timeout_ms = timeout_ms
        self.max_retries = max_retries
        self.on_transmit = None
        self.on_data = None
        self.tx_seq = 0
        self.rx_seq = -1
        self._pending: bytes | None = None
        self._timer = 0
        self._retries = 0

    def send(self, payload: bytes) -> bool:
        if self._pending is not None:
            return False
        frame = build_frame(V1FrameType.DATA, self.tx_seq, payload)
        self._pending = frame
        self._timer = 0
        self._retries = 0
        if self.on_transmit:
            self.on_transmit(frame)
        return True

    def on_frame(self, data: bytes):
        f = parse_frame(data)
        if f is None:
            return
        if f.type == V1FrameType.ACK:
            if self._pending is not None and f.seq == self.tx_seq:
                self._pending = None
                self.tx_seq = (self.tx_seq + 1) & 0xFFFF
            return
        if f.type == V1FrameType.DATA:
            if f.seq != self.rx_seq:
                self.rx_seq = f.seq
                if self.on_data:
                    self.on_data(f.payload)
            if self.on_transmit:
                self.on_transmit(build_frame(V1FrameType.ACK, f.seq))

    def tick(self, elapsed_ms: int):
        if self._pending is None:
            return
        self._timer += elapsed_ms
        if self._timer >= self.timeout_ms:
            self._timer = 0
            self._retries += 1
            if self._retries > self.max_retries:
                self._pending = None
                return
            if self.on_transmit:
                self.on_transmit(self._pending)
