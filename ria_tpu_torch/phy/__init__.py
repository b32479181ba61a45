"""phy stage of the port (mirrors ria_tpu.phy)."""

from .frame_v2 import (
    ControlFrame, DataFrame, ConnectFrame, FrameType, Flags, WaveformMode,
    NackPayload, crc16, hash_callsign, sanitize_callsign,
    encode_frame_ldpc, decode_codewords, encode_fixed_frame, decode_fixed_frame,
    split_into_codewords, reassemble_codewords, parse_header,
    make_fixed_data_frame, fixed_frame_payload_capacity,
)
from .modem import MCDPSKModem, RxFrame

__all__ = [
    "ControlFrame", "DataFrame", "ConnectFrame", "FrameType", "Flags",
    "WaveformMode", "NackPayload", "crc16", "hash_callsign", "sanitize_callsign",
    "encode_frame_ldpc", "decode_codewords", "encode_fixed_frame",
    "decode_fixed_frame", "split_into_codewords", "reassemble_codewords",
    "parse_header", "make_fixed_data_frame", "fixed_frame_payload_capacity",
    "MCDPSKModem", "RxFrame",
]
