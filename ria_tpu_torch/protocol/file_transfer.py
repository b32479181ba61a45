"""File transfer over DATA frames: chunking, deflate, CRC32.

Host copy of ``ria_tpu/protocol/file_transfer.py``, its imports pointed at the port.

Wire contract from the reference (src/protocol/file_transfer.{hpp,cpp}):
- DATA payload type discriminator byte: 0x00 text, 0x01 FILE_START,
  0x02 FILE_DATA;
- FILE_START = [0x01][flags][orig_size u32 BE][crc32 u32 BE][filename];
  flags bit0 = deflate-compressed payload stream;
- FILE_DATA = [0x02][offset u32 BE][chunk bytes];
- chunk size adapts to the negotiated frame capacity; CRC32 of the ORIGINAL
  (uncompressed) file verifies reassembly.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import Callable

PAYLOAD_TEXT = 0x00
PAYLOAD_FILE_START = 0x01
PAYLOAD_FILE_DATA = 0x02
FILE_FLAG_COMPRESSED = 0x01
FILE_DATA_OVERHEAD = 5  # type + offset
DEFAULT_CHUNK_SIZE = 250


@dataclass
class FileProgress:
    filename: str = ""
    total_bytes: int = 0
    transferred_bytes: int = 0
    is_sending: bool = False

    @property
    def percentage(self) -> float:
        return 100.0 * self.transferred_bytes / self.total_bytes if self.total_bytes else 0.0


class FileTransferController:
    def __init__(self, chunk_payload: int = DEFAULT_CHUNK_SIZE + FILE_DATA_OVERHEAD):
        self.chunk_size = max(16, chunk_payload - FILE_DATA_OVERHEAD)
        self.on_progress: Callable[[FileProgress], None] | None = None
        self.on_received: Callable[[str, bytes, bool], None] | None = None
        self.on_sent: Callable[[bool, str], None] | None = None
        self._reset_tx()
        self._reset_rx()

    def set_max_chunk_payload(self, max_payload: int):
        self.chunk_size = max(16, max_payload - FILE_DATA_OVERHEAD)

    # ------------------------------------------------------------------ TX
    def _reset_tx(self):
        self.tx_data = b""
        self.tx_offset = 0
        self.tx_filename = ""
        self.tx_flags = 0
        self.tx_original_size = 0
        self.tx_crc = 0
        self.tx_meta_pending = False
        self.sending = False

    def start_send(self, filename: str, data: bytes, compress: bool = True) -> bool:
        if self.sending:
            return False
        self.tx_filename = filename
        self.tx_original_size = len(data)
        self.tx_crc = zlib.crc32(data) & 0xFFFFFFFF
        packed = zlib.compress(data, 6) if compress else data
        if compress and len(packed) < len(data):
            self.tx_data = packed
            self.tx_flags = FILE_FLAG_COMPRESSED
        else:
            self.tx_data = data
            self.tx_flags = 0
        self.tx_offset = 0
        self.tx_meta_pending = True
        self.sending = True
        return True

    def has_more_chunks(self) -> bool:
        return self.sending and (self.tx_meta_pending or self.tx_offset < len(self.tx_data))

    def next_chunk(self) -> bytes | None:
        """Next payload (type byte included); None when done."""
        if not self.sending:
            return None
        if self.tx_meta_pending:
            self.tx_meta_pending = False
            max_name = self.chunk_size + FILE_DATA_OVERHEAD - 10
            name = self.tx_filename[:max_name].encode()
            return (bytes([PAYLOAD_FILE_START, self.tx_flags])
                    + self.tx_original_size.to_bytes(4, "big")
                    + self.tx_crc.to_bytes(4, "big") + name)
        if self.tx_offset >= len(self.tx_data):
            return None
        chunk = self.tx_data[self.tx_offset : self.tx_offset + self.chunk_size]
        payload = bytes([PAYLOAD_FILE_DATA]) + self.tx_offset.to_bytes(4, "big") + chunk
        self.tx_offset += len(chunk)
        if self.on_progress:
            self.on_progress(FileProgress(self.tx_filename, len(self.tx_data),
                                          self.tx_offset, True))
        if self.tx_offset >= len(self.tx_data):
            self.sending = False
            if self.on_sent:
                self.on_sent(True, "")
        return payload

    # ------------------------------------------------------------------ RX
    def _reset_rx(self):
        self.rx_buffer = bytearray()
        self.rx_filename = ""
        self.rx_flags = 0
        self.rx_expected_size = 0
        self.rx_crc = 0
        self.receiving = False

    def process_payload(self, payload: bytes) -> bool:
        """Handle a DATA payload; returns True if it was a file-transfer frame."""
        if not payload:
            return False
        ptype = payload[0]
        if ptype == PAYLOAD_FILE_START:
            if len(payload) < 11:
                return True
            self.rx_flags = payload[1]
            self.rx_expected_size = int.from_bytes(payload[2:6], "big")
            self.rx_crc = int.from_bytes(payload[6:10], "big")
            self.rx_filename = payload[10:].decode(errors="replace")
            self.rx_buffer = bytearray()
            self.receiving = True
            return True
        if ptype == PAYLOAD_FILE_DATA:
            if not self.receiving or len(payload) < 5:
                return True
            offset = int.from_bytes(payload[1:5], "big")
            chunk = payload[5:]
            if offset != len(self.rx_buffer):
                return True  # duplicate/overlap: ignore (ARQ guarantees order)
            self.rx_buffer.extend(chunk)
            if self.on_progress:
                self.on_progress(FileProgress(self.rx_filename, self.rx_expected_size,
                                              len(self.rx_buffer), False))
            self._maybe_complete()
            return True
        return False

    def _maybe_complete(self):
        data = bytes(self.rx_buffer)
        if self.rx_flags & FILE_FLAG_COMPRESSED:
            try:
                data = zlib.decompress(data)
            except zlib.error:
                return  # not complete yet
        if len(data) < self.rx_expected_size:
            return
        ok = (zlib.crc32(data) & 0xFFFFFFFF) == self.rx_crc
        self.receiving = False
        if self.on_received:
            self.on_received(self.rx_filename, data, ok)
