"""ProtocolEngine: user-facing facade over Connection.

Host copy of ``ria_tpu/protocol/engine.py``, its imports pointed at the port
(the cipher is the port's own, ``protocol/crypto.py``).

Mirrors the reference facade (src/protocol/protocol_engine.{hpp,cpp}):
- callsign management, connect/disconnect/auto-accept;
- message APIs with optional deflate (>=32 B gate) and AES-256-CBC; the
  COMPRESSED/ENCRYPTED frame flags ride the DATA payload's first frame;
- file transfer (chunked over ARQ, pumped as ACKs free window slots);
- beacon/CQ broadcast; tick() drives all timers.

Payload wire format inside a message: a leading type byte discriminates
text/file frames (file_transfer.py); compression/encryption wrap the message
body before fragmentation, with flags carried in a 1-byte header here
(payload-level, since frame flags are per-fragment).
"""

from __future__ import annotations

from typing import Callable

from ria_tpu_torch.protocol.connection import Connection, ConnectionConfig, ConnectionState
from ria_tpu_torch.protocol.crypto import AES256, compress, decompress
from ria_tpu_torch.protocol.file_transfer import (
    FileTransferController, PAYLOAD_FILE_DATA, PAYLOAD_FILE_START, PAYLOAD_TEXT,
)

MSG_FLAG_COMPRESSED = 0x01
MSG_FLAG_ENCRYPTED = 0x02


class ProtocolEngine:
    def __init__(self, config: ConnectionConfig | None = None,
                 conn: Connection | None = None):
        # An existing Connection (e.g. a Station's) can be injected so the
        # engine fronts a full modem stack (dual_modem_tcp tool); the engine
        # takes over the message/connection callbacks.
        self.conn = conn if conn is not None else Connection(config)
        self.files = FileTransferController()
        self.encryption_enabled = False
        self._aes: AES256 | None = None
        self.compression_enabled = True

        self.on_message: Callable[[bytes], None] | None = None
        self.on_connected: Callable[[], None] | None = None
        self.on_disconnected: Callable[[str], None] | None = None
        self.on_file_received: Callable[[str, bytes, bool], None] | None = None
        self.on_beacon: Callable[[int, bytes], None] | None = None

        self.conn.on_message = self._on_conn_message
        self.conn.on_connected = lambda: self.on_connected and self.on_connected()
        self.conn.on_disconnected = self._on_disconnected
        self.conn.on_message_sent = self._on_message_sent
        self.conn.on_beacon = lambda h, p: self.on_beacon and self.on_beacon(h, p)
        self.files.on_received = self._on_file_received

    # ------------------------------------------------------------ config
    def set_callsign(self, call: str):
        self.conn.set_local_callsign(call)

    def set_encryption_key(self, passphrase: str | None):
        if passphrase:
            self._aes = AES256.from_passphrase(passphrase)
            self.encryption_enabled = True
        else:
            self._aes = None
            self.encryption_enabled = False

    # ------------------------------------------------------------ control
    def connect(self, remote: str) -> bool:
        return self.conn.connect(remote)

    def disconnect(self):
        self.conn.disconnect()

    @property
    def state(self) -> ConnectionState:
        return self.conn.state

    def send_beacon(self, text: bytes = b""):
        self.conn.send_beacon(text)

    # ------------------------------------------------------------ messages
    def send_message(self, data: bytes | str) -> bool:
        if isinstance(data, str):
            data = data.encode()
        flags = 0
        if self.compression_enabled:
            data, was = compress(data)
            if was:
                flags |= MSG_FLAG_COMPRESSED
        if self.encryption_enabled and self._aes:
            data = self._aes.encrypt(data)
            flags |= MSG_FLAG_ENCRYPTED
        body = bytes([PAYLOAD_TEXT, flags]) + data
        return self.conn.send_message(body)

    def _on_conn_message(self, body: bytes):
        if not body:
            return
        ptype = body[0]
        if ptype in (PAYLOAD_FILE_START, PAYLOAD_FILE_DATA):
            self.files.process_payload(body)
            return
        if ptype != PAYLOAD_TEXT or len(body) < 2:
            # Legacy/plain payload with no discriminator.
            if self.on_message:
                self.on_message(body)
            return
        flags, data = body[1], body[2:]
        try:
            if flags & MSG_FLAG_ENCRYPTED:
                if not self._aes:
                    return
                data = self._aes.decrypt(data)
            if flags & MSG_FLAG_COMPRESSED:
                data = decompress(data)
        except Exception:
            return
        if self.on_message:
            self.on_message(data)

    # ------------------------------------------------------------ files
    def send_file(self, filename: str, data: bytes) -> bool:
        if self.state != ConnectionState.CONNECTED:
            return False
        self.files.set_max_chunk_payload(max(32, self.conn.message_capacity() - 2))
        if not self.files.start_send(filename, data,
                                     compress=self.compression_enabled):
            return False
        self._pump_file()
        return True

    def _pump_file(self):
        while self.files.has_more_chunks() and self.conn.arq.is_ready_to_send():
            chunk = self.files.next_chunk()
            if chunk is None:
                break
            self.conn.arq.send_data(chunk, 0x20)  # FINAL per fragment

    def _on_message_sent(self, ok: bool):
        if self.files.sending or self.files.has_more_chunks():
            if ok:
                self._pump_file()

    def _on_file_received(self, name: str, data: bytes, ok: bool):
        if self.on_file_received:
            self.on_file_received(name, data, ok)

    def _on_disconnected(self, reason: str):
        if self.on_disconnected:
            self.on_disconnected(reason)

    # ------------------------------------------------------------ timing
    def tick(self, elapsed_ms: int):
        self.conn.tick(elapsed_ms)
        self._pump_file()
