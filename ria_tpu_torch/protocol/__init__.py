"""protocol stage of the port (mirrors ria_tpu.protocol): host copies of the
ARQ, the connection state machine, the file-transfer controller and the
protocol engine, with an AES-256 of its own."""

from .arq import ARQConfig, ARQMode, ARQStats, StopAndWaitARQ, SelectiveRepeatARQ, create_arq
from .connection import Connection, ConnectionConfig, ConnectionState, LinkMode
from .crypto import AES256, compress, decompress
from .engine import ProtocolEngine
from .file_transfer import FileTransferController, FileProgress

__all__ = [
    "ARQConfig", "ARQMode", "ARQStats", "StopAndWaitARQ", "SelectiveRepeatARQ",
    "create_arq", "Connection", "ConnectionConfig", "ConnectionState", "LinkMode",
    "AES256", "compress", "decompress", "ProtocolEngine",
    "FileTransferController", "FileProgress",
]
