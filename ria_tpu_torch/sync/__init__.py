"""sync stage of the port (mirrors ria_tpu.sync)."""

from .chirp import ChirpConfig, ChirpSyncResult, detect_dual_chirp, generate

__all__ = ["ChirpConfig", "ChirpSyncResult", "detect_dual_chirp", "generate"]
