"""wave stage of the port (mirrors ria_tpu.wave)."""

from .mc_dpsk import MCDPSKConfig, MCDPSKDemodResult, demodulate, modulate, preamble

__all__ = ["MCDPSKConfig", "MCDPSKDemodResult", "demodulate", "modulate", "preamble"]
