"""sim stage of the port (mirrors ria_tpu.sim): the Watterson channel, the
dual-station simulator and the threaded continuous simulator."""

from .channel import (
    ChannelConfig, ChannelResult, PRESETS, apply_channel,
    awgn, good, moderate, poor, flutter,
)

__all__ = [
    "ChannelConfig", "ChannelResult", "PRESETS", "apply_channel",
    "awgn", "good", "moderate", "poor", "flutter",
]
