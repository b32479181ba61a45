"""Dual-station lock-step simulator (the cli_simulator equivalent), in PyTorch.

Port of ``ria_tpu/sim/simulator.py``.  Two complete modem stacks (Station =
waveforms + connection + ARQ) joined by independent Watterson channels in
each direction, advancing in fixed audio blocks of virtual time (reference
tools/cli_simulator.cpp: 10 ms ticks; here larger blocks since processing
is batched).  Deterministic via seeded channels and virtual-time protocol
timers.

Both stations and both channels run on ``device`` (default the card).  Each
direction's channel block is computed there and copied to the host once, as
the audio a station's ring receives.  The channels' standard normals come
from ``draws``: a pair of sources (A->B, B->A) with the methods of
:class:`~ria_tpu_torch.sim.channel.GeneratorDraws` (``init`` once, then
``stream_block`` per block); by default two ``torch.Generator``s on
``device`` seeded ``seed`` and ``seed + 1``, as the reference seeds its two
``jax.random`` keys.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ria_tpu_torch.phy.station import Station
from ria_tpu_torch.protocol.connection import ConnectionConfig, ConnectionState
from ria_tpu_torch.sim.channel import (ChannelConfig, GeneratorDraws, apply_channel_stream,
                                       awgn, init_channel_state)
from ria_tpu_torch.utils.device import resolve_device


@dataclass
class SimResult:
    connected: bool = False
    messages_delivered: list = field(default_factory=list)
    messages_delivered_b: list = field(default_factory=list)
    disconnect_clean: bool = False
    ticks: int = 0
    stats_a: dict = field(default_factory=dict)
    stats_b: dict = field(default_factory=dict)


class DualStationSim:
    def __init__(self, channel_cfg: ChannelConfig | None = None, seed: int = 42,
                 block_ms: float = 200.0, config_a: ConnectionConfig | None = None,
                 config_b: ConnectionConfig | None = None,
                 save_signals: str | None = None,
                 mc_carriers: int = 10, chase_enabled: bool = True,
                 feed_chunk_ms: float | None = None,
                 decode_delay_blocks: int = 1, use_css: bool = False,
                 device: str | torch.device = "cuda", draws=None):
        self.device = resolve_device(device)
        self.channel_cfg = channel_cfg or awgn(15.0)
        self.block = int(48000 * block_ms / 1000.0)
        self.block_ms = block_ms
        # Stress knobs (reference cli_simulator --rx-batch-callbacks /
        # --decode-delay-ms, cli_simulator.cpp:2540-2596): feed audio in
        # many small appends, and let decode passes lag audio arrival.
        self.feed_chunk = (int(48000 * feed_chunk_ms / 1000.0)
                           if feed_chunk_ms else None)
        self.decode_delay_blocks = max(1, int(decode_delay_blocks))
        self.alpha = Station("ALPHA", config_a, mc_carriers=mc_carriers,
                             chase_enabled=chase_enabled, use_css=use_css,
                             device=self.device)
        self.bravo = Station("BRAVO", config_b, mc_carriers=mc_carriers,
                             chase_enabled=chase_enabled, use_css=use_css,
                             device=self.device)
        if draws is None:
            draws = (GeneratorDraws(seed, self.device), GeneratorDraws(seed + 1, self.device))
        self.draws = {"ab": draws[0], "ba": draws[1]}
        # Streaming channel state per direction: fading taps, echo delay
        # line and CFO phases carry across blocks (the reference channel is
        # a continuous per-sample process, hf_channel.hpp:107).
        self.state = {d: init_channel_state(self.channel_cfg, src.init(), device=self.device)
                      for d, src in self.draws.items()}
        self.ticks = 0
        # Signal capture (--save-signals equivalent, cli_simulator.cpp:2540):
        # raw f32 traces of what each station hears.
        self._capture = None
        if save_signals:
            self._capture = {
                "ab": open(f"{save_signals}_alpha_to_bravo.f32", "wb"),
                "ba": open(f"{save_signals}_bravo_to_alpha.f32", "wb"),
            }

    def _channel(self, x: np.ndarray, direction: str) -> np.ndarray:
        draws = self.draws[direction].stream_block(x.shape, self.channel_cfg)
        res, self.state[direction] = apply_channel_stream(
            x, self.channel_cfg, self.state[direction], draws, device=self.device)
        return res.samples.cpu().numpy().astype(np.float32, copy=False)

    def step(self):
        """One lock-step audio block in both directions."""
        a_tx = self.alpha.pull_tx(self.block)
        b_tx = self.bravo.pull_tx(self.block)
        ab = self._channel(a_tx, "ab")
        ba = self._channel(b_tx, "ba")
        if self._capture:
            self._capture["ab"].write(ab.tobytes())
            self._capture["ba"].write(ba.tobytes())
        self._feed(self.bravo, ab)
        self._feed(self.alpha, ba)
        poll = (self.ticks % self.decode_delay_blocks) == self.decode_delay_blocks - 1
        self.alpha.tick(int(self.block_ms), poll=poll)
        self.bravo.tick(int(self.block_ms), poll=poll)
        self.ticks += 1

    def _feed(self, station: Station, audio: np.ndarray):
        if self.feed_chunk is None:
            station.feed_audio(audio)
            return
        for i in range(0, len(audio), self.feed_chunk):
            station.feed_audio(audio[i : i + self.feed_chunk])

    def close(self):
        if self._capture:
            for f in self._capture.values():
                f.close()
            self._capture = None

    def run_until(self, predicate, max_ticks: int = 400) -> bool:
        while self.ticks < max_ticks:
            self.step()
            if predicate():
                return True
        return False

    def both_connected(self) -> bool:
        return (self.alpha.conn.state == ConnectionState.CONNECTED and
                self.bravo.conn.state == ConnectionState.CONNECTED)
