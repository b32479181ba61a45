"""Wall-clock threaded two-station simulator (threaded_simulator tier).

Port of ``ria_tpu/sim/continuous.py``.  Mirrors the reference's
realtime/threading integration test (tools/threaded_simulator.cpp): each
station runs in its own thread against a shared wall-clock 48 kHz "air"
with always-on channel noise and random PTT-delay jitter, exercising the
whole Station runtime (ring buffering, decode scheduling, protocol timers)
under real concurrency.

Both stations run on ``device`` (default the card), so the two threads
decode there at once.  The air is the native C++ ring buffers and Watterson
channels (``runtime/native.py``), as in the reference.  Where the reference
runs with no channel and no noise at all when its native library is missing,
this simulator calls ``native.require()`` and raises instead.

Beyond the reference it records, per direction (``"ab"``: ALPHA's thread,
``"ba"``: BRAVO's), the blocks each thread produced (``ticks``), the
iterations whose backpressure wait slept (``backpressure_waits``) and each
block's milliseconds after that wait (``tick_ms``); and a station thread
that raises ends the run and re-raises in :meth:`run`.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from ria_tpu_torch.phy.station import Station
from ria_tpu_torch.protocol.connection import ConnectionConfig
from ria_tpu_torch.runtime import native
from ria_tpu_torch.sim.channel import ChannelConfig
from ria_tpu_torch.utils.device import resolve_device

JOIN_TIMEOUT_S = 60.0


class ContinuousAudioSimulator:
    def __init__(self, channel_cfg: ChannelConfig, seed: int = 42,
                 block_ms: float = 100.0, realtime_factor: float = 0.0,
                 ptt_jitter_ms: float = 0.0, device: str | torch.device = "cuda"):
        """realtime_factor: 1.0 = wall-clock pacing, 0 = as fast as possible."""
        self.device = resolve_device(device)
        native.require()
        self.channel_cfg = channel_cfg
        self.block = int(48000 * block_ms / 1000.0)
        self.block_ms = block_ms
        self.realtime = realtime_factor
        self.ptt_jitter_ms = ptt_jitter_ms
        self.alpha = Station("ALPHA", ConnectionConfig(), device=self.device)
        self.bravo = Station("BRAVO", ConnectionConfig(), device=self.device)
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._rng = np.random.default_rng(seed)
        self._air = {d: native.NativeRingBuffer(48000 * 30) for d in ("ab", "ba")}
        self._ch = {d: native.NativeWatterson(
            channel_cfg.snr_db, channel_cfg.delay_spread_ms,
            channel_cfg.doppler_spread_hz, channel_cfg.cfo_hz, 48000, seed + i,
            channel_cfg.fading_enabled, channel_cfg.multipath_enabled,
            channel_cfg.noise_enabled) for i, d in enumerate(("ab", "ba"))}
        self.ticks = {"ab": 0, "ba": 0}
        self.backpressure_waits = {"ab": 0, "ba": 0}
        self.tick_ms: dict[str, list[float]] = {"ab": [], "ba": []}
        self._errors: list[BaseException] = []

    def _station_loop(self, me: Station, peer_dir: str):
        from ria_tpu_torch.utils.logging import set_station_tag

        set_station_tag(me.callsign)
        my_air = self._air[peer_dir]
        rx_air = self._air["ba" if peer_dir == "ab" else "ab"]
        while not self._stop.is_set():
            t0 = time.monotonic()
            # Backpressure: a real sound card blocks the writer at a few
            # blocks of latency; without this the protocol's virtual clock
            # (one tick per produced block) races ahead of the audio stream.
            if len(my_air) > 4 * self.block and not self._stop.is_set():
                self.backpressure_waits[peer_dir] += 1
            while len(my_air) > 4 * self.block and not self._stop.is_set():
                time.sleep(0.001)
            t_work = time.monotonic()
            with self._lock:
                # PTT lead jitter: delay the START of a new burst only
                # (per-block shifting would corrupt the stream).
                if (self.ptt_jitter_ms > 0 and me.tx_pending
                        and not getattr(me, "_ptt_active", False)):
                    jitter = int(self._rng.uniform(0, self.ptt_jitter_ms) * 48)
                    if jitter:
                        me.tx_queue.insert(0, np.zeros(jitter, np.float32))
                me._ptt_active = me.tx_pending
                tx = me.pull_tx(self.block)
                my_air.write(self._ch[peer_dir].process(tx))
                # Receive from the opposite air: drain EVERYTHING available
                # (like an audio callback), so a slower decode loop cannot
                # fall behind the peer's production rate.
                rx = rx_air.read(len(rx_air))
                if len(rx):
                    me.feed_audio(rx)
            # Protocol time follows this station's own TX stream (one block
            # per iteration); draining an RX backlog is catching up, not
            # time passing.
            me.tick(int(self.block_ms))
            self.ticks[peer_dir] += 1
            self.tick_ms[peer_dir].append((time.monotonic() - t_work) * 1e3)
            if self.realtime > 0:
                dt = time.monotonic() - t0
                sleep = self.block_ms / 1000.0 / self.realtime - dt
                if sleep > 0:
                    time.sleep(sleep)

    def _guarded(self, me: Station, peer_dir: str):
        try:
            self._station_loop(me, peer_dir)
        except BaseException as e:  # re-raised by run() in the caller's thread
            self._errors.append(e)
            self._stop.set()

    def run(self, duration_s: float, until=None) -> bool:
        threads = [threading.Thread(target=self._guarded, args=(st, d), daemon=True)
                   for st, d in ((self.alpha, "ab"), (self.bravo, "ba"))]
        for t in threads:
            t.start()
        deadline = time.monotonic() + duration_s
        ok = False
        while time.monotonic() < deadline and not self._stop.is_set():
            if until is not None and until():
                ok = True
                break
            time.sleep(0.02)
        self._stop.set()
        for t in threads:
            t.join(timeout=JOIN_TIMEOUT_S)
        if self._errors:
            raise RuntimeError("a station thread failed") from self._errors[0]
        if any(t.is_alive() for t in threads):
            raise RuntimeError(f"a station thread did not stop within {JOIN_TIMEOUT_S} s")
        return ok if until is not None else True
