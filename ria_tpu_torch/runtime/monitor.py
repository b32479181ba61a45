"""Headless monitoring: waterfall, constellation and status readouts.

Host copy of ``ria_tpu/runtime/monitor.py``, its imports pointed at the port.

The data layer behind the reference GUI's widgets (src/gui/widgets/:
waterfall spectral display, constellation plot, SNR/CFO/fading status).
This platform is headless, so the producers emit plain arrays any frontend
(terminal, notebook, web) can render; the `ria_tpu_torch.cli monitor` textual
renderer consumes them.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np


def waterfall(samples: np.ndarray, fft_size: int = 1024, hop: int = 512,
              sample_rate: float = 48000.0, max_freq: float = 3000.0):
    """STFT magnitude in dB: [frames, bins<=max_freq]; (frames, freqs_hz)."""
    x = np.asarray(samples, np.float32)
    n = (len(x) - fft_size) // hop + 1
    if n <= 0:
        return np.zeros((0, 0), np.float32), np.zeros(0)
    idx = np.arange(fft_size)[None, :] + hop * np.arange(n)[:, None]
    frames = x[idx] * np.hanning(fft_size)[None, :]
    spec = np.abs(np.fft.rfft(frames, axis=-1))
    freqs = np.fft.rfftfreq(fft_size, 1.0 / sample_rate)
    keep = freqs <= max_freq
    db = 20.0 * np.log10(np.maximum(spec[:, keep], 1e-9))
    return db.astype(np.float32), freqs[keep]


class ConstellationBuffer:
    """Ring of recent equalized symbols (MAX_CONSTELLATION_SYMBOLS=500)."""

    def __init__(self, max_symbols: int = 500):
        self.buf: deque = deque(maxlen=max_symbols)

    def push(self, symbols: np.ndarray):
        for s in np.asarray(symbols).reshape(-1)[:200]:
            self.buf.append(complex(s))

    def snapshot(self) -> np.ndarray:
        return np.array(self.buf, np.complex64)


@dataclass
class ModemStatus:
    snr_db: float = 0.0
    cfo_hz: float = 0.0
    fading_index: float = 0.0
    state: str = "DISCONNECTED"
    waveform: str = "MC_DPSK"
    frames_rx: int = 0
    frames_tx: int = 0
    decode_failures: int = 0
    buffer_fill: float = 0.0


class ModemMonitor:
    """Aggregates Station + Connection state into display-ready status."""

    def __init__(self, station):
        self.station = station
        self.constellation = ConstellationBuffer()
        self._last_snr = 0.0
        self._last_cfo = 0.0
        self._last_fading = 0.0

    def observe_rx(self, rx_frame):
        if rx_frame.snr_db:
            self._last_snr = rx_frame.snr_db
        self._last_cfo = rx_frame.cfo_hz
        self._last_fading = rx_frame.fading_index

    def status(self) -> ModemStatus:
        st = self.station
        return ModemStatus(
            snr_db=self._last_snr,
            cfo_hz=self._last_cfo,
            fading_index=self._last_fading,
            state=st.conn.state.name,
            waveform=st.conn.link.waveform.name,
            frames_rx=st.stats.frames_rx,
            frames_tx=st.stats.frames_tx,
            decode_failures=st.stats.decode_failures,
            buffer_fill=len(st.rx_buffer) / st.max_buffer,
        )

    def waterfall_frame(self, n_latest: int = 48000):
        return waterfall(self.station.rx_buffer[-n_latest:])
