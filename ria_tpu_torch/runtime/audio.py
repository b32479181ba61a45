"""Audio engine: 48 kHz mono float32 TX/RX with pluggable backends.

Host copy of ``ria_tpu/runtime/audio.py``, its TX ring the port's native
ring buffer (``runtime/native.py``).

Mirrors the reference AudioEngine contract (src/gui/audio_engine.*,
docs/AUDIO_SYSTEM.md): 48 kHz mono f32, ~1024-sample callback blocks,
thread-safe TX/RX queues.  This platform has no SDL/sound hardware, so the
backends are:

- LoopbackBackend: TX feeds RX directly (optionally through a channel fn);
- FileBackend: RX from an .f32 file, TX captured to an .f32 file;
- SoundDeviceBackend: real audio via the `sounddevice` package when
  installed (gated import — absent in this image).

The engine is the host-side boundary: everything inside stays numpy, the
modem consumes blocks via Station.feed_audio / pull_tx.
"""

from __future__ import annotations

import threading
from typing import Callable

import numpy as np

from ria_tpu_torch.runtime import native

SAMPLE_RATE = 48000
BLOCK_SAMPLES = 1024


class AudioEngine:
    def __init__(self, backend: "AudioBackend | None" = None,
                 rx_callback: Callable[[np.ndarray], None] | None = None):
        self.backend = backend or LoopbackBackend()
        self.rx_callback = rx_callback
        if native.available():
            self._tx_ring = native.NativeRingBuffer(SAMPLE_RATE * 30)
        else:
            self._tx_ring = None
            self._tx_buf = np.zeros(0, np.float32)
        self._lock = threading.Lock()
        self.running = False

    # ------------------------------------------------------------------ TX
    def queue_tx(self, samples: np.ndarray):
        x = np.asarray(samples, np.float32)
        with self._lock:
            if self._tx_ring is not None:
                self._tx_ring.write(x)
            else:
                self._tx_buf = np.concatenate([self._tx_buf, x])

    def tx_pending(self) -> int:
        with self._lock:
            return len(self._tx_ring) if self._tx_ring is not None else len(self._tx_buf)

    def _pull_tx(self, n: int) -> np.ndarray:
        with self._lock:
            if self._tx_ring is not None:
                got = self._tx_ring.read(n)
            else:
                got, self._tx_buf = self._tx_buf[:n], self._tx_buf[n:]
        if len(got) < n:
            got = np.concatenate([got, np.zeros(n - len(got), np.float32)])
        return got

    # ------------------------------------------------------------------ run
    def process_block(self):
        """One callback cycle: emit a TX block, deliver an RX block."""
        tx = self._pull_tx(BLOCK_SAMPLES)
        rx = self.backend.exchange(tx)
        if rx is not None and len(rx) and self.rx_callback:
            self.rx_callback(rx)

    def start(self):
        self.running = True
        self.backend.start()

    def stop(self):
        self.running = False
        self.backend.stop()


class AudioBackend:
    def start(self):
        pass

    def stop(self):
        pass

    def exchange(self, tx_block: np.ndarray) -> np.ndarray | None:
        raise NotImplementedError


class LoopbackBackend(AudioBackend):
    """TX -> (optional channel fn) -> RX."""

    def __init__(self, channel_fn: Callable[[np.ndarray], np.ndarray] | None = None):
        self.channel_fn = channel_fn

    def exchange(self, tx_block: np.ndarray) -> np.ndarray:
        return self.channel_fn(tx_block) if self.channel_fn else tx_block


class FileBackend(AudioBackend):
    """RX from an .f32 file; TX appended to an .f32 file."""

    def __init__(self, rx_path: str | None = None, tx_path: str | None = None):
        self.rx = np.fromfile(rx_path, np.float32) if rx_path else np.zeros(0, np.float32)
        self.pos = 0
        self.tx_file = open(tx_path, "ab") if tx_path else None

    def exchange(self, tx_block: np.ndarray) -> np.ndarray | None:
        if self.tx_file is not None:
            self.tx_file.write(np.asarray(tx_block, np.float32).tobytes())
        if self.pos >= len(self.rx):
            return None
        block = self.rx[self.pos : self.pos + BLOCK_SAMPLES]
        self.pos += len(block)
        return block

    def stop(self):
        if self.tx_file is not None:
            self.tx_file.close()
            self.tx_file = None


class SoundDeviceBackend(AudioBackend):  # pragma: no cover - needs hardware
    """Real duplex audio via sounddevice, when available."""

    def __init__(self, device=None):
        try:
            import sounddevice  # noqa: F401
        except ImportError as e:
            raise RuntimeError("sounddevice not installed") from e
        import sounddevice as sd

        self._sd = sd
        self.device = device
        self.stream = None
        self._rx = []

    def start(self):
        sd = self._sd
        self.stream = sd.Stream(samplerate=SAMPLE_RATE, channels=1,
                                dtype="float32", device=self.device,
                                blocksize=BLOCK_SAMPLES)
        self.stream.start()

    def exchange(self, tx_block: np.ndarray) -> np.ndarray | None:
        if self.stream is None:
            return None
        self.stream.write(np.asarray(tx_block, np.float32).reshape(-1, 1))
        rx, _ = self.stream.read(BLOCK_SAMPLES)
        return rx.reshape(-1)

    def stop(self):
        if self.stream is not None:
            self.stream.stop()
            self.stream.close()
            self.stream = None
