"""ctypes bindings for the C++ runtime components (native/ria_native.cpp).

Port of ``ria_tpu/runtime/native.py``: the ring buffer, the streaming
resampler, the per-sample Watterson channel, CRC-16 and the select()-based
TCP server, all host code in C++.  The source is the repository's own
``native/ria_native.cpp``, built unchanged (it is not part of the JAX
package, and a second copy would drift).

The library is built on first use with ``g++ -O2 -shared -fPIC -std=c++17``
through ``utils/native_build.py`` (into ``build/ria_tpu_torch/`` at the root of
the checkout, named by a hash of the source and the flags, so an edited
source rebuilds).  :func:`require` loads the library or raises with g++'s
output; :func:`available` says whether it loads (``HostInterface(backend=
"auto")`` and ``AudioEngine`` pick the native path with it).  Nothing is
built at import time.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

from ria_tpu_torch.utils import native_build

_SRC = Path(__file__).resolve().parents[2] / "native" / "ria_native.cpp"
_CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
_LOCK = threading.Lock()
_lib = None
_error: str | None = None


def build() -> native_build.Build:
    """Compile the library if it is missing; raises with g++'s output when
    the compile fails."""
    return native_build.compile_libraries("g++", {"ria_native": (_SRC, _CXX_FLAGS)},
                                          timeout=300)["ria_native"]


def require() -> ctypes.CDLL:
    """The loaded library, built first if need be.  Raises RuntimeError with
    the reason (g++'s output) when it cannot be built or loaded; a failure
    is remembered and raised again without a second build."""
    global _lib, _error
    with _LOCK:
        if _lib is not None:
            return _lib
        if _error is not None:
            raise RuntimeError(_error)
        try:
            _lib = _declare(ctypes.CDLL(str(build().path)))
        except (RuntimeError, OSError) as e:
            _error = f"native library unavailable: {e}"
            raise RuntimeError(_error) from e
        return _lib


def available() -> bool:
    try:
        require()
    except RuntimeError:
        return False
    return True


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Argument and result types of every entry point of ``lib``."""
    lib.rb_create.restype = ctypes.c_void_p
    lib.rb_create.argtypes = [ctypes.c_size_t]
    lib.rb_destroy.argtypes = [ctypes.c_void_p]
    lib.rb_size.restype = ctypes.c_size_t
    lib.rb_size.argtypes = [ctypes.c_void_p]
    lib.rb_overflows.restype = ctypes.c_uint64
    lib.rb_overflows.argtypes = [ctypes.c_void_p]
    for fn in (lib.rb_write, lib.rb_read, lib.rb_peek):
        fn.restype = ctypes.c_size_t
        fn.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_size_t]
    lib.rb_consume.argtypes = [ctypes.c_void_p, ctypes.c_size_t]

    lib.rs_create.restype = ctypes.c_void_p
    lib.rs_create.argtypes = [ctypes.c_uint, ctypes.c_uint]
    lib.rs_destroy.argtypes = [ctypes.c_void_p]
    lib.rs_output_size.restype = ctypes.c_size_t
    lib.rs_output_size.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    lib.rs_process.restype = ctypes.c_size_t
    lib.rs_process.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                               ctypes.c_size_t, ctypes.POINTER(ctypes.c_float),
                               ctypes.c_size_t]

    lib.wc_create.restype = ctypes.c_void_p
    lib.wc_create.argtypes = [ctypes.c_double] * 4 + [ctypes.c_uint, ctypes.c_uint,
                                                      ctypes.c_int, ctypes.c_int,
                                                      ctypes.c_int]
    lib.wc_destroy.argtypes = [ctypes.c_void_p]
    lib.wc_process.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                               ctypes.POINTER(ctypes.c_float), ctypes.c_size_t]

    lib.crc16_ccitt.restype = ctypes.c_uint16
    lib.crc16_ccitt.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t]

    lib.tcp_create.restype = ctypes.c_void_p
    lib.tcp_create.argtypes = [ctypes.c_char_p, ctypes.c_int]
    for fn in (lib.tcp_port, lib.tcp_client_count):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p]
    lib.tcp_poll.restype = ctypes.c_int
    lib.tcp_poll.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.tcp_next_event.restype = ctypes.c_int
    lib.tcp_next_event.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                                   ctypes.POINTER(ctypes.c_int),
                                   ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
    for fn in (lib.tcp_send, lib.tcp_broadcast):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int] \
            if fn is lib.tcp_broadcast else \
            [ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
    lib.tcp_close_client.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.tcp_destroy.argtypes = [ctypes.c_void_p]
    return lib


def _fptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class NativeRingBuffer:
    """SPSC float ring buffer with overflow accounting (C++ backed)."""

    def __init__(self, capacity: int):
        lib = require()
        self._lib = lib
        self._h = lib.rb_create(capacity)
        self.capacity = capacity

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.rb_destroy(self._h)
            self._h = None

    def write(self, samples: np.ndarray) -> int:
        x = np.ascontiguousarray(samples, np.float32)
        return self._lib.rb_write(self._h, _fptr(x), len(x))

    def read(self, n: int) -> np.ndarray:
        out = np.empty(n, np.float32)
        got = self._lib.rb_read(self._h, _fptr(out), n)
        return out[:got]

    def peek(self, n: int) -> np.ndarray:
        out = np.empty(n, np.float32)
        got = self._lib.rb_peek(self._h, _fptr(out), n)
        return out[:got]

    def consume(self, n: int):
        self._lib.rb_consume(self._h, n)

    def __len__(self) -> int:
        return self._lib.rb_size(self._h)

    @property
    def overflows(self) -> int:
        return self._lib.rb_overflows(self._h)


class NativeResampler:
    """Streaming rational polyphase resampler (C++ backed)."""

    def __init__(self, input_rate: int, output_rate: int):
        lib = require()
        self._lib = lib
        self._h = lib.rs_create(input_rate, output_rate)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.rs_destroy(self._h)
            self._h = None

    def process(self, samples: np.ndarray) -> np.ndarray:
        x = np.ascontiguousarray(samples, np.float32)
        cap = self._lib.rs_output_size(self._h, len(x)) + 8
        out = np.empty(cap, np.float32)
        got = self._lib.rs_process(self._h, _fptr(x), len(x), _fptr(out), cap)
        return out[:got]


class NativeWatterson:
    """Per-sample reference-faithful Watterson channel (C++ backed)."""

    def __init__(self, snr_db: float, delay_ms: float = 0.0, doppler_hz: float = 0.0,
                 cfo_hz: float = 0.0, sample_rate: int = 48000, seed: int = 42,
                 fading: bool = False, multipath: bool = False, noise: bool = True):
        lib = require()
        self._lib = lib
        self._h = lib.wc_create(snr_db, delay_ms, doppler_hz, cfo_hz, sample_rate,
                                seed, int(fading), int(multipath), int(noise))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.wc_destroy(self._h)
            self._h = None

    def process(self, samples: np.ndarray) -> np.ndarray:
        x = np.ascontiguousarray(samples, np.float32)
        out = np.empty(len(x), np.float32)
        self._lib.wc_process(self._h, _fptr(x), _fptr(out), len(x))
        return out


def crc16_native(data: bytes) -> int:
    if not available():
        from ria_tpu_torch.phy.frame_v2 import crc16

        return crc16(data)
    lib = require()
    buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    return lib.crc16_ccitt(buf, len(data))


class NativeTcpServer:
    """select()-based multi-client TCP server (native/ria_native.cpp
    TcpServer; reference src/interface/tcp_server.{hpp,cpp}).

    Event-queue API: poll(timeout_ms) multiplexes accept/read/close and
    drain() yields (type, client_id, payload) with type in
    {"connect", "disconnect", "data"}.  Writes are best-effort
    non-blocking, like the reference (a slow client must not stall the
    modem tick loop).
    """

    _EV = {1: "connect", 2: "disconnect", 3: "data"}
    _CHUNK = 65536

    def __init__(self, port: int = 0, bind_addr: str = "127.0.0.1"):
        lib = require()
        self._lib = lib
        self._h = lib.tcp_create(bind_addr.encode(), port)
        if not self._h:
            raise OSError(f"tcp_create failed for {bind_addr}:{port}")
        self.port = lib.tcp_port(self._h)
        self._buf = (ctypes.c_uint8 * self._CHUNK)()

    def __del__(self):
        self.close()

    def close(self):
        if getattr(self, "_h", None):
            self._lib.tcp_destroy(self._h)
            self._h = None

    @property
    def client_count(self) -> int:
        return self._lib.tcp_client_count(self._h)

    def poll(self, timeout_ms: int = 0) -> int:
        return self._lib.tcp_poll(self._h, timeout_ms)

    def drain(self):
        t, c = ctypes.c_int(), ctypes.c_int()
        while True:
            n = self._lib.tcp_next_event(self._h, ctypes.byref(t), ctypes.byref(c),
                                         self._buf, self._CHUNK)
            if n < 0:
                return
            yield self._EV[t.value], c.value, bytes(self._buf[:n])

    def send(self, client_id: int, data: bytes) -> int:
        buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
        return self._lib.tcp_send(self._h, client_id, buf, len(data))

    def broadcast(self, data: bytes) -> int:
        buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
        return self._lib.tcp_broadcast(self._h, buf, len(data))

    def close_client(self, client_id: int):
        self._lib.tcp_close_client(self._h, client_id)
