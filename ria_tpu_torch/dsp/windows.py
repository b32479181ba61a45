"""Window functions (host numpy; constants uploaded once by their users).

Parity surface: reference include/ultra/dsp.hpp:183-204 (Hann, Hamming,
Blackman, Kaiser).

Host copy of ``ria_tpu/dsp/windows.py`` (numpy only).
"""

from __future__ import annotations

import numpy as np


def hann(n: int) -> np.ndarray:
    return (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / (n - 1))).astype(np.float32)


def hamming(n: int) -> np.ndarray:
    return (0.54 - 0.46 * np.cos(2 * np.pi * np.arange(n) / (n - 1))).astype(np.float32)


def blackman(n: int) -> np.ndarray:
    x = 2 * np.pi * np.arange(n) / (n - 1)
    return (0.42 - 0.5 * np.cos(x) + 0.08 * np.cos(2 * x)).astype(np.float32)


def kaiser(n: int, beta: float = 8.6) -> np.ndarray:
    return np.kaiser(n, beta).astype(np.float32)


def window(name: str, n: int, **kw) -> np.ndarray:
    return {"hann": hann, "hamming": hamming, "blackman": blackman, "kaiser": kaiser}[name](n, **kw)
