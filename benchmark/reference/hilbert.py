"""Frozen copy of ``ria_tpu_torch/dsp/hilbert.py``, held by the benchmark as its plain
reference; it imports nothing of the port.

FFT-based analytic signal (zero-group-delay Hilbert transform) in PyTorch.

Port of ``ria_tpu/dsp/hilbert.py``: double the positive frequencies, zero the
negative ones, on a power-of-two FFT length (cuFFT on the card).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _weights(nfft: int, device: torch.device) -> torch.Tensor:
    h = np.zeros(nfft, np.float32)
    h[0] = h[nfft // 2] = 1.0
    h[1 : nfft // 2] = 2.0
    return torch.as_tensor(h, device=device)


def analytic_signal(x: torch.Tensor) -> torch.Tensor:
    """Real [..., N] -> complex64 analytic signal [..., N], on x's device.

    Computed on the next power-of-two length, as the reference does; the
    samples past N are discarded.  Every consumer normalizes per-lag energy,
    so the wrap-around of the zero-padded window is noise-level.
    """
    n = x.shape[-1]
    nfft = 1 << (n - 1).bit_length()
    X = torch.fft.fft(x.float(), n=nfft, dim=-1)
    return torch.fft.ifft(X * _weights(nfft, x.device), dim=-1)[..., :n]
