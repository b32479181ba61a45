"""FIR design (host numpy) + batched FFT-based filtering, in PyTorch.

Port of ``ria_tpu/dsp/fir.py``.  Tap design matches the reference
windowed-sinc formulas (reference: src/dsp/filters.cpp:20-77):
Hamming-windowed normalized lowpass, spectral-inversion highpass,
Blackman-windowed bandpass; the ``design_*`` functions are the reference
package's numpy code, bit for bit.  Filtering convolves whole blocks via
``torch.fft.rfft``/``irfft`` on the input's device (cuFFT on the card),
batched over leading axes, with the causal delay line carried by the caller
as a ``tail``.
"""

from __future__ import annotations

import numpy as np
import torch


def design_lowpass(taps: int, cutoff: float, sample_rate: float) -> np.ndarray:
    fc = cutoff / sample_rate
    M = (taps - 1) // 2
    n = np.arange(taps)
    x = np.pi * (n - M)
    with np.errstate(divide="ignore", invalid="ignore"):
        h = np.where(n == M, 2.0 * fc, np.sin(2.0 * fc * x) / x)
    h *= 0.54 - 0.46 * np.cos(2.0 * np.pi * n / (taps - 1))
    return (h / h.sum()).astype(np.float32)


def design_highpass(taps: int, cutoff: float, sample_rate: float) -> np.ndarray:
    h = -design_lowpass(taps, cutoff, sample_rate)
    h[(taps - 1) // 2] += 1.0
    return h.astype(np.float32)


def design_bandpass(taps: int, low: float, high: float, sample_rate: float) -> np.ndarray:
    fl, fh = low / sample_rate, high / sample_rate
    M = (taps - 1) // 2
    n = np.arange(taps)
    x = np.pi * (n - M)
    with np.errstate(divide="ignore", invalid="ignore"):
        h = np.where(n == M, 2.0 * (fh - fl), (np.sin(2.0 * fh * x) - np.sin(2.0 * fl * x)) / x)
    w = 2.0 * np.pi * n / (taps - 1)
    h *= 0.42 - 0.5 * np.cos(w) + 0.08 * np.cos(2.0 * w)
    return h.astype(np.float32)


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def _taps_like(h, x: torch.Tensor) -> torch.Tensor:
    """The taps as a float32 tensor on ``x``'s device."""
    return torch.as_tensor(np.asarray(h, np.float32) if not isinstance(h, torch.Tensor) else h,
                           dtype=torch.float32, device=x.device)


def fft_convolve(x: torch.Tensor, h, mode: str = "same") -> torch.Tensor:
    """Linear convolution along the last axis via FFT (batched).

    "same" is centered like ``np.convolve(mode="same")``; "full" returns
    len(x)+len(h)-1 samples.  ``h`` is a numpy array or a tensor; the
    result lies on ``x``'s device.
    """
    h = _taps_like(h, x)
    n = x.shape[-1] + h.shape[-1] - 1
    nfft = _next_pow2(n)
    X = torch.fft.rfft(x.float(), nfft, dim=-1)
    H = torch.fft.rfft(h, nfft, dim=-1)
    y = torch.fft.irfft(X * H, nfft, dim=-1)[..., :n]
    if mode == "full":
        return y
    if mode == "same":
        start = (h.shape[-1] - 1) // 2
        return y[..., start : start + x.shape[-1]]
    raise ValueError(mode)


def fir_filter(x: torch.Tensor, h, tail: torch.Tensor | None = None):
    """Causal streaming FIR over a block: returns (y, new_tail).

    Equivalent to feeding the samples through a stateful delay-line FIR
    (reference src/dsp/filters.cpp:79-104): y[i] = sum_k h[k] x[i-k], with
    history carried in ``tail`` ([..., len(h)-1] previous input samples).
    """
    taps = len(h)
    if tail is None:
        tail = x.new_zeros(x.shape[:-1] + (taps - 1,))
    xx = torch.cat([tail, x], dim=-1)
    y = fft_convolve(xx, h, mode="full")[..., taps - 1 : taps - 1 + x.shape[-1]]
    new_tail = xx[..., -(taps - 1) :]
    return y, new_tail
