"""Rational polyphase resampler (e.g. 48 kHz <-> 8 kHz), batched, in PyTorch.

Port of ``ria_tpu/dsp/resampler.py``.  Contract from the reference
(src/dsp/resampler.cpp): upsample-by-L zero-stuffing (scaled by L), 64-tap
windowed-sinc anti-alias lowpass at 0.45*min(fin,fout) designed at the high
rate, decimate-by-M.  As in the reference package, the explicit form: an FFT
convolution of the zero-stuffed signal (``dsp/fir.py``), the causal part,
every M-th sample; on the input's device.
"""

from __future__ import annotations

import functools
from math import gcd

import torch

from ria_tpu_torch.dsp.fir import design_lowpass, fft_convolve


@functools.lru_cache(maxsize=None)
def _design(input_rate: int, output_rate: int):
    g = gcd(input_rate, output_rate)
    L = output_rate // g
    M = input_rate // g
    h = design_lowpass(64, min(input_rate, output_rate) * 0.45,
                       float(max(input_rate, output_rate)))
    return L, M, h


def resample(x: torch.Tensor, input_rate: int, output_rate: int) -> torch.Tensor:
    """Resample along the last axis (batched over leading axes)."""
    if input_rate == output_rate:
        return x
    L, M, h = _design(input_rate, output_rate)
    n = x.shape[-1]
    up = x.new_zeros(x.shape[:-1] + (n * L,))
    up[..., ::L] = x * L
    y = fft_convolve(up, h, mode="full")
    # Causal alignment matching the streaming FIR (y[i] uses x up to i).
    y = y[..., : n * L]
    return y[..., ::M]


def output_size(input_size: int, input_rate: int, output_rate: int) -> int:
    L, M, _ = _design(input_rate, output_rate)
    return -(-input_size * L // M)
