"""Biquad IIR filters and AGC (batched), in PyTorch.

Port of ``ria_tpu/dsp/biquad.py``.  Coefficient formulas match the reference
RBJ-style designs (src/dsp/filters.cpp:108-172), computed in float64 numpy
exactly as the reference package does; AGC matches filters.cpp:195-224.

Both recurrences are sequential by nature (the reference package evaluates
them with ``lax.scan``).  Here each is a loop over the time axis,
vectorised over the leading axes, on the input's device.  The coefficients
enter the float32 arithmetic as float32, as the reference's weak-typed
Python floats do; the feed-forward products ``b_i * x`` are formed for the
whole block first (the same roundings as inside the loop).  Only the tests
call these functions: no modem path runs them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class BiquadCoeffs:
    b0: float
    b1: float
    b2: float
    a1: float
    a2: float


def _rbj(freq: float, q: float, fs: float):
    w0 = 2.0 * np.pi * freq / fs
    alpha = np.sin(w0) / (2.0 * q)
    return w0, alpha, np.cos(w0)


def lowpass(freq: float, q: float, fs: float) -> BiquadCoeffs:
    w0, alpha, c = _rbj(freq, q, fs)
    a0 = 1.0 + alpha
    return BiquadCoeffs(((1 - c) / 2) / a0, (1 - c) / a0, ((1 - c) / 2) / a0,
                        (-2 * c) / a0, (1 - alpha) / a0)


def highpass(freq: float, q: float, fs: float) -> BiquadCoeffs:
    w0, alpha, c = _rbj(freq, q, fs)
    a0 = 1.0 + alpha
    return BiquadCoeffs(((1 + c) / 2) / a0, -(1 + c) / a0, ((1 + c) / 2) / a0,
                        (-2 * c) / a0, (1 - alpha) / a0)


def bandpass(freq: float, q: float, fs: float) -> BiquadCoeffs:
    w0, alpha, c = _rbj(freq, q, fs)
    a0 = 1.0 + alpha
    return BiquadCoeffs(alpha / a0, 0.0, -alpha / a0, (-2 * c) / a0, (1 - alpha) / a0)


def notch(freq: float, q: float, fs: float) -> BiquadCoeffs:
    w0, alpha, c = _rbj(freq, q, fs)
    a0 = 1.0 + alpha
    return BiquadCoeffs(1.0 / a0, (-2 * c) / a0, 1.0 / a0, (-2 * c) / a0, (1 - alpha) / a0)


def biquad_filter(x: torch.Tensor, c: BiquadCoeffs, state=None):
    """Transposed direct form II over the last axis; returns (y, state).

    state: (z1, z2) tensors broadcastable to x[..., 0].
    """
    if state is None:
        z = x.new_zeros(x.shape[:-1])
        state = (z, z)
    z1, z2 = state
    b0, b1, b2, a1, a2 = (float(np.float32(v)) for v in (c.b0, c.b1, c.b2, c.a1, c.a2))
    xt = torch.movedim(x, -1, 0)
    bx0, bx1, bx2 = b0 * xt, b1 * xt, b2 * xt
    y = torch.empty_like(xt)
    for i in range(xt.shape[0]):
        yi = bx0[i] + z1
        z1 = bx1[i] - a1 * yi + z2
        z2 = bx2[i] - a2 * yi
        y[i] = yi
    return torch.movedim(y, 0, -1), (z1, z2)


def agc(x: torch.Tensor, target: float = 0.5, attack: float = 0.01,
        decay: float = 0.001, gain0: float = 1.0):
    """Per-sample AGC recurrence (filters.cpp:195-211); returns (y, gain)."""
    target, attack, decay = (float(np.float32(v)) for v in (target, attack, decay))
    xt = torch.movedim(x, -1, 0)
    level_x = xt.abs()
    gain = x.new_full(x.shape[:-1], gain0)
    y = torch.empty_like(xt)
    for i in range(xt.shape[0]):
        level = level_x[i] * gain
        gain = torch.where(level > target, gain - attack * (level - target),
                           gain + decay * (target - level))
        gain = gain.clamp(0.001, 1000.0)
        y[i] = xt[i] * gain
    return torch.movedim(y, 0, -1), gain
