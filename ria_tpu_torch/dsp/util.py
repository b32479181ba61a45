"""Small DSP utilities (rms/peak/normalize/dB) on tensors, and the numeric
helpers the sync and waveform modules share (``_rdiv``, ``_sliding``,
``_first_true``, ``_cis``).

Port of ``ria_tpu/dsp/util.py``; parity surface: reference
include/ultra/dsp.hpp:183-204.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ria_tpu_torch.utils.device import wide_cumsum


def rms(x: torch.Tensor, axis=-1) -> torch.Tensor:
    return torch.sqrt(torch.mean(torch.square(x), dim=axis))


def peak(x: torch.Tensor, axis=-1) -> torch.Tensor:
    return torch.amax(torch.abs(x), dim=axis)


def normalize_rms(x: torch.Tensor, target_rms: float = 0.25, axis=-1) -> torch.Tensor:
    r = rms(x, axis=axis)
    scale = torch.where(r > 1e-9, target_rms / torch.clamp(r, min=1e-9), torch.ones_like(r))
    return x * scale.unsqueeze(axis)


def db_to_linear(db):
    return 10.0 ** (db / 20.0)


def linear_to_db(lin):
    if isinstance(lin, torch.Tensor):
        return 20.0 * torch.log10(torch.clamp(lin, min=1e-12))
    return 20.0 * math.log10(max(lin, 1e-12))


def _rdiv(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c for a constant c as the reference computes it under ``jax.jit``:
    XLA turns the division into a multiply by the float32 reciprocal of c.
    (Over a 26,880-sample downmix ramp the two differ by up to 2 ulps of the
    phase, 1e-3 rad, which moves LLRs of near-zero symbols by ~0.05.)"""
    return x * float(np.float32(1.0) / np.float32(c))


def _sliding(x: torch.Tensor, w: int) -> torch.Tensor:
    """Sliding sums of w samples along the last axis (cumsum difference)."""
    cs = torch.cat([torch.zeros_like(x[..., :1]), wide_cumsum(x, dim=-1)], dim=-1)
    return cs[..., w:] - cs[..., :-w]


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 when none): the
    reference's argmax of a boolean mask (``torch.argmax`` takes no bool)."""
    return torch.argmax(mask.to(torch.uint8), dim=-1)


def _cis(theta: torch.Tensor) -> torch.Tensor:
    """exp(1j * theta) as complex64 (theta float32)."""
    return torch.polar(torch.ones_like(theta), theta)
