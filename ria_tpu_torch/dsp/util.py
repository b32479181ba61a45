"""Small DSP utilities (rms/peak/normalize/dB) on tensors.

Port of ``ria_tpu/dsp/util.py``; parity surface: reference
include/ultra/dsp.hpp:183-204.
"""

from __future__ import annotations

import math

import torch


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
