"""NCO / mixing as vectorized phase ramps (no per-sample state), in PyTorch.

Port of ``ria_tpu/dsp/nco.py``: it replaces the reference's per-sample NCO
object (include/ultra/dsp.hpp:160-181) with batched phase-ramp
construction; streaming phase continuity is carried explicitly by the
caller as a start phase.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ria_tpu_torch.dsp.hilbert import analytic_signal


def phase_ramp(freq_hz, num_samples: int, sample_rate: float, start_phase=0.0,
               device: str | torch.device | None = None) -> torch.Tensor:
    """Float32 phase ramp(s) [samples] or [..., samples] for a scalar or an
    array of frequencies, on ``freq_hz``'s device (a tensor), else on
    ``device`` (default the CPU)."""
    if isinstance(freq_hz, torch.Tensor):
        device = freq_hz.device
    freq = torch.as_tensor(freq_hz, dtype=torch.float32, device=device)
    t = torch.arange(num_samples, dtype=torch.float32, device=freq.device)
    start = torch.as_tensor(start_phase, dtype=torch.float32, device=freq.device)
    return start[..., None] + (2.0 * math.pi * freq[..., None] / sample_rate) * t


def mixer_bank(freqs_hz: np.ndarray, num_samples: int, sample_rate: float) -> np.ndarray:
    """Complex mixer bank e^{-j 2 pi f t} of shape [num_samples, num_freqs]
    (host constant, as in the reference package; src/psk/
    multi_carrier_dpsk.hpp:931-946)."""
    t = np.arange(num_samples, dtype=np.float64)[:, None]
    f = np.asarray(freqs_hz, dtype=np.float64)[None, :]
    return np.exp(-2j * np.pi * f * t / sample_rate).astype(np.complex64)


def freq_shift_real(x: torch.Tensor, shift_hz: float, sample_rate: float, start_phase=0.0):
    """Shift a real signal's spectrum by shift_hz via analytic signal rotation.

    Returns (shifted_real, end_phase), on ``x``'s device.  Matches the
    reference's Hilbert+rotate approach (src/psk/multi_carrier_dpsk.hpp:
    897-926) with the zero-delay FFT Hilbert of ``dsp/hilbert.py``.
    """
    z = analytic_signal(x)
    ph = phase_ramp(shift_hz, x.shape[-1], sample_rate, start_phase, device=x.device)
    rot = torch.polar(torch.ones_like(ph), ph)
    end_phase = ph[..., -1] + 2.0 * math.pi * shift_hz / sample_rate
    return torch.real(z * rot), end_phase
