"""CSS (chirp spread spectrum) sync with cyclic-shift frame typing, in PyTorch.

Port of ``ria_tpu/sync/css.py``.  Contract from the reference
(src/sync/css_sync.hpp):
- single base up-chirp 300->2700 Hz over 500 ms, repeated num_chirps=2 with
  100 ms gaps; frame type in 1-of-4 cyclic shift of the chirp (PING=0,
  PONG=1, DATA=2, CONTROL=3), shifts evenly spaced over the duration;
- detection: matched filter of the whole two-chirp preamble for each of the
  four shifts; the frame type is the argmax template.

The TX tables are host numpy copies.  :class:`CSSDetector` correlates a batch
of windows against the four shifted templates by FFT (cuFFT on the card),
one template at a time so that only one [B, nfft] spectrum product is alive;
:func:`detect` is the reference's functional form over a cached detector.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ria_tpu_torch.dsp.util import _sliding
from ria_tpu_torch.utils.device import resolve_device

CSS_PING, CSS_PONG, CSS_DATA, CSS_CONTROL, CSS_UNKNOWN = 0, 1, 2, 3, 255


@dataclass(frozen=True)
class CSSConfig:
    sample_rate: float = 48000.0
    f_start: float = 300.0
    f_end: float = 2700.0
    duration_ms: float = 500.0
    gap_ms: float = 100.0
    num_shifts: int = 4
    num_chirps: int = 2
    threshold: float = 0.3

    @property
    def chirp_samples(self) -> int:
        return int(self.sample_rate * self.duration_ms / 1000.0)

    @property
    def gap_samples(self) -> int:
        return int(self.sample_rate * self.gap_ms / 1000.0)

    @property
    def preamble_samples(self) -> int:
        return (self.num_chirps * self.chirp_samples
                + (self.num_chirps - 1) * self.gap_samples + self.gap_samples)


@functools.lru_cache(maxsize=None)
def _base_phase(cfg: CSSConfig) -> np.ndarray:
    t = np.arange(cfg.chirp_samples, dtype=np.float64) / cfg.sample_rate
    k = (cfg.f_end - cfg.f_start) / (cfg.duration_ms / 1000.0)
    return 2.0 * np.pi * (cfg.f_start * t + 0.5 * k * t * t)


@functools.lru_cache(maxsize=None)
def _shifted_chirp(cfg: CSSConfig, shift: int) -> np.ndarray:
    """Real chirp cyclically shifted by shift/num_shifts of its duration."""
    base = np.sin(_base_phase(cfg)).astype(np.float32)
    off = (shift * cfg.chirp_samples) // cfg.num_shifts
    return np.roll(base, off)


@functools.lru_cache(maxsize=None)
def _shifted_template(cfg: CSSConfig, shift: int) -> np.ndarray:
    """Analytic template of the WHOLE preamble (both chirp repeats + gap):
    one chirp alone peaks equally at either repeat, and a partly visible
    shifted chirp aliases into another (shift, position) pair."""
    analytic = np.exp(1j * _base_phase(cfg)).astype(np.complex64)
    off = (shift * cfg.chirp_samples) // cfg.num_shifts
    one = np.roll(analytic, off)
    gap = np.zeros(cfg.gap_samples, np.complex64)
    parts = []
    for i in range(cfg.num_chirps):
        parts.append(one)
        if i < cfg.num_chirps - 1:
            parts.append(gap)
    return np.concatenate(parts)


def generate_preamble(cfg: CSSConfig, frame_type: int, amplitude: float = 0.5) -> np.ndarray:
    shift = frame_type if 0 <= frame_type < cfg.num_shifts else CSS_DATA
    chirp = amplitude * _shifted_chirp(cfg, shift)
    gap = np.zeros(cfg.gap_samples, np.float32)
    parts = []
    for i in range(cfg.num_chirps):
        parts.append(chirp)
        parts.append(gap)
    return np.concatenate(parts).astype(np.float32)


class CSSResult(NamedTuple):
    detected: torch.Tensor
    frame_type: torch.Tensor
    start_sample: torch.Tensor  # data start (after preamble)
    correlation: torch.Tensor


class CSSDetector(nn.Module):
    """CSS preamble detector for windows of ``num_samples``:
    samples [..., num_samples] -> CSSResult (per leading index).

    Buffer: the conjugated spectra of the shifted templates (``tmpl_fft``,
    [num_shifts, nfft]).  nfft is ``1 << (n + L - 1).bit_length()`` as in the
    reference, which is twice the next power of two when n + L - 1 is one."""

    def __init__(self, cfg: CSSConfig, num_samples: int, device: str | torch.device = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.n = num_samples
        self.L = L = len(_shifted_template(cfg, 0))          # full two-chirp span
        self.short = num_samples < cfg.preamble_samples + 64
        if self.short:
            return
        self.nfft = 1 << (num_samples + L - 1).bit_length()
        self.num_lags = max(num_samples - L, 1)
        tmpl = np.stack([_shifted_template(cfg, s) for s in range(cfg.num_shifts)])
        spec = torch.fft.fft(torch.as_tensor(tmpl, device=dev), self.nfft, dim=-1)
        self.register_buffer("tmpl_fft", torch.conj(spec).resolve_conj())
        # Template energy as a Python float, as the reference computes it.
        self.energy = float(np.sum(np.abs(_shifted_template(cfg, 0)) ** 2) / 2.0)

    def forward(self, samples: torch.Tensor) -> CSSResult:
        shape = samples.shape[:-1]
        if samples.shape[-1] != self.n:
            raise ValueError(f"window of {samples.shape[-1]} samples, built for {self.n}")
        dev = samples.device
        if self.short:
            return CSSResult(torch.zeros(shape, dtype=torch.bool, device=dev),
                             torch.full(shape, CSS_UNKNOWN, dtype=torch.int32, device=dev),
                             torch.full(shape, -1, dtype=torch.int32, device=dev),
                             torch.zeros(shape, dtype=torch.float32, device=dev))
        res = self._detect(samples.reshape(-1, self.n).float())
        return CSSResult(*(v.reshape(shape) for v in res))

    def _detect(self, x: torch.Tensor) -> CSSResult:
        cfg, L, num_lags = self.cfg, self.L, self.num_lags
        X = torch.fft.fft(x.to(torch.complex64), self.nfft)
        corr = torch.stack([torch.abs(torch.fft.ifft(X * t))[:, :num_lags]
                            for t in self.tmpl_fft], dim=1)          # [B, shifts, lags]

        win = _sliding(torch.square(x), L)[:, :num_lags]
        # Relative energy floor: a near-silent lag window must not spike the
        # normalized metric.
        win = torch.maximum(win, 0.02 * torch.amax(win, dim=-1, keepdim=True))
        norm = corr / torch.sqrt(torch.clamp_min(win[:, None, :] * self.energy, 1e-20))

        # One argmax over [shift, lag]: on a tie the lower shift wins.
        flat = norm.reshape(norm.shape[0], -1)
        best = torch.argmax(flat, dim=-1)
        shift = (best // num_lags).to(torch.int32)
        pos = (best % num_lags).to(torch.int32)
        val = torch.gather(flat, 1, best[:, None])[:, 0]
        detected = val > cfg.threshold
        return CSSResult(
            detected=detected,
            frame_type=torch.where(detected, shift, CSS_UNKNOWN).to(torch.int32),
            start_sample=torch.where(detected, pos + cfg.preamble_samples, -1).to(torch.int32),
            correlation=val,
        )


@functools.lru_cache(maxsize=64)
def css_detector(cfg: CSSConfig, num_samples: int,
                 device: str | torch.device = "cuda") -> CSSDetector:
    """Cached :class:`CSSDetector` for a (config, window, device)."""
    return CSSDetector(cfg, num_samples, device)


def detect(samples: torch.Tensor, cfg: CSSConfig) -> CSSResult:
    """Detect a CSS preamble in a window [..., N] (batched over leading
    axes), on the samples' device."""
    return css_detector(cfg, samples.shape[-1], samples.device)(samples)
