"""Zadoff-Chu synchronization (compact preamble, frame type in the root) in PyTorch.

Port of ``ria_tpu/sync/zc.py``.  Numeric contract from the reference
(src/sync/zc_sync.hpp):
- ZC sequence N=127 (odd prime): zc[n] = exp(-j pi r n (n+1) / N); roots
  PING=1, PONG=3, DATA=5, CONTROL=7 (:60-107, :420-436);
- 8x linear-interpolation upsample, 2 repetitions, I/Q modulated onto a
  1500 Hz carrier with continuous phase, peak-normalized to 0.8, 10 ms gap
  (:133-190);
- detection: downconvert to baseband, normalized complex correlation against
  each enabled root template, earliest-repetition timing adjustment (40%
  rule), non-coherent repetition combining below corr 0.25 (:192-305);
- CFO from inter-repetition correlation phase: cfo = arg(c2 conj(c1)) /
  (2 pi T_rep), unambiguous +/-23.6 Hz, confidence gate 0.1 (:307-366);
- correlation -> SNR map 20 log10(c/(1-c+0.01)) clamped [-10, 30] (:628-633);
- start_sample points PAST the preamble (payload start) (:380).

The TX tables are host numpy, copied from the reference so they match bit
for bit.  :class:`ZCDetector` correlates a batch of windows against all four
root templates in one batched FFT (cuFFT on the card) and evaluates every
lag; its buffers are the baseband time ramp and the conjugated template
spectra.  :func:`detect` is the reference's functional form over a cached
detector.  Divisions by constants follow the compiled reference
(``_rdiv``: ``x * f32(1/c)``).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ria_tpu_torch.dsp.util import _cis, _first_true, _rdiv, _sliding
from ria_tpu_torch.sync.chirp import _next_pow2
from ria_tpu_torch.utils.device import resolve_device

ZC_DEFAULT_DETECT_THRESHOLD = 0.3
ZC_REP1_ADJUST_THRESHOLD = 0.4
# First-significant-tap refinement (multipath): walk back this many samples
# from the correlation peak and lock to the earliest lag >= FRACTION * peak.
ZC_FIRST_TAP_WINDOW = 120
ZC_FIRST_TAP_FRACTION = 0.45
ZC_FIRST_TAP_MIN_PEAK = 0.4
ZC_FIRST_TAP_LOBE = 16
ZC_AMPLITUDE_SCALE = 0.8
ZC_CFO_CONFIDENCE_THRESHOLD = 0.1
ZC_LOW_SNR_COHERENT_THRESHOLD = 0.25
ZC_MAX_UNAMBIGUOUS_CFO_HZ = 23.6
# CFAR secondary detector: the peak-to-floor ratio of the correlation stays
# discriminative far below the 0.3 absolute threshold (noise-only windows
# max out around ratio ~4.3).
ZC_CFAR_RATIO = 6.0
ZC_CFAR_MIN_MAG = 0.04

# Frame types encoded in the ZC root
ZC_PING, ZC_PONG, ZC_DATA, ZC_CONTROL, ZC_UNKNOWN = 0, 1, 2, 3, 255

ROOT_MASK_PING = 1 << 0
ROOT_MASK_PONG = 1 << 1
ROOT_MASK_DATA = 1 << 2
ROOT_MASK_CONTROL = 1 << 3
ROOT_MASK_ALL = 0b1111


@dataclass(frozen=True)
class ZCConfig:
    sample_rate: float = 48000.0
    sequence_length: int = 127
    upsample_factor: int = 8
    num_repetitions: int = 2
    carrier_freq: float = 1500.0
    gap_ms: float = 10.0
    root_ping: int = 1
    root_pong: int = 3
    root_data: int = 5
    root_control: int = 7
    threshold: float = ZC_DEFAULT_DETECT_THRESHOLD

    @property
    def gap_samples(self) -> int:
        return int(self.sample_rate * self.gap_ms / 1000.0)

    @property
    def single_rep_samples(self) -> int:
        return self.sequence_length * self.upsample_factor

    @property
    def preamble_samples(self) -> int:
        return self.single_rep_samples * self.num_repetitions + self.gap_samples

    @property
    def roots(self) -> tuple[int, int, int, int]:
        return (self.root_ping, self.root_pong, self.root_data, self.root_control)

    def root_for_type(self, frame_type: int) -> int:
        return self.roots[frame_type] if 0 <= frame_type <= 3 else self.root_data


def zc_sequence(root: int, length: int) -> np.ndarray:
    n = np.arange(length, dtype=np.float64)
    if length % 2 == 0:
        phase = -np.pi * root * n * n / length
    else:
        phase = -np.pi * root * n * (n + 1) / length
    return np.exp(1j * phase).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _upsampled_template(cfg: ZCConfig, root: int) -> np.ndarray:
    """Linear-interpolated 8x upsampled ZC chip sequence [rep_samples] complex."""
    zc = zc_sequence(root, cfg.sequence_length)
    L, U = cfg.sequence_length, cfg.upsample_factor
    i = np.arange(L * U)
    chip_pos = i / U
    idx = chip_pos.astype(np.int64)
    frac = (chip_pos - idx).astype(np.float32)
    nxt = np.minimum(idx + 1, L - 1)
    frac = np.where(idx >= L - 1, 0.0, frac)
    return (zc[idx] * (1.0 - frac) + zc[nxt] * frac).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def generate_preamble(cfg: ZCConfig, frame_type: int) -> np.ndarray:
    """TX preamble for a frame type: repetitions + gap, peak-normalized 0.8."""
    root = cfg.root_for_type(frame_type)
    interp = _upsampled_template(cfg, root)
    rep_len = cfg.single_rep_samples
    total_sig = rep_len * cfg.num_repetitions
    t = np.arange(total_sig, dtype=np.float64) / cfg.sample_rate
    carrier = np.exp(1j * 2.0 * np.pi * cfg.carrier_freq * t)
    sig = np.real(np.tile(interp, cfg.num_repetitions) * carrier).astype(np.float32)
    peak = np.max(np.abs(sig))
    if peak > 0:
        sig *= ZC_AMPLITUDE_SCALE / peak
    return np.concatenate([sig, np.zeros(cfg.gap_samples, np.float32)])


class ZCSyncResult(NamedTuple):
    detected: torch.Tensor      # bool
    frame_type: torch.Tensor    # int32 (0..3, 255 unknown)
    start_sample: torch.Tensor  # int32: PAYLOAD start (past preamble)
    correlation: torch.Tensor   # float32
    cfo_hz: torch.Tensor        # float32
    snr_estimate: torch.Tensor  # float32
    root_index: torch.Tensor    # int32 index into cfg.roots, -1 if none


def _at(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[..., idx[...]] along the last axis, for idx with one axis fewer."""
    return torch.gather(x, -1, idx[..., None].long())[..., 0]


class ZCDetector(nn.Module):
    """ZC preamble detector for windows of ``num_samples``, with the roots of
    ``root_mask`` enabled: (samples [..., num_samples], known_cfo_hz) ->
    ZCSyncResult (per leading index).

    Buffers: the float32 time ramp of the downconversion (``t``) and the
    conjugated spectra of the four root templates (``tmpl_fft``, zero rows
    for disabled roots)."""

    def __init__(self, cfg: ZCConfig, num_samples: int, root_mask: int = ROOT_MASK_ALL,
                 device: str | torch.device = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.n = num_samples
        self.rep = rep = cfg.single_rep_samples
        self.short = num_samples < cfg.preamble_samples + 64
        if self.short:
            return
        self.nfft = _next_pow2(num_samples + rep)
        self.num_lags = num_samples - rep + 1
        self.enabled = [bool(root_mask & (1 << i)) for i in range(4)]
        # t = arange(n) / fs in float32, as the compiled reference forms it.
        self.register_buffer("t", _rdiv(torch.arange(num_samples, dtype=torch.float32,
                                                     device=dev), cfg.sample_rate))
        tmpl = np.zeros((4, rep), np.complex64)
        for i, root in enumerate(cfg.roots):
            if self.enabled[i]:
                tmpl[i] = _upsampled_template(cfg, root)
        spec = torch.fft.fft(torch.as_tensor(tmpl, device=dev), self.nfft, dim=-1)
        self.register_buffer("tmpl_fft", torch.conj(spec).resolve_conj())
        self.register_buffer("enabled_mask", torch.tensor(self.enabled, device=dev)[:, None])

    def forward(self, samples: torch.Tensor, known_cfo_hz: float = 0.0) -> ZCSyncResult:
        shape = samples.shape[:-1]
        if samples.shape[-1] != self.n:
            raise ValueError(f"window of {samples.shape[-1]} samples, built for {self.n}")
        dev = samples.device
        if self.short:
            f = torch.zeros(shape, dtype=torch.float32, device=dev)
            return ZCSyncResult(torch.zeros(shape, dtype=torch.bool, device=dev),
                                torch.full(shape, ZC_UNKNOWN, dtype=torch.int32, device=dev),
                                torch.full(shape, -1, dtype=torch.int32, device=dev), f, f, f,
                                torch.full(shape, -1, dtype=torch.int32, device=dev))
        res = self._detect(samples.reshape(-1, self.n).float(), known_cfo_hz)
        return ZCSyncResult(*(v.reshape(shape) for v in res))

    def _detect(self, x: torch.Tensor, known_cfo_hz: float) -> ZCSyncResult:
        cfg, rep, num_lags = self.cfg, self.rep, self.num_lags
        # Downconvert to baseband with a global-time phase ramp:
        # phase = (f32(-2 pi) * f32(fc + cfo)) * t, all in float32.
        w = np.float32(-2.0 * np.pi) * (np.float32(cfg.carrier_freq) + np.float32(known_cfo_hz))
        bb = x.to(torch.complex64) * _cis(self.t * float(w))

        # Sliding rx energy over num_lags lags (|bb| == |x|).
        rx_energy = _sliding(torch.square(x), rep)
        denom = torch.sqrt(torch.clamp_min(rx_energy * float(rep), 1e-20))
        # -60 dB relative energy floor: lags over digital silence are invalid
        # (their mag is zeroed and the CFAR floor averages valid lags only).
        lag_valid = rx_energy >= 1e-6 * torch.amax(rx_energy, dim=-1, keepdim=True)

        BB = torch.fft.fft(bb, self.nfft)
        corr = torch.fft.ifft(BB[:, None, :] * self.tmpl_fft, dim=-1)[..., :num_lags]
        norm_corr = corr / denom[:, None, :]
        valid = self.enabled_mask & lag_valid[:, None, :]           # [B, 4, lags]
        mag = torch.where(valid, torch.abs(norm_corr), 0.0)

        peak_pos = torch.argmax(mag, dim=-1)                         # [B, 4]
        peak_mag = _at(mag, peak_pos)
        n_valid = torch.clamp_min(torch.sum(valid.float(), dim=-1), 1.0)
        floor = torch.sum(mag, dim=-1) / n_valid                     # [B, 4]

        # Earliest-repetition timing adjustment (40% rule), only when the
        # lag one rep earlier rises clearly above the floor.
        earlier = torch.clamp_min(peak_pos - rep, 0)
        earlier_mag = _at(mag, earlier)
        confident = (peak_mag > cfg.threshold) | (earlier_mag > 3.0 * floor)
        use_earlier = confident & (peak_pos >= rep) & (
            earlier_mag > peak_mag * ZC_REP1_ADJUST_THRESHOLD)
        timing = torch.where(use_earlier, earlier, peak_pos)

        # First-significant-tap refinement: the earliest lag within the
        # walk-back window at >= 45% of the peak, then its main-lobe maximum.
        dev = x.device
        offs = torch.arange(-ZC_FIRST_TAP_WINDOW, 1, device=dev)
        widx = torch.clamp(timing[..., None] + offs, 0, num_lags - 1)   # [B, 4, W+1]
        at_peak = _at(mag, timing)
        strong = torch.gather(mag, -1, widx) >= ZC_FIRST_TAP_FRACTION * at_peak[..., None]
        edge = _at(widx, _first_true(strong))
        lidx = torch.clamp(edge[..., None] + torch.arange(ZC_FIRST_TAP_LOBE, device=dev),
                           0, num_lags - 1)
        refined = _at(lidx, torch.argmax(torch.gather(mag, -1, lidx), dim=-1))
        timing = torch.where(at_peak >= ZC_FIRST_TAP_MIN_PEAK, refined, timing)

        # Low-SNR non-coherent repetition combining.
        rep2 = torch.clamp_max(timing + rep, num_lags - 1)
        m1, m2 = _at(mag, timing), _at(mag, rep2)
        combined = _rdiv(torch.sqrt(m1 * m1 + m2 * m2), np.sqrt(np.float32(2.0)))
        combined = torch.maximum(combined, peak_mag)
        det_mag = torch.where(peak_mag < ZC_LOW_SNR_COHERENT_THRESHOLD, combined, peak_mag)

        # CFO from inter-repetition correlation phase.
        c1, c2 = _at(norm_corr, timing), _at(norm_corr, rep2)
        conf = ((torch.abs(c1) > ZC_CFO_CONFIDENCE_THRESHOLD)
                & (torch.abs(c2) > ZC_CFO_CONFIDENCE_THRESHOLD))
        rep_duration = rep / cfg.sample_rate
        cfo = _rdiv(torch.angle(c2 * torch.conj(c1)), 2.0 * np.pi * rep_duration)
        cfo = torch.where(conf, cfo, 0.0)

        # CFAR statistic: detection peak vs the correlation floor of the same
        # root.  Disabled roots have mag == 0 everywhere (ratio 0).
        ratio = det_mag / torch.clamp_min(floor, 1e-6)
        cfar_ok = (ratio > ZC_CFAR_RATIO) & (det_mag > ZC_CFAR_MIN_MAG)

        # Best root: the absolute-threshold detector's winner first, else the
        # best CFAR ratio.
        score = torch.where(det_mag > cfg.threshold, det_mag + 10.0,
                            torch.where(cfar_ok, _rdiv(ratio, ZC_CFAR_RATIO), det_mag))
        best = torch.argmax(score, dim=-1)
        best_mag = _at(det_mag, best)
        best_ratio = _at(ratio, best)
        best_timing = _at(timing, best)
        best_cfo = _at(cfo, best)

        detected = (best_mag > cfg.threshold) | (
            (best_ratio > ZC_CFAR_RATIO) & (best_mag > ZC_CFAR_MIN_MAG))
        snr = 20.0 * torch.log10(best_mag / (1.0 - best_mag + 0.01))
        snr = torch.clamp(snr, -10.0, 30.0)
        best = best.to(torch.int32)
        return ZCSyncResult(
            detected=detected,
            frame_type=torch.where(detected, best, ZC_UNKNOWN).to(torch.int32),
            start_sample=torch.where(detected, best_timing + cfg.preamble_samples,
                                     -1).to(torch.int32),
            correlation=best_mag,
            cfo_hz=torch.where(detected, best_cfo, 0.0),
            snr_estimate=snr,
            root_index=torch.where(detected, best, -1).to(torch.int32),
        )


@functools.lru_cache(maxsize=64)
def zc_detector(cfg: ZCConfig, num_samples: int, root_mask: int = ROOT_MASK_ALL,
                device: str | torch.device = "cuda") -> ZCDetector:
    """Cached :class:`ZCDetector` for a (config, window, root mask, device)."""
    return ZCDetector(cfg, num_samples, root_mask, device)


def detect(samples: torch.Tensor, cfg: ZCConfig, root_mask: int = ROOT_MASK_ALL,
           known_cfo_hz: float = 0.0) -> ZCSyncResult:
    """Detect a ZC preamble in a window [..., N] (batched over leading axes),
    on the samples' device."""
    return zc_detector(cfg, samples.shape[-1], root_mask, samples.device)(samples, known_cfo_hz)
