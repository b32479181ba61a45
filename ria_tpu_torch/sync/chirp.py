"""Dual linear-FM chirp synchronization (FFT matched filter) in PyTorch.

Port of ``ria_tpu/sync/chirp.py``.  Numeric contract from the reference
(src/sync/chirp_sync.hpp):
- up-chirp 300->2700 Hz over 500 ms, 100 ms gap, down-chirp 2700->300 Hz,
  100 ms gap (~1.2 s total), amplitude 0.5 (generate(): :61-108);
- detection = complex (analytic) template cross-correlation, magnitude peak,
  normalized by sqrt(sliding signal energy * template energy)
  (detectChirpTemplateFFT :627-709);
- dual-chirp CFO: correlation peaks shift by -/+ CFO*fs/chirp_rate for
  up/down chirps, so CFO = gap_error / (2*fs/chirp_rate) and the true
  up-chirp start is up_pos + CFO*fs/chirp_rate (detectDualChirp :352-512);
- reject |CFO| > 100 Hz; default threshold 0.15.

The whole search window is one batched FFT correlation and an argmax.  For
large windows (nfft >= 131072) the zoom branch correlates a box-sum-decimated
complex baseband on a lag grid of stride 16, then refines the coarse peak to
sample resolution with a small matmul against shifted templates, which also
gives the exact normalized correlation used for thresholding.  The numpy
table builders are copied verbatim from the reference package, so the
complex64 constants match bit for bit; the FFTs and the refinement matmuls
are torch ops (cuFFT, cuBLAS on the card), as they were XLA ops there.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ria_tpu_torch.utils.device import resolve_device, wide_cumsum


@dataclass(frozen=True)
class ChirpConfig:
    sample_rate: float = 48000.0
    f_start: float = 300.0
    f_end: float = 2700.0
    duration_ms: float = 500.0
    gap_ms: float = 100.0
    amplitude: float = 0.5
    use_dual_chirp: bool = True
    threshold: float = 0.15
    # CFAR acceptance: accept when the up-chirp peak stands cfar_ratio above
    # the median normalized correlation of the window, with absolute floors
    # (true chirps: peak/median >= 22 down to -14 dB AWGN; pure noise <= 4.0).
    cfar_ratio: float = 6.0
    cfar_abs_floor: float = 0.06
    cfar_down_floor: float = 0.08

    @property
    def chirp_samples(self) -> int:
        return int(self.sample_rate * self.duration_ms / 1000.0)

    @property
    def gap_samples(self) -> int:
        return int(self.sample_rate * self.gap_ms / 1000.0)

    @property
    def total_samples(self) -> int:
        if self.use_dual_chirp:
            return 2 * self.chirp_samples + 2 * self.gap_samples
        return self.chirp_samples + self.gap_samples

    @property
    def chirp_rate(self) -> float:
        return (self.f_end - self.f_start) / (self.duration_ms / 1000.0)

    @property
    def cfo_to_samples(self) -> float:
        """Correlation-peak shift per Hz of CFO (~10 samples/Hz)."""
        return self.sample_rate / self.chirp_rate


class ChirpSyncResult(NamedTuple):
    detected: torch.Tensor   # bool
    start: torch.Tensor      # int32, CFO-corrected up-chirp start
    cfo_hz: torch.Tensor     # float32
    up_corr: torch.Tensor    # float32
    down_corr: torch.Tensor  # float32


def _chirp_phase(cfg: ChirpConfig, up: bool) -> np.ndarray:
    t = np.arange(cfg.chirp_samples, dtype=np.float64) / cfg.sample_rate
    k = cfg.chirp_rate
    if up:
        return 2.0 * np.pi * (cfg.f_start * t + 0.5 * k * t * t)
    return 2.0 * np.pi * (cfg.f_end * t - 0.5 * k * t * t)


@functools.lru_cache(maxsize=None)
def generate(cfg: ChirpConfig, tx_cfo_hz: float = 0.0) -> np.ndarray:
    """TX chirp sequence [up][gap][down][gap] as float32 samples."""
    t = np.arange(cfg.chirp_samples, dtype=np.float64) / cfg.sample_rate
    out = np.zeros(cfg.total_samples, dtype=np.float32)
    up = cfg.amplitude * np.sin(_chirp_phase(cfg, up=True) + 2 * np.pi * tx_cfo_hz * t)
    out[: cfg.chirp_samples] = up
    if cfg.use_dual_chirp:
        down_start = cfg.chirp_samples + cfg.gap_samples
        down = cfg.amplitude * np.sin(_chirp_phase(cfg, up=False) + 2 * np.pi * tx_cfo_hz * t)
        out[down_start : down_start + cfg.chirp_samples] = down
    return out


@functools.lru_cache(maxsize=None)
def _templates(cfg: ChirpConfig):
    """Unit-amplitude analytic templates (cos + j sin) and their energies."""
    up = np.exp(1j * _chirp_phase(cfg, up=True)).astype(np.complex64)
    down = np.exp(1j * _chirp_phase(cfg, up=False)).astype(np.complex64)
    # Template energy of the real (sin) template, as the reference normalizes
    # against its stored sin template: sum sin^2 ~= N/2.
    energy = float(np.sum(np.sin(_chirp_phase(cfg, up=True)) ** 2))
    return up, down, energy


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


# Zoom branch: decimate the correlation lag grid by this factor (the kept
# 3 kHz band holds the 300-2700 Hz chirp with a ~300 Hz leakage guard).
_ZOOM_DECIM = 16
# Refinement half-width in samples around the coarse peak (>= _ZOOM_DECIM so
# the true peak is always inside the refined search).
_ZOOM_REFINE = 24
_ZOOM_MIN_NFFT = 131072


@functools.lru_cache(maxsize=None)
def _zoom_tables(cfg: ChirpConfig, nfft: int):
    """Precomputed decimated templates + shifted-template refinement matrices.

    Coarse stage operates on a complex baseband decimated by _ZOOM_DECIM:
    mix by e^{-j w_c t} (band center), box-sum groups of D samples.  The
    box-sum is a linear filter, so correlating two box-filtered signals
    equals the true correlation smoothed by a 2D-1 tap triangle — the
    envelope peak location is preserved, and the refinement matmul restores
    exact full-rate timing and correlation values.
    """
    up_t, down_t, energy = _templates(cfg)
    D = _ZOOM_DECIM
    fc = (cfg.f_start + cfg.f_end) / 2.0
    n_t = cfg.chirp_samples
    rot_t = np.exp(-2j * np.pi * fc * np.arange(n_t) / cfg.sample_rate)
    nb = nfft // D

    def dec_tmpl(t):
        z = (t * rot_t)[: (n_t // D) * D].reshape(-1, D).sum(-1)
        return np.conj(np.fft.fft(z, nb)).astype(np.complex64)

    up_band = dec_tmpl(up_t)
    down_band = dec_tmpl(down_t)

    # Refinement matmul: M[n, j] = conj(t[n - j]) so (y @ M)[j] is the
    # correlation of window y against the template placed at offset j.
    R = _ZOOM_REFINE
    L = cfg.chirp_samples + 2 * R
    def shift_mat(t):
        M = np.zeros((L, 2 * R + 1), np.complex64)
        for j in range(2 * R + 1):
            M[j : j + cfg.chirp_samples, j] = np.conj(t)
        return np.ascontiguousarray(M.real), np.ascontiguousarray(M.imag)
    return up_band, down_band, energy, shift_mat(up_t), shift_mat(down_t)


def _median(x: torch.Tensor) -> torch.Tensor:
    """Median over the last axis with numpy/JAX semantics: for an even count,
    the mean of the two middle values (``torch.median`` returns the lower)."""
    n = x.shape[-1]
    s = torch.sort(x, dim=-1).values
    return 0.5 * (s[..., (n - 1) // 2] + s[..., n // 2])


def window_slice(x: torch.Tensor, start: torch.Tensor, length: int) -> torch.Tensor:
    """x[b, start[b] : start[b] + length] per row, with the start clamped
    into range as ``jax.lax.dynamic_slice`` does.  x: [B, n]; start: [B]."""
    start = torch.clamp(start.long(), 0, max(x.shape[-1] - length, 0))
    idx = start[:, None] + torch.arange(length, device=x.device)
    return torch.gather(x, 1, idx)


def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    """a / b as an IEEE division.  (A Python-scalar divisor may become a
    multiplication by its reciprocal on the card, and start = round(up_pos
    + cfo * 10) sits on a half-integer whenever the gap error is odd.)"""
    return a / torch.full_like(a, b)


class ChirpDetector(nn.Module):
    """Dual-chirp detector for windows of ``num_samples``:
    samples [..., num_samples] -> ChirpSyncResult (per leading index).

    Buffers: the conjugated template spectra (full-rate branch), or the
    decimated band templates, the mixing ramp and the refinement matrices
    (zoom branch)."""

    def __init__(self, cfg: ChirpConfig, num_samples: int,
                 device: str | torch.device = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.n = num_samples
        self.chirp_len = cfg.chirp_samples
        self.short = num_samples < cfg.total_samples + 64
        self.nfft = _next_pow2(num_samples + self.chirp_len)
        self.zoom = (not self.short and self.nfft >= _ZOOM_MIN_NFFT
                     and self.chirp_len % _ZOOM_DECIM == 0)
        if self.short:
            return
        if self.zoom:
            up_band, down_band, energy, up_mats, down_mats = _zoom_tables(cfg, self.nfft)
            nblk = num_samples // _ZOOM_DECIM
            fc = (cfg.f_start + cfg.f_end) / 2.0
            rot = np.exp(-2j * np.pi * fc * np.arange(nblk * _ZOOM_DECIM)
                         / cfg.sample_rate).astype(np.complex64)
            for name, arr in (("up_band", up_band), ("down_band", down_band), ("rot", rot),
                              ("up_mr", up_mats[0]), ("up_mi", up_mats[1]),
                              ("down_mr", down_mats[0]), ("down_mi", down_mats[1])):
                self.register_buffer(name, torch.as_tensor(arr, device=dev))
        else:
            up_t, down_t, energy = _templates(cfg)
            for name, t in (("up_fft", up_t), ("down_fft", down_t)):
                spec = torch.conj(torch.fft.fft(torch.as_tensor(t, device=dev), self.nfft))
                self.register_buffer(name, spec.resolve_conj())
        self.energy = energy

    def forward(self, samples: torch.Tensor) -> ChirpSyncResult:
        shape = samples.shape[:-1]
        if samples.shape[-1] != self.n:
            raise ValueError(f"window of {samples.shape[-1]} samples, built for {self.n}")
        if self.short:
            # Window cannot hold the dual-chirp sequence.
            f = torch.zeros(shape, dtype=torch.float32, device=samples.device)
            return ChirpSyncResult(torch.zeros(shape, dtype=torch.bool, device=samples.device),
                                   torch.full(shape, -1, dtype=torch.int32,
                                              device=samples.device), f, f, f)
        x = samples.reshape(-1, self.n).float()
        res = self._zoom(x) if self.zoom else self._full_rate(x)
        return ChirpSyncResult(*(v.reshape(shape) for v in res))

    def _decide(self, up_pos, up_val, up_cfar, down_pos, down_val) -> ChirpSyncResult:
        cfg = self.cfg
        if not cfg.use_dual_chirp:
            ok = (up_val >= cfg.threshold) | up_cfar
            return ChirpSyncResult(ok, torch.where(ok, up_pos, -1), torch.zeros_like(up_val),
                                   up_val, torch.zeros_like(up_val))
        expected_gap = self.chirp_len + cfg.gap_samples
        gap_error = (down_pos - up_pos - expected_gap).float()
        cfo = _div(gap_error, 2.0 * cfg.cfo_to_samples)
        strong = (up_val >= cfg.threshold) & (down_val >= cfg.threshold)
        cfar = up_cfar & (down_val >= cfg.cfar_down_floor)
        ok = (strong | cfar) & (torch.abs(cfo) <= 100.0)
        start = torch.round(up_pos.float() + cfo * cfg.cfo_to_samples).to(torch.int32)
        return ChirpSyncResult(
            detected=ok,
            start=torch.where(ok, start, -1).to(torch.int32),
            cfo_hz=torch.where(ok, cfo, 0.0),
            up_corr=up_val,
            down_corr=down_val,
        )

    def _cfar(self, up_val, up_med):
        cfg = self.cfg
        return ((up_val >= cfg.cfar_ratio * torch.clamp_min(up_med, 1e-9))
                & (up_val >= cfg.cfar_abs_floor))

    def _down_window(self, up_pos: torch.Tensor, lags: torch.Tensor) -> torch.Tensor:
        """Lags the reference searches for the down-chirp:
        [up + chirp/2, up + chirp + gap + 10000 + chirp]."""
        lo = up_pos + self.chirp_len // 2
        hi = up_pos + self.chirp_len + self.cfg.gap_samples + 10000 + self.chirp_len
        return (lags >= lo[:, None]) & (lags <= hi[:, None])

    # -- full-rate branch ---------------------------------------------------

    def _norm_correlate(self, x: torch.Tensor, tmpl_fft: torch.Tensor) -> torch.Tensor:
        """Normalized correlation magnitude for every lag: [B, n - chirp_len]."""
        X = torch.fft.fft(x.to(torch.complex64), self.nfft)
        corr = torch.fft.ifft(X * tmpl_fft)
        zero = torch.zeros(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)
        csum = torch.cat([zero, wide_cumsum(x * x, dim=-1)], dim=-1)
        num_lags = self.n - self.chirp_len
        win = csum[..., self.chirp_len : self.chirp_len + num_lags] - csum[..., :num_lags]
        # -60 dB energy floor: windows holding only numeric residue of
        # silence must not win the argmax through a vanishing denominator.
        win_floor = 1e-6 * torch.amax(win, dim=-1, keepdim=True)
        denom = torch.sqrt(torch.clamp_min(torch.maximum(win, win_floor) * self.energy, 1e-20))
        return torch.abs(corr[..., :num_lags]) / denom

    def _full_rate(self, x: torch.Tensor) -> ChirpSyncResult:
        up_corr = self._norm_correlate(x, self.up_fft)
        up_pos = torch.argmax(up_corr, dim=-1).to(torch.int32)
        up_val = torch.gather(up_corr, 1, up_pos[:, None].long())[:, 0]
        up_cfar = self._cfar(up_val, _median(up_corr))
        if not self.cfg.use_dual_chirp:
            return self._decide(up_pos, up_val, up_cfar, None, None)
        down_corr = self._norm_correlate(x, self.down_fft)
        lags = torch.arange(down_corr.shape[-1], dtype=torch.int32, device=x.device)
        down_masked = torch.where(self._down_window(up_pos, lags), down_corr, -1.0)
        down_pos = torch.argmax(down_masked, dim=-1).to(torch.int32)
        down_val = torch.gather(down_masked, 1, down_pos[:, None].long())[:, 0]
        return self._decide(up_pos, up_val, up_cfar, down_pos, down_val)

    # -- zoom branch ----------------------------------------------------------

    def _refine_peak(self, x: torch.Tensor, coarse_pos: torch.Tensor,
                     Mr: torch.Tensor, Mi: torch.Tensor):
        """Exact normalized correlation around a coarse peak (batched).

        x: [B, n]; coarse_pos: [B] int32.  Returns (lag [B] int32, corr [B]).
        """
        R = _ZOOM_REFINE
        L = self.chirp_len + 2 * R
        start = torch.clamp(coarse_pos - R, 0, self.n - L)
        y = window_slice(x, start, L)
        cr = y @ Mr
        ci = y @ Mi
        mag2 = cr * cr + ci * ci                       # [B, 2R+1]
        zero = torch.zeros(y.shape[:-1] + (1,), dtype=y.dtype, device=y.device)
        csum = torch.cat([zero, wide_cumsum(y * y, dim=-1)], dim=-1)
        win = csum[..., self.chirp_len : self.chirp_len + 2 * R + 1] - csum[..., : 2 * R + 1]
        win_floor = 1e-6 * torch.amax(win, dim=-1, keepdim=True)
        corr2 = mag2 / torch.clamp_min(torch.maximum(win, win_floor) * self.energy, 1e-20)
        j = torch.argmax(corr2, dim=-1)
        val = torch.sqrt(torch.gather(corr2, 1, j[:, None])[:, 0])
        return (start + j).to(torch.int32), val

    def _zoom(self, x: torch.Tensor) -> ChirpSyncResult:
        D = _ZOOM_DECIM
        B, n = x.shape
        nb = self.nfft // D
        nblk = n // D
        chirp_len = self.chirp_len
        # Decimated complex baseband: mix by the band-center ramp and box-sum
        # groups of D samples; every transform after it is D times smaller.
        zb = (x[:, : nblk * D] * self.rot).reshape(B, nblk, D).sum(-1)
        Z = torch.fft.fft(zb, nb)
        env_up = torch.abs(torch.fft.ifft(Z * self.up_band))     # ~|c(mD)|
        env_down = torch.abs(torch.fft.ifft(Z * self.down_band))

        # Sliding window energy at the stride-D lags (exact for these lags).
        num_lags = n - chirp_len
        xb = x[:, : nblk * D]
        blk = (xb * xb).reshape(B, nblk, D).sum(-1)
        zero = torch.zeros((B, 1), dtype=x.dtype, device=x.device)
        csum = torch.cat([zero, wide_cumsum(blk, dim=-1)], dim=-1)
        idx = torch.arange(nb, dtype=torch.int32, device=x.device) * D
        valid = idx < num_lags
        idx_b = torch.clamp_max(idx // D, max(nblk - chirp_len // D - 1, 0)).long()
        win = csum[:, idx_b + chirp_len // D] - csum[:, idx_b]
        win_floor = 1e-6 * torch.amax(torch.where(valid, win, 0.0), dim=-1, keepdim=True)
        inv = torch.rsqrt(torch.clamp_min(torch.maximum(win, win_floor) * self.energy, 1e-20))

        up_norm = env_up * inv
        up_env = torch.where(valid, up_norm, -1.0)
        up_coarse = torch.argmax(up_env, dim=-1).to(torch.int32) * D
        up_pos, up_val = self._refine_peak(x, up_coarse, self.up_mr, self.up_mi)
        # CFAR floor: median normalized correlation over the valid lags,
        # which are a prefix of the grid (nanmedian in the reference).
        n_valid = int(np.sum(np.arange(nb) * D < num_lags))
        up_cfar = self._cfar(up_val, _median(up_norm[:, :n_valid]))
        if not self.cfg.use_dual_chirp:
            return self._decide(up_pos, up_val, up_cfar, None, None)

        mask = valid & self._down_window(up_pos, idx)
        down_env = torch.where(mask, env_down * inv, -1.0)
        down_coarse = torch.argmax(down_env, dim=-1).to(torch.int32) * D
        down_pos, down_val = self._refine_peak(x, down_coarse, self.down_mr, self.down_mi)
        return self._decide(up_pos, up_val, up_cfar, down_pos, down_val)


@functools.lru_cache(maxsize=64)
def chirp_detector(cfg: ChirpConfig, num_samples: int,
                   device: str | torch.device = "cuda") -> ChirpDetector:
    """Cached :class:`ChirpDetector` for a (config, window, device): the
    reference compiles ``detect_dual_chirp`` once per static configuration."""
    return ChirpDetector(cfg, num_samples, device)


def detect_dual_chirp(samples: torch.Tensor, cfg: ChirpConfig,
                      num_samples: int | None = None) -> ChirpSyncResult:
    """Detect the dual-chirp preamble in a fixed-size window (batched over
    leading axes), on the samples' device.  ``num_samples`` is ignored, as
    in the reference (``ria_tpu/sync/chirp.py:318``): the window is
    ``samples.shape[-1]``."""
    return chirp_detector(cfg, samples.shape[-1], samples.device)(samples)
