"""OTFS (delay-Doppler) waveform for doubly-selective channels, in PyTorch.

Port of ``ria_tpu/wave/otfs.py``.  Numeric contract from the reference
(include/ultra/otfs.hpp, src/otfs/otfs.cpp):
- DD grid M=32 delay x N=16 Doppler, dd[k*N+l]; ISFFT = unscaled IFFT along
  Doppler then FFT along delay -> tf[n*M+m] (otfs.cpp:54-91); SFFT inverts;
- OFDM carrier: M values on FFT bins 1..M (positive freqs only), 512-pt FFT,
  CP 64, continuous 1500 Hz mixer (otfs.cpp:297-331);
- preamble: 4 identical sync symbols (ZC-like root-1 sequence of length M on
  the carriers), RMS-normalized; channel estimated per subcarrier by
  averaging preamble symbols;
- coherent mode: DD pilot 2.0 at (0,0) with 4x4 guard zeros; differential
  mode: DQPSK-style phase chaining across the DD grid raster scan;
- two RX modes: TF-equalized (OTFS_EQ) and raw-DD differential (OTFS_RAW).

The TX is host numpy, copied from the reference.  :class:`OTFSDemodulator`
demodulates a batch of presynced frames at once: the downmix, one batched
512-point symbol FFT, the residual-CFO ramp, the preamble channel estimate,
MMSE equalization (optionally with decision-directed per-symbol gain
tracking), the SFFT and the soft demap (the port's ``ofdm._demap``).
Divisions by constants follow the compiled reference (``_rdiv``).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ria_tpu_torch.utils.device import resolve_device
from ria_tpu_torch.wave.ofdm import _cis, _demap, _rdiv, constellation_table

PREAMBLE_TARGET_RMS = 0.35
BITS_PER_CELL = {"BPSK": 1, "QPSK": 2, "QAM16": 4}


@dataclass(frozen=True)
class OTFSConfig:
    M: int = 32
    N: int = 16
    fft_size: int = 512
    cp_len: int = 64
    sample_rate: float = 48000.0
    center_freq: float = 1500.0
    modulation: str = "QPSK"
    dd_differential: bool = False
    dd_pilot_enable: bool = True
    guard_delay: int = 4
    guard_doppler: int = 4
    tf_equalization: bool = True
    preamble_symbols: int = 4
    # Decision-directed per-symbol tracking: after a first static MMSE pass,
    # the hardened DD grid is re-synthesized to TF and a per-OFDM-symbol
    # complex gain r[n] is estimated against the raw TF samples; the second
    # MMSE pass equalizes with H[m]*r[n].
    phase_tracking: bool = False

    @property
    def symbol_samples(self) -> int:
        return self.fft_size + self.cp_len

    @property
    def preamble_samples(self) -> int:
        return self.preamble_symbols * self.symbol_samples

    @property
    def frame_samples(self) -> int:
        return self.N * self.symbol_samples

    def data_cells(self) -> np.ndarray:
        """Boolean [M, N] mask of usable data cells (pilot/guard excluded)."""
        mask = np.ones((self.M, self.N), bool)
        if not self.dd_differential and self.dd_pilot_enable:
            mask[: self.guard_delay, : self.guard_doppler] = False
        return mask

    def bits_per_frame(self) -> int:
        bps = 2 if self.dd_differential else BITS_PER_CELL[self.modulation]
        return int(self.data_cells().sum()) * bps


def isfft(dd: torch.Tensor) -> torch.Tensor:
    """DD [.., M, N] -> TF [.., N, M]: unscaled IFFT over Doppler, FFT over delay."""
    t = torch.fft.ifft(dd, dim=-1) * dd.shape[-1]  # unscaled inverse
    tf = torch.fft.fft(t, dim=-2)
    return torch.swapaxes(tf, -1, -2)


def sfft(tf: torch.Tensor) -> torch.Tensor:
    """TF [.., N, M] -> DD [.., M, N] (inverse of isfft)."""
    temp = torch.fft.ifft(tf, dim=-1)            # undo FFT over delay (M)
    temp = torch.swapaxes(temp, -1, -2)          # [.., M, N]
    return torch.fft.fft(temp, dim=-1) / temp.shape[-1]  # undo unscaled IDFT over N


@functools.lru_cache(maxsize=None)
def _sync_sequence(cfg: OTFSConfig) -> np.ndarray:
    n = np.arange(cfg.M, dtype=np.float64)
    return np.exp(-1j * np.pi * n * (n + 1) / cfg.M).astype(np.complex64)


def _ofdm_to_time(tf_syms: np.ndarray, cfg: OTFSConfig) -> np.ndarray:
    """[S, M] TF symbols -> complex time stream [S*(fft+cp)]."""
    S = tf_syms.shape[0]
    freq = np.zeros((S, cfg.fft_size), np.complex64)
    freq[:, 1 : 1 + cfg.M] = tf_syms
    td = np.fft.ifft(freq, axis=-1).astype(np.complex64)
    with_cp = np.concatenate([td[:, -cfg.cp_len :], td], axis=-1)
    return with_cp.reshape(-1)


def _mix(stream: np.ndarray, cfg: OTFSConfig, offset: int = 0) -> np.ndarray:
    t = np.arange(len(stream), dtype=np.float64) + offset
    carrier = np.exp(2j * np.pi * cfg.center_freq * t / cfg.sample_rate)
    return np.real(stream * carrier).astype(np.float32)


def map_to_dd(bits: np.ndarray, cfg: OTFSConfig) -> np.ndarray:
    """Bits -> DD grid [M, N] (raster scan over k then l)."""
    mask = cfg.data_cells()
    dd = np.zeros((cfg.M, cfg.N), np.complex64)
    if cfg.dd_differential:
        nbits = min(len(bits), 2 * cfg.M * cfg.N)
        grouped = np.zeros(2 * cfg.M * cfg.N, np.int64)
        grouped[:nbits] = bits[:nbits]
        vals = grouped.reshape(-1, 2)[:, 0] * 2 + grouped.reshape(-1, 2)[:, 1]
        rot = constellation_table("DQPSK")[vals]
        chain = np.cumprod(rot)
        dd = chain.reshape(cfg.M, cfg.N).astype(np.complex64)
        return dd
    table = constellation_table(cfg.modulation)
    bps = BITS_PER_CELL[cfg.modulation]
    cells = np.argwhere(mask)
    padded = np.zeros(len(cells) * bps, np.int64)
    padded[: min(len(bits), len(padded))] = bits[: len(padded)]
    grouped = padded.reshape(len(cells), bps)
    vals = np.zeros(len(cells), np.int64)
    for b in range(bps):
        vals = (vals << 1) | grouped[:, b]
    dd[cells[:, 0], cells[:, 1]] = table[vals]
    if cfg.dd_pilot_enable:
        dd[0, 0] = 2.0
    return dd


def tx_frame(bits: np.ndarray, cfg: OTFSConfig) -> np.ndarray:
    """Preamble (4 sync symbols) + OTFS frame, passband."""
    dd = map_to_dd(np.asarray(bits, np.int64), cfg)
    temp = np.fft.ifft(dd, axis=-1) * dd.shape[-1]
    tf = np.swapaxes(np.fft.fft(temp, axis=-2), -1, -2).astype(np.complex64)  # [N, M]
    # Normalize TF power to the unit-amplitude sync carriers so the preamble
    # channel estimate applies to data symbols at matched scale.
    tf /= np.sqrt(np.mean(np.abs(tf) ** 2)) + 1e-12
    sync = np.tile(_sync_sequence(cfg)[None, :], (cfg.preamble_symbols, 1))
    pre_stream = _ofdm_to_time(sync, cfg)
    data_stream = _ofdm_to_time(tf, cfg)
    full = np.concatenate([pre_stream, data_stream])
    out = _mix(full, cfg)
    pre_rms = np.sqrt(np.mean(out[: cfg.preamble_samples] ** 2) + 1e-20)
    return out * (PREAMBLE_TARGET_RMS / max(pre_rms, 1e-9))


class OTFSDemodResult(NamedTuple):
    soft_bits: torch.Tensor
    dd_symbols: torch.Tensor
    snr_db: torch.Tensor
    noise_var: torch.Tensor


class OTFSDemodulator(nn.Module):
    """Presynced OTFS demodulator: (samples [..., >= (P+N)*sym] starting at
    the first preamble symbol, cfo_hz [...]) -> OTFSDemodResult.

    Buffers: the float32 time ramp of the downmix (``t``), the symbol index
    ramp of the residual-CFO correction (``idx``), the reciprocal of the sync
    sequence (``sync_inv``: the compiled reference divides by a constant as a
    multiply by its reciprocal), the data-cell mask and indices, and the
    constellation (``table``)."""

    def __init__(self, cfg: OTFSConfig, device: str | torch.device = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.need = (cfg.preamble_symbols + cfg.N) * cfg.symbol_samples
        self.register_buffer("t", _rdiv(torch.arange(self.need, dtype=torch.float32,
                                                     device=dev), cfg.sample_rate))
        self.register_buffer("idx", torch.arange(cfg.preamble_symbols + cfg.N,
                                                 dtype=torch.float32, device=dev))
        sync_inv = (np.complex64(1.0) / _sync_sequence(cfg)).astype(np.complex64)
        self.register_buffer("sync_inv", torch.as_tensor(sync_inv, device=dev))
        mask = cfg.data_cells()
        self.nmask = int(mask.sum())
        self.register_buffer("mask", torch.as_tensor(mask, device=dev))
        cells = np.argwhere(mask)
        self.register_buffer("cell_k", torch.as_tensor(cells[:, 0], device=dev))
        self.register_buffer("cell_l", torch.as_tensor(cells[:, 1], device=dev))
        # The constellation of the coherent modes (unused by the differential one).
        self.register_buffer("table", torch.as_tensor(constellation_table(cfg.modulation),
                                                      device=dev))

    def _mean_mod(self, dd: torch.Tensor) -> torch.Tensor:
        """Mean modulus over the data cells, [..., 1, 1]."""
        return _rdiv(torch.sum(torch.abs(dd) * self.mask, dim=(-2, -1), keepdim=True),
                     self.nmask)

    def forward(self, samples: torch.Tensor, cfo_hz: torch.Tensor) -> OTFSDemodResult:
        cfg = self.cfg
        sym = cfg.symbol_samples
        P, N, M = cfg.preamble_symbols, cfg.N, cfg.M
        x = samples[..., : self.need].float()

        # Downmix at fc + cfo: phase = (f32(-2 pi) * f32(fc + cfo)) * t.
        w = (cfg.center_freq + torch.as_tensor(cfo_hz, dtype=torch.float32,
                                               device=x.device)) * float(np.float32(-2.0 * np.pi))
        bb = x.to(torch.complex64) * _cis(w[..., None] * self.t)

        syms = bb.reshape(bb.shape[:-1] + (P + N, sym))
        core = syms[..., cfg.cp_len :]
        freq = torch.fft.fft(core, dim=-1)[..., 1 : 1 + M]   # [.., P+N, M]

        # Residual CFO from the repeated preamble symbols: adjacent identical
        # symbols differ by e^{j 2 pi df T_sym}; undo the ramp over the frame.
        pre = freq[..., :P, :]
        corr = torch.sum(pre[..., 1:, :] * torch.conj(pre[..., :-1, :]), dim=(-1, -2))
        dphi = torch.angle(corr)  # radians per symbol
        freq = freq * _cis(-dphi[..., None, None] * self.idx[:, None])

        H = torch.mean(freq[..., :P, :] * self.sync_inv, dim=-2)      # [.., M]
        d = freq[..., 1, :] - freq[..., 0, :]
        noise_var = torch.mean(torch.square(torch.abs(d)), dim=-1) / 2.0
        noise_var = torch.clamp_min(noise_var, 1e-9)

        tf_raw = freq[..., P:, :]  # [.., N, M]
        tf = tf_raw
        if cfg.tf_equalization:
            h2 = torch.square(torch.abs(H))[..., None, :]
            tf = tf_raw * torch.conj(H)[..., None, :] / torch.clamp_min(
                h2 + noise_var[..., None, None], 1e-12)

        if cfg.phase_tracking and cfg.tf_equalization and not cfg.dd_differential:
            # Decision-directed per-symbol complex gain: harden the first-pass
            # DD grid (data cells -> nearest constellation point, pilot and
            # guards kept), re-synthesize TF, and fit one complex gain per
            # OFDM symbol against the raw TF samples.
            dd1 = sfft(tf)
            mean_mod1 = self._mean_mod(dd1)
            dd1n = dd1 / torch.clamp_min(mean_mod1, 1e-9)
            near = torch.argmin(torch.square(torch.abs(dd1n[..., None] - self.table)), dim=-1)
            hard = self.table[near]
            dd_hard = torch.where(self.mask, hard * mean_mod1, dd1)
            x_hat = isfft(dd_hard)                                # [.., N, M]
            ref = H[..., None, :] * x_hat
            num = torch.sum(tf_raw * torch.conj(ref), dim=-1)     # [.., N]
            den = torch.sum(torch.square(torch.abs(ref)), dim=-1)
            r = num / torch.clamp_min(den, 1e-12)                 # per-symbol gain
            # Decision-failure symbols fall back to unit gain.
            r = torch.where(torch.abs(r) < 0.1, torch.ones_like(r), r)
            H_tv = H[..., None, :] * r[..., :, None]
            h2 = torch.square(torch.abs(H_tv))
            tf = tf_raw * torch.conj(H_tv) / torch.clamp_min(
                h2 + noise_var[..., None, None], 1e-12)

        dd = sfft(tf)  # [.., M, N]

        # Blind amplitude renormalization (TX normalized TF power).
        dd = dd * (1.0 / torch.clamp_min(self._mean_mod(dd), 1e-9))

        # Self-calibrated effective noise: mean squared distance to the
        # nearest constellation point over the data cells.
        if not cfg.dd_differential:
            err = torch.amin(torch.square(torch.abs(dd[..., None] - self.table)), dim=-1)
            nv_eff = _rdiv(torch.sum(err * self.mask, dim=(-2, -1)), self.nmask)
            noise_var = torch.clamp_min(nv_eff, 1e-4)

        nv = torch.clamp_min(noise_var[..., None, None], 1e-9)
        if cfg.dd_differential:
            flat = dd.reshape(dd.shape[:-2] + (M * N,))
            prev = torch.cat([torch.ones_like(flat[..., :1]), flat[..., :-1]], dim=-1)
            diff = flat * torch.conj(prev)
            phase = torch.angle(diff)
            # Phase-noise-calibrated LLR scale against the nearest DQPSK
            # rotation.
            ideal = torch.round(_rdiv(phase - np.pi / 4, np.pi / 2)) * (np.pi / 2) + np.pi / 4
            err = phase - ideal
            err = torch.where(err > np.pi, err - 2 * np.pi, err)
            err = torch.where(err < -np.pi, err + 2 * np.pi, err)
            pvar = torch.clamp_min(torch.mean(torch.square(err), dim=-1, keepdim=True), 0.01)
            scale = torch.clamp_max(2.0 * torch.sqrt(1.0 / pvar), 20.0)
            l0 = scale * torch.sin(phase + np.pi / 4)
            l1 = scale * (torch.abs(diff.real) - torch.abs(diff.imag)) \
                / torch.clamp_min(torch.abs(diff), 1e-9)
            soft = torch.stack([l0, l1], dim=-1).reshape(flat.shape[:-1] + (2 * M * N,))
            soft = torch.clamp(soft, -20.0, 20.0)
        else:
            vals = dd[..., self.cell_k, self.cell_l]
            nvv = nv[..., 0, :].expand(vals.shape)
            llr = _demap(cfg.modulation, vals, torch.ones_like(vals), nvv)
            soft = llr.reshape(llr.shape[:-2] + (llr.shape[-2] * llr.shape[-1],))

        h_pow = torch.mean(torch.square(torch.abs(H)), dim=-1)
        snr_db = 10.0 * torch.log10(torch.clamp_min(h_pow / noise_var, 1e-6))
        return OTFSDemodResult(soft_bits=soft, dd_symbols=dd, snr_db=snr_db,
                               noise_var=noise_var)


@functools.lru_cache(maxsize=64)
def otfs_demodulator(cfg: OTFSConfig, device: str | torch.device = "cuda") -> OTFSDemodulator:
    """Cached :class:`OTFSDemodulator` for a (config, device)."""
    return OTFSDemodulator(cfg, device)


def demodulate_presynced(samples: torch.Tensor, cfo_hz: torch.Tensor,
                         cfg: OTFSConfig) -> OTFSDemodResult:
    """Demod preamble+frame starting at the first preamble symbol, on the
    samples' device."""
    return otfs_demodulator(cfg, samples.device)(samples, cfo_hz)
