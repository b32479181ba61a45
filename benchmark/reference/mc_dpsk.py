"""Frozen copy of ``ria_tpu_torch/wave/mc_dpsk.py``, held by the benchmark as its plain
reference and the tables of its MC-DPSK TX; it imports nothing of the port.
Trimmed to what the chain and the TX call.

Multi-Carrier DPSK waveform (the low-SNR workhorse) in PyTorch.

Port of ``ria_tpu/wave/mc_dpsk.py``.  Numeric contract from the reference
(src/psk/multi_carrier_dpsk.hpp):
- N carriers evenly spaced freq_low..freq_high (default 10 @ 500-2500 Hz),
  512 samples/symbol (93.75 baud), DBPSK or DQPSK differential per carrier,
  carrier phase restarts at 0 every symbol (:156-159, :256-259);
- preamble = dual chirp + 8 training symbols (pattern e^{j c*s*pi/2}) +
  1 all-ones reference symbol (:127-196);
- 2x/4x time spreading: repeat symbols at TX, coherently combine at RX
  BEFORE differential decode (:548-573) for +3/+6 dB;
- LLR scale = min(2*sqrt(1/max(phase_noise_var, 0.01)), 20), soft bits
  clamped +/-20 (:634-642, :698-707);
- DBPSK per-carrier reliability weights: magnitude ratio x temporal
  stability x weak-carrier damping, clamped [0.12, 1.25] (:644-688);
- trailing-silence exclusion: reference energy = mean of first 4 symbols,
  symbols below 20% excluded from reliability stats (:604-632).

The preamble is host numpy (copied verbatim); demodulation is one complex
matmul of every symbol against a static [samples_per_symbol, carriers] mixer
bank, held as a buffer of :class:`MCDPSKDemodulator`.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from .chirp import ChirpConfig, generate as chirp_generate
from .device import resolve_device


@dataclass(frozen=True)
class MCDPSKConfig:
    sample_rate: float = 48000.0
    num_carriers: int = 10
    freq_low: float = 500.0
    freq_high: float = 2500.0
    samples_per_symbol: int = 512
    bits_per_symbol: int = 1  # 1 = DBPSK, 2 = DQPSK
    spreading: int = 1        # 1, 2 or 4 (TIME_2X / TIME_4X)
    training_symbols: int = 8
    chirp: ChirpConfig = field(default_factory=ChirpConfig)

    @property
    def carrier_freqs(self) -> tuple[float, ...]:
        if self.num_carriers == 1:
            return ((self.freq_low + self.freq_high) / 2.0,)
        spacing = (self.freq_high - self.freq_low) / (self.num_carriers - 1)
        return tuple(self.freq_low + i * spacing for i in range(self.num_carriers))

    @property
    def bits_per_mc_symbol(self) -> int:
        return self.num_carriers * self.bits_per_symbol

    @property
    def preamble_samples(self) -> int:
        return self.chirp.total_samples + (self.training_symbols + 1) * self.samples_per_symbol

    def num_data_symbols(self, num_bits: int) -> int:
        """Unique data symbols (pre-spreading) to carry num_bits."""
        return -(-num_bits // self.bits_per_mc_symbol)

    def num_rx_symbols(self, num_bits: int) -> int:
        return self.num_data_symbols(num_bits) * self.spreading

    def frame_samples(self, num_bits: int) -> int:
        """Samples from chirp start to end of data for a frame of num_bits."""
        return self.preamble_samples + self.num_rx_symbols(num_bits) * self.samples_per_symbol


@functools.lru_cache(maxsize=None)
def _synth_matrix(cfg: MCDPSKConfig) -> np.ndarray:
    """[sps, C] complex: e^{+j 2 pi f_c t}, t restarting at 0 each symbol."""
    t = np.arange(cfg.samples_per_symbol, dtype=np.float64)[:, None]
    f = np.asarray(cfg.carrier_freqs, dtype=np.float64)[None, :]
    return np.exp(2j * np.pi * f * t / cfg.sample_rate).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _training_matrix(cfg: MCDPSKConfig) -> np.ndarray:
    """[T, C] training constellation e^{j c*s*pi/2}."""
    s = np.arange(cfg.training_symbols)[:, None]
    c = np.arange(cfg.num_carriers)[None, :]
    return np.exp(1j * (c * s) * np.pi / 2.0).astype(np.complex64)


def _synthesize(symbols: np.ndarray, cfg: MCDPSKConfig) -> np.ndarray:
    """[S, C] complex constellation -> [S*sps] real samples (host TX path)."""
    E = _synth_matrix(cfg)
    out = np.real(symbols @ E.T.astype(np.complex64)) / cfg.num_carriers
    return out.reshape(-1).astype(np.float32)


DQPSK_PHASES = np.array([np.pi / 4, 3 * np.pi / 4, -3 * np.pi / 4, -np.pi / 4])
# Index by 2-bit symbol value; note the reference's table maps
# 10 -> -3pi/4 (index 2) and 11 -> -pi/4 (index 3)
# (src/psk/multi_carrier_dpsk.hpp:236-239).


def preamble(cfg: MCDPSKConfig, tx_cfo_hz: float = 0.0) -> np.ndarray:
    """Chirp + training + reference symbol (host TX path)."""
    chirp = chirp_generate(cfg.chirp, tx_cfo_hz)
    train = _synthesize(_training_matrix(cfg), cfg)
    ref = _synthesize(np.ones((1, cfg.num_carriers), dtype=np.complex64), cfg)
    return np.concatenate([chirp, train, ref]).astype(np.float32)


class MCDPSKDemodResult(NamedTuple):
    soft_bits: torch.Tensor        # [..., num_data_symbols * C * bps], clamped +/-20
    phase_noise_var: torch.Tensor  # [...]
    freq_fading_index: torch.Tensor
    temporal_fading_index: torch.Tensor
    snr_estimate_db: torch.Tensor  # from phase-noise variance
    zsym: torch.Tensor             # [..., T+1+R, C] raw carrier integrals


class MCDPSKDemodulator(nn.Module):
    """Mixer-bank demodulator: (frame_samples [..., >= (T+1+R)*sps],
    cfo_hz [...]) -> MCDPSKDemodResult, for frames of ``num_data_symbols``.

    Buffer ``mixer``: the [sps, C] mixer bank conj(e^{j 2 pi f_c t}) / sps.
    """

    def __init__(self, cfg: MCDPSKConfig, num_data_symbols: int,
                 device: str | torch.device = "cuda"):
        super().__init__()
        self.cfg = cfg
        self.num_data_symbols = num_data_symbols
        self.register_buffer("mixer", torch.as_tensor(
            np.conj(_synth_matrix(cfg)) / cfg.samples_per_symbol, device=resolve_device(device)))

    def forward(self, frame_samples: torch.Tensor, cfo_hz: torch.Tensor) -> MCDPSKDemodResult:
        cfg = self.cfg
        sps = cfg.samples_per_symbol
        S_all = cfg.training_symbols + 1 + self.num_data_symbols * cfg.spreading
        x = frame_samples[..., : S_all * sps]
        dev = x.device

        # CFO correction fused into the mix: rotating the REAL signal by
        # e^{-j 2 pi cfo t} shifts its positive-frequency band onto the mixer
        # grid; the negative-frequency image is rejected by the 512-sample
        # integration.  Factored ramp: t = s*sps + i, so exp(-jwt) =
        # rot_sym[s] * rot_in[i] (sps + S evaluations, small arguments).
        w = (2.0 * np.pi / cfg.sample_rate) * torch.as_tensor(cfo_hz, dtype=torch.float32,
                                                              device=dev)
        i_idx = torch.arange(sps, dtype=torch.float32, device=dev)
        s_idx = torch.arange(S_all, dtype=torch.float32, device=dev) * float(sps)
        rot_in = torch.polar(torch.ones((), device=dev), -(w[..., None] * i_idx))   # [..., sps]
        rot_sym = torch.polar(torch.ones((), device=dev), -(w[..., None] * s_idx))  # [..., S]

        # Mix-and-integrate every symbol x carrier at once: [S, sps] @ [sps, C].
        syms = x.reshape(x.shape[:-1] + (S_all, sps)).to(torch.complex64)
        zsym = (syms * rot_in[..., None, :]) @ self.mixer * rot_sym[..., :, None]
        return soft_from_zsym(zsym, cfg, self.num_data_symbols)


def _normalize(v: torch.Tensor) -> torch.Tensor:
    m = torch.abs(v)
    return torch.where(m > 1e-4, v / torch.clamp_min(m, 1e-9),
                       torch.ones((), dtype=v.dtype, device=v.device))


def soft_from_zsym(zsym: torch.Tensor, cfg: MCDPSKConfig,
                   num_data_symbols: int) -> MCDPSKDemodResult:
    """Differential decode + LLR stage on mix-integrated symbols.

    zsym: [..., T+1+R, C] complex carrier integrals (training, reference,
    data).
    """
    T = cfg.training_symbols
    C = cfg.num_carriers
    dev = zsym.device

    z_ref = zsym[..., T, :]
    z_data = zsym[..., T + 1 :, :]

    # Coherent spreading combine BEFORE differential decode (:548-573).
    z_comb = z_data.reshape(z_data.shape[:-2] + (num_data_symbols, cfg.spreading, C)).mean(-2)
    mag = torch.abs(z_comb)

    prev0 = _normalize(z_ref)
    znorm = _normalize(z_comb)
    prev = torch.cat([prev0[..., None, :], znorm[..., :-1, :]], dim=-2)
    diff = znorm * torch.conj(prev)
    phase = torch.angle(diff)  # [..., D, C]

    # Phase-noise variance vs nearest ideal constellation point (:581-600).
    if cfg.bits_per_symbol == 2:
        shifted = phase - np.pi / 4.0
        ideal = torch.round(shifted / (np.pi / 2.0)) * (np.pi / 2.0) + np.pi / 4.0
    else:
        ideal = torch.round(phase / np.pi) * np.pi
    err = phase - ideal
    err = torch.where(err > np.pi, err - 2 * np.pi, err)
    err = torch.where(err < -np.pi, err + 2 * np.pi, err)
    phase_noise_var = torch.clamp_min(torch.mean(torch.square(err), dim=(-1, -2)), 0.01)
    scale = torch.clamp_max(2.0 * torch.sqrt(1.0 / phase_noise_var), 20.0)

    # Trailing-silence exclusion (:604-632): valid symbol count from the last
    # symbol whose total magnitude is >= 20% of the first-4-symbol mean.
    sym_total = torch.sum(mag, dim=-1)  # [..., D]
    D = num_data_symbols
    if D >= 4:
        ref_mag = torch.mean(sym_total[..., :4], dim=-1, keepdim=True)
        thr = ref_mag * 0.2
        idx = torch.arange(D, device=dev)
        above = torch.where(sym_total >= thr, idx, -1)
        last_valid = torch.amax(above, dim=-1)
        valid_symbols = torch.clamp_min(last_valid + 1, 4)
        valid_symbols = torch.where(ref_mag[..., 0] > 1e-3, valid_symbols, D)
    else:
        valid_symbols = torch.full(sym_total.shape[:-1], D, device=dev)
    vmask = (torch.arange(D, device=dev) < valid_symbols[..., None]).float()  # [..., D]

    nvalid = torch.clamp_min(torch.sum(vmask, dim=-1, keepdim=True), 1.0)  # [..., 1]
    mag_v = mag * vmask[..., None]
    carrier_mean = torch.sum(mag_v, dim=-2) / nvalid                   # [..., C]
    carrier_mean_sq = torch.sum(torch.square(mag_v), dim=-2) / nvalid  # [..., C]

    # DBPSK per-carrier reliability weights (:644-688).
    if cfg.bits_per_symbol == 1:
        gmask = (carrier_mean > 1e-4).float()
        gcount = torch.clamp_min(torch.sum(gmask, dim=-1, keepdim=True), 1.0)
        global_mean = torch.sum(carrier_mean * gmask, dim=-1, keepdim=True) / gcount
        var = torch.clamp_min(carrier_mean_sq - torch.square(carrier_mean), 0.0)
        cv = torch.sqrt(var) / (carrier_mean + 1e-6)
        mag_ratio = carrier_mean / torch.clamp_min(global_mean, 1e-9)
        mag_weight = torch.clamp(mag_ratio, 0.10, 1.25)
        stability = 1.0 / (1.0 + 1.5 * cv)
        weak_damp = torch.where(mag_ratio < 0.20, 0.25, torch.where(mag_ratio < 0.35, 0.50, 1.0))
        w = torch.clamp(mag_weight * stability * weak_damp, 0.12, 1.25)
        dead = (carrier_mean <= 1e-4) | (global_mean <= 1e-4)
        reliability = torch.where(dead, 0.12, w)
    else:
        reliability = torch.ones_like(carrier_mean)

    carrier_scale = scale[..., None, None] * reliability[..., None, :]  # [...,1,C]
    if cfg.bits_per_symbol == 2:
        sb0 = carrier_scale * torch.sin(phase)
        sb1 = carrier_scale * torch.sin(2.0 * phase)
        soft = torch.stack([sb0, sb1], dim=-1)  # [..., D, C, 2]
    else:
        soft = (carrier_scale * torch.cos(phase))[..., None]  # [..., D, C, 1]
    soft = torch.clamp(soft, -20.0, 20.0)
    soft = soft.reshape(soft.shape[:-3] + (D * C * cfg.bits_per_symbol,))

    # Fading indices (:407-445, :716-733).
    cmean = carrier_mean
    mean_all = torch.mean(cmean, dim=-1)
    std_all = torch.std(cmean, dim=-1, correction=0)
    freq_cv = torch.where(mean_all > 1e-3, std_all / torch.clamp_min(mean_all, 1e-9), 0.0)
    var_t = torch.clamp_min(carrier_mean_sq - torch.square(cmean), 0.0)
    cv_t = torch.sqrt(var_t) / torch.clamp_min(cmean, 1e-9)
    alive = (cmean >= 1e-3).float()
    acount = torch.clamp_min(torch.sum(alive, dim=-1), 1.0)
    temporal = torch.where(
        nvalid[..., 0] >= 4, torch.sum(cv_t * alive, dim=-1) / acount, 0.0)

    # SNR from phase-noise variance: var ~= 1/SNR for small noise.
    snr_db = 10.0 * torch.log10(1.0 / phase_noise_var)

    return MCDPSKDemodResult(
        soft_bits=soft,
        phase_noise_var=phase_noise_var,
        freq_fading_index=freq_cv,
        temporal_fading_index=temporal,
        snr_estimate_db=snr_db,
        zsym=zsym,
    )
