"""Adaptive MFSK waveform for very low SNR (-17..+3 dB) in PyTorch.

Port of ``ria_tpu/wave/mfsk.py``.  Numeric contract from the reference
(src/fsk/mfsk.hpp):
- 2/4/8/16/32 tones at 50 Hz spacing centered on 1500 Hz, 1536 samples/symbol
  (31.25 baud), symbol repetition (default 2), continuous TX phase;
- tone_freq(i) = center + (i - (T-1)/2) * spacing;
- bits map MSB-first to the tone index; preamble = `cycles` sweeps through
  all tones in order;
- demod: per-tone power, repetition combining, max-log soft bits.

The TX is host numpy, copied from the reference.  Per-tone power for every
symbol is one |[S, sps] @ [sps, T]|^2 matmul (real and imaginary parts of
the tone bank as one [sps, 2T] float32 matrix; TF32 off on the card).
:class:`MFSKPreambleDetector` scores the known sweep at sps/4-strided offsets
(four framings, the sweep slid along the symbol axis as one gather) and
:class:`MFSKDemodulator` gives the soft bits.  As in the reference,
:func:`find_preamble` reports a batched (not 1-D) input as not detected.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ria_tpu_torch.dsp.util import _sliding
from ria_tpu_torch.utils.device import full_fp32_matmul, resolve_device

# Preamble offsets step by sps / SYNC_PHASES.
SYNC_PHASES = 4


@dataclass(frozen=True)
class MFSKConfig:
    sample_rate: float = 48000.0
    center_freq: float = 1500.0
    tone_spacing: float = 50.0
    num_tones: int = 8
    samples_per_symbol: int = 1536
    repetition: int = 2
    preamble_cycles: int = 2

    @property
    def bits_per_symbol(self) -> int:
        return int(np.log2(self.num_tones))

    def tone_freq(self, idx: int) -> float:
        return self.center_freq + (idx - (self.num_tones - 1) / 2.0) * self.tone_spacing

    @property
    def preamble_samples(self) -> int:
        return self.preamble_cycles * self.num_tones * self.samples_per_symbol

    def num_symbols_for_bits(self, num_bits: int) -> int:
        return -(-num_bits // self.bits_per_symbol)

    def frame_samples(self, num_bits: int) -> int:
        return (self.preamble_samples +
                self.num_symbols_for_bits(num_bits) * self.repetition * self.samples_per_symbol)


def bfsk_config(repetition: int = 4, preamble_cycles: int = 8) -> MFSKConfig:
    """Binary FSK preset (reference src/fsk/fsk.hpp:14-32): mark/space at
    1525/1475 Hz (center 1500 Hz, 50 Hz separation), 1536 samples/symbol =
    31.25 baud, 4x bit repetition; the sweep preamble degenerates to the
    reference's alternating-tone preamble (8 cycles x 2 tones)."""
    return MFSKConfig(num_tones=2, repetition=repetition,
                      preamble_cycles=preamble_cycles)


@functools.lru_cache(maxsize=None)
def _tone_bank(cfg: MFSKConfig) -> np.ndarray:
    """[sps, T] complex mixers for per-tone correlation."""
    t = np.arange(cfg.samples_per_symbol, dtype=np.float64)[:, None]
    f = np.array([cfg.tone_freq(i) for i in range(cfg.num_tones)])[None, :]
    return np.exp(-2j * np.pi * f * t / cfg.sample_rate).astype(np.complex64)


def modulate(bits: np.ndarray, cfg: MFSKConfig) -> np.ndarray:
    """Data bits -> samples with repetition (continuous phase, host TX)."""
    bits = np.asarray(bits, np.int64)
    bps = cfg.bits_per_symbol
    S = -(-len(bits) // bps)
    padded = np.zeros(S * bps, np.int64)
    padded[: len(bits)] = bits
    grouped = padded.reshape(S, bps)
    tone = np.zeros(S, np.int64)
    for b in range(bps):
        tone = (tone << 1) | grouped[:, b]
    tone = np.repeat(tone, cfg.repetition)
    freqs = np.array([cfg.tone_freq(i) for i in range(cfg.num_tones)])[tone]
    inc = 2.0 * np.pi * np.repeat(freqs, cfg.samples_per_symbol) / cfg.sample_rate
    phase = np.cumsum(inc)
    return np.sin(phase).astype(np.float32)


def generate_preamble(cfg: MFSKConfig) -> np.ndarray:
    """Tone sweep: cycles x all tones in order, continuous phase."""
    sweep = np.tile(np.arange(cfg.num_tones), cfg.preamble_cycles)
    freqs = np.array([cfg.tone_freq(i) for i in range(cfg.num_tones)])[sweep]
    inc = 2.0 * np.pi * np.repeat(freqs, cfg.samples_per_symbol) / cfg.sample_rate
    phase = np.cumsum(inc)
    return np.sin(phase).astype(np.float32)


def tx_frame(bits: np.ndarray, cfg: MFSKConfig) -> np.ndarray:
    return np.concatenate([generate_preamble(cfg), modulate(bits, cfg)])


class MFSKSyncResult(NamedTuple):
    detected: torch.Tensor
    data_start: torch.Tensor  # first sample after the preamble
    score: torch.Tensor


def _bank(cfg: MFSKConfig, device: torch.device) -> torch.Tensor:
    """[sps, 2T]: the tone bank's real parts, then its imaginary parts."""
    bank = _tone_bank(cfg)
    return torch.as_tensor(np.ascontiguousarray(np.concatenate([bank.real, bank.imag], axis=1)),
                           device=device)


def _tone_powers(frames: torch.Tensor, bank: torch.Tensor) -> torch.Tensor:
    """[..., S, sps] -> [..., S, T] tone powers |frames @ bank|^2."""
    z = frames @ bank
    T = bank.shape[-1] // 2
    return torch.square(torch.abs(torch.complex(z[..., :T], z[..., T:])))


class MFSKPreambleDetector(nn.Module):
    """Sweep-preamble search over windows of ``num_samples``:
    samples [..., num_samples] -> MFSKSyncResult (per leading index).

    Per framing phase: tone powers of every symbol, the sweep's share of the
    total power over each run of P symbols (cumsum difference) and the share
    of those symbols whose strongest tone is the sweep's.  The four phases'
    scores are concatenated phase by phase and one argmax picks the start.
    Buffers: the tone bank (``bank``) and the sweep gather indices."""

    def __init__(self, cfg: MFSKConfig, num_samples: int, device: str | torch.device = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        full_fp32_matmul()
        self.cfg = cfg
        self.n = n = num_samples
        sps = cfg.samples_per_symbol
        self.P = P = cfg.preamble_cycles * cfg.num_tones
        self.step = sps // SYNC_PHASES
        self.short = n < cfg.preamble_samples + self.step
        if self.short:
            return
        self.Sp = Sp = n // sps - 1             # symbols per phase
        self.Kp = Sp - P + 1                     # sweep alignments per phase
        self.register_buffer("bank", _bank(cfg, dev))
        sweep = np.tile(np.arange(cfg.num_tones), cfg.preamble_cycles)
        self.register_buffer("sweep", torch.as_tensor(sweep, device=dev))
        # powers[k + i, sweep[i]] for alignment k and sweep symbol i.
        rows = np.arange(self.Kp)[:, None] + np.arange(P)[None, :]
        self.register_buffer("rows", torch.as_tensor(rows, device=dev))
        starts = (np.arange(SYNC_PHASES)[:, None] * self.step + np.arange(self.Kp)[None, :] * sps
                  + cfg.preamble_samples)
        self.register_buffer("starts", torch.as_tensor(starts.reshape(-1), device=dev))

    def forward(self, samples: torch.Tensor) -> MFSKSyncResult:
        shape = samples.shape[:-1]
        if samples.shape[-1] != self.n:
            raise ValueError(f"window of {samples.shape[-1]} samples, built for {self.n}")
        dev = samples.device
        if self.short:
            return MFSKSyncResult(torch.zeros(shape, dtype=torch.bool, device=dev),
                                  torch.full(shape, -1, dtype=torch.int32, device=dev),
                                  torch.zeros(shape, dtype=torch.float32, device=dev))
        res = self._search(samples.reshape(-1, self.n).float())
        return MFSKSyncResult(*(v.reshape(shape) for v in res))

    def _search(self, x: torch.Tensor) -> MFSKSyncResult:
        sps, P, Sp, Kp, step = self.cfg.samples_per_symbol, self.P, self.Sp, self.Kp, self.step
        B = x.shape[0]
        # All four framings at once: [B, phases, Sp, sps].
        frames = torch.stack([x[:, p * step : p * step + Sp * sps]
                              for p in range(SYNC_PHASES)], dim=1).reshape(B, SYNC_PHASES, Sp, sps)
        powers = _tone_powers(frames, self.bank)                  # [B, 4, Sp, T]
        den = _sliding(torch.sum(powers, dim=-1), P)               # [B, 4, Kp]
        hard = torch.argmax(powers, dim=-1)                        # [B, 4, Sp]
        swept = powers[..., self.rows, self.sweep]                 # [B, 4, Kp, P]
        num = torch.sum(swept, dim=-1)
        match = torch.sum((hard[..., self.rows] == self.sweep).float(), dim=-1) / P
        scores = (num / (den + 1e-9)).reshape(B, SYNC_PHASES * Kp)
        matches = match.reshape(B, SYNC_PHASES * Kp)
        best = torch.argmax(scores, dim=-1)
        val = torch.gather(scores, 1, best[:, None])[:, 0]
        mval = torch.gather(matches, 1, best[:, None])[:, 0]
        # Hard-decision sweep match: energy dominance alone false-fires on
        # other sweeping signals (an up-chirp, an MC-DPSK preamble).
        detected = (val > 0.5) & (mval > 0.7)
        start = self.starts[best].to(torch.int32)
        return MFSKSyncResult(detected, torch.where(detected, start, -1).to(torch.int32), val)


@functools.lru_cache(maxsize=64)
def mfsk_preamble_detector(cfg: MFSKConfig, num_samples: int,
                           device: str | torch.device = "cuda") -> MFSKPreambleDetector:
    """Cached :class:`MFSKPreambleDetector` for a (config, window, device)."""
    return MFSKPreambleDetector(cfg, num_samples, device)


def find_preamble(samples: torch.Tensor, cfg: MFSKConfig) -> MFSKSyncResult:
    """Score the known tone sweep at sps/4-strided offsets of a 1-D window,
    on the samples' device.  A batched input is reported as not detected,
    as in the reference."""
    if samples.ndim != 1:
        shape = samples.shape[:-1]
        dev = samples.device
        return MFSKSyncResult(torch.zeros(shape, dtype=torch.bool, device=dev),
                              torch.full(shape, -1, dtype=torch.int32, device=dev),
                              torch.zeros(shape, dtype=torch.float32, device=dev))
    return mfsk_preamble_detector(cfg, samples.shape[-1], samples.device)(samples)


class MFSKDemodResult(NamedTuple):
    soft_bits: torch.Tensor
    tone_powers: torch.Tensor
    snr_estimate_db: torch.Tensor


class MFSKDemodulator(nn.Module):
    """Demodulator of ``num_bits`` starting at the first data symbol:
    data_samples [..., >= S*R*sps] -> MFSKDemodResult.  Tone powers summed
    over the repetitions, max-log LLRs normalized by the mean of the
    non-max tones.  Buffers: the tone bank and the bit masks."""

    def __init__(self, cfg: MFSKConfig, num_bits: int, device: str | torch.device = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        full_fp32_matmul()
        self.cfg = cfg
        self.num_bits = num_bits
        self.S = cfg.num_symbols_for_bits(num_bits)
        self.register_buffer("bank", _bank(cfg, dev))
        bps = cfg.bits_per_symbol
        tones = np.arange(cfg.num_tones)
        self.register_buffer("bit_masks", torch.as_tensor(
            np.stack([((tones >> (bps - 1 - b)) & 1).astype(bool) for b in range(bps)]),
            device=dev))

    def forward(self, data_samples: torch.Tensor) -> MFSKDemodResult:
        cfg = self.cfg
        S, R, T = self.S, cfg.repetition, cfg.num_tones
        bps = cfg.bits_per_symbol
        x = data_samples[..., : S * R * cfg.samples_per_symbol].float()
        frames = x.reshape(x.shape[:-1] + (S * R, cfg.samples_per_symbol))
        powers = _tone_powers(frames, self.bank)
        powers = powers.reshape(powers.shape[:-2] + (S, R, T)).sum(-2)

        sorted_p = torch.sort(powers, dim=-1).values
        noise = torch.mean(sorted_p[..., :-1], dim=-1, keepdim=True) + 1e-9
        metric = powers / noise
        llrs = []
        for mask in self.bit_masks:
            m1 = torch.amax(torch.where(mask, metric, -torch.inf), dim=-1)
            m0 = torch.amax(torch.where(~mask, metric, -torch.inf), dim=-1)
            llrs.append(torch.clamp(m0 - m1, -20.0, 20.0))  # positive => bit 0
        soft = torch.stack(llrs, dim=-1)
        soft = soft.reshape(soft.shape[:-2] + (S * bps,))[..., : self.num_bits]

        peak = sorted_p[..., -1]
        snr = 10.0 * torch.log10(torch.clamp_min(peak / (noise[..., 0] * T), 1e-3))
        return MFSKDemodResult(soft, powers, torch.mean(snr, dim=-1))


@functools.lru_cache(maxsize=64)
def mfsk_demodulator(cfg: MFSKConfig, num_bits: int,
                     device: str | torch.device = "cuda") -> MFSKDemodulator:
    """Cached :class:`MFSKDemodulator` for a (config, bit count, device)."""
    return MFSKDemodulator(cfg, num_bits, device)


def demodulate(data_samples: torch.Tensor, cfg: MFSKConfig, num_bits: int) -> MFSKDemodResult:
    """Demod ``num_bits`` of data starting at the first data symbol, on the
    samples' device."""
    return mfsk_demodulator(cfg, num_bits, data_samples.device)(data_samples)
