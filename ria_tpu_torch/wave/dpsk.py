"""Single-carrier DPSK (the very-low-SNR / raw-PING waveform) in PyTorch.

Port of ``ria_tpu/wave/dpsk.py``.  Numeric contract from the reference
(src/psk/dpsk.hpp):
- single carrier at 1500 Hz, 1536 samples/symbol default (31.25 baud),
  DBPSK/DQPSK/D8PSK with phase increments: DBPSK 0/180, DQPSK
  (2v+1)*45 deg Gray offsets, D8PSK v*45+22.5 deg (:77-100);
- Barker-13 x3 BPSK preamble for sync (:108-140).

The TX is host numpy, copied from the reference.  The RX stages are modules:
:class:`BarkerDetector` (``find_preamble``) and :class:`DPSKDemodulator`
(``demodulate``).  A symbol phasor is a [S, sps] @ [sps, 2] matmul of the
frames against the mixer's real and imaginary parts (TF32 off on the card).
The reference scores every coarse offset (a step of sps/8) with its own
framing; here the window is framed once at each of the 8 sub-symbol phases,
so each offset's symbols are a slice of one phase's phasors: the same dot
products, without a [B, offsets, P * sps] gather.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ria_tpu_torch.dsp.util import _rdiv
from ria_tpu_torch.utils.device import full_fp32_matmul, resolve_device

BARKER13 = np.array([1, 1, 1, 1, 1, -1, -1, 1, 1, -1, 1, -1, 1])
BARKER_REPEATS = 3
TRAINING_SYMBOLS = 8
# Coarse offsets step by sps / COARSE_PHASES; the fine pass steps by
# FINE_STEP samples over one symbol either side of the coarse peak.
COARSE_PHASES = 8
FINE_STEP = 16


@dataclass(frozen=True)
class DPSKConfig:
    sample_rate: float = 48000.0
    carrier_freq: float = 1500.0
    samples_per_symbol: int = 1536
    bits_per_symbol: int = 2  # 1 DBPSK, 2 DQPSK, 3 D8PSK

    @property
    def preamble_symbols(self) -> int:
        return len(BARKER13) * BARKER_REPEATS

    @property
    def preamble_samples(self) -> int:
        return self.preamble_symbols * self.samples_per_symbol

    def phase_increment(self, v: np.ndarray) -> np.ndarray:
        if self.bits_per_symbol == 1:
            return v * np.pi
        if self.bits_per_symbol == 2:
            return (v * 2 + 1) * np.pi / 4.0
        return (v & 7) * np.pi / 4.0 + np.pi / 8.0

    def num_symbols_for_bits(self, num_bits: int) -> int:
        return -(-num_bits // self.bits_per_symbol)

    def frame_samples(self, num_bits: int) -> int:
        return self.preamble_samples + (1 + self.num_symbols_for_bits(num_bits)) \
            * self.samples_per_symbol


def _synth(phases: np.ndarray, cfg: DPSKConfig) -> np.ndarray:
    """Absolute per-symbol phases -> passband samples (carrier restarts at 0
    each symbol, matching the reference's per-symbol synthesis)."""
    t = np.arange(cfg.samples_per_symbol, dtype=np.float64)
    carrier_phase = 2.0 * np.pi * cfg.carrier_freq * t / cfg.sample_rate
    out = np.cos(carrier_phase[None, :] + phases[:, None])
    return out.reshape(-1).astype(np.float32)


def generate_preamble(cfg: DPSKConfig) -> np.ndarray:
    """Barker-13 x3 as absolute BPSK phases (0 / pi)."""
    seq = np.tile(BARKER13, BARKER_REPEATS)
    phases = np.where(seq > 0, 0.0, np.pi)
    return _synth(phases, cfg)


def modulate(bits: np.ndarray, cfg: DPSKConfig) -> np.ndarray:
    """Reference symbol + differentially-encoded data symbols."""
    bits = np.asarray(bits, np.int64)
    bps = cfg.bits_per_symbol
    S = cfg.num_symbols_for_bits(len(bits))
    padded = np.zeros(S * bps, np.int64)
    padded[: len(bits)] = bits
    grouped = padded.reshape(S, bps)
    vals = np.zeros(S, np.int64)
    for b in range(bps):
        vals = (vals << 1) | grouped[:, b]
    dphi = cfg.phase_increment(vals)
    phases = np.concatenate([[0.0], np.cumsum(dphi)])  # ref symbol at phase 0
    return _synth(phases, cfg)


def tx_frame(bits: np.ndarray, cfg: DPSKConfig) -> np.ndarray:
    return np.concatenate([generate_preamble(cfg), modulate(bits, cfg)])


class DPSKSyncResult(NamedTuple):
    detected: torch.Tensor
    data_start: torch.Tensor  # first sample of the reference symbol
    corr: torch.Tensor


def _mixer(cfg: DPSKConfig, device: torch.device) -> torch.Tensor:
    """[sps, 2]: the real and imaginary parts of the complex64 mixer
    exp(-2j pi fc t / fs) (built in float64, rounded as the reference)."""
    t = np.arange(cfg.samples_per_symbol, dtype=np.float64)
    mixer = np.exp(-2j * np.pi * cfg.carrier_freq * t / cfg.sample_rate).astype(np.complex64)
    return torch.as_tensor(np.stack([mixer.real, mixer.imag], axis=-1), device=device)


def _phasors(frames: torch.Tensor, mixer: torch.Tensor, sps: int) -> torch.Tensor:
    """frames [..., S, sps] -> symbol phasors [..., S] complex64:
    (frames @ mixer) / sps, the division as the compiled reference does it."""
    z = _rdiv(frames @ mixer, sps)
    return torch.complex(z[..., 0], z[..., 1])


def _barker_template() -> np.ndarray:
    """Differential sign template between adjacent Barker symbols [P-1]."""
    seq = np.tile(BARKER13, BARKER_REPEATS).astype(np.float32)
    return seq[1:] * seq[:-1]


class BarkerDetector(nn.Module):
    """Barker-13x3 preamble search over windows of ``num_samples``:
    samples [..., num_samples] -> DPSKSyncResult (per leading index).

    Coarse pass: at every sps/8 offset, the matched-filter energy (the sum
    of the differential products against the Barker sign template) and its
    normalized value; the coarse peak is the UNNORMALIZED energy's argmax
    (against a silent lead-in a partial overlap 13 symbols early scores a
    perfect normalized correlation).  Fine pass: the energy at 16-sample
    steps one symbol either side, offsets clipped into the window.
    Buffers: the mixer (``mixer``) and the template (``dtemplate``)."""

    def __init__(self, cfg: DPSKConfig, num_samples: int, device: str | torch.device = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        full_fp32_matmul()
        self.cfg = cfg
        self.n = n = num_samples
        sps = cfg.samples_per_symbol
        P = cfg.preamble_symbols
        self.need = (P + 1) * sps
        self.step = sps // COARSE_PHASES
        self.short = n < self.need + self.step
        if self.short:
            return
        self.num_off = max((n - self.need) // self.step, 1)
        self.register_buffer("mixer", _mixer(cfg, dev))
        self.register_buffer("dtemplate", torch.as_tensor(_barker_template(), device=dev))
        self.register_buffer("fine_offsets", torch.arange(-sps, sps + 1, FINE_STEP, device=dev))

    def forward(self, samples: torch.Tensor) -> DPSKSyncResult:
        shape = samples.shape[:-1]
        if samples.shape[-1] != self.n:
            raise ValueError(f"window of {samples.shape[-1]} samples, built for {self.n}")
        dev = samples.device
        if self.short:
            return DPSKSyncResult(torch.zeros(shape, dtype=torch.bool, device=dev),
                                  torch.full(shape, -1, dtype=torch.int32, device=dev),
                                  torch.zeros(shape, dtype=torch.float32, device=dev))
        res = self._search(samples.reshape(-1, self.n).float())
        return DPSKSyncResult(*(v.reshape(shape) for v in res))

    def _scores(self, z: torch.Tensor):
        """Symbol phasors [..., P] -> (matched-filter energy, normalized)."""
        diff = torch.real(z[..., 1:] * torch.conj(z[..., :-1]))
        num = torch.sum(diff * self.dtemplate, dim=-1)
        den = torch.sum(torch.abs(diff), dim=-1) + 1e-9
        return num, num / den

    def _search(self, x: torch.Tensor) -> DPSKSyncResult:
        cfg, n, step = self.cfg, self.n, self.step
        B = x.shape[0]
        sps = cfg.samples_per_symbol
        P = cfg.preamble_symbols
        num_off = self.num_off
        # Offset k = COARSE_PHASES * q + p starts at symbol q of phase p's
        # framing, so its P phasors are that framing's symbols q .. q+P-1.
        # Every offset below num_off lies inside the window; the slots past
        # it (the last q of some phases) are zero-padded and dropped.
        q_max = -(-num_off // COARSE_PHASES)
        nums, scores = [], []
        for p in range(COARSE_PHASES):
            count = min((n - p * step) // sps, q_max + P - 1)
            frames = x[:, p * step : p * step + count * sps].reshape(B, count, sps)
            z = _phasors(frames, self.mixer, sps).unfold(-1, P, 1)   # [B, count-P+1, P]
            num, score = self._scores(z)
            pad = (0, q_max - num.shape[-1])
            nums.append(nn.functional.pad(num, pad))
            scores.append(nn.functional.pad(score, pad))
        # Interleave back to offset order (k = 8q + p) and drop the tail.
        energies = torch.stack(nums, dim=-1).reshape(B, -1)[:, :num_off]
        scores = torch.stack(scores, dim=-1).reshape(B, -1)[:, :num_off]
        best = torch.argmax(energies, dim=-1)
        coarse = best * step

        # Fine pass: total matched-filter energy around the coarse peak.
        offs = torch.clamp(coarse[:, None] + self.fine_offsets, 0, n - self.need)  # [B, F]
        windows = x.unfold(-1, P * sps, 1)[torch.arange(B, device=x.device)[:, None], offs]
        fine_scores, _ = self._scores(_phasors(windows.reshape(B, -1, P, sps), self.mixer, sps))
        refined = torch.gather(offs, 1, torch.argmax(fine_scores, dim=-1)[:, None])[:, 0]

        val = torch.gather(scores, 1, best[:, None])[:, 0]
        detected = val > 0.6
        start = (refined + P * sps).to(torch.int32)
        return DPSKSyncResult(detected, torch.where(detected, start, -1).to(torch.int32), val)


@functools.lru_cache(maxsize=64)
def barker_detector(cfg: DPSKConfig, num_samples: int,
                    device: str | torch.device = "cuda") -> BarkerDetector:
    """Cached :class:`BarkerDetector` for a (config, window, device)."""
    return BarkerDetector(cfg, num_samples, device)


def find_preamble(samples: torch.Tensor, cfg: DPSKConfig) -> DPSKSyncResult:
    """Correlate the Barker differential-sign sequence at sub-symbol lags in
    a window [..., N] (batched over leading axes), on the samples' device."""
    return barker_detector(cfg, samples.shape[-1], samples.device)(samples)


class DPSKDemodResult(NamedTuple):
    soft_bits: torch.Tensor
    phase_noise_var: torch.Tensor
    snr_estimate_db: torch.Tensor


class DPSKDemodulator(nn.Module):
    """Demodulator of ``num_bits`` from [ref symbol + data symbols]:
    data_samples [..., >= (S+1)*sps] starting at the reference symbol ->
    DPSKDemodResult.  Soft bits by max-log over the candidate phase
    increments, scaled by the phase-noise variance.  Buffers: the mixer and
    the candidate increments (``cand``)."""

    def __init__(self, cfg: DPSKConfig, num_bits: int, device: str | torch.device = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        full_fp32_matmul()
        self.cfg = cfg
        self.num_bits = num_bits
        self.S = cfg.num_symbols_for_bits(num_bits)
        self.register_buffer("mixer", _mixer(cfg, dev))
        bps = cfg.bits_per_symbol
        if bps > 1:
            levels = 1 << bps
            self.register_buffer("cand", torch.as_tensor(
                cfg.phase_increment(np.arange(levels)).astype(np.float32), device=dev))
            vals = np.arange(levels)
            self.register_buffer("bit_masks", torch.as_tensor(
                np.stack([((vals >> (bps - 1 - b)) & 1).astype(bool) for b in range(bps)]),
                device=dev))

    def forward(self, data_samples: torch.Tensor) -> DPSKDemodResult:
        cfg = self.cfg
        bps = cfg.bits_per_symbol
        sps = cfg.samples_per_symbol
        S = self.S
        x = data_samples[..., : (S + 1) * sps].float()
        z = _phasors(x.reshape(x.shape[:-1] + (S + 1, sps)), self.mixer, sps)
        diff = z[..., 1:] * torch.conj(z[..., :-1])
        phase = torch.angle(diff)

        if bps == 1:
            ideal = torch.round(_rdiv(phase, np.pi)) * np.pi
        elif bps == 2:
            ideal = torch.round(_rdiv(phase - np.pi / 4, np.pi / 2)) * (np.pi / 2) + np.pi / 4
        else:
            ideal = torch.round(_rdiv(phase - np.pi / 8, np.pi / 4)) * (np.pi / 4) + np.pi / 8
        err = phase - ideal
        err = torch.where(err > np.pi, err - 2 * np.pi, err)
        err = torch.where(err < -np.pi, err + 2 * np.pi, err)
        pvar = torch.clamp_min(torch.mean(torch.square(err), dim=-1), 0.01)
        scale = torch.clamp_max(2.0 * torch.sqrt(1.0 / pvar), 20.0)[..., None]

        if bps == 1:
            soft = (scale * torch.cos(phase))[..., None]
        else:
            # Max-log over the TX phase increments, MSB first.
            d = torch.cos(phase[..., None] - self.cand)   # similarity to each phase
            softs = []
            for mask in self.bit_masks:
                m0 = torch.amax(torch.where(~mask, d, -torch.inf), dim=-1)
                m1 = torch.amax(torch.where(mask, d, -torch.inf), dim=-1)
                softs.append(scale * (m0 - m1))
            soft = torch.stack(softs, dim=-1)

        soft = torch.clamp(soft, -20.0, 20.0)
        soft = soft.reshape(soft.shape[:-2] + (S * bps,))[..., : self.num_bits]
        snr = 10.0 * torch.log10(1.0 / pvar)
        return DPSKDemodResult(soft, pvar, snr)


@functools.lru_cache(maxsize=64)
def dpsk_demodulator(cfg: DPSKConfig, num_bits: int,
                     device: str | torch.device = "cuda") -> DPSKDemodulator:
    """Cached :class:`DPSKDemodulator` for a (config, bit count, device)."""
    return DPSKDemodulator(cfg, num_bits, device)


def demodulate(data_samples: torch.Tensor, cfg: DPSKConfig, num_bits: int) -> DPSKDemodResult:
    """Demod [ref symbol + data symbols] starting at the reference symbol,
    on the samples' device."""
    return dpsk_demodulator(cfg, num_bits, data_samples.device)(data_samples)
