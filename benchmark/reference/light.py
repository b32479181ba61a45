"""The light preamble's LTS search and the OFDM chain behind it, frozen from
``ria_tpu_torch/wave/ofdm.py`` (``LTSDetector``) and
``ria_tpu_torch/phy/pipeline.py`` (``OFDMRxPipeline(..., preamble="lts")``),
held by the benchmark as its plain reference; it imports nothing of the port.

The light preamble is two LTS symbols and no guard or STS: what both OFDM
waveforms send before every data frame once a link is connected.  The
search correlates the window with the LTS template in the passband by an FFT
pair, normalises by the sliding window energy (the float64 prefixes of
:func:`.device.wide_cumsum`), takes the earliest lag above the threshold,
centres on its local peak, walks back to the first repeat (92% rule, twice),
then to the first significant tap, and reads the CFO from the two repeats'
phase.  The chain is :class:`.chains.OfdmChain` with this search in the
Schmidl-Cox search's place: frame slice, CP strip and FFTs, equalisation,
soft demap, frame and channel deinterleave, min-sum BP.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .chains import OfdmChain
from .device import resolve_device
from .ofdm import OFDMConfig, _lts_symbol, _rdiv, _sliding, _take

THRESHOLD = 0.5   # the light search's threshold (``wave/api.py``'s ``lts_search(x, cfg)``)


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 when none)."""
    return torch.argmax(mask.to(torch.uint8), dim=-1)


class LTSSyncResult(NamedTuple):
    detected: torch.Tensor
    lts_start: torch.Tensor   # int32 sample of the first LTS symbol; -1 where none
    corr: torch.Tensor
    cfo_hz: torch.Tensor
    repeats: torch.Tensor     # LTS repeats at the sync point: 2, or 3 for a burst


class LTSDetector(torch.nn.Module):
    """samples [B, num_samples] float32 -> LTSSyncResult.  Buffer: the
    conjugated spectrum of the LTS template mixed from t = 0."""

    def __init__(self, cfg: OFDMConfig, num_samples: int, threshold: float,
                 device: torch.device):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.n = num_samples
        self.threshold = threshold
        lts = _lts_symbol(cfg)
        self.L = L = len(lts)
        if num_samples < 2 * L + 64:
            raise ValueError(f"a window of {num_samples} samples cannot hold two LTS symbols")
        lts_analytic = np.asarray(
            np.exp(2j * np.pi * cfg.center_freq * np.arange(L) / cfg.sample_rate) * lts
            * cfg.output_scale, np.complex64)
        self.ref_energy = float(np.sum(np.abs(lts_analytic) ** 2)) * 0.5
        self.nfft = 1 << (num_samples + L - 1).bit_length()
        spec = torch.fft.fft(torch.as_tensor(lts_analytic, device=dev), self.nfft)
        self.register_buffer("lts_fft", torch.conj(spec).resolve_conj())

    def forward(self, samples: torch.Tensor) -> LTSSyncResult:
        cfg = self.cfg
        x = samples.float()
        n, L = self.n, self.L
        sym = cfg.symbol_samples
        dev = x.device

        # Coarse: the normalised passband correlation at every lag.
        x2 = torch.square(x)
        X = torch.fft.fft(x.to(torch.complex64), self.nfft)
        xc = torch.fft.ifft(X * self.lts_fft)[:, : max(n - L, 1)]
        e = _sliding(x2, L)[:, : xc.shape[-1]]
        e_floor = 1e-6 * torch.amax(e, dim=-1, keepdim=True)
        corr = torch.abs(xc) / torch.sqrt(
            torch.clamp_min(torch.maximum(e, e_floor) * self.ref_energy, 1e-12))
        last = corr.shape[-1] - 1

        # Fine: the earliest lag above the threshold, its local peak, the
        # walk back to the first repeat.
        above = corr > self.threshold
        first = _first_true(above)
        local = torch.clamp_max(first[:, None] + torch.arange(sym, device=dev), last)
        lvals = torch.gather(corr, 1, local)
        pos = _take(local, torch.argmax(lvals, dim=-1))
        pos = torch.where(above.any(dim=-1), pos, torch.argmax(corr, dim=-1))
        val = _take(corr, pos)
        for _ in range(2):
            prev_pos = torch.clamp_min(pos - sym, 0)
            prev_val = _take(corr, prev_pos)
            take_prev = (pos >= sym) & (prev_val >= val * 0.92)
            pos = torch.where(take_prev, prev_pos, pos)
            val = torch.where(take_prev, prev_val, val)
        det = val > self.threshold

        # The earliest lag within 48 samples that clears 0.6x the peak, then
        # its lobe's maximum within 12.
        offs = torch.arange(-48, 1, device=dev)
        widx = torch.clamp(pos[:, None] + offs, 0, last)
        strong = torch.gather(corr, 1, widx) >= 0.6 * val[:, None]
        edge = _take(widx, _first_true(strong))
        lidx = torch.clamp(edge[:, None] + torch.arange(12, device=dev), 0, last)
        refined = _take(lidx, torch.argmax(torch.gather(corr, 1, lidx), dim=-1))
        refined = torch.minimum(refined, pos)
        pos = torch.where(det, refined, pos)
        val = _take(corr, pos)

        # CFO from the phase between the two repeats; a third marks a burst.
        pos2 = torch.clamp_max(pos + sym, xc.shape[-1] - 1)
        xc1, xc2 = _take(xc, pos), _take(xc, pos2)
        val2 = _take(corr, pos2)
        dphi = torch.angle(xc2 * torch.conj(xc1))
        cfo = _rdiv(dphi * cfg.sample_rate, 2.0 * np.pi * sym)
        cfo = torch.where(val2 >= 0.5 * val, cfo, 0.0)
        val3 = _take(corr, torch.clamp_max(pos + 2 * sym, last))
        repeats = torch.where(val3 >= 0.5 * val, 3, 2).to(torch.int32)

        pos = pos.to(torch.int32)
        return LTSSyncResult(det, torch.where(det, pos, -1).to(torch.int32), val, cfo, repeats)


class LightChain(OfdmChain):
    """audio [B, window] -> outputs, for fixed 4-codeword frames behind the
    light preamble (``lts_start``, the first LTS symbol's sample, as
    ``start``)."""

    def __init__(self, cfg: OFDMConfig, rate: str, window_samples: int, ci_bits: int | None,
                 min_sum_factor: float, device: torch.device):
        super().__init__(cfg, rate, window_samples, ci_bits, min_sum_factor, device)
        self.sync = LTSDetector(cfg, window_samples, THRESHOLD, device)
