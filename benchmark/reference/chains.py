"""The plain RX chains, frozen from ``ria_tpu_torch/phy/pipeline.py``
(``RxPipeline`` and ``OFDMRxPipeline``), with the plain decoder of
:mod:`.ldpc_plain` in K1's place; they import nothing of the port.

- MC-DPSK: dual-chirp sync (zoom branch at the production window), frame
  slice, mixer-bank demodulation, min-sum BP;
- OFDM: Schmidl-Cox search, frame slice, CP strip and 1024-point FFTs,
  equalization, soft demap, frame and channel deinterleave, min-sum BP.

Each returns a dict of the outputs that the served path hands the host:
``detected``, ``start``, ``cfo_hz``, ``snr_db`` per channel and
``cw_success``, ``info_bits``, ``iterations`` per codeword.
"""

from __future__ import annotations

import torch
from torch import nn

from .chirp import ChirpDetector, window_slice
from .interleave import FRAME_CODEWORDS, channel_perm, frame_perm
from .ldpc_matrix import RECOMMENDED_ITERS, get_code
from .ldpc_plain import PlainDecoder
from .mc_dpsk import MCDPSKConfig, MCDPSKDemodulator
from .ofdm import OFDMConfig, OFDMDemodulator, SchmidlCoxDetector

LDPC_BITS = 648


class McdpskChain(nn.Module):
    """audio [B, window] -> outputs, for frames of ``num_codewords``."""

    def __init__(self, cfg: MCDPSKConfig, rate: str, num_codewords: int,
                 window_samples: int, min_sum_factor: float, device: torch.device):
        super().__init__()
        self.cfg = cfg
        self.num_codewords = num_codewords
        self.window_samples = window_samples
        self.min_sum_factor = min_sum_factor
        self.num_bits = num_codewords * LDPC_BITS
        n_sym = cfg.num_data_symbols(self.num_bits)
        self.frame_need = (cfg.training_symbols + 1 + n_sym * cfg.spreading) * cfg.samples_per_symbol
        self.sync = ChirpDetector(cfg.chirp, window_samples, device)
        self.demod = MCDPSKDemodulator(cfg, n_sym, device)
        self.decoder = PlainDecoder(get_code(rate), RECOMMENDED_ITERS[rate], device)

    def forward(self, audio: torch.Tensor) -> dict[str, torch.Tensor]:
        B = audio.shape[0]
        sync = self.sync(audio)
        start = torch.clamp(sync.start + self.cfg.chirp.total_samples, 0,
                            max(self.window_samples - self.frame_need, 0))
        frames = window_slice(audio.float(), start, self.frame_need)
        demod = self.demod(frames, sync.cfo_hz)
        soft = demod.soft_bits[..., : self.num_bits].reshape(-1, LDPC_BITS).contiguous()
        factors = torch.full((soft.shape[0],), self.min_sum_factor, dtype=torch.float32,
                             device=soft.device)
        dec = self.decoder(soft, factors)
        return {
            "detected": sync.detected,
            "start": sync.start,
            "cfo_hz": sync.cfo_hz,
            "snr_db": demod.snr_estimate_db,
            "cw_success": dec.success.reshape(B, self.num_codewords) & sync.detected[:, None],
            "info_bits": dec.info_bits.reshape(B, self.num_codewords, -1),
            "iterations": dec.iterations.reshape(B, self.num_codewords),
        }


class OfdmChain(nn.Module):
    """audio [B, window] -> outputs, for fixed 4-codeword frames."""

    def __init__(self, cfg: OFDMConfig, rate: str, window_samples: int, ci_bits: int | None,
                 min_sum_factor: float, device: torch.device):
        super().__init__()
        self.cfg = cfg
        self.window_samples = window_samples
        self.min_sum_factor = min_sum_factor
        self.num_bits = FRAME_CODEWORDS * LDPC_BITS
        S = cfg.num_symbols_for_bits(self.num_bits)
        self.need = (2 + S) * cfg.symbol_samples
        self.sync = SchmidlCoxDetector(cfg, window_samples, device)
        self.demod = OFDMDemodulator(cfg, S, 2, device)
        self.register_buffer("frame_idx", torch.as_tensor(frame_perm(), device=device))
        self.register_buffer("ci_idx", torch.as_tensor(channel_perm(ci_bits), device=device)
                             if ci_bits else None)
        self.decoder = PlainDecoder(get_code(rate), RECOMMENDED_ITERS[rate], device)

    def forward(self, audio: torch.Tensor) -> dict[str, torch.Tensor]:
        B = audio.shape[0]
        sync = self.sync(audio)
        start = torch.clamp(torch.where(sync.detected, sync.lts_start, 0), 0,
                            max(self.window_samples - self.need, 0))
        frames = window_slice(audio.float(), start, self.need)
        demod = self.demod(frames, sync.cfo_hz)
        soft = demod.soft_bits[..., : self.num_bits][..., self.frame_idx]
        cw_soft = soft.reshape(-1, FRAME_CODEWORDS, LDPC_BITS)
        if self.ci_idx is not None:
            cw_soft = cw_soft[..., self.ci_idx]
        soft = cw_soft.reshape(-1, LDPC_BITS).contiguous()
        factors = torch.full((soft.shape[0],), self.min_sum_factor, dtype=torch.float32,
                             device=soft.device)
        dec = self.decoder(soft, factors)
        return {
            "detected": sync.detected,
            "start": sync.lts_start,
            "cfo_hz": sync.cfo_hz,
            "snr_db": demod.snr_db,
            "cw_success": dec.success.reshape(B, FRAME_CODEWORDS) & sync.detected[:, None],
            "info_bits": dec.info_bits.reshape(B, FRAME_CODEWORDS, -1),
            "iterations": dec.iterations.reshape(B, FRAME_CODEWORDS),
        }
