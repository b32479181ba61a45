"""Batched RX/TX pipelines over channels, in PyTorch.

Port of ``ria_tpu/phy/pipeline.py``.  A whole window of audio per channel
runs as one batched program for B independent channels at once:

- MC-DPSK: dual-chirp sync search (batched FFT correlation), per-channel
  frame slice, mixer-bank demodulation, batched LDPC belief propagation;
- OFDM: Schmidl-Cox search (or, for connected-mode data frames behind the
  light preamble, the LTS-only search), frame slice, CP strip + 1024-pt
  FFT, LTS channel estimate, MMSE (or pilot-tracking) equalization, soft
  demap, frame and channel deinterleave as static gathers, batched LDPC BP.

On a CUDA device the decoder is kernel K1 (``csrc/ldpc_bp.cu``).  Each RX
call marks its three stages with ``utils/trace.span`` spans, ``rx.sync``
(with ``sync.coarse`` and ``sync.fine`` inside it, in the chirp zoom search,
the Schmidl-Cox search and the LTS search), ``rx.demod`` (frame slice,
demodulation, deinterleave) and ``rx.decode``: each keeps its recent host
intervals, and a profiled call splits by stage (``tools/bench_profile.py``).
Building a pipeline is the span ``setup.rx_pipeline``.

A HARQ round (:class:`HarqRxPipeline`) runs the MC-DPSK chain's sync and
demod over every received copy of each channel's frame at once, decodes
each copy alone in ``rx.decode`` and, in the span ``rx.chase`` beside it,
sums the LLRs of the copies that failed and decodes the sums
(``fec/chase.py::chase_round``), on the device throughout.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ria_tpu_torch.fec.chase import MAX_COMBINES, chase_round
from ria_tpu_torch.fec.interleave import FRAME_CODEWORDS, channel_perm, frame_perm
from ria_tpu_torch.fec.ldpc import LDPCDecoder, ldpc_decoder
from ria_tpu_torch.fec.ldpc_matrix import RECOMMENDED_ITERS
from ria_tpu_torch.sync.chirp import ChirpDetector, window_slice, generate as chirp_generate
from ria_tpu_torch.utils.device import full_fp32_matmul, resolve_device
from ria_tpu_torch.utils.trace import span
from ria_tpu_torch.wave.mc_dpsk import (
    MCDPSKConfig,
    MCDPSKDemodulator,
    _synth_matrix,
    _training_matrix,
)
from ria_tpu_torch.wave.ofdm import (
    LTSDetector,
    OFDMConfig,
    OFDMDemodulator,
    SchmidlCoxDetector,
    carrier_layout,
)

LDPC_BITS = 648


class RxBatchResult(NamedTuple):
    detected: torch.Tensor    # [B] bool
    start: torch.Tensor       # [B] int32 chirp start
    cfo_hz: torch.Tensor      # [B]
    cw_success: torch.Tensor  # [B, NCW] bool
    info_bits: torch.Tensor   # [B, NCW, k] uint8
    iterations: torch.Tensor  # [B, NCW]
    snr_db: torch.Tensor      # [B]


# Block length of the compiled reference's float32 cumulative sum on the CPU.
_XLA_SCAN_BLOCK = 16


def _xla_cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive cumulative sum along ``dim`` in the order of the reference's
    compiled ``jnp.cumsum`` on the CPU: sequential float32 sums within
    blocks of 16, the block totals scanned the same way, then added.
    (``torch.cumsum`` accumulates in double on the CPU; over the ~260 symbol
    phases of a TX frame, up to ~800 rad, the two differ by ulps of the
    phase, 3e-5 of the audio.)"""
    x = x.movedim(dim, -1)
    n, b = x.shape[-1], _XLA_SCAN_BLOCK
    nb = -(-n // b)
    xp = nn.functional.pad(x, (0, nb * b - n)).reshape(x.shape[:-1] + (nb, b))
    cols = [xp[..., 0]]
    for i in range(1, b):
        cols.append(cols[-1] + xp[..., i])
    pre = torch.stack(cols, dim=-1)
    if nb > 1:
        totals = _xla_cumsum(pre[..., -1], -1)
        before = torch.cat([torch.zeros_like(totals[..., :1]), totals[..., :-1]], dim=-1)
        pre = pre + before[..., None]
    return pre.reshape(x.shape[:-1] + (nb * b,))[..., :n].movedim(-1, dim)


def _pick_decoder(rate: str, device: torch.device) -> LDPCDecoder:
    """The chain's decoder: kernel K1 for CUDA tensors (no tile padding: it
    exits per codeword), the plain decoder for CPU tensors."""
    return ldpc_decoder(rate, RECOMMENDED_ITERS[rate], device)


class RxPipeline(nn.Module):
    """audio [B, window] -> RxBatchResult for frames of a known codeword count."""

    def __init__(self, cfg: MCDPSKConfig, rate: str, num_codewords: int,
                 window_samples: int, min_sum_factor: float = 0.75,
                 device: str | torch.device = "cuda"):
        with span("setup.rx_pipeline"):
            super().__init__()
            dev = resolve_device(device)
            full_fp32_matmul()
            self.cfg = cfg
            self.num_codewords = num_codewords
            self.window_samples = window_samples
            self.min_sum_factor = min_sum_factor
            self.num_bits = num_codewords * LDPC_BITS
            n_sym = cfg.num_data_symbols(self.num_bits)
            self.frame_need = ((cfg.training_symbols + 1 + n_sym * cfg.spreading)
                               * cfg.samples_per_symbol)
            self.sync = ChirpDetector(cfg.chirp, window_samples, dev)
            self.demod = MCDPSKDemodulator(cfg, n_sym, dev)
            self.decoder = _pick_decoder(rate, dev)

    def soft_bits(self, audio: torch.Tensor):
        """Sync, frame slice and demodulation: (sync, demod, codeword LLRs
        [B * NCW, 648]), the decoder's input."""
        with span("rx.sync"):
            sync = self.sync(audio)
        with span("rx.demod"):
            # Frame slice, clamped into the window as jax.lax.dynamic_slice does.
            start = torch.clamp(sync.start + self.cfg.chirp.total_samples, 0,
                                max(self.window_samples - self.frame_need, 0))
            frames = window_slice(audio.float(), start, self.frame_need)
            demod = self.demod(frames, sync.cfo_hz)
            soft = demod.soft_bits[..., : self.num_bits].reshape(-1, LDPC_BITS).contiguous()
        return sync, demod, soft

    def forward(self, audio: torch.Tensor) -> RxBatchResult:
        B = audio.shape[0]
        sync, demod, soft = self.soft_bits(audio)
        with span("rx.decode"):
            factors = torch.full((soft.shape[0],), self.min_sum_factor, dtype=torch.float32,
                                 device=soft.device)
            dec = self.decoder(soft, factors)
            k = dec.info_bits.shape[-1]
            return RxBatchResult(
                detected=sync.detected,
                start=sync.start,
                cfo_hz=sync.cfo_hz,
                cw_success=dec.success.reshape(B, self.num_codewords) & sync.detected[:, None],
                info_bits=dec.info_bits.reshape(B, self.num_codewords, k),
                iterations=dec.iterations.reshape(B, self.num_codewords),
                snr_db=demod.snr_estimate_db,
            )


def make_rx_pipeline(cfg: MCDPSKConfig, rate: str, num_codewords: int,
                     window_samples: int, min_sum_factor: float = 0.75, batch_hint: int = 0,
                     device: str | torch.device = "cuda") -> RxPipeline:
    """Batch RX on ``device`` (the card by default; ``device="cpu"`` for the
    host): audio [B, window_samples] -> RxBatchResult.

    ``batch_hint`` keeps the reference's parameter in its place and changes
    nothing: the reference uses it to pick its Pallas kernel when
    ``batch_hint * num_codewords`` fills whole 128-row tiles
    (``ria_tpu/phy/pipeline.py:42-51``), while K1 takes every CUDA batch
    as it comes (:func:`_pick_decoder`)."""
    return RxPipeline(cfg, rate, num_codewords, window_samples, min_sum_factor, device)


class HarqRxBatchResult(NamedTuple):
    detected: torch.Tensor    # [B, R] bool, each copy's
    start: torch.Tensor       # [B, R] int32 chirp start
    cfo_hz: torch.Tensor      # [B, R]
    cw_success: torch.Tensor  # [B, NCW] bool, the round's outcome
    info_bits: torch.Tensor   # [B, NCW, k] uint8
    iterations: torch.Tensor  # [B, NCW]
    snr_db: torch.Tensor      # [B, R]
    source: torch.Tensor      # [B, NCW] int8, fec/chase.py::walk_position; -1 none


class HarqRxPipeline(nn.Module):
    """audio [B, R, window], each channel's R transmissions of one frame in
    arrival order -> HarqRxBatchResult: one HARQ round with chase combining.

    The B * R windows go through :meth:`RxPipeline.soft_bits` in one pass;
    one decoder call decodes every copy alone (``rx.decode``), and
    :func:`~ria_tpu_torch.fec.chase.chase_round` walks the copies as the
    host's chase cache does, decoding each sum in one more call
    (``rx.chase``): 1 + (R - 1) decoder launches a round, every one at the
    configuration's min-sum factor and iteration cap."""

    def __init__(self, cfg: MCDPSKConfig, rate: str, num_codewords: int,
                 window_samples: int, copies: int, min_sum_factor: float = 0.75,
                 device: str | torch.device = "cuda"):
        if not 1 <= copies <= MAX_COMBINES:
            raise ValueError(f"copies must lie in [1, {MAX_COMBINES}], got {copies}")
        super().__init__()
        self.copies = copies
        self.rx = RxPipeline(cfg, rate, num_codewords, window_samples, min_sum_factor, device)

    def _decode(self, llrs: torch.Tensor):
        factors = torch.full((llrs.shape[0],), self.rx.min_sum_factor, dtype=torch.float32,
                             device=llrs.device)
        return self.rx.decoder(llrs, factors)

    def forward(self, audio: torch.Tensor) -> HarqRxBatchResult:
        B, R, window = audio.shape
        if R != self.copies:
            raise ValueError(f"audio holds {R} copies a channel, the round {self.copies}")
        sync, demod, soft = self.rx.soft_bits(audio.reshape(B * R, window))
        with span("rx.decode"):
            alone = self._decode(soft)
        with span("rx.chase"):
            out = chase_round(soft.reshape(B, R, self.rx.num_codewords, LDPC_BITS),
                              sync.detected.reshape(B, R), alone, self._decode)
            return HarqRxBatchResult(
                detected=sync.detected.reshape(B, R),
                start=sync.start.reshape(B, R),
                cfo_hz=sync.cfo_hz.reshape(B, R),
                cw_success=out.cw_success,
                info_bits=out.info_bits,
                iterations=out.iterations,
                snr_db=demod.snr_estimate_db.reshape(B, R),
                source=out.source,
            )


def make_harq_rx_pipeline(cfg: MCDPSKConfig, rate: str, num_codewords: int,
                          window_samples: int, copies: int, min_sum_factor: float = 0.75,
                          device: str | torch.device = "cuda") -> HarqRxPipeline:
    """One batched HARQ round on ``device`` (the card by default;
    ``device="cpu"`` for the host): audio [B, copies, window_samples] ->
    HarqRxBatchResult (see :class:`HarqRxPipeline`)."""
    return HarqRxPipeline(cfg, rate, num_codewords, window_samples, copies, min_sum_factor,
                          device)


class OFDMRxBatchResult(NamedTuple):
    detected: torch.Tensor    # [B] bool
    lts_start: torch.Tensor   # [B] int32
    cfo_hz: torch.Tensor      # [B]
    cw_success: torch.Tensor  # [B, 4] bool
    info_bits: torch.Tensor   # [B, 4, k] uint8
    iterations: torch.Tensor  # [B, 4]
    snr_db: torch.Tensor      # [B]


# The LTS threshold of the light preamble's search (``wave/api.py``'s
# ``lts_search(x, cfg)``), and the control profile's pilot layout: DQPSK with
# pilot spacing 10 (``wave/api.py::_OFDMWaveformBase._rebuild``), whose LTS a
# light frame carries when it holds a control frame.
_LIGHT_THRESHOLD = 0.5
_CONTROL_PROFILE = {"modulation": "DQPSK", "use_pilots": True, "pilot_spacing": 10}


def _light_detector(cfg: OFDMConfig, window_samples: int, dev: torch.device) -> LTSDetector:
    """The light preamble's LTS search over the data layout's template.  A
    waveform searches the control profile's template too where its LTS
    differs (``_light_lts_search``); a batched chain searches once, so it
    refuses such a layout rather than miss its control frames silently."""
    control = dataclasses.replace(cfg, **_CONTROL_PROFILE)
    if not np.array_equal(carrier_layout(cfg)[1], carrier_layout(control)[1]):
        raise ValueError(
            f"the light preamble's LTS of {cfg.modulation} with pilot spacing "
            f"{cfg.pilot_spacing if cfg.use_pilots else None} differs from the control "
            "profile's (DQPSK, pilot spacing 10): a chain searches one template")
    return LTSDetector(cfg, window_samples, _LIGHT_THRESHOLD, dev)


class OFDMRxPipeline(nn.Module):
    """audio [B, window] -> OFDMRxBatchResult for fixed 4-codeword frames.

    ``preamble`` names the frames' sync: ``"cox"``, the Schmidl-Cox
    preamble (guard, 4 STS, 2 LTS) of the OFDM-COX waveform, or ``"lts"``,
    the light preamble (2 LTS alone) that both OFDM waveforms send before
    every data frame once a link is connected, found by the LTS search.
    Either way ``lts_start`` is the first LTS symbol's sample.

    Buffers: the frame deinterleave gather (``frame_idx``, the inverse of
    ``apply_perm``'s scatter form: x[..., frame_perm()]) and, with
    ``ci_bits``, the channel deinterleave gather within each codeword
    (``ci_idx``: x[..., channel_perm(ci_bits)]).
    """

    def __init__(self, cfg: OFDMConfig, rate: str, window_samples: int,
                 ci_bits: int | None = None, min_sum_factor: float = 0.9375,
                 device: str | torch.device = "cuda", preamble: str = "cox"):
        if preamble not in ("cox", "lts"):
            raise ValueError(f"preamble {preamble!r}: 'cox' or 'lts'")
        with span("setup.rx_pipeline"):
            super().__init__()
            dev = resolve_device(device)
            full_fp32_matmul()
            self.cfg = cfg
            self.window_samples = window_samples
            self.min_sum_factor = min_sum_factor
            self.num_bits = FRAME_CODEWORDS * LDPC_BITS
            S = cfg.num_symbols_for_bits(self.num_bits)
            self.need = (2 + S) * cfg.symbol_samples
            self.sync = (SchmidlCoxDetector(cfg, window_samples, dev) if preamble == "cox"
                         else _light_detector(cfg, window_samples, dev))
            self.demod = OFDMDemodulator(cfg, S, 2, dev)
            self.register_buffer("frame_idx", torch.as_tensor(frame_perm(), device=dev))
            self.register_buffer("ci_idx", torch.as_tensor(channel_perm(ci_bits), device=dev)
                                 if ci_bits else None)
            self.decoder = _pick_decoder(rate, dev)

    def soft_bits(self, audio: torch.Tensor):
        """Sync, frame slice, demodulation and deinterleave: (sync, demod,
        codeword LLRs [B * 4, 648]), the decoder's input."""
        with span("rx.sync"):
            sync = self.sync(audio)
        with span("rx.demod"):
            # Undetected channels slice from 0; the start is clamped into the
            # window as jax.lax.dynamic_slice does.
            start = torch.clamp(torch.where(sync.detected, sync.lts_start, 0), 0,
                                max(self.window_samples - self.need, 0))
            frames = window_slice(audio.float(), start, self.need)
            demod = self.demod(frames, sync.cfo_hz)
            soft = demod.soft_bits[..., : self.num_bits][..., self.frame_idx]
            cw_soft = soft.reshape(-1, FRAME_CODEWORDS, LDPC_BITS)
            if self.ci_idx is not None:
                cw_soft = cw_soft[..., self.ci_idx]
            soft = cw_soft.reshape(-1, LDPC_BITS).contiguous()
        return sync, demod, soft

    def forward(self, audio: torch.Tensor) -> OFDMRxBatchResult:
        B = audio.shape[0]
        sync, demod, soft = self.soft_bits(audio)
        with span("rx.decode"):
            factors = torch.full((soft.shape[0],), self.min_sum_factor, dtype=torch.float32,
                                 device=soft.device)
            dec = self.decoder(soft, factors)
            k = dec.info_bits.shape[-1]
            return OFDMRxBatchResult(
                detected=sync.detected,
                lts_start=sync.lts_start,
                cfo_hz=sync.cfo_hz,
                cw_success=dec.success.reshape(B, FRAME_CODEWORDS) & sync.detected[:, None],
                info_bits=dec.info_bits.reshape(B, FRAME_CODEWORDS, k),
                iterations=dec.iterations.reshape(B, FRAME_CODEWORDS),
                snr_db=demod.snr_db,
            )


def make_ofdm_rx_pipeline(cfg: OFDMConfig, rate: str, window_samples: int,
                          ci_bits: int | None = None, batch_hint: int = 0,
                          min_sum_factor: float = 0.9375,
                          device: str | torch.device = "cuda",
                          preamble: str = "cox") -> OFDMRxPipeline:
    """Batched OFDM RX on ``device`` (the card by default; ``device="cpu"``
    for the host): audio [B, window_samples] -> OFDMRxBatchResult, for
    frames behind the Schmidl-Cox preamble (``preamble="cox"``) or the
    light one (``"lts"``; see :class:`OFDMRxPipeline`).

    ``batch_hint`` sits where the reference has it and changes nothing, as
    in :func:`make_rx_pipeline`."""
    return OFDMRxPipeline(cfg, rate, window_samples, ci_bits, min_sum_factor, device,
                          preamble)


class TxPipeline(nn.Module):
    """coded bits [B, NCW*648] -> audio [B, samples]: batched mirror of
    modulate() + preamble().  Buffers: synthesis bank, chirp, training."""

    def __init__(self, cfg: MCDPSKConfig, num_codewords: int,
                 device: str | torch.device = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        full_fp32_matmul()
        self.cfg = cfg
        self.num_bits = num_codewords * LDPC_BITS
        self.n_sym = cfg.num_data_symbols(self.num_bits)
        self.pad = self.n_sym * cfg.bits_per_mc_symbol - self.num_bits
        self.register_buffer("synth_t", torch.as_tensor(
            np.ascontiguousarray(_synth_matrix(cfg).T), device=dev))
        self.register_buffer("chirp", torch.as_tensor(chirp_generate(cfg.chirp), device=dev))
        self.register_buffer("train_syms", torch.as_tensor(_training_matrix(cfg), device=dev))
        self.register_buffer("dqpsk_phases", torch.tensor(
            [np.pi / 4, 3 * np.pi / 4, -3 * np.pi / 4, -np.pi / 4], dtype=torch.float32,
            device=dev))

    def forward(self, bits: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        B = bits.shape[0]
        b = nn.functional.pad(bits.float(), (0, self.pad))
        grouped = b.reshape(B, self.n_sym, cfg.num_carriers, cfg.bits_per_symbol)
        if cfg.bits_per_symbol == 2:
            val = (grouped[..., 0] * 2 + grouped[..., 1]).long()
            dphi = self.dqpsk_phases[val]
        else:
            dphi = grouped[..., 0] * np.pi
        phase = _xla_cumsum(dphi, dim=1)
        symbols = torch.polar(torch.ones((), device=bits.device), phase)  # [B, S, C]
        ref = torch.ones((B, 1, cfg.num_carriers), dtype=torch.complex64, device=bits.device)
        tr = self.train_syms.expand((B,) + tuple(self.train_syms.shape))
        allsym = torch.cat([tr, ref, torch.repeat_interleave(symbols, cfg.spreading, dim=1)],
                           dim=1)
        wave = (allsym @ self.synth_t).real / cfg.num_carriers  # [B, S_all, sps]
        body = wave.reshape(B, -1)
        return torch.cat([self.chirp.expand(B, -1), body], dim=-1)


def make_tx_pipeline(cfg: MCDPSKConfig, num_codewords: int,
                     device: str | torch.device = "cuda") -> TxPipeline:
    """Batch TX on ``device`` (the card by default): coded bits [B, NCW*648]
    -> audio [B, samples]."""
    return TxPipeline(cfg, num_codewords, device)
