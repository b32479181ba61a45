"""AFDM (Affine Frequency Division Multiplexing) via the discrete affine
Fourier transform (DAFT), in PyTorch.

Port of ``ria_tpu/wave/afdm.py``.  Contract from the reference
(src/afdm/daft.hpp, src/afdm/afdm_config.hpp):
- DAFT basis exp(j 2 pi (c1 n^2 + c2 m^2 + m n / N)), implemented as
  chirp-multiply -> FFT -> chirp-multiply;
- documented negative finding (afdm_config.hpp:33-47): chirped AFDM (c1>0)
  is incompatible with narrowband real audio (image overlap after DSB), so
  the HF audio profile runs c1=0 — which reduces AFDM to OFDM.  We reproduce
  both the transform (for completeness/testing) and the c1=0 audio profile.

``daft`` and ``idaft`` are torch FFTs in complex64 on their input's device;
the block (de)modulators take host arrays, as in ``ria_tpu``, and run the
transform on ``device``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ria_tpu_torch.dsp.hilbert import analytic_signal
from ria_tpu_torch.fec.ldpc import decode_with_retries
from ria_tpu_torch.phy.frame_v2 import encode_frame_ldpc
from ria_tpu_torch.phy.modem import as_audio, host_scalars
from ria_tpu_torch.sync import zc as zc_sync
from ria_tpu_torch.utils.bits import bits_to_bytes
from ria_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True)
class AFDMConfig:
    N: int = 64            # subcarriers / block length
    c1: float = 0.0        # quadratic chirp rate (0 => OFDM mode for HF audio)
    c2: float = 0.0
    fft_size: int = 512
    cp_len: int = 64
    sample_rate: float = 48000.0
    center_freq: float = 1500.0


def _chirp(c: float, N: int, sign: float, device: torch.device) -> torch.Tensor:
    """exp(sign * 2j pi c n^2) for n < N as complex64, the phase in float32."""
    n = torch.arange(N, dtype=torch.float32, device=device)
    phase = (sign * 2.0 * math.pi * c) * n * n
    return torch.polar(torch.ones_like(phase), phase)


def daft(x: torch.Tensor, cfg: AFDMConfig) -> torch.Tensor:
    """Forward DAFT along the last axis: chirp -> FFT -> chirp."""
    N = cfg.N
    x = x.to(torch.complex64)
    c_pre = _chirp(cfg.c1, N, -1.0, x.device)
    c_post = _chirp(cfg.c2, N, -1.0, x.device)
    return c_post * torch.fft.fft(x * c_pre, dim=-1) / math.sqrt(N)


def idaft(y: torch.Tensor, cfg: AFDMConfig) -> torch.Tensor:
    """Inverse DAFT: conj-chirp -> IFFT -> conj-chirp."""
    N = cfg.N
    y = y.to(torch.complex64)
    c_pre = _chirp(cfg.c1, N, 1.0, y.device)
    c_post = _chirp(cfg.c2, N, 1.0, y.device)
    return c_pre * torch.fft.ifft(y * c_post, dim=-1) * math.sqrt(N)


def modulate_block(symbols: np.ndarray, cfg: AFDMConfig,
                   device: str | torch.device = "cuda") -> np.ndarray:
    """AFDM symbols [..., N] -> passband samples of each block (audio
    profile), the inverse DAFT on ``device``."""
    dev = resolve_device(device)
    symbols = np.asarray(symbols)
    time_block = idaft(torch.as_tensor(symbols.astype(np.complex64), device=dev),
                       cfg).cpu().numpy()
    freq = np.zeros(symbols.shape[:-1] + (cfg.fft_size,), np.complex64)
    freq[..., 1 : 1 + cfg.N] = time_block
    td = np.fft.ifft(freq, axis=-1).astype(np.complex64)
    with_cp = np.concatenate([td[..., -cfg.cp_len :], td], axis=-1)
    t = np.arange(with_cp.shape[-1], dtype=np.float64)
    carrier = np.exp(2j * np.pi * cfg.center_freq * t / cfg.sample_rate)
    return (np.real(with_cp * carrier) * 20.0).astype(np.float32)


def demodulate_block(samples: np.ndarray, cfg: AFDMConfig,
                     device: str | torch.device = "cuda") -> np.ndarray:
    """Passband blocks [..., cp + fft] -> AFDM symbols [..., N] (zero CFO,
    known timing), the DAFT on ``device``."""
    dev = resolve_device(device)
    samples = np.asarray(samples)
    t = np.arange(samples.shape[-1], dtype=np.float64)
    bb = samples.astype(np.complex64) * np.exp(
        -2j * np.pi * cfg.center_freq * t / cfg.sample_rate)
    core = bb[..., cfg.cp_len : cfg.cp_len + cfg.fft_size]
    freq = np.fft.fft(core, axis=-1)[..., 1 : 1 + cfg.N]
    return daft(torch.as_tensor(freq.astype(np.complex64), device=dev), cfg).cpu().numpy()


# ============================================================================
# Experimental AFDM waveform (factory-gated; never auto-negotiated)
# ============================================================================
#
# The reference builds its AFDM stack into ultra_core but never wires it
# into WaveformFactory (SURVEY.md §2.3); this wrapper goes one step
# further and makes the c1=0 audio profile an actually-creatable,
# roundtrip-tested waveform: ZC-synced frames of DAFT blocks, DQPSK
# differential ACROSS BLOCKS per bin (a training block provides the
# phase reference — the in-band diversity the reference says to get
# "through interleaving instead of chirps"), LDPC R1/4 coded.

AFDM_ACTIVE_LO = 6          # active DAFT bins [lo, lo+count): ~560-3375 Hz
AFDM_ACTIVE_COUNT = 30      # 30 carriers ~ the reference's audio profile


def _shift_real(x, shift_hz: float, fs: float,
                device: str | torch.device = "cuda") -> np.ndarray:
    """True frequency shift of a REAL passband signal: analytic signal (on
    ``device``, or where a tensor lies) -> complex rotate -> real part."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x, np.float32), device=resolve_device(device))
    z = analytic_signal(x).cpu().numpy()
    t = np.arange(x.shape[-1], dtype=np.float64)
    return (z * np.exp(2j * np.pi * shift_hz * t / fs)).real.astype(np.float32)


class AFDMWaveform:
    """Experimental c1=0 AFDM waveform (see module docstring).

    API mirrors the light-preamble data path of the other waveforms:
    tx_frame(frame_bytes) -> passband audio; rx_frame(audio) ->
    (ok, frame_bytes | None, info dict).  Chirped profiles (c1 > 0) are
    rejected at construction for audio use — the reference's documented
    negative finding (afdm_config.hpp:33-47).  It has no ``mode`` or
    ``modulation`` attribute, as in ``ria_tpu``: it is reached through
    ``create_waveform(WaveformMode.AFDM)`` only, never through the CLI."""

    mode_name = "AFDM"

    def __init__(self, rate: str = "R1_4", cfg: AFDMConfig | None = None,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg or AFDMConfig()
        if self.cfg.c1 != 0.0:
            raise ValueError(
                "chirped AFDM (c1>0) is incompatible with narrowband real "
                "audio (image overlap after DSB; afdm_config.hpp:33-47) — "
                "use c1=0 for the HF audio profile")
        self.rate = rate
        self.zc_cfg = zc_sync.ZCConfig()
        self._bits_per_block = 2 * AFDM_ACTIVE_COUNT

    @property
    def block_samples(self) -> int:
        return self.cfg.cp_len + self.cfg.fft_size

    def _blocks_for_bits(self, num_bits: int) -> int:
        return -(-num_bits // self._bits_per_block)

    def frame_samples(self, num_codewords: int = 1) -> int:
        nb = self._blocks_for_bits(num_codewords * 648)
        return self.zc_cfg.preamble_samples + (1 + nb) * self.block_samples

    # ------------------------------------------------------------------ TX
    def tx_frame(self, frame_bytes: bytes, light: bool = True,
                 tx_cfo_hz: float = 0.0) -> np.ndarray:
        cw_bits = encode_frame_ldpc(frame_bytes, self.rate, None)
        bits = np.asarray(cw_bits).reshape(-1)
        nb = self._blocks_for_bits(len(bits))
        bits = np.concatenate([bits, np.zeros(nb * self._bits_per_block - len(bits),
                                              bits.dtype)])
        # DQPSK across blocks per active bin.  Quadrant map matches the
        # shared demap formulas (l0 = sin(ang+45deg) -> b0 splits
        # {0,90} vs {180,270}; l1 = |dI|-|dQ| -> b1 splits axes vs
        # diagonals): quad = b0*2 + b1, natural binary.
        pairs = bits.reshape(nb, AFDM_ACTIVE_COUNT, 2)
        quad = pairs[..., 0] * 2 + pairs[..., 1]
        phase = np.cumsum(quad * (np.pi / 2), axis=0)  # differential chain
        syms = np.zeros((1 + nb, self.cfg.N), np.complex64)
        active = slice(AFDM_ACTIVE_LO, AFDM_ACTIVE_LO + AFDM_ACTIVE_COUNT)
        syms[0, active] = 1.0                          # reference block
        syms[1:, active] = np.exp(1j * phase).astype(np.complex64)
        out = [np.asarray(zc_sync.generate_preamble(self.zc_cfg, zc_sync.ZC_DATA),
                          np.float32)]
        out.append(modulate_block(syms, self.cfg, self.device).reshape(-1))
        audio = np.concatenate(out).astype(np.float32)
        if tx_cfo_hz:
            audio = _shift_real(audio, tx_cfo_hz, self.cfg.sample_rate, self.device)
        return audio

    # ------------------------------------------------------------------ RX
    def rx_frame(self, audio, num_codewords: int = 1):
        """-> (ok, frame_bytes | None, info).  Variable-CW frames are sized
        by the caller (tests use 1 CW); sync via the ZC data preamble."""
        audio = as_audio(audio, self.device)
        res = zc_sync.detect(audio.samples, self.zc_cfg, root_mask=zc_sync.ROOT_MASK_DATA)
        detected, start, cfo = host_scalars(res.detected, res.start_sample, res.cfo_hz)
        if not detected:
            return False, None, {"detected": False}
        start = int(start)
        num_bits = num_codewords * 648
        nb = self._blocks_for_bits(num_bits)
        bs = self.block_samples
        need = (1 + nb) * bs
        # CFO-correct the whole span, then per-block DAFT demod.  A real
        # signal must go through the analytic signal first: multiplying the
        # REAL samples by a complex exponential and taking .real is an
        # amplitude modulation (cos envelope with nulls), not a frequency
        # shift.
        seg_c = _shift_real(audio.chunk(start, need), -cfo, self.cfg.sample_rate)
        sl = AFDM_ACTIVE_LO
        zs = demodulate_block(seg_c.reshape(1 + nb, bs), self.cfg,
                              self.device)[:, sl : sl + AFDM_ACTIVE_COUNT]
        diff = zs[1:] * np.conj(zs[:-1])            # [nb, carriers]
        power = np.mean(np.abs(zs) ** 2)
        nv = max(np.var(np.abs(zs[1:]) - np.sqrt(power)), 1e-6)
        scale = min(2.0 * power / nv, 40.0)
        ang = np.angle(diff)
        l0 = np.clip(scale * np.sin(ang + np.pi / 4), -20, 20)
        l1 = np.clip(scale * (np.abs(diff.real) - np.abs(diff.imag))
                     / np.maximum(np.abs(diff), 1e-9), -20, 20)
        soft = np.stack([l0, l1], axis=-1).reshape(-1)[:num_bits]
        dec = decode_with_retries(
            np.asarray(soft, np.float32).reshape(num_codewords, 648), self.rate,
            device=self.device)
        oks = dec.success.cpu().numpy()
        if not oks.all():
            return False, None, {"detected": True, "cw_ok": oks}
        info_bits = dec.info_bits.cpu().numpy()
        chunks = [bits_to_bytes(info_bits[i]) for i in range(num_codewords)]
        fb = b"".join(chunks)
        return True, fb, {"detected": True, "cw_ok": oks, "cfo_hz": cfo,
                          "start": start}
