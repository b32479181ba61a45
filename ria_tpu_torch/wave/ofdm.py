"""OFDM waveform (1024-pt FFT, CP 96, pilot-assisted MMSE equalization) in PyTorch.

Port of ``ria_tpu/wave/ofdm.py``.  Numeric contract from the reference:
- geometry: fft=1024 @ 48 kHz (46.875 Hz bins), 59 carriers symmetric around
  DC (bins -29..-1, +1..+30), CP 96 (MEDIUM), center 1500 Hz, output scale 40
  (include/ultra/types.hpp:195-267, src/ofdm/modulator.cpp:143-181);
- constellations: Gray BPSK/QPSK/QAM16/32/64/256 exactly as
  src/ofdm/modulator.cpp:14-106; differential DBPSK/DQPSK/D8PSK across time
  per carrier from an all-ones reference, D8PSK with 22.5 deg offset
  (:406-445);
- pilots: legacy every-pilot_spacing carriers, BPSK signs from
  mt19937(0x50494C54) raw draws (:195-200);
- preamble: [silence fft+cp][STS x4: sync seq on even FFT bins -> two
  identical time halves][LTS x2: sync seq on all carriers + pilots]
  (:479-532); chirp-mode uses LTS training only (:534-583);
- Schmidl-Cox: M(d)=|P|/sqrt(R1 R2), CFO = arg(P) fs/(pi N)
  (src/ofdm/ofdm_sync.cpp:133-260); LTS passband cross-correlation fine
  timing, earlier-LTS preference at 92%, accept threshold 0.05 @ 1024 FFT
  (:386-480);
- equalization: MMSE conj(H) y/(|H|^2+sigma^2), soft erasure below
  0.25x average |H|^2, carrier noise var in [1e-6, 100]
  (src/ofdm/channel_equalizer.cpp:1259-1340);
- soft demap: per-modulation LLR formulas with clip +/-20 and min mag 0.01,
  CE error margins, per-carrier EMA instability inflation (K=10)
  (src/ofdm/soft_demap.hpp, src/ofdm/demodulator.cpp:234-332).

The TX and the tables are host numpy, copied from the reference so the
constants match bit for bit.  The RX stages are modules whose constants are
buffers: :class:`SchmidlCoxDetector`, :class:`LTSDetector` and
:class:`OFDMDemodulator`; each is also reachable through a function of the
reference's name, which builds its module once per static configuration
(config, window or symbol counts, device) and caches it, as the reference
compiles once per ``static_argnames``.  Whole frames are demodulated at once: every symbol
CP-stripped and FFT'd in one batch (cuFFT on the card), equalized with a
broadcast H and demapped elementwise.  The per-carrier EMA chains are
first-order linear recurrences, computed as a log-depth prefix over their
affine maps (:func:`_affine_scan`); only D8PSK and the adaptive equalizer
loop over symbols.  Phase ramps stay in float32, as in the reference.
"""

from __future__ import annotations

import collections
import functools
import threading
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ria_tpu_torch.dsp.hilbert import analytic_signal
from ria_tpu_torch.dsp.util import _cis, _first_true, _rdiv, _sliding
from ria_tpu_torch.sync import sc_kernel
from ria_tpu_torch.sync.chirp import window_slice
from ria_tpu_torch.utils.device import resolve_device
from ria_tpu_torch.utils.mt19937 import MT19937
from ria_tpu_torch.utils.trace import span

PILOT_RNG_SEED = 0x50494C54
MAX_LLR = 20.0
MIN_LLR_MAG = 0.01
FADE_THRESHOLD_RATIO = 0.25
DEFAULT_SNR_LINEAR = 31.6
MIN_CARRIER_NOISE_VAR = 1e-6
MAX_CARRIER_NOISE_VAR = 100.0
CARRIER_ADAPTIVE_K = 10.0
MAG_EMA_ALPHA = 0.3

CE_MARGIN = {"DBPSK": 1.0, "DQPSK": 1.0, "BPSK": 1.0, "QPSK": 1.0, "D8PSK": 1.1,
             "QAM16": 1.2, "QAM32": 1.5, "QAM64": 1.8, "QAM256": 2.5}
BITS_PER_SYMBOL = {"BPSK": 1, "DBPSK": 1, "QPSK": 2, "DQPSK": 2, "D8PSK": 3,
                   "QAM16": 4, "QAM32": 5, "QAM64": 6, "QAM256": 8}
DIFFERENTIAL = ("DBPSK", "DQPSK", "D8PSK")


@dataclass(frozen=True)
class OFDMConfig:
    sample_rate: float = 48000.0
    center_freq: float = 1500.0
    fft_size: int = 1024
    num_carriers: int = 59
    # CP MEDIUM profile: base 48 x (1024/512) = 96 samples.  The modem
    # runtime's over-the-air CP: ModemEngine ctor pushes its ModemConfig
    # (cp_mode=MEDIUM, types.hpp:208) into the encoder/decoder via
    # setOFDMConfig, overriding the StreamingEncoder ctor's LONG default —
    # verified against `ria ptx` fixtures (30240-sample light frame =
    # 2x1120 LTS + 25x1120 data symbols).
    cp_len: int = 96
    symbol_guard: int = 0
    output_scale: float = 40.0
    use_pilots: bool = False
    pilot_spacing: int = 2
    modulation: str = "DQPSK"
    sync_threshold: float = 0.5
    # Optional decision-directed adaptive equalizer (LMS / RLS), coherent
    # modes only (reference channel_equalizer.cpp:1236-1369).
    adaptive_eq: bool = False
    adaptive_rls: bool = False
    lms_mu: float = 0.05
    rls_lambda: float = 0.99

    @property
    def symbol_samples(self) -> int:
        return self.fft_size + self.cp_len + self.symbol_guard

    @property
    def preamble_samples(self) -> int:
        """Schmidl-Cox preamble: guard + 4 STS + 2 LTS."""
        return self.symbol_samples + 6 * self.symbol_samples

    @property
    def num_data_carriers(self) -> int:
        return len(carrier_layout(self)[1])

    def bits_per_ofdm_symbol(self) -> int:
        return self.num_data_carriers * BITS_PER_SYMBOL[self.modulation]

    def num_symbols_for_bits(self, num_bits: int) -> int:
        return -(-num_bits // self.bits_per_ofdm_symbol())


@functools.lru_cache(maxsize=None)
def carrier_layout(cfg: OFDMConfig):
    """(all_bins, data_bins, pilot_bins) FFT bin indices (reference order)."""
    neg = cfg.num_carriers // 2
    pos = (cfg.num_carriers + 1) // 2
    all_bins, data_bins, pilot_bins = [], [], []
    count = 0
    for i in range(-neg, pos + 1):
        if i == 0:
            continue
        idx = (i + cfg.fft_size) % cfg.fft_size
        all_bins.append(idx)
        if cfg.use_pilots and count % cfg.pilot_spacing == 0:
            pilot_bins.append(idx)
        else:
            data_bins.append(idx)
        count += 1
    return (np.array(all_bins), np.array(data_bins), np.array(pilot_bins, dtype=np.int64))


@functools.lru_cache(maxsize=None)
def pilot_sequence(cfg: OFDMConfig) -> np.ndarray:
    """BPSK pilot signs from mt19937(\"PILT\") raw draws."""
    _, _, pilot_bins = carrier_layout(cfg)
    rng = MT19937(PILOT_RNG_SEED)
    return np.array([1.0 if (rng() & 1) else -1.0 for _ in range(len(pilot_bins))],
                    dtype=np.complex64)


@functools.lru_cache(maxsize=None)
def sync_sequence(cfg: OFDMConfig) -> np.ndarray:
    """Zadoff-Chu root 1, length num_carriers (modulator.cpp:183-193)."""
    N = cfg.num_carriers
    n = np.arange(N, dtype=np.float64)
    return np.exp(-1j * np.pi * 1 * n * (n + 1) / N).astype(np.complex64)


# ============================================================================
# Constellations (TX maps exactly matching modulator.cpp)
# ============================================================================

def _qam16_table():
    levels = np.array([-3, -1, 3, 1], np.float64)
    scale = 1 / np.sqrt(10)
    out = np.zeros(16, np.complex64)
    for b in range(16):
        out[b] = complex(levels[(b >> 2) & 3] * scale, levels[b & 3] * scale)
    return out


def _qam32_table():
    i_levels = [-3, -1, 1, 3]
    i_gray = [0, 1, 3, 2]
    q_levels = [-7, -5, -3, -1, 1, 3, 5, 7]
    q_gray = [0, 1, 3, 2, 6, 7, 5, 4]
    scale = 1 / np.sqrt(26)
    out = np.zeros(32, np.complex64)
    for b in range(32):
        qb, ib = (b >> 2) & 7, b & 3
        qi = q_gray.index(qb)
        ii = i_gray.index(ib)
        out[b] = complex(i_levels[ii] * scale, q_levels[qi] * scale)
    return out


def _qam64_table():
    levels = np.array([-7, -5, -1, -3, 7, 5, 1, 3], np.float64)
    scale = 1 / np.sqrt(42)
    out = np.zeros(64, np.complex64)
    for b in range(64):
        out[b] = complex(levels[(b >> 3) & 7] * scale, levels[b & 7] * scale)
    return out


def _qam256_table():
    levels = np.array([-15, -13, -9, -11, -1, -3, -7, -5, 15, 13, 9, 11, 1, 3, 7, 5], np.float64)
    scale = 1 / np.sqrt(170)
    out = np.zeros(256, np.complex64)
    for b in range(256):
        out[b] = complex(levels[(b >> 4) & 15] * scale, levels[b & 15] * scale)
    return out


@functools.lru_cache(maxsize=None)
def constellation_table(mod: str) -> np.ndarray:
    s = 1 / np.sqrt(2)
    if mod == "BPSK":
        return np.array([-1, 1], np.complex64)
    if mod == "QPSK":
        return np.array([complex(-s, -s), complex(-s, s), complex(s, -s), complex(s, s)],
                        np.complex64)
    if mod == "QAM16":
        return _qam16_table()
    if mod == "QAM32":
        return _qam32_table()
    if mod == "QAM64":
        return _qam64_table()
    if mod == "QAM256":
        return _qam256_table()
    if mod == "DBPSK":
        return np.array([1, -1], np.complex64)
    if mod == "DQPSK":
        return np.array([1, 1j, -1, -1j], np.complex64)
    if mod == "D8PSK":
        ang = np.arange(8) * (np.pi / 4) + np.pi / 8
        return np.exp(1j * ang).astype(np.complex64)
    raise ValueError(mod)


# ============================================================================
# TX (host numpy)
# ============================================================================

def _bits_to_carrier_symbols(bits: np.ndarray, cfg: OFDMConfig) -> np.ndarray:
    """bits -> per-carrier constellation/differential symbols [S, D].

    Carriers whose bit group starts past the end of the data transmit ZERO
    (the reference modulator's per-carrier loop exits when data runs out and
    pads the remaining carriers with 0 — modulator.cpp modulate(); only the
    last symbol is affected).  A carrier that straddles the end gets
    zero-padded bits and is still transmitted.
    """
    bpc = BITS_PER_SYMBOL[cfg.modulation]
    D = cfg.num_data_carriers
    per_sym = D * bpc
    S = -(-len(bits) // per_sym)
    padded = np.zeros(S * per_sym, np.int64)
    padded[: len(bits)] = bits
    grouped = padded.reshape(S, D, bpc)
    vals = np.zeros((S, D), np.int64)
    for b in range(bpc):
        vals = (vals << 1) | grouped[..., b]
    table = constellation_table(cfg.modulation)
    # Active mask: carrier (s, d) is transmitted iff its first bit index is
    # within the real data.
    start = (np.arange(S)[:, None] * D + np.arange(D)[None, :]) * bpc
    active = start < len(bits)
    if cfg.modulation in DIFFERENTIAL:
        rot = table[vals]
        sym = np.cumprod(rot, axis=0)  # differential from all-ones reference
        return np.where(active, sym, 0).astype(np.complex64)
    return np.where(active, table[vals], 0).astype(np.complex64)


def _ofdm_symbols_to_time(carrier_syms: np.ndarray, cfg: OFDMConfig,
                          include_pilots: bool = True) -> np.ndarray:
    """[S, D] -> complex time-domain CP+FFT symbols [S, sym_samples]."""
    _, data_bins, pilot_bins = carrier_layout(cfg)
    S = carrier_syms.shape[0]
    freq = np.zeros((S, cfg.fft_size), np.complex64)
    freq[:, data_bins] = carrier_syms
    if include_pilots and len(pilot_bins):
        freq[:, pilot_bins] = pilot_sequence(cfg)[None, :]
    td = np.fft.ifft(freq, axis=-1).astype(np.complex64)
    with_cp = np.concatenate([td[:, -cfg.cp_len:], td], axis=-1)
    if cfg.symbol_guard:
        with_cp = np.concatenate(
            [with_cp, np.zeros((S, cfg.symbol_guard), np.complex64)], axis=-1)
    return with_cp


def _mix_to_real(complex_stream: np.ndarray, cfg: OFDMConfig, tx_cfo_hz: float = 0.0) -> np.ndarray:
    """Continuous-phase upmix from t=0 + output scaling."""
    n = complex_stream.shape[-1]
    t = np.arange(n, dtype=np.float64)
    carrier = np.exp(2j * np.pi * (cfg.center_freq + tx_cfo_hz) * t / cfg.sample_rate)
    return (np.real(complex_stream * carrier) * cfg.output_scale).astype(np.float32)


def _sts_symbol(cfg: OFDMConfig) -> np.ndarray:
    """Schmidl-Cox STS: sync seq on even FFT bins among data carriers."""
    _, data_bins, _ = carrier_layout(cfg)
    seq = sync_sequence(cfg)
    freq = np.zeros(cfg.fft_size, np.complex64)
    for seq_idx, bin_idx in enumerate(data_bins):
        if bin_idx % 2 == 0:
            freq[bin_idx] = seq[seq_idx % len(seq)]
    td = np.fft.ifft(freq).astype(np.complex64)
    return np.concatenate([td[-cfg.cp_len:], td])


def _lts_symbol(cfg: OFDMConfig) -> np.ndarray:
    _, data_bins, _ = carrier_layout(cfg)
    seq = sync_sequence(cfg)
    lts_data = seq[np.arange(len(data_bins)) % len(seq)][None, :]
    return _ofdm_symbols_to_time(lts_data, cfg, include_pilots=True)[0]


def generate_preamble(cfg: OFDMConfig, tx_cfo_hz: float = 0.0) -> np.ndarray:
    """Full Schmidl-Cox preamble: silence + STS x4 + LTS x2 (passband)."""
    guard = np.zeros(cfg.fft_size + cfg.cp_len, np.float32)
    sts = _sts_symbol(cfg)
    lts = _lts_symbol(cfg)
    stream = np.concatenate([np.tile(sts, 4), np.tile(lts, 2)])
    return np.concatenate([guard, _mix_to_real(stream, cfg, tx_cfo_hz)])


def generate_training(cfg: OFDMConfig, count: int = 2, tx_cfo_hz: float = 0.0) -> np.ndarray:
    """LTS training symbols only (chirp-acquisition mode). NOTE: for phase
    coherence with modulate(), use tx_frame() which mixes in one stream."""
    lts = _lts_symbol(cfg)
    return _mix_to_real(np.tile(lts, count), cfg, tx_cfo_hz)


def modulate(bits: np.ndarray, cfg: OFDMConfig, tx_cfo_hz: float = 0.0,
             mixer_offset: int = 0) -> np.ndarray:
    """Data bits -> passband samples; mixer phase starts at sample mixer_offset."""
    syms = _bits_to_carrier_symbols(np.asarray(bits, np.int64), cfg)
    stream = _ofdm_symbols_to_time(syms, cfg).reshape(-1)
    n = stream.shape[0]
    t = (np.arange(n, dtype=np.float64) + mixer_offset)
    carrier = np.exp(2j * np.pi * (cfg.center_freq + tx_cfo_hz) * t / cfg.sample_rate)
    return (np.real(stream * carrier) * cfg.output_scale).astype(np.float32)


def tx_frame(bits: np.ndarray, cfg: OFDMConfig, preamble: str = "cox",
             training_count: int = 2, tx_cfo_hz: float = 0.0) -> np.ndarray:
    """Preamble + data in one phase-coherent stream.

    preamble="cox": silence + 4 STS + 2 LTS + data (OFDM-COX waveform).
    preamble="lts": training LTS only (chirp/ZC-synced waveforms prepend
    their own sync signal before this).
    """
    syms = _bits_to_carrier_symbols(np.asarray(bits, np.int64), cfg)
    data_stream = _ofdm_symbols_to_time(syms, cfg).reshape(-1)
    lts = _lts_symbol(cfg)
    if preamble == "cox":
        sts = _sts_symbol(cfg)
        stream = np.concatenate([np.tile(sts, 4), np.tile(lts, 2), data_stream])
        head = np.zeros(cfg.fft_size + cfg.cp_len, np.float32)
        return np.concatenate([head, _mix_to_real(stream, cfg, tx_cfo_hz)])
    stream = np.concatenate([np.tile(lts, training_count), data_stream])
    return _mix_to_real(stream, cfg, tx_cfo_hz)


# ============================================================================
# RX helpers
# ============================================================================

def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b]] for x [B, n] and idx [B]."""
    return torch.gather(x, 1, idx[:, None].long())[:, 0]


# ============================================================================
# RX: Schmidl-Cox search
# ============================================================================

class SCSyncResult(NamedTuple):
    detected: torch.Tensor
    lts_start: torch.Tensor  # int32 sample index of the FIRST LTS symbol
    cfo_hz: torch.Tensor
    metric: torch.Tensor     # SC correlation at detection
    lts_corr: torch.Tensor


# Coarse SC metric decimation: mix by the center-frequency NCO and box-sum
# groups of this many samples (the metric's plateau spans ~4 STS symbols, so
# the lag grid cannot miss it; the LTS correlation refines to the sample).
_SC_DEC = 8
# The search's other scalars, which the plain search and the kernels'
# ``sc_consts`` both take from here.
_SC_FLOOR = 1e-6       # the -60 dB energy floor, against the row's largest
_SC_RR_MIN = 1e-20     # the least R1 R2
_LTS_E_MIN = 1e-12     # the least slice energy times the template's
_LTS_PREV = 0.92       # the 92% rule
_LTS_R_MIN = 1e-12     # the least |r| that gives a fine CFO


def _lts_threshold(cfg: OFDMConfig) -> float:
    """The LTS correlation's detection threshold."""
    return 0.05 if cfg.fft_size >= 1024 else 0.35


def _turns(cfg: OFDMConfig, lag: int) -> complex:
    """exp(2j pi frac(fc lag / fs)): the turns the mix leaves in a product of
    samples ``lag`` apart, which the search undoes."""
    return complex(np.exp(2j * np.pi * float((cfg.center_freq * lag / cfg.sample_rate) % 1.0)))


def sc_consts(cfg: OFDMConfig, ref_energy: float) -> np.ndarray:
    """The search's scalars for its kernels (``enum Const`` of
    ``csrc/sc_search.cu``), float32 as ATen rounds them in the plain search:
    a Python scalar times a complex64 tensor as complex64, ``_rdiv``'s
    divisor as the float32 reciprocal."""
    N, sym, fs = cfg.fft_size, cfg.symbol_samples, cfg.sample_rate
    rot_half, rot_sym = np.complex64(_turns(cfg, N // 2)), np.complex64(_turns(cfg, sym))
    spacing = fs / sym
    one = np.float32(1.0)
    return np.array([
        rot_half.real, rot_half.imag, fs, one / np.float32(np.pi * N), fs / N,
        _SC_FLOOR, _SC_RR_MIN, ref_energy, _LTS_E_MIN, _LTS_PREV,
        rot_sym.real, rot_sym.imag, spacing, one / np.float32(2.0 * np.pi),
        one / np.float32(spacing), _LTS_R_MIN,
        cfg.sync_threshold, _lts_threshold(cfg),
    ], dtype=np.float32)


class SchmidlCoxDetector(nn.Module):
    """Schmidl-Cox preamble search over windows of ``num_samples``:
    samples [..., num_samples] -> SCSyncResult (per leading index).

    The SC metric gates detection and gives the coarse CFO; the LTS
    cross-correlation in a slice around the expected LTS gives the timing;
    the LTS repeat pair's phase gives the fine CFO.  Buffers: the mixer NCO
    over the whole window (``rot``), the conjugated spectrum of the LTS
    template (``lts_fft``) and the search's scalars for its kernels
    (``sc_consts``).  A CUDA tensor is searched by the CUDA kernels of
    ``sync/sc_kernel.py`` (loaded here on a CUDA device, so that the first
    call pays nothing for them), a CPU tensor by :meth:`search_plain`; the
    two agree bit for bit on the card.
    """

    def __init__(self, cfg: OFDMConfig, num_samples: int,
                 device: str | torch.device = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.n = num_samples
        self.short = num_samples < cfg.preamble_samples + 64
        if self.short:
            return
        sym = cfg.symbol_samples
        nblk = num_samples // _SC_DEC
        # rot = exp(-2j pi (fc/fs) t) with t and the phase in float32, as
        # the reference forms it.
        t_full = torch.arange(nblk * _SC_DEC, dtype=torch.float32, device=dev)
        w = np.float32(-2.0 * np.pi * (cfg.center_freq / cfg.sample_rate))
        self.register_buffer("rot", _cis(t_full * float(w)))
        lts = _lts_symbol(cfg)
        self.L = len(lts)
        # The LTS as TX'd after the 4 STS symbols (the mixer phase offset
        # does not change the correlation magnitude).
        lts_analytic = np.asarray(
            np.exp(2j * np.pi * cfg.center_freq * (np.arange(self.L) + 4 * sym)
                   / cfg.sample_rate) * lts * cfg.output_scale, np.complex64)
        self.ref_energy = float(np.sum(np.abs(lts_analytic) ** 2)) * 0.5
        # The SC argmax can land anywhere on its ~4-symbol plateau, so the
        # candidate span covers the whole plateau.
        self.span = 4 * sym + sym // 2
        self.R = self.span + self.L + _SC_DEC
        self.nfft = 1 << (self.R - 1).bit_length()
        spec = torch.fft.fft(torch.as_tensor(lts_analytic, device=dev), self.nfft)
        self.register_buffer("lts_fft", torch.conj(spec).resolve_conj())
        self.register_buffer("sc_consts", torch.as_tensor(sc_consts(cfg, self.ref_energy),
                                                          device=dev))
        if dev.type == "cuda":
            sc_kernel.load()

    def forward(self, samples: torch.Tensor) -> SCSyncResult:
        shape = samples.shape[:-1]
        if samples.shape[-1] != self.n:
            raise ValueError(f"window of {samples.shape[-1]} samples, built for {self.n}")
        dev = samples.device
        if self.short:
            f = torch.zeros(shape, dtype=torch.float32, device=dev)
            return SCSyncResult(torch.zeros(shape, dtype=torch.bool, device=dev),
                                torch.full(shape, -1, dtype=torch.int32, device=dev), f, f, f)
        x = samples.reshape(-1, self.n).float()
        res = sc_kernel.search(self, x) if x.is_cuda else self.search_plain(x)
        return SCSyncResult(*(v.reshape(shape) for v in res))

    def search_plain(self, x: torch.Tensor) -> SCSyncResult:
        """The search in PyTorch operations over x [B, n] float32: what CPU
        tensors run, and what the kernels compute on the card."""
        cfg = self.cfg
        B, n = x.shape
        N = cfg.fft_size
        half = N // 2
        sym = cfg.symbol_samples
        L = self.L

        # The mix opens the search and the decision closes it outside the
        # spans of its parts, as in ``ChirpDetector._zoom``: the caller's
        # ``rx.sync`` keeps a device-side range over the whole search.
        # Coarse SC metric on the mixed, box-summed complex baseband.
        nblk = n // _SC_DEC
        zb = (x[:, : nblk * _SC_DEC] * self.rot).reshape(B, nblk, _SC_DEC).sum(-1)
        with span("sync.coarse"):
            half_d = half // _SC_DEC
            zc_d = torch.conj(zb[:, :-half_d]) * zb[:, half_d:]
            absz2_d = torch.square(torch.abs(zb))
            P = _sliding(zc_d, half_d)
            R1 = _sliding(absz2_d, half_d)
            R2 = _sliding(absz2_d[:, half_d:], half_d)
            m = min(P.shape[-1], R2.shape[-1])
            P, R1, R2 = P[:, :m], R1[:, :m], R2[:, :m]
            # -60 dB energy floor: silence holds only numeric residue, and
            # dividing by its energy would mint false metric peaks.
            rr = R1 * R2
            rr_floor = _SC_FLOOR * torch.amax(rr, dim=-1, keepdim=True)
            M = torch.abs(P) / torch.sqrt(torch.clamp_min(torch.maximum(rr, rr_floor),
                                                          _SC_RR_MIN))

            # Offset d has data_start = d + cp -> decimated index (d + cp) / DEC.
            cp_d = cfg.cp_len // _SC_DEC
            num_lags = max(m - cp_d, 1)
            Md = M[:, cp_d : cp_d + num_lags]
            peak_d = torch.argmax(Md, dim=-1)
            peak_val = _take(Md, peak_d)
            peak = peak_d.to(torch.int32) * _SC_DEC

            # Coarse CFO at the peak; the mix leaves fc*half/fs turns in the
            # lag-half product, whose fractional part is undone here.
            P_peak = _take(P[:, cp_d : cp_d + num_lags], peak_d) * _turns(cfg, half)
            cfo = _rdiv(torch.angle(P_peak) * cfg.sample_rate, np.pi * N)
            max_cfo = cfg.sample_rate / N
            cfo = torch.clamp(cfo, -max_cfo, max_cfo)

        with span("sync.fine"):
            # LTS fine timing: FFT cross-correlation in a slice around the
            # expected LTS (peak + 4 symbols), normalized by the slice energy.
            R = self.R
            expected = peak + 4 * sym
            lo = torch.clamp(expected - 4 * sym, 0, max(n - R, 0))
            sl = window_slice(x, lo, R)
            X = torch.fft.fft(sl.to(torch.complex64), self.nfft)
            xc = torch.fft.ifft(X * self.lts_fft)[:, : R - L]
            e = _sliding(torch.square(sl), L)[:, : xc.shape[-1]]
            e_floor = _SC_FLOOR * torch.amax(e, dim=-1, keepdim=True)
            corr = torch.abs(xc) / torch.sqrt(
                torch.clamp_min(torch.maximum(e, e_floor) * self.ref_energy, _LTS_E_MIN))

            # Candidates: [expected - 3 sym, expected + sym/2] relative to lo.
            lags = torch.arange(corr.shape[-1], dtype=torch.int32, device=x.device)
            lo_rel = (expected - 4 * sym - lo)[:, None]
            hi_rel = (expected + sym // 2 - lo)[:, None]
            masked = torch.where((lags >= lo_rel) & (lags <= hi_rel), corr, -1.0)
            pos_rel = torch.argmax(masked, dim=-1).to(torch.int32)
            lts_val = _take(masked, pos_rel)

            # Prefer the earlier of the two LTS repeats (92% rule).
            prev_rel = torch.clamp_min(pos_rel - sym, 0)
            prev_val = _take(corr, prev_rel)
            take_prev = (pos_rel >= sym) & (prev_val >= lts_val * _LTS_PREV)
            pos_rel = torch.where(take_prev, prev_rel, pos_rel)
            lts_val = torch.where(take_prev, prev_val, lts_val)
            lts_pos = lo + pos_rel

            # Fine CFO from the LTS repeat pair on the analytic signal of the
            # slice (the 2fc image would fold the pair product onto the real
            # axis), wrap-resolved against the coarse SC estimate.
            seg_len = sym + L
            seg = window_slice(x, torch.clamp(lts_pos, 0, max(n - seg_len, 0)), seg_len)
            segz = analytic_signal(seg)
            r = torch.sum(segz[:, :L] * torch.conj(segz[:, sym : sym + L]), dim=-1)
            r = r * _turns(cfg, sym)
            spacing = cfg.sample_rate / sym
            cfo_fine = _rdiv(-torch.angle(r) * spacing, 2.0 * np.pi)
            k = torch.round(_rdiv(cfo - cfo_fine, spacing))
            cfo = torch.where(torch.abs(r) > _LTS_R_MIN, cfo_fine + k * spacing, cfo)

        detected = (peak_val > cfg.sync_threshold) & (lts_val > _lts_threshold(cfg))
        return SCSyncResult(
            detected=detected,
            lts_start=torch.where(detected, lts_pos, -1).to(torch.int32),
            cfo_hz=torch.where(detected, cfo, 0.0),
            metric=peak_val,
            lts_corr=lts_val,
        )


@functools.lru_cache(maxsize=64)
def schmidl_cox_detector(cfg: OFDMConfig, num_samples: int,
                         device: str | torch.device = "cuda") -> SchmidlCoxDetector:
    """Cached :class:`SchmidlCoxDetector` for a (config, window, device)."""
    return SchmidlCoxDetector(cfg, num_samples, device)


def schmidl_cox_search(samples: torch.Tensor, cfg: OFDMConfig) -> SCSyncResult:
    """Find the preamble in a window (batched over leading axes), on the
    samples' device."""
    return schmidl_cox_detector(cfg, samples.shape[-1], samples.device)(samples)


# ============================================================================
# RX: LTS search (light preamble)
# ============================================================================

class LTSSyncResult(NamedTuple):
    detected: torch.Tensor
    lts_start: torch.Tensor
    corr: torch.Tensor
    cfo_hz: torch.Tensor
    # LTS repeats at the sync point: 2 = normal frame, 3 = burst marker.
    repeats: torch.Tensor


class LTSDetector(nn.Module):
    """LTS search by passband cross-correlation over windows of
    ``num_samples`` (light-preamble frames, no STS): samples
    [..., num_samples] -> LTSSyncResult.

    Takes the EARLIEST correlation above ``threshold`` (several back-to-back
    frames can share a window), centres on its local peak, walks back to the
    first LTS repeat (92% rule, twice, for 3-repeat burst preambles), then to
    the earliest tap within 0.6x of the peak (late lock under multipath is
    outside the CP's safe zone).  CFO from the phase between the two LTS
    repeats.  Buffer: the conjugated spectrum of the LTS template mixed from
    t = 0 (``lts_fft``).
    """

    def __init__(self, cfg: OFDMConfig, num_samples: int, threshold: float = 0.5,
                 device: str | torch.device = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.n = num_samples
        self.threshold = threshold
        lts = _lts_symbol(cfg)
        self.L = L = len(lts)
        self.short = num_samples < 2 * L + 64
        if self.short:
            return
        lts_analytic = np.asarray(
            np.exp(2j * np.pi * cfg.center_freq * np.arange(L) / cfg.sample_rate) * lts
            * cfg.output_scale, np.complex64)
        self.ref_energy = float(np.sum(np.abs(lts_analytic) ** 2)) * 0.5
        self.nfft = 1 << (num_samples + L - 1).bit_length()
        spec = torch.fft.fft(torch.as_tensor(lts_analytic, device=dev), self.nfft)
        self.register_buffer("lts_fft", torch.conj(spec).resolve_conj())

    def forward(self, samples: torch.Tensor) -> LTSSyncResult:
        shape = samples.shape[:-1]
        if samples.shape[-1] != self.n:
            raise ValueError(f"window of {samples.shape[-1]} samples, built for {self.n}")
        dev = samples.device
        if self.short:
            f = torch.zeros(shape, dtype=torch.float32, device=dev)
            return LTSSyncResult(torch.zeros(shape, dtype=torch.bool, device=dev),
                                 torch.full(shape, -1, dtype=torch.int32, device=dev), f, f,
                                 torch.full(shape, 2, dtype=torch.int32, device=dev))
        res = self._search(samples.reshape(-1, self.n).float())
        return LTSSyncResult(*(v.reshape(shape) for v in res))

    def _search(self, x: torch.Tensor) -> LTSSyncResult:
        cfg = self.cfg
        n, L = self.n, self.L
        sym = cfg.symbol_samples
        dev = x.device
        X = torch.fft.fft(x.to(torch.complex64), self.nfft)
        xc = torch.fft.ifft(X * self.lts_fft)[:, : max(n - L, 1)]
        e = _sliding(torch.square(x), L)[:, : xc.shape[-1]]
        # -60 dB energy floor (digital silence must not mint corr > 1 peaks).
        e_floor = 1e-6 * torch.amax(e, dim=-1, keepdim=True)
        corr = torch.abs(xc) / torch.sqrt(
            torch.clamp_min(torch.maximum(e, e_floor) * self.ref_energy, 1e-12))
        last = corr.shape[-1] - 1

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

        # First-significant-tap refinement: the earliest lag within one echo
        # span (48 samples) whose correlation clears 0.6x the peak, then its
        # local lobe maximum (12 samples).
        offs = torch.arange(-48, 1, device=dev)
        widx = torch.clamp(pos[:, None] + offs, 0, last)
        strong = torch.gather(corr, 1, widx) >= 0.6 * val[:, None]
        edge = _take(widx, _first_true(strong))
        lidx = torch.clamp(edge[:, None] + torch.arange(12, device=dev), 0, last)
        refined = _take(lidx, torch.argmax(torch.gather(corr, 1, lidx), dim=-1))
        refined = torch.minimum(refined, pos)
        pos = torch.where(det, refined, pos)
        val = _take(corr, pos)

        # CFO from the inter-repeat phase of the two LTS symbols.
        pos2 = torch.clamp_max(pos + sym, xc.shape[-1] - 1)
        xc1, xc2 = _take(xc, pos), _take(xc, pos2)
        val2 = _take(corr, pos2)
        dphi = torch.angle(xc2 * torch.conj(xc1))
        cfo = _rdiv(dphi * cfg.sample_rate, 2.0 * np.pi * sym)
        cfo = torch.where(val2 >= 0.5 * val, cfo, 0.0)
        # Burst marker: a third LTS repeat.
        val3 = _take(corr, torch.clamp_max(pos + 2 * sym, last))
        repeats = torch.where(val3 >= 0.5 * val, 3, 2).to(torch.int32)
        pos = pos.to(torch.int32)
        return LTSSyncResult(det, torch.where(det, pos, -1).to(torch.int32), val, cfo, repeats)


@functools.lru_cache(maxsize=64)
def lts_detector(cfg: OFDMConfig, num_samples: int, threshold: float = 0.5,
                 device: str | torch.device = "cuda") -> LTSDetector:
    """Cached :class:`LTSDetector` for a (config, window, threshold, device)."""
    return LTSDetector(cfg, num_samples, threshold, device)


def lts_search(samples: torch.Tensor, cfg: OFDMConfig, threshold: float = 0.5) -> LTSSyncResult:
    """Find an LTS training symbol in a window (batched over leading axes),
    on the samples' device."""
    return lts_detector(cfg, samples.shape[-1], threshold, samples.device)(samples)


# ============================================================================
# RX: presynced demodulation
# ============================================================================

class OFDMDemodResult(NamedTuple):
    soft_bits: torch.Tensor      # [..., S*D*bps]
    snr_db: torch.Tensor
    noise_var: torch.Tensor
    fading_index: torch.Tensor   # CV of |H| over data carriers
    channel_mag: torch.Tensor    # [..., D]
    symbols: torch.Tensor        # [..., S, D] equalized data-carrier symbols


COHERENT = ("BPSK", "QPSK", "QAM16", "QAM32", "QAM64", "QAM256")

# The equaliser path of each ``from_bins`` call since start-up (or since a
# caller last cleared it), by name: "pilot_tracking" (coherent, two or more
# pilots), "common_phase" (the broadcast MMSE, with a pilots' phase correction
# where there are pilots), "adaptive" (LMS / RLS) or "d8psk" (the sequential
# two-pass correction).  The path is a host decision, so counting it costs no
# device sync.  Stations demodulate from threads of their own, so it moves
# under a lock.
EQ_PATHS: collections.Counter[str] = collections.Counter()
_EQ_LOCK = threading.Lock()


def _demap(mod: str, eq: torch.Tensor, prev: torch.Tensor, nv: torch.Tensor,
           table: torch.Tensor | None = None) -> torch.Tensor:
    """Per-carrier demap -> LLRs [..., D, bps]. ``prev`` only for
    differential modes, ``table`` (the constellation) only for QAM32.
    LLR > 0 => bit 0 (reference convention)."""
    def clip(v):
        c = torch.clamp(v, -MAX_LLR, MAX_LLR)
        return torch.where(torch.abs(c) < MIN_LLR_MAG,
                           torch.where(c >= 0, MIN_LLR_MAG, -MIN_LLR_MAG), c)

    I, Q = eq.real, eq.imag
    if mod == "BPSK":
        return clip(-2.0 * I / nv)[..., None]
    if mod == "QPSK":
        scale = -2.0 * (1 / np.sqrt(2)) / nv
        return clip(torch.stack([I * scale, Q * scale], dim=-1))
    if mod == "QAM16":
        thr = 2 / np.sqrt(10)
        s = 2.0 / nv
        return clip(torch.stack([-s * I, s * (torch.abs(I) - thr),
                                 -s * Q, s * (torch.abs(Q) - thr)], dim=-1))
    if mod == "QAM32":
        d2 = torch.square(torch.abs(eq[..., None] - table))  # [..., D, 32]
        bits = torch.arange(32, device=eq.device)
        s = 2.0 / nv
        llrs = []
        for b in range(5):
            mask1 = ((bits >> (4 - b)) & 1) == 1
            d1 = torch.amin(torch.where(mask1, d2, torch.inf), dim=-1)
            d0 = torch.amin(torch.where(~mask1, d2, torch.inf), dim=-1)
            llrs.append(s * (d1 - d0))
        return clip(torch.stack(llrs, dim=-1))
    if mod == "QAM64":
        d4, d2c = 4 / np.sqrt(42), 2 / np.sqrt(42)
        s = 2.0 / nv
        aI, aQ = torch.abs(I), torch.abs(Q)
        return clip(torch.stack([
            -s * I, s * (aI - d4), s * (torch.abs(aI - d4) - d2c),
            -s * Q, s * (aQ - d4), s * (torch.abs(aQ - d4) - d2c)], dim=-1))
    if mod == "QAM256":
        d8, d4c, d2c = 8 / np.sqrt(170), 4 / np.sqrt(170), 2 / np.sqrt(170)
        s = 2.0 / nv
        aI, aQ = torch.abs(I), torch.abs(Q)
        return clip(torch.stack([
            -s * I, s * (aI - d8), s * (torch.abs(aI - d8) - d4c),
            s * (torch.abs(torch.abs(aI - d8) - d4c) - d2c),
            -s * Q, s * (aQ - d8), s * (torch.abs(aQ - d8) - d4c),
            s * (torch.abs(torch.abs(aQ - d8) - d4c) - d2c)], dim=-1))

    # Differential modes
    diff = eq * torch.conj(prev)
    dI, dQ = diff.real, diff.imag
    signal_power = torch.abs(eq) * torch.abs(prev)
    weak = signal_power < 1e-6
    diff_nv = 2.0 * nv
    if mod == "DBPSK":
        phase = torch.atan2(dQ, dI)
        conf = 2.0 * signal_power / diff_nv
        llr = clip(conf * torch.cos(phase))
        return torch.where(weak[..., None], 0.0, llr[..., None])
    if mod == "DQPSK":
        mag = torch.abs(diff)
        snr_lin = signal_power / diff_nv
        scale = 2.0 * torch.sqrt(snr_lin)
        phase = torch.atan2(dQ, dI)
        l0 = clip(scale * torch.sin(phase + np.pi / 4))
        l1 = clip(scale * (torch.abs(dI) - torch.abs(dQ)) / torch.clamp_min(mag, 1e-9))
        out = torch.stack([l0, l1], dim=-1)
        return torch.where((mag < 1e-6)[..., None], 0.0, out)
    if mod == "D8PSK":
        phase = torch.atan2(dQ, dI)
        conf = signal_power / diff_nv
        out = torch.stack([clip(conf * torch.sin(phase)),
                           clip(conf * torch.sin(2 * phase)),
                           clip(conf * torch.sin(4 * phase))], dim=-1)
        return torch.where(weak[..., None], 0.0, out)
    raise ValueError(mod)


def _affine_scan(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix of s_n = A_n * s_{n-1} + B_n along axis -2 from
    s_{-1} = 0: the states after each step.  Log-depth (Hillis-Steele)
    doubling over the affine maps: after the step of offset o, (A_n, B_n)
    is the composition of the maps n-2o+1 .. n.  The reference's
    ``jax.lax.associative_scan`` composes in another order, so the two agree
    to float32 rounding, not bit for bit."""
    n = A.shape[-2]
    off = 1
    while off < n:
        A_lo, B_lo = A[..., : n - off, :], B[..., : n - off, :]
        A_hi, B_hi = A[..., off:, :], B[..., off:, :]
        B = torch.cat([B[..., :off, :], A_hi * B_lo + B_hi], dim=-2)
        A = torch.cat([A[..., :off, :], A_hi * A_lo], dim=-2)
        off *= 2
    return B


def _affine_prefix(x: torch.Tensor, init: torch.Tensor, alpha: float) -> torch.Tensor:
    """BEFORE-step states of the EMA recurrence s_n = (1-a)*s_{n-1} + a*x_n
    along axis -2: out[..., n, :] = state after consuming x[..., :n, :],
    out[..., 0, :] = init."""
    a = 1.0 - alpha
    A = torch.full_like(x, a)
    B = alpha * x
    # Fold the init into the first element so the scan starts from zero.
    B = torch.cat([B[..., :1, :] + a * init[..., None, :], B[..., 1:, :]], dim=-2)
    after = _affine_scan(A, B)
    return torch.cat([init[..., None, :], after[..., :-1, :]], dim=-2)


@functools.lru_cache(maxsize=None)
def _pilot_interp(cfg: OFDMConfig) -> np.ndarray:
    """[D, P] linear weights interpolating pilot values onto data carriers
    (carrier order), constant beyond the outermost pilots."""
    pos = np.cumsum(np.ones(cfg.num_carriers)) - 1  # 0..58 carrier order
    order_bins, _, order_pilot = carrier_layout(cfg)
    is_pilot = np.isin(order_bins, order_pilot)
    pos_pilot = pos[is_pilot]
    pos_data = pos[~is_pilot]
    W = np.zeros((len(pos_data), len(pos_pilot)), np.float32)
    for di, pd in enumerate(pos_data):
        j = int(np.searchsorted(pos_pilot, pd))
        if j == 0:
            W[di, 0] = 1.0
        elif j >= len(pos_pilot):
            W[di, -1] = 1.0
        else:
            t = (pd - pos_pilot[j - 1]) / (pos_pilot[j] - pos_pilot[j - 1])
            W[di, j - 1] = 1.0 - t
            W[di, j] = t
    return W


class OFDMDemodulator(nn.Module):
    """Presynced demodulator for frames of ``training_symbols`` LTS +
    ``num_data_symbols`` data symbols: (samples [..., >= (T+S)*sym] starting
    at the first LTS, cfo_hz [...]) -> OFDMDemodResult.

    Buffers: the float32 time ramp of the downmix (``t``), the data and
    pilot bin indices, the known LTS and pilot values, the pilot
    interpolation matrix (``w_t``) and the constellation (``table``).
    """

    def __init__(self, cfg: OFDMConfig, num_data_symbols: int, training_symbols: int = 2,
                 device: str | torch.device = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.S = num_data_symbols
        self.T = training_symbols
        self.need = (self.T + self.S) * cfg.symbol_samples
        _, data_bins, pilot_bins = carrier_layout(cfg)
        self.D, self.P = len(data_bins), len(pilot_bins)
        seq = sync_sequence(cfg)
        # t = arange(need) / fs in float32, as the compiled reference forms it.
        self.register_buffer("t", _rdiv(torch.arange(self.need, dtype=torch.float32,
                                                     device=dev), cfg.sample_rate))
        self.register_buffer("data_bins", torch.as_tensor(data_bins, device=dev))
        self.register_buffer("pilot_bins", torch.as_tensor(pilot_bins, device=dev))
        self.register_buffer("lts_data", torch.as_tensor(
            seq[np.arange(self.D) % len(seq)], device=dev))
        self.register_buffer("pilots", torch.as_tensor(pilot_sequence(cfg), device=dev))
        self.register_buffer("w_t", torch.as_tensor(
            np.ascontiguousarray(_pilot_interp(cfg).T), device=dev).to(torch.complex64)
            if self.P > 1 else None)
        self.register_buffer("table", torch.as_tensor(constellation_table(cfg.modulation),
                                                      device=dev))

    def forward(self, samples: torch.Tensor, cfo_hz: torch.Tensor) -> OFDMDemodResult:
        cfg = self.cfg
        x = samples[..., : self.need].float()
        # Downmix at fc + cfo: phase = (-2 pi (fc + cfo)) * t in float32.
        w = (cfg.center_freq + torch.as_tensor(cfo_hz, dtype=torch.float32,
                                               device=x.device)) * float(np.float32(-2.0 * np.pi))
        bb = x.to(torch.complex64) * _cis(w[..., None] * self.t)
        syms = bb.reshape(bb.shape[:-1] + (self.T + self.S, cfg.symbol_samples))
        core = syms[..., cfg.cp_len : cfg.cp_len + cfg.fft_size]
        freq = torch.fft.fft(core, dim=-1)  # [..., T+S, fft]
        Y_data = freq[..., self.data_bins]
        Y_pilot = freq[..., self.pilot_bins] if self.P else None
        return self.from_bins(Y_data, Y_pilot)

    def from_bins(self, Y_data: torch.Tensor, Y_pilot: torch.Tensor | None) -> OFDMDemodResult:
        """Back half of the demodulator from the per-symbol carrier bins
        Y [..., T+S, D] (and the pilots' [..., T+S, P])."""
        cfg = self.cfg
        T, S, D = self.T, self.S, self.D
        mod = cfg.modulation
        tracking = mod in COHERENT and Y_pilot is not None and self.P > 1
        if cfg.adaptive_eq and mod in COHERENT:
            path = "adaptive"
        elif mod == "D8PSK":
            path = "d8psk"
        else:
            path = "pilot_tracking" if tracking else "common_phase"
        with _EQ_LOCK:
            EQ_PATHS[path] += 1

        with span("demod.equalize"):
            # LTS channel estimate: H = mean(Y / X_known) over training symbols.
            H_data = torch.mean(Y_data[..., :T, :] / self.lts_data, dim=-2)  # [..., D]
            if Y_pilot is not None:
                H_pilot = torch.mean(Y_pilot[..., :T, :] / self.pilots, dim=-2)

            # Noise variance from the LTS repeat difference.
            if T >= 2:
                d = Y_data[..., 1, :] - Y_data[..., 0, :]
                noise_var = torch.mean(torch.square(torch.abs(d)), dim=-1) / 2.0
            else:
                noise_var = (torch.mean(torch.square(torch.abs(H_data)), dim=-1)
                             / DEFAULT_SNR_LINEAR)
            noise_var = torch.clamp_min(noise_var, 1e-9)

            h_power = torch.square(torch.abs(H_data))
            avg_h_power = torch.mean(h_power, dim=-1, keepdim=True)
            fade_thr = FADE_THRESHOLD_RATIO * avg_h_power

            Yd = Y_data[..., T:, :]  # [..., S, D]
            nv = noise_var[..., None, None]
            if tracking:
                # Per-symbol pilot TRACKING: the ratio H_s/H_lts at each pilot,
                # clamped, time-EMA'd from the LTS baseline (ratio 1),
                # interpolated across carriers, re-scaling the dense LTS estimate.
                Hp_s = Y_pilot[..., T:, :] / self.pilots               # [..., S, P]
                base = torch.where(torch.abs(H_pilot) > 1e-9, H_pilot, 1.0 + 0j)
                ratio = Hp_s / base[..., None, :]
                rmag = torch.abs(ratio)
                ratio = ratio * (torch.clamp(rmag, 0.25, 4.0) / torch.clamp_min(rmag, 1e-9))
                a = 0.35
                A = torch.full_like(ratio, 1.0 - a)
                # seed r~_{-1} = 1: the first element's B is (1-a)*1 + a*r_0
                Bv = a * ratio
                Bv = torch.cat([Bv[..., :1, :] + (1.0 - a), Bv[..., 1:, :]], dim=-2)
                ratio_s = _affine_scan(A, Bv)
                R = ratio_s @ self.w_t                                  # [..., S, D]
                # Near-AWGN gate (CV of |H| <= 0.15): pilot-weighted common
                # phase/gain only; a selective channel keeps the per-carrier ratio.
                h_mag0 = torch.abs(H_data)
                cv0 = torch.std(h_mag0, dim=-1, correction=0) / torch.clamp_min(
                    torch.mean(h_mag0, dim=-1), 1e-9)
                wgt = torch.square(torch.abs(base))[..., None, :]
                r_common = (torch.sum(ratio_s * wgt, dim=-1)
                            / torch.clamp_min(torch.sum(wgt, dim=-1), 1e-12))
                R = torch.where((cv0 > 0.15)[..., None, None], R, r_common[..., None])
                H_s = H_data[..., None, :] * R
                hp_s = torch.square(torch.abs(H_s))
                denom = hp_s + nv
                eq = Yd * torch.conj(H_s) / torch.clamp_min(denom, 1e-10)
                carrier_nv = nv / torch.clamp_min(denom, 1e-10)
                carrier_nv = torch.where(hp_s < fade_thr[..., None, :],
                                         MAX_CARRIER_NOISE_VAR, carrier_nv)
                carrier_nv = torch.clamp(carrier_nv, MIN_CARRIER_NOISE_VAR, MAX_CARRIER_NOISE_VAR)
            else:
                # Pilot-based common phase correction per data symbol.
                if Y_pilot is not None and self.P > 0:
                    expect = H_pilot[..., None, :] * self.pilots
                    rot = torch.sum(Y_pilot[..., T:, :] * torch.conj(expect), dim=-1)  # [..., S]
                    Yd = Yd * _cis(-torch.angle(rot))[..., None]
                # MMSE equalization (broadcast over symbols).
                denom = h_power[..., None, :] + nv
                eq = Yd * torch.conj(H_data[..., None, :]) / torch.clamp_min(denom, 1e-10)
                carrier_nv = nv / torch.clamp_min(denom, 1e-10)
                carrier_nv = torch.where(h_power[..., None, :] < fade_thr[..., None, :],
                                         MAX_CARRIER_NOISE_VAR, carrier_nv)
                carrier_nv = torch.clamp(carrier_nv, MIN_CARRIER_NOISE_VAR, MAX_CARRIER_NOISE_VAR)
            carrier_nv = carrier_nv.expand(eq.shape)

        ce_margin = CE_MARGIN[mod]
        h_mag = torch.abs(H_data)
        mean_h = torch.mean(h_mag, dim=-1)
        fading = torch.where(mean_h > 1e-9, torch.std(h_mag, dim=-1, correction=0)
                             / torch.clamp_min(mean_h, 1e-9), 0.0)
        snr_db = 10.0 * torch.log10(torch.clamp_min(avg_h_power[..., 0] / noise_var, 1e-6))

        with span("demod.demap"):
            if cfg.adaptive_eq and mod in COHERENT:
                llrs, eq = self._adaptive(Yd, H_data, noise_var, ce_margin)
            elif mod == "D8PSK":
                llrs = self._d8psk(eq, carrier_nv, ce_margin, fading)
            else:
                # Symbol-parallel path: the differential reference is the
                # previous symbol's equalized value, and the EMA/variance
                # instability chain is a first-order linear recurrence.
                mags = torch.abs(eq)                       # [..., S, D]
                ema_before = _affine_prefix(mags, mags[..., 0, :], MAG_EMA_ALPHA)
                delta = mags - ema_before
                var_before = _affine_prefix(delta * delta, torch.zeros_like(mags[..., 0, :]),
                                            MAG_EMA_ALPHA)
                norm_var = var_before / torch.clamp_min(ema_before * ema_before, 1e-6)
                nv_eff = carrier_nv * ce_margin * (1.0 + CARRIER_ADAPTIVE_K * norm_var)
                prev_all = torch.cat([torch.ones_like(eq[..., :1, :]), eq[..., :-1, :]], dim=-2)
                llrs = _demap(mod, eq, prev_all, nv_eff, self.table)  # [..., S, D, bps]
            soft = llrs.reshape(llrs.shape[:-3] + (S * D * BITS_PER_SYMBOL[mod],))
        return OFDMDemodResult(soft_bits=soft, snr_db=snr_db, noise_var=noise_var,
                               fading_index=fading, channel_mag=h_mag, symbols=eq)

    def _d8psk(self, eq, carrier_nv, ce_margin, fading_pre):
        """Sequential D8PSK: the two-pass phase correction (gated on a
        fading index > 0.30) rotates each symbol before it becomes the next
        symbol's differential reference."""
        ema = torch.abs(eq[..., 0, :])
        var = torch.zeros_like(ema)
        prev = torch.ones_like(eq[..., 0, :])
        out = []
        for s in range(self.S):
            eq_s, nv_s = eq[..., s, :], carrier_nv[..., s, :]
            mag = torch.abs(eq_s)
            delta = mag - ema
            norm_var = var / torch.clamp_min(ema * ema, 1e-6)
            nv_eff = nv_s * ce_margin * (1.0 + CARRIER_ADAPTIVE_K * norm_var)
            ema = ema + MAG_EMA_ALPHA * delta
            var = var + MAG_EMA_ALPHA * (delta * delta - var)
            # Pass 1: weighted circular-mean phase error against the
            # embedded DQPSK grid; pass 2: a 50% correction when
            # 3 deg < |err| < 15 deg (demodulator.cpp:533-630).
            diff = eq_s * torch.conj(prev)
            power = torch.abs(eq_s) * torch.abs(prev)
            phase = torch.angle(diff)
            quad = torch.round(_rdiv(phase - np.pi / 4, np.pi / 2))
            err = phase - (quad * (np.pi / 2) + np.pi / 4)
            err = torch.where(err > np.pi, err - 2 * np.pi, err)
            err = torch.where(err < -np.pi, err + 2 * np.pi, err)
            w = torch.where(power > 0.1, power, 0.0)
            mean_err = torch.where(torch.sum(w, dim=-1) > 0.1,
                                   torch.atan2(torch.sum(w * torch.sin(err), dim=-1),
                                               torch.sum(w * torch.cos(err), dim=-1)), 0.0)
            apply = ((torch.abs(mean_err) > 0.05) & (torch.abs(mean_err) < 0.26)
                     & (fading_pre > 0.30))
            eq_s = eq_s * _cis(torch.where(apply, -0.5 * mean_err, 0.0))[..., None]
            out.append(_demap("D8PSK", eq_s, prev, nv_eff))
            prev = eq_s
        return torch.stack(out, dim=-3)

    def _adaptive(self, Yd, H_data, noise_var, ce_margin):
        """Decision-directed LMS/RLS (channel_equalizer.cpp:1343-1369):
        per-carrier weights from the LTS estimate; equalize each symbol with
        the current weights, then update toward the hard decision."""
        cfg, mod, table = self.cfg, self.cfg.modulation, self.table
        nv0 = noise_var[..., None]
        w = H_data.expand(Yd[..., 0, :].shape)
        P = torch.ones(w.shape, dtype=torch.float32, device=w.device)
        ema = torch.abs(Yd[..., 0, :] * torch.conj(w)
                        / torch.clamp_min(torch.square(torch.abs(w)) + nv0, 1e-10))
        var = torch.zeros_like(ema)
        prev = torch.ones_like(w)
        llrs, eqs = [], []
        for s in range(self.S):
            y_s = Yd[..., s, :]
            denom = torch.clamp_min(torch.square(torch.abs(w)) + nv0, 1e-10)
            eq_s = y_s * torch.conj(w) / denom
            nv_s = torch.clamp(nv0 / denom, MIN_CARRIER_NOISE_VAR, MAX_CARRIER_NOISE_VAR)
            delta = torch.abs(eq_s) - ema
            norm_var = var / torch.clamp_min(ema * ema, 1e-6)
            nv_eff = nv_s * ce_margin * (1.0 + CARRIER_ADAPTIVE_K * norm_var)
            ema = ema + MAG_EMA_ALPHA * delta
            var = var + MAG_EMA_ALPHA * (delta * delta - var)
            llrs.append(_demap(mod, eq_s, prev, nv_eff, table))
            eqs.append(eq_s)
            dec = table[torch.argmin(torch.square(torch.abs(eq_s[..., None] - table)), dim=-1)]
            errv = y_s - w * dec
            if cfg.adaptive_rls:
                ref_norm = torch.square(torch.abs(dec))
                k = P / (cfg.rls_lambda + P * ref_norm)
                w = w + k * torch.conj(dec) * errv
                P = torch.clamp(_rdiv(P - k * ref_norm * P, cfg.rls_lambda), 1e-3, 1e3)
            else:
                w = w + cfg.lms_mu * torch.conj(dec) * errv
            prev = eq_s
        return torch.stack(llrs, dim=-3), torch.stack(eqs, dim=-2)


@functools.lru_cache(maxsize=64)
def ofdm_demodulator(cfg: OFDMConfig, num_data_symbols: int, training_symbols: int = 2,
                     device: str | torch.device = "cuda") -> OFDMDemodulator:
    """Cached :class:`OFDMDemodulator` for a (config, symbol counts, device)."""
    return OFDMDemodulator(cfg, num_data_symbols, training_symbols, device)


def demodulate_presynced(samples: torch.Tensor, cfo_hz: torch.Tensor, cfg: OFDMConfig,
                         num_data_symbols: int, training_symbols: int = 2) -> OFDMDemodResult:
    """Demodulate [T training LTS + S data] symbols starting at the first
    LTS, on the samples' device.  samples: [..., (T+S)*symbol_samples]
    passband audio; CFO is removed by a complex downmix at fc + cfo."""
    return ofdm_demodulator(cfg, num_data_symbols, training_symbols,
                            samples.device)(samples, cfo_hz)


def demodulate_from_bins(Y_data: torch.Tensor, Y_pilot: torch.Tensor | None,
                         cfg: OFDMConfig, num_data_symbols: int,
                         training_symbols: int = 2) -> OFDMDemodResult:
    """Demod back half from the per-symbol carrier bins Y [..., T+S, D]
    (continuous-downmix convention of :func:`demodulate_presynced`)."""
    return ofdm_demodulator(cfg, num_data_symbols, training_symbols,
                            Y_data.device).from_bins(Y_data, Y_pilot)
