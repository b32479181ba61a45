"""Watterson HF channel model (ITU-R F.1487) in PyTorch, with injectable draws.

Port of ``ria_tpu/sim/channel.py``.  Model contract from the reference
(src/sim/hf_channel.hpp:35-303):
- two independent Rayleigh taps: complex one-pole IIR (alpha =
  1 - exp(-2 pi fd/fs)) driven by complex white Gaussian noise with
  std sqrt(1/alpha) per component, magnitude-only fading applied to the
  real signal;
- two-path multipath: direct + delayed (delay_spread_ms), gains 0.707/0.707;
- AWGN with sigma = rms(non-zero samples) * 10^(-SNR/20);
- CFO as a true SSB shift (the reference package's deliberate deviation,
  see ``_cfo_shift_block``);
- ITU-R presets: Good 0.5ms/0.1Hz, Moderate 1.0/0.5, Poor 2.0/1.0,
  Flutter 0.5/10, AWGN-only.

Every signal operation runs on ``device`` (default the card).  The AR(1)
fading recurrence is the reference's associative scan, in its evaluation
order (:func:`ar1_scan`).

Random draws.  ``jax.random`` and torch draw different streams, so every
function here takes its standard normals from outside, in the shapes the
reference draws them (``draws``, a mapping of arrays or tensors):

- :func:`init_channel_state`: ``h1``, ``h2`` [..., 2] (the two tap carries);
- :func:`apply_channel_stream`: ``fade1``, ``fade2`` [..., N, 2] and
  ``noise`` [..., N];
- :func:`apply_channel`: those three plus ``init1``, ``init2`` [..., 2];

each may be absent when the configuration does not use it.  The scales
(``sqrt(1/alpha)``, the stationary ``init_std``, the noise sigma) are applied
here, as the reference applies them after its draw.  :class:`GeneratorDraws`
makes them from a seeded ``torch.Generator``; a caller that replays another
source (the tests replay ``jax.random``'s keys) hands its own arrays.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Mapping, NamedTuple

import numpy as np
import torch

from ria_tpu_torch.dsp.fir import design_lowpass, fir_filter
from ria_tpu_torch.utils.device import resolve_device

@dataclass(frozen=True)
class ChannelConfig:
    snr_db: float = 15.0
    delay_spread_ms: float = 2.0
    doppler_spread_hz: float = 1.0
    cfo_hz: float = 0.0
    path1_gain: float = 0.707
    path2_gain: float = 0.707
    sample_rate: float = 48000.0
    fading_enabled: bool = True
    multipath_enabled: bool = True
    noise_enabled: bool = True
    cfo_enabled: bool = True

    @property
    def delay_samples(self) -> int:
        return int(self.delay_spread_ms * self.sample_rate / 1000.0)

    @property
    def fading_alpha(self) -> float:
        nd = self.doppler_spread_hz / self.sample_rate
        return 1.0 - float(np.exp(-2.0 * np.pi * nd))

    @property
    def uses_multipath(self) -> bool:
        return self.multipath_enabled and self.delay_samples > 0

    @property
    def uses_cfo(self) -> bool:
        return self.cfo_enabled and abs(self.cfo_hz) > 1e-3


def awgn(snr_db: float = 15.0) -> ChannelConfig:
    return ChannelConfig(snr_db=snr_db, delay_spread_ms=0.0, doppler_spread_hz=0.0,
                         path1_gain=1.0, path2_gain=0.0, fading_enabled=False,
                         multipath_enabled=False)


def good(snr_db: float = 20.0) -> ChannelConfig:
    return ChannelConfig(snr_db=snr_db, delay_spread_ms=0.5, doppler_spread_hz=0.1)


def moderate(snr_db: float = 20.0) -> ChannelConfig:
    return ChannelConfig(snr_db=snr_db, delay_spread_ms=1.0, doppler_spread_hz=0.5)


def poor(snr_db: float = 20.0) -> ChannelConfig:
    return ChannelConfig(snr_db=snr_db, delay_spread_ms=2.0, doppler_spread_hz=1.0)


def flutter(snr_db: float = 20.0) -> ChannelConfig:
    return ChannelConfig(snr_db=snr_db, delay_spread_ms=0.5, doppler_spread_hz=10.0)


PRESETS = {"awgn": awgn, "good": good, "moderate": moderate, "poor": poor, "flutter": flutter}


# ------------------------------------------------------------------- draws
class GeneratorDraws:
    """Standard normals for the channel from a seeded ``torch.Generator``.

    The generator lives on ``generator_device`` (default ``device``) and the
    draws are moved to ``device``: two channels on different devices fed by
    generators on one device get the same numbers.  Only the draws a
    configuration uses are made, in a fixed order (``h1``, ``h2`` once;
    then per block ``init1``, ``fade1``, ``init2``, ``fade2``, ``noise``)."""

    def __init__(self, seed: int, device: str | torch.device = "cuda",
                 generator_device: str | torch.device | None = None):
        self.device = resolve_device(device)
        gdev = resolve_device(generator_device) if generator_device is not None else self.device
        self.generator = torch.Generator(device=gdev)
        self.generator.manual_seed(int(seed))
        self._gdev = gdev

    def _normal(self, shape: tuple) -> torch.Tensor:
        z = torch.randn(shape, generator=self.generator, device=self._gdev, dtype=torch.float32)
        return z.to(self.device)

    def init(self, batch_shape: tuple = ()) -> dict:
        """The two tap carries of :func:`init_channel_state`."""
        return {"h1": self._normal(tuple(batch_shape) + (2,)),
                "h2": self._normal(tuple(batch_shape) + (2,))}

    def stream_block(self, shape: tuple, cfg: ChannelConfig) -> dict:
        """One block's draws for :func:`apply_channel_stream`."""
        return self._block(tuple(shape), cfg, with_init=False)

    def block(self, shape: tuple, cfg: ChannelConfig) -> dict:
        """The draws of one :func:`apply_channel` call."""
        return self._block(tuple(shape), cfg, with_init=True)

    def _block(self, shape: tuple, cfg: ChannelConfig, with_init: bool) -> dict:
        out = {}
        if cfg.fading_enabled:
            taps = ("1", "2") if cfg.uses_multipath else ("1",)
            for t in taps:
                if with_init:
                    out["init" + t] = self._normal(shape[:-1] + (2,))
                out["fade" + t] = self._normal(shape + (2,))
        if cfg.noise_enabled:
            out["noise"] = self._normal(shape)
        return out


def _draw(draws: Mapping, name: str, shape: tuple, device: torch.device) -> torch.Tensor:
    if name not in draws or draws[name] is None:
        raise KeyError(f"the channel needs the draw {name!r} of shape {shape}")
    z = torch.as_tensor(draws[name], dtype=torch.float32, device=device)
    if tuple(z.shape) != tuple(shape):
        raise ValueError(f"draw {name!r} has shape {tuple(z.shape)}, {tuple(shape)} expected")
    return z


def _complex(v: torch.Tensor, scale: float) -> torch.Tensor:
    """complex(v[..., 0], v[..., 1]) of a [..., 2] draw scaled in float32."""
    v = v * scale
    return torch.complex(v[..., 0], v[..., 1])


# --------------------------------------------------------------- AR(1) scan
def _affine_scan(A: torch.Tensor, B: torch.Tensor):
    """Inclusive scan of the affine maps y -> A y + B along the last axis,
    combined as (a2 a1, a2 b1 + b2), in the evaluation order of
    ``jax.lax.associative_scan``: pair neighbours, scan the pairs, then fix
    up the even elements.  The order is the reference's float32 rounding,
    which parts from the exact recurrence by more than the port is held to
    (3.5e-5 of the tap RMS at Moderate's Doppler, 2.1e-4 at Good's,
    tests/test_torch_channel.py); this order reproduces it bit for bit on
    the CPU, where an exact evaluation would not.  Depth log2(N)."""
    n = A.shape[-1]
    if n < 2:
        return A, B
    a1, b1 = A[..., 0:-1:2], B[..., 0:-1:2]
    a2, b2 = A[..., 1::2], B[..., 1::2]
    odd_a, odd_b = _affine_scan(a2 * a1, a2 * b1 + b2)
    if n % 2 == 0:
        prev_a, prev_b = odd_a[..., :-1], odd_b[..., :-1]
    else:
        prev_a, prev_b = odd_a, odd_b
    xa, xb = A[..., 2::2], B[..., 2::2]
    even_a = torch.cat([A[..., :1], xa * prev_a], dim=-1)
    even_b = torch.cat([B[..., :1], xa * prev_b + xb], dim=-1)
    out_a, out_b = torch.empty_like(A), torch.empty_like(B)
    out_a[..., 0::2], out_a[..., 1::2] = even_a, odd_a
    out_b[..., 0::2], out_b[..., 1::2] = even_b, odd_b
    return out_a, out_b


def ar1_scan(drive: torch.Tensor, alpha: float, init: torch.Tensor) -> torch.Tensor:
    """y[n] = (1-alpha) y[n-1] + alpha x[n] with y[-1] = ``init``.

    ``drive`` [..., N] complex64, ``init`` [...] complex64.  The recurrence
    is an associative scan over affine maps (:func:`_affine_scan`), so its
    depth is log2(N) elementwise steps instead of N sequential ones, and
    every factor is a power of (1 - alpha) <= 1: nothing overflows where the
    closed form a^n (init + cumsum(b a^-k)) would (a^-9600 ~ e^12.6 at
    Flutter's Doppler)."""
    b = alpha * drive
    A = torch.full(drive.shape, 1.0 - alpha, dtype=drive.dtype, device=drive.device)
    As, Bs = _affine_scan(A, b)
    return As * init[..., None] + Bs


class ChannelResult(NamedTuple):
    samples: torch.Tensor
    fading_mag: torch.Tensor  # tap-1 magnitude trace (diagnostics)


def _noise_std(x: torch.Tensor, cfg: ChannelConfig, last_rms: torch.Tensor | None):
    """(noise sigma [..., 1], the new last_rms or None): the per-block SNR
    normalization against the non-zero-sample RMS (hf_channel.hpp:110-128),
    with the streaming form's stationary-noise memory when ``last_rms`` is
    given."""
    n = x.shape[-1]
    nz = (torch.abs(x) > 1e-6).float()
    nzs = torch.sum(nz, dim=-1, keepdim=True)
    count = torch.clamp(nzs, min=1.0)
    power = torch.sum(torch.square(x) * nz, dim=-1, keepdim=True) / count
    if last_rms is None:
        input_rms = torch.where(nzs > 0, torch.sqrt(power), torch.full_like(power, 0.1))
        new_last = None
    else:
        # A block must carry a >10% signal fraction to set the noise level;
        # silence blocks keep the last signal-bearing block's (the reference
        # package's stationary-noise deviation, including the stale-level
        # behaviour it keeps for blocks under that fraction).
        has_signal = nzs > 0.1 * n
        input_rms = torch.where(has_signal, torch.sqrt(power), last_rms)
        new_last = input_rms
    return input_rms * (10.0 ** (-cfg.snr_db / 20.0)), new_last


def apply_channel(x, cfg: ChannelConfig, draws: Mapping,
                  device: str | torch.device = "cuda") -> ChannelResult:
    """Pass samples [..., N] through the channel. Batched over leading axes.

    The one-shot form: the echo path is a roll plus a ramp (no history),
    the fading taps start from ``init1``/``init2`` drawn from the stationary
    distribution."""
    dev = resolve_device(device)
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    n = x.shape[-1]
    shape = tuple(x.shape)
    noise_std, _ = _noise_std(x, cfg, None)

    out = x
    h1_mag = torch.ones_like(x)
    if cfg.fading_enabled:
        alpha = cfg.fading_alpha
        scale = float(np.sqrt(1.0 / alpha))
        # Stationary AR(1) state variance per component, 1/(2-alpha): the
        # channel is statistically stationary from sample 0.
        init_std = float(np.sqrt(1.0 / (2.0 - alpha)))

        def fade(tap):
            drive = _complex(_draw(draws, "fade" + tap, shape + (2,), dev), scale)
            init = _complex(_draw(draws, "init" + tap, shape[:-1] + (2,), dev), init_std)
            return ar1_scan(drive, alpha, init)

        h1_mag = torch.abs(fade("1"))
        if cfg.uses_multipath:
            h2 = fade("2")
            d = cfg.delay_samples
            ramp = (torch.arange(n, device=dev) >= d).float()
            delayed = torch.roll(x, d, dims=-1) * ramp
            out = x * cfg.path1_gain * h1_mag + delayed * cfg.path2_gain * torch.abs(h2)
        else:
            out = x * h1_mag
    elif cfg.uses_multipath:
        d = cfg.delay_samples
        ramp = (torch.arange(n, device=dev) >= d).float()
        delayed = torch.roll(x, d, dims=-1)
        out = x * cfg.path1_gain + delayed * ramp * cfg.path2_gain

    if cfg.noise_enabled:
        out = out + noise_std * _draw(draws, "noise", shape, dev)

    if cfg.uses_cfo:
        zeros = x.new_zeros(shape[:-1])
        tail0 = x.new_zeros(shape[:-1] + (_CFO_LP_TAPS - 1,))
        out = _cfo_shift_block(out, cfg, tail0, tail0, zeros, zeros)[0]
    return ChannelResult(out, h1_mag)


_MIX_HZ = 1500.0         # SSB shift mixer (channel band center)
_CFO_LP_TAPS = 193       # windowed-sinc lowpass for the SSB shift:
_CFO_LP_CUTOFF = 1550.0  # passband covers the full +-1350 Hz audio band,
#                          stopband reaches the first image term at 1800 Hz.


@functools.lru_cache(maxsize=4)
def _cfo_lp_taps(fs: float) -> np.ndarray:
    return design_lowpass(_CFO_LP_TAPS, _CFO_LP_CUTOFF, fs).astype(np.float32)


def _phase_ramp(phase: torch.Tensor, w: float, n: int) -> torch.Tensor:
    """float32 ``phase[..., None] + f32(w) * arange(n)`` rounded once, as
    the reference's compiled CPU code evaluates it (a fused multiply-add).
    Rounding the product first moves a 1,885-rad mixer phase by up to
    1.22e-4 rad (tests/test_torch_channel.py).  The float64 sum is exact,
    so its rounding to float32 is the fused result on every device."""
    idx = torch.arange(n, dtype=torch.float64, device=phase.device)
    w32 = float(np.float32(w))
    return (phase.double()[..., None] + w32 * idx).float()


def _cfo_shift_block(x: torch.Tensor, cfg: ChannelConfig,
                     i_tail: torch.Tensor, q_tail: torch.Tensor,
                     cfo_phase: torch.Tensor, mix_phase: torch.Tensor):
    """One block of the streaming SSB shift; returns (out, i_tail, q_tail,
    cfo_phase, mix_phase).  Causal FIR -> streamed == one-shot exactly.

    The reference package's DELIBERATE DEVIATION from the reference's
    applyCFO (src/sim/hf_channel.hpp:182-241), kept: a conjugate mix to
    baseband at 1500 Hz, a 193-tap lowpass, the rotation by the CFO and the
    mix back — a physically correct shift, where the reference's mix keeps
    the inverted copy and its 48-tap boxcar cuts the band."""
    fs = cfg.sample_rate
    n = x.shape[-1]
    h = _cfo_lp_taps(fs)
    w_mix = 2.0 * np.pi * _MIX_HZ / fs
    w_cfo = 2.0 * np.pi * cfg.cfo_hz / fs
    mix = _phase_ramp(mix_phase, w_mix, n)
    cm, sm = torch.cos(mix), torch.sin(mix)
    # Conjugate mix-down keeps the positive-frequency copy at f - fc.
    i_bb = x * cm
    q_bb = -x * sm
    i_f, i_tail = fir_filter(i_bb, h, i_tail)
    q_f, q_tail = fir_filter(q_bb, h, q_tail)
    ph = _phase_ramp(cfo_phase, w_cfo, n)
    c, s = torch.cos(ph), torch.sin(ph)
    i_r = i_f * c - q_f * s
    q_r = i_f * s + q_f * c
    out = 2.0 * (i_r * cm - q_r * sm)
    two_pi = 2.0 * np.pi
    return (out, i_tail, q_tail,
            torch.remainder(cfo_phase + w_cfo * n, two_pi),
            torch.remainder(mix_phase + w_mix * n, two_pi))


# ---------------------------------------------------------------- streaming
# Block-streaming channel: the same model as apply_channel, with all the
# state the reference's per-sample C++ loop carries implicitly (fading AR(1)
# values, the multipath delay line, the CFO mixer/rotator phases, the
# lowpass history) an explicit ChannelState threaded between blocks, so a
# session simulator that pushes audio block by block sees no phase
# discontinuity at block boundaries.

class ChannelState(NamedTuple):
    h1: torch.Tensor         # complex64 [...]: tap-1 AR(1) carry
    h2: torch.Tensor         # complex64 [...]: tap-2 AR(1) carry
    x_tail: torch.Tensor     # float32 [..., delay]: input history (echo path)
    i_tail: torch.Tensor     # float32 [..., taps-1]: CFO lowpass I history
    q_tail: torch.Tensor     # float32 [..., taps-1]: CFO lowpass Q history
    cfo_phase: torch.Tensor  # float32 [...]: CFO rotator phase (rad, wrapped)
    mix_phase: torch.Tensor  # float32 [...]: 1500 Hz mixer phase (rad, wrapped)
    last_rms: torch.Tensor   # float32 [..., 1]: signal rms of the last block
    #                          that carried signal (stationary-noise memory)


def init_channel_state(cfg: ChannelConfig, draws: Mapping, batch_shape: tuple = (),
                       device: str | torch.device = "cuda") -> ChannelState:
    """Fresh state; fading taps from the stationary distribution (``draws``
    ``h1``, ``h2`` [..., 2] standard normals, drawn whatever the config)."""
    dev = resolve_device(device)
    batch_shape = tuple(batch_shape)
    alpha = cfg.fading_alpha if cfg.fading_enabled else 0.5
    init_std = float(np.sqrt(1.0 / (2.0 - alpha)))

    def zeros(shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    return ChannelState(
        h1=_complex(_draw(draws, "h1", batch_shape + (2,), dev), init_std),
        h2=_complex(_draw(draws, "h2", batch_shape + (2,), dev), init_std),
        x_tail=zeros(batch_shape + (max(cfg.delay_samples, 1),)),
        i_tail=zeros(batch_shape + (_CFO_LP_TAPS - 1,)),
        q_tail=zeros(batch_shape + (_CFO_LP_TAPS - 1,)),
        cfo_phase=zeros(batch_shape), mix_phase=zeros(batch_shape),
        last_rms=torch.full(batch_shape + (1,), 0.1, dtype=torch.float32, device=dev))


def apply_channel_stream(x, cfg: ChannelConfig, state: ChannelState, draws: Mapping,
                         device: str | torch.device = "cuda") -> tuple[ChannelResult, ChannelState]:
    """One block through the stateful channel; returns (result, new state)."""
    dev = resolve_device(device)
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    n = x.shape[-1]
    shape = tuple(x.shape)
    noise_std, new_last_rms = _noise_std(x, cfg, state.last_rms)

    out = x
    h1_mag = torch.ones_like(x)
    new_h1, new_h2 = state.h1, state.h2
    new_x_tail = state.x_tail
    if cfg.fading_enabled:
        alpha = cfg.fading_alpha
        scale = float(np.sqrt(1.0 / alpha))

        def fade(tap, carry):
            drive = _complex(_draw(draws, "fade" + tap, shape + (2,), dev), scale)
            y = ar1_scan(drive, alpha, carry)
            return y, y[..., -1]

        h1, new_h1 = fade("1", state.h1)
        h1_mag = torch.abs(h1)
        if cfg.uses_multipath:
            h2, new_h2 = fade("2", state.h2)
            d = cfg.delay_samples
            xx = torch.cat([state.x_tail[..., -d:], x], dim=-1)
            delayed = xx[..., :n]
            new_x_tail = xx[..., n:]
            out = (x * cfg.path1_gain * h1_mag
                   + delayed * cfg.path2_gain * torch.abs(h2))
        else:
            out = x * h1_mag
    elif cfg.uses_multipath:
        d = cfg.delay_samples
        xx = torch.cat([state.x_tail[..., -d:], x], dim=-1)
        out = x * cfg.path1_gain + xx[..., :n] * cfg.path2_gain
        new_x_tail = xx[..., n:]

    if cfg.noise_enabled:
        out = out + noise_std * _draw(draws, "noise", shape, dev)

    new_i_tail, new_q_tail = state.i_tail, state.q_tail
    new_cfo_phase, new_mix_phase = state.cfo_phase, state.mix_phase
    if cfg.uses_cfo:
        (out, new_i_tail, new_q_tail, new_cfo_phase,
         new_mix_phase) = _cfo_shift_block(out, cfg, state.i_tail, state.q_tail,
                                           state.cfo_phase, state.mix_phase)

    new_state = ChannelState(new_h1, new_h2, new_x_tail, new_i_tail, new_q_tail,
                             new_cfo_phase, new_mix_phase, new_last_rms)
    return ChannelResult(out, h1_mag), new_state
