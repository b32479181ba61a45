"""Channel characterization and OFDM<->OTFS adaptive selection.

Contracts from the reference:
- ChannelReport wire format (frame_v2.cpp): 5 bytes — SNR*5 (0.2 dB),
  delay_ms*10 (0.1 ms), doppler_hz*10 (0.1 Hz), recommended mode,
  capabilities bitmap;
- ITU-R F.1487 channel classes (include/ultra/adaptive_modem.hpp):
  Good: delay < 0.75 ms and doppler < 0.3 Hz;
  Moderate: 0.75 <= delay < 1.5 and 0.3 <= doppler < 2.0;
  Poor: delay >= 1.5 or doppler >= 2.0; Flutter: doppler >= 5;
- empirical mode selection (adaptive_modem.hpp:216-224): Good -> OTFS_EQ,
  Moderate -> OFDM, Poor -> OTFS_RAW;
- delay spread estimated from the channel impulse response (IFFT of the
  per-carrier frequency response), Doppler spread from symbol-to-symbol
  channel decorrelation.

Host numpy only, copied from ``ria_tpu/phy/channel_probe.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class ChannelEstimate:
    snr_db: float = 0.0
    delay_spread_ms: float = 0.0
    doppler_spread_hz: float = 0.0

    def is_good(self) -> bool:
        return self.delay_spread_ms < 0.75 and self.doppler_spread_hz < 0.3

    def is_moderate(self) -> bool:
        return (0.75 <= self.delay_spread_ms < 1.5
                and 0.3 <= self.doppler_spread_hz < 2.0)

    def is_poor(self) -> bool:
        return self.delay_spread_ms >= 1.5 or self.doppler_spread_hz >= 2.0

    def is_flutter(self) -> bool:
        return self.doppler_spread_hz >= 5.0

    @property
    def condition_name(self) -> str:
        if self.is_flutter():
            return "Flutter"
        if self.is_poor():
            return "Poor"
        if self.is_good():
            return "Good"
        return "Moderate"

    def recommended_mode(self) -> str:
        """'OTFS_EQ' | 'OFDM' | 'OTFS_RAW'.

        Reference table (adaptive_modem.hpp:216-224) maps Poor->OTFS_RAW
        based on its empirics (raw 20% vs OFDM 10% frame success).  Our
        equalized OTFS (preamble MMSE + decision-directed per-symbol gain
        tracking, wave/otfs.py phase_tracking) measures 60% on the same
        Poor channel (12/20 seeds; 75% Moderate) while raw-DD's
        equalization-free differential hits the 2 ms twisted-convolution
        ISI floor, so Poor routes to OTFS_EQ here (tools/otfs_mode_sweep
        and test_otfs_mode_selection_beats_ofdm_on_poor).  OTFS_RAW stays
        available via explicit config for reference-parity workflows.
        """
        if self.is_poor():
            return "OTFS_EQ"
        if self.is_good():
            return "OTFS_EQ"
        return "OFDM"


@dataclass
class ChannelReport:
    snr_db: float = 0.0
    delay_spread_ms: float = 0.0
    doppler_spread_hz: float = 0.0
    recommended_mode: int = 0
    capabilities: int = 0x3F

    def encode(self) -> bytes:
        return bytes([
            int(min(250.0, max(0.0, self.snr_db * 5.0))),
            int(min(250.0, max(0.0, self.delay_spread_ms * 10.0))),
            int(min(250.0, max(0.0, self.doppler_spread_hz * 10.0))),
            self.recommended_mode & 0xFF,
            self.capabilities & 0xFF,
        ])

    @classmethod
    def decode(cls, data: bytes) -> "ChannelReport":
        if len(data) < 5:
            return cls()
        return cls(snr_db=data[0] / 5.0, delay_spread_ms=data[1] / 10.0,
                   doppler_spread_hz=data[2] / 10.0, recommended_mode=data[3],
                   capabilities=data[4])


def estimate_channel(h_per_symbol: np.ndarray, carrier_spacing_hz: float,
                     symbol_duration_s: float, noise_var: float = 0.0) -> ChannelEstimate:
    """Characterize the channel from per-symbol frequency responses.

    h_per_symbol: [S, C] complex per-carrier channel estimates over S
    training/pilot symbols (e.g. repeated LTS or OTFS preamble symbols).
    """
    h = np.asarray(h_per_symbol)
    S, C = h.shape

    # Delay spread: RMS width of the impulse response (IFFT over carriers).
    h_mean = h.mean(axis=0)
    imp = np.fft.ifft(h_mean)
    p = np.abs(imp) ** 2
    # Center the window on the strongest tap to avoid wrap bias.
    peak = int(np.argmax(p))
    p = np.roll(p, -peak + C // 4)
    taps = np.arange(C)
    total = p.sum() + 1e-12
    mean_tap = (taps * p).sum() / total
    rms_taps = np.sqrt((((taps - mean_tap) ** 2) * p).sum() / total)
    # Each impulse-response tap spans 1/(C * df) seconds.
    tap_s = 1.0 / (C * carrier_spacing_hz)
    delay_ms = float(rms_taps * tap_s * 1000.0)

    # Doppler spread from symbol-to-symbol channel correlation:
    # rho = |E[h_s conj(h_{s+1})]| / E[|h|^2]; for a Gaussian Doppler
    # spectrum rho ~ exp(-2 (pi fd T)^2) -> fd = sqrt(-ln rho / 2) / (pi T).
    if S >= 2:
        num = np.abs(np.sum(h[:-1] * np.conj(h[1:])))
        den = np.sum(np.abs(h) ** 2) * (S - 1) / S + 1e-12
        rho = float(np.clip(num / den, 1e-6, 1.0))
        fd = np.sqrt(max(-np.log(rho), 0.0) / 2.0) / (np.pi * symbol_duration_s)
    else:
        fd = 0.0

    sig = float(np.mean(np.abs(h) ** 2))
    snr_db = 10.0 * np.log10(max(sig / max(noise_var, 1e-12), 1e-6)) if noise_var > 0 else 30.0
    return ChannelEstimate(snr_db=snr_db, delay_spread_ms=delay_ms,
                           doppler_spread_hz=float(fd))


def estimate_mc_dpsk(zsym: np.ndarray, cfg, snr_db: float = 30.0) -> ChannelEstimate:
    """Channel characterization from the MC-DPSK handshake frame itself.

    The reference's AdaptiveModem characterizes the channel from preamble
    observations before routing OFDM vs OTFS (adaptive_modem.hpp:25-230);
    here every decoded handshake frame IS the probe: ``zsym`` [S, C] are
    the raw mix-integrated carrier samples (training + reference + data)
    from wave.mc_dpsk.demodulate.

    - **Delay spread** (two-path separation, the Watterson model's
      delay_spread_ms parameter): a two-tap channel's power response is
      |H(f)|^2 = g1^2 + g2^2 + 2 g1 g2 cos(2 pi f d) — a frequency ripple
      whose period is exactly 1/d, INVARIANT to the sync lock point (an
      absolute timing offset rotates H's phase but not |H|).  All MC-DPSK
      constellations are unit-modulus, so mean_s |zsym[s, c]|^2 samples
      |H|^2 on the carrier grid using every symbol of the frame; the
      ripple frequency is read off a zero-padded FFT peak with parabolic
      interpolation.  Carrier spacing ~222 Hz gives an unambiguous range
      of 2.25 ms — beyond it the reading aliases, but every reading
      >= 1.5 ms classifies Poor regardless, so the class is still right.
    - **Doppler spread**: |zsym[s, c]| also traces the Rayleigh tap
      envelopes over time.  For the AR(1) taps the envelope
      autocovariance decays as exp(-4 pi fd k tau) (envelope corr ~=
      |rho|^2, rho(tau) = exp(-2 pi fd tau)).  Lag >= 1 covariances are
      noise-free in expectation (disjoint integration windows, iid
      noise), so fd comes from ratios of BAND-AVERAGED covariances —
      slow bands (lags 2-6 vs 18-30) resolve 0.1 vs 0.5 Hz across a
      ~0.8 s frame, and a fast band pair (2-3 vs 5-7) catches flutter
      rates whose covariance dies before the slow band.  Band averaging
      is what keeps a 0.1 Hz channel from reading as 1-2 Hz: individual
      lag covariances at these frame lengths are noise-dominated, their
      log-fit slope is garbage.

    Gates return 0.0 (AWGN reading) when the ripple or the envelope
    variance fall below the estimator's own noise floor.
    """
    z = np.asarray(zsym)
    C = cfg.num_carriers
    freqs = np.asarray(cfg.carrier_freqs)
    spacing = float(freqs[1] - freqs[0]) if C > 1 else 1.0
    tau = cfg.samples_per_symbol / cfg.sample_rate

    m = np.abs(z)                                          # [S, C]
    # Trailing-silence guard: drop symbols far below the frame's level.
    live = m.sum(axis=1) > 0.2 * np.median(m.sum(axis=1))
    m = m[live]
    S = m.shape[0]

    # ------------------------------------------------ delay (|H|^2 ripple)
    P = np.mean(m * m, axis=0)                             # [C] ~ |H(f_c)|^2
    Pd = P - P.mean()
    nfft = 64 * C
    spec = np.abs(np.fft.rfft(Pd, nfft))
    half = nfft // 2
    b = int(np.argmax(spec[1:half])) + 1
    y0, y1, y2 = spec[b - 1], spec[b], spec[min(b + 1, half)]
    denom = y0 - 2 * y1 + y2
    frac = 0.5 * (y0 - y2) / denom if abs(denom) > 1e-12 else 0.0
    d_s = (b + float(np.clip(frac, -0.5, 0.5))) / (nfft * spacing)
    # Significance: ripple amplitude (~2 g1 g2) vs the mean power and vs
    # the residual floor of the demeaned ripple spectrum.
    ripple = spec[b] * 2.0 * nfft / C / 2.0                # peak-to-mean est
    floor = float(np.median(spec[1:half]))
    delay_ms = d_s * 1000.0
    if (ripple < 0.25 * max(P.mean(), 1e-12) or spec[b] < 3.0 * floor
            or delay_ms < 0.15):
        delay_ms = 0.0

    # -------------------------------------------------- doppler (variogram)
    # Structure function V[k] = E (m[s+k]-m[s])^2 = 2 sigma_n^2
    # + 2 var_env (1 - e^{-lambda k}), lambda = 4 pi fd tau.  V is immune
    # to the frame mean (no demeaning-ramp bias, the failure mode of
    # sample autocovariance on sub-coherence-time frames) and iid noise
    # only adds a constant offset, absorbed by the fit's A term.  Fit
    # V[k] ~= A - B e^{-lambda k} by grid search over lambda with
    # closed-form least squares for (A, B).
    fd = 0.0
    if S >= 16:
        kmax = min(32, S - 4)
        ks = np.arange(1, kmax + 1, dtype=np.float64)
        V = np.array([np.mean((m[k:] - m[:-k]) ** 2) for k in range(1, kmax + 1)])
        best = (np.inf, 0.0, 0.0, 0.0)
        for lam in np.geomspace(3e-3, 4.0, 48):
            e = np.exp(-lam * ks)
            # LS for V ~ A - B e  (2-param linear fit).
            em, vm = e.mean(), V.mean()
            den = np.mean((e - em) ** 2)
            Bc = -float(np.sum((e - em) * (V - vm)) / max(den * kmax, 1e-30))
            Ac = vm + Bc * em
            err = float(np.mean((Ac - Bc * e - V) ** 2))
            if err < best[0]:
                best = (err, lam, Ac, Bc)
        _, lam, A, B = best
        mean_pow = float(np.mean(m)) ** 2
        # Fading significance: judge the exponential by the variogram rise
        # it actually expresses across the observed lags, B (e^-lam -
        # e^-lam*kmax) — raw B explodes when lam is large and the curve is
        # flat (a one-bin dip at lag 1 on pure noise fits lam=max with
        # B >> A but a negligible expressed rise).
        rise = B * (np.exp(-lam) - np.exp(-lam * kmax))
        if rise > 0.15 * max(float(V.mean()), 1e-12) and rise > 0.004 * mean_pow:
            fd = lam / (4.0 * np.pi * tau)
    if fd < 0.04:
        fd = 0.0

    return ChannelEstimate(snr_db=snr_db, delay_spread_ms=float(delay_ms),
                           doppler_spread_hz=float(fd))
