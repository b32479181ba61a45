"""Spectral SNR estimation from received audio.

The reference does not actually measure SNR on the DPSK handshake path: in
simulation it feeds the *known* channel SNR straight into the protocol
(src/gui/app.cpp:309-316, "DPSK doesn't measure SNR"), and its waveform
selection tables were calibrated against the simulator's SNR definition
(noise_std = signal_rms * 10^(-SNR/20), white over the full 48 kHz band —
src/sim/hf_channel.hpp:125-128).

Here we measure it instead: Welch-averaged periodogram (4-term
Blackman-Harris, -92 dB sidelobes), noise floor preferably from a
noise-only reference window (the inter-frame gap before the preamble),
in-band signal power as the above-floor excess.  Reported SNR uses the
same full-band-noise convention the selection tables expect.  Unlike the
differential-phase-variance estimate (which floors at ~13 dB from
inter-carrier leakage), this tracks SNR from below -14 dB to 30+ dB, so
mode negotiation can reach the coherent-QAM rates without sim-truth side
channels.

Host numpy only, copied from ``ria_tpu/dsp/snr.py``: the waveform classes
measure the SNR on host slices of the receive buffer.
"""

from __future__ import annotations

import numpy as np

_window_cache: dict[int, np.ndarray] = {}


def _blackman_harris(n: int) -> np.ndarray:
    # 4-term Blackman-Harris: -92 dB sidelobes, so a 30 dB-above-noise
    # in-band signal leaks negligibly into the noise measurement region
    # (Hann's -31 dB first sidelobe biased the floor ~3 dB at high SNR).
    k = np.arange(n)
    a = (0.35875, 0.48829, 0.14128, 0.01168)
    return (a[0] - a[1] * np.cos(2 * np.pi * k / n)
            + a[2] * np.cos(4 * np.pi * k / n)
            - a[3] * np.cos(6 * np.pi * k / n))


def _psd_segments(x: np.ndarray, nfft: int) -> np.ndarray:
    """50%-overlap windowed periodograms, [n_seg, nfft//2+1]."""
    x = np.asarray(x, np.float64)
    if len(x) < nfft:
        x = np.pad(x, (0, nfft - len(x)))
    hop = nfft // 2
    n_seg = max((len(x) - nfft) // hop + 1, 1)
    idx = np.arange(nfft)[None, :] + hop * np.arange(n_seg)[:, None]
    win = _window_cache.get(nfft)
    if win is None:
        win = _blackman_harris(nfft)
        _window_cache[nfft] = win
    return np.abs(np.fft.rfft(x[idx] * win, axis=-1)) ** 2


def measure_noise_floor(window: np.ndarray, fs: float = 48000.0,
                        signal_band: tuple[float, float] = (300.0, 2800.0),
                        nfft: int = 4096) -> float | None:
    """In-band per-bin noise floor of a (presumed) noise-only window —
    the value `spectral_snr_db` accepts as noise_bin_prior.  Median over
    all (segment, bin) periodogram values, chi^2_2-corrected."""
    window = np.asarray(window, np.float32)
    if len(window) < nfft:
        return None
    freqs = np.fft.rfftfreq(nfft, 1.0 / fs)
    sg = (freqs >= signal_band[0]) & (freqs <= signal_band[1])
    flat = _psd_segments(window, nfft)[:, sg].ravel()
    if not flat.size:
        return None
    return float(np.median(flat)) / np.log(2.0)


def spectral_snr_db(audio: np.ndarray, fs: float = 48000.0,
                    signal_band: tuple[float, float] = (300.0, 2800.0),
                    noise_band: tuple[float, float] = (8000.0, 22000.0),
                    nfft: int = 4096,
                    noise_ref: np.ndarray | None = None,
                    noise_bin_prior: float | None = None,
                    return_floor: bool = False):
    """Estimate full-band-noise SNR of a bandlimited signal in white noise.

    audio: real samples containing (mostly) the frame of interest.
    noise_ref: optional noise-only samples (e.g. the inter-frame gap just
    before the preamble).  When given, the noise floor is measured from it
    IN-BAND, which is immune to the modem's own out-of-band sidelobes (a
    ~3 dB floor bias at 25+ dB SNR when the TX band filter is off — the
    reference's default) and stays correct when the receiver's SSB filter
    has already stripped out-of-band noise (real radio audio).
    noise_bin_prior: a previously measured in-band floor (the return_floor
    value from an earlier frame) used when no gap window is available this
    frame — a receiver-tracked noise floor, like the reference's OFDM
    energy gate (ofdm_sync.cpp:20-47).
    Returns 10*log10(P_signal / P_noise_total) with P_noise_total the noise
    power over the whole Nyquist band — the simulator's SNR definition.
    With return_floor=True returns (snr_db, noise_bin) so callers can track
    the floor across frames.
    """
    freqs = np.fft.rfftfreq(nfft, 1.0 / fs)
    sg = (freqs >= signal_band[0]) & (freqs <= signal_band[1])

    noise_bin = 0.0
    if noise_ref is not None and len(noise_ref) >= nfft:
        # In-band floor from the noise-only window.  Median over all
        # (segment, bin) periodogram values; chi^2_2 median = ln(2)*mean.
        flat = _psd_segments(noise_ref, nfft)[:, sg].ravel()
        if flat.size:
            noise_bin = float(np.median(flat)) / np.log(2.0)

    if noise_bin <= 0.0 and noise_bin_prior is not None and noise_bin_prior > 0.0:
        noise_bin = float(noise_bin_prior)

    per_seg = _psd_segments(audio, nfft)
    if noise_bin <= 0.0:
        # Fall back to the out-of-band floor of the frame itself.
        nz = (freqs >= noise_band[0]) & (freqs <= noise_band[1])
        # Median across segments per bin (robust to on/off transients),
        # then median over noise bins (robust to narrowband interferers).
        if per_seg.shape[0] > 2:
            noise_psd = np.median(per_seg[:, nz], axis=0) / np.log(2.0)
        else:
            noise_psd = np.mean(per_seg[:, nz], axis=0)
        noise_bin = float(np.median(noise_psd)) if nz.any() else float(np.mean(per_seg))
    noise_bin = max(noise_bin, 1e-30)

    # Signal power: plain mean across segments (the signal is not
    # exponential-distributed, and its transients are signal energy).
    psd_sig = np.mean(per_seg[:, sg], axis=0)
    sig_power = float(np.sum(np.maximum(psd_sig - noise_bin, 0.0)))
    total_noise = noise_bin * len(freqs)
    if sig_power <= 0.0:
        return (-30.0, noise_bin) if return_floor else -30.0
    snr = float(np.clip(10.0 * np.log10(sig_power / total_noise), -30.0, 50.0))
    return (snr, noise_bin) if return_floor else snr
