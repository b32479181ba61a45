"""Adaptive mode control and carrier sense.

Contracts from the reference:
- AdaptiveModeController (src/gui/adaptive_mode.{hpp,cpp}): pilot-SNR ->
  (modulation, rate) ladder with 2 dB hysteresis and 3-frame stability
  before switching;
- carrier sense (src/gui/modem/modem_carrier_sense.cpp): EMA-smoothed RMS
  channel energy vs threshold ("listen before talk");
- TX post-processing (modem_engine.hpp:356): lead-in silence, band FIR,
  output scaling.

Port of ``ria_tpu/phy/adaptive.py``: the controllers are its host code with
the imports pointed at the port; ``tx_post_process`` filters through the
port's ``fft_convolve`` on ``device`` (default the card) and returns host
samples.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ria_tpu_torch.utils.device import resolve_device

HYSTERESIS_DB = 2.0
MIN_FRAMES_BEFORE_SWITCH = 3
ENERGY_SMOOTHING = 0.1

# Pilot-SNR ladder (adaptive_mode.cpp:recommendMode)
_LADDER = [
    (38.0, ("QAM64", "R5_6")),
    (34.0, ("QAM64", "R3_4")),
    (30.0, ("QAM16", "R3_4")),
    (26.0, ("QAM16", "R2_3")),
    (24.0, ("QPSK", "R2_3")),
    (22.0, ("QPSK", "R1_2")),
    (18.0, ("BPSK", "R1_2")),
]
_FLOOR = ("BPSK", "R1_4")


def recommend_mode(snr_db: float) -> tuple[str, str]:
    for thr, mode in _LADDER:
        if snr_db > thr:
            return mode
    return _FLOOR


class AdaptiveModeController:
    def __init__(self):
        self.reset()

    def reset(self):
        self.modulation, self.rate = _FLOOR
        self.last_switch_snr = 0.0
        self.frames_at_current = 0

    def update(self, snr_db: float) -> bool:
        """Feed an SNR measurement; returns True if the mode changed."""
        self.frames_at_current += 1
        mod, rate = recommend_mode(snr_db)
        if (mod, rate) == (self.modulation, self.rate):
            return False
        if self.frames_at_current < MIN_FRAMES_BEFORE_SWITCH:
            return False
        if abs(snr_db - self.last_switch_snr) < HYSTERESIS_DB and self.last_switch_snr:
            return False
        self.modulation, self.rate = mod, rate
        self.last_switch_snr = snr_db
        self.frames_at_current = 0
        return True


_MOD_BITS = {"BPSK": 1, "DBPSK": 1, "QPSK": 2, "DQPSK": 2, "D8PSK": 3,
             "QAM16": 4, "QAM32": 5, "QAM64": 6, "QAM256": 8}
_RATE_VAL = {"R1_4": 0.25, "R1_2": 0.5, "R2_3": 2 / 3, "R3_4": 0.75,
             "R5_6": 5 / 6}


def mode_efficiency(modulation: str, rate: str) -> float:
    return _MOD_BITS.get(modulation, 1) * _RATE_VAL.get(rate, 0.25)


class LinkAdapter:
    """In-session link adaptation (reference App::updateAdaptiveAdvisory,
    src/gui/app.cpp:1914-2010): average (SNR, fading) over a 5-frame
    window, re-run recommend_data_mode, and switch only after the same
    candidate persists 4 windows for upgrades (plus an 8 s hold since the
    last switch) or 2 windows for downgrades.  Returns the (mod, rate,
    spreading) to request, or None."""

    WINDOW_FRAMES = 5
    UPGRADE_WINDOWS = 4
    DOWNGRADE_WINDOWS = 2
    UPGRADE_HOLD_MS = 8000

    def __init__(self):
        self.reset()

    def reset(self):
        self._snr: list[float] = []
        self._fading: list[float] = []
        self._candidate: tuple[str, str, int] | None = None
        self._hits = 0
        self._last_switch_ms = 0.0

    def feed(self, snr_db: float, fading_index: float, now_ms: float,
             waveform, current_mod: str, current_rate: str):
        from ria_tpu_torch.wave.selection import recommend_data_mode

        self._snr.append(float(snr_db))
        self._fading.append(float(fading_index))
        if len(self._snr) > self.WINDOW_FRAMES:
            self._snr.pop(0)
            self._fading.pop(0)
        if len(self._snr) < self.WINDOW_FRAMES:
            return None
        avg_snr = sum(self._snr) / len(self._snr)
        avg_fading = sum(self._fading) / len(self._fading)

        rec = recommend_data_mode(avg_snr, waveform, avg_fading)
        if (rec[0], rec[1]) == (current_mod, current_rate):
            self._candidate, self._hits = None, 0
            return None
        # 2 dB downgrade hysteresis (reference adaptive_mode.hpp): a mode
        # that engaged right at its rung must not flap back on measurement
        # noise — only downgrade when even a 2 dB-more-generous read still
        # recommends leaving the current mode.  (Without this, a link
        # whose SNR median sits on a rung boundary oscillates, and every
        # flap rebuilds waveforms and recompiles pipelines.)
        rec_hyst = recommend_data_mode(avg_snr + HYSTERESIS_DB, waveform,
                                       avg_fading)
        if ((rec_hyst[0], rec_hyst[1]) == (current_mod, current_rate)
                and mode_efficiency(rec[0], rec[1])
                < mode_efficiency(current_mod, current_rate)):
            self._candidate, self._hits = None, 0
            return None
        if self._candidate == rec:
            self._hits += 1
        else:
            self._candidate, self._hits = rec, 1

        is_upgrade = (mode_efficiency(rec[0], rec[1])
                      > mode_efficiency(current_mod, current_rate) + 0.05)
        required = self.UPGRADE_WINDOWS if is_upgrade else self.DOWNGRADE_WINDOWS
        if self._hits < required:
            return None
        if is_upgrade and now_ms - self._last_switch_ms < self.UPGRADE_HOLD_MS:
            return None
        self._last_switch_ms = now_ms
        self._candidate, self._hits = None, 0
        return rec, is_upgrade, avg_snr, avg_fading


class CarrierSense:
    """EMA RMS energy vs threshold (listen-before-talk)."""

    def __init__(self, threshold: float = 0.05):
        self.threshold = threshold
        self.energy = 0.0

    def update(self, samples: np.ndarray):
        if len(samples) == 0:
            return
        rms = float(np.sqrt(np.mean(np.square(samples))))
        self.energy = ENERGY_SMOOTHING * rms + (1.0 - ENERGY_SMOOTHING) * self.energy

    @property
    def busy(self) -> bool:
        return self.energy > self.threshold


@functools.lru_cache(maxsize=8)
def _tx_band_filter(fir_taps: int, lo: float, hi: float,
                    sample_rate: float) -> "np.ndarray":
    from ria_tpu_torch.dsp.fir import design_bandpass

    return design_bandpass(fir_taps, lo, hi, sample_rate)


def tx_post_process(samples: np.ndarray, lead_in_ms: float = 50.0,
                    sample_rate: float = 48000.0, band=(200.0, 2900.0),
                    scale: float = 1.0, fir_taps: int = 129,
                    device: str | torch.device = "cuda") -> np.ndarray:
    """Lead-in silence + band FIR + output scale (ModemEngine::postProcessTx).

    The band filter matters beyond spectral politeness: it keeps the
    transmitted waveform's sidelobes out of the 8-22 kHz region the RX-side
    spectral SNR estimator (dsp/snr.py) uses as its noise-floor reference.
    The convolution runs on ``device``; the result is a host array.
    """
    from ria_tpu_torch.dsp.fir import fft_convolve

    dev = resolve_device(device)
    h = _tx_band_filter(fir_taps, band[0], band[1], sample_rate)
    x = torch.as_tensor(np.asarray(samples, np.float32), device=dev)
    filtered = fft_convolve(x, h, mode="same").cpu().numpy().astype(np.float32)
    lead = np.zeros(int(sample_rate * lead_in_ms / 1000.0), np.float32)
    return np.concatenate([lead, filtered * scale])
