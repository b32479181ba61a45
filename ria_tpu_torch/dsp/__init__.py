"""dsp stage of the port (mirrors ria_tpu.dsp)."""

from .windows import hann, hamming, blackman, kaiser, window
from .fir import design_lowpass, design_highpass, design_bandpass, fir_filter, fft_convolve
from .hilbert import analytic_signal
from .nco import mixer_bank, phase_ramp, freq_shift_real
from .util import rms, peak, normalize_rms, db_to_linear, linear_to_db

__all__ = [
    "hann", "hamming", "blackman", "kaiser", "window",
    "design_lowpass", "design_highpass", "design_bandpass", "fir_filter", "fft_convolve",
    "analytic_signal",
    "mixer_bank", "phase_ramp", "freq_shift_real",
    "rms", "peak", "normalize_rms", "db_to_linear", "linear_to_db",
]
