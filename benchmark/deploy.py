"""A configuration file's waveform as constructor arguments, for the port's
dataclasses and the reference's alike, and its window, checked."""

from __future__ import annotations

MCDPSK_KEYS = ("sample_rate", "num_carriers", "freq_low", "freq_high", "samples_per_symbol",
               "bits_per_symbol", "spreading", "training_symbols")
OFDM_KEYS = ("sample_rate", "center_freq", "fft_size", "num_carriers", "cp_len",
             "output_scale", "modulation", "use_pilots")


def mcdpsk_kwargs(cfg: dict) -> dict:
    return {k: cfg[k] for k in MCDPSK_KEYS}


def chirp_kwargs(cfg: dict) -> dict:
    return dict(cfg["chirp"], sample_rate=cfg["sample_rate"])


def ofdm_kwargs(cfg: dict) -> dict:
    return {k: cfg[k] for k in OFDM_KEYS}


def check_window(cfg: dict, frame_samples: int) -> int:
    """The configuration's window, which must be its frame plus its slack."""
    window = frame_samples + cfg["window_slack"]
    if window != cfg["window_samples"]:
        raise ValueError(f"{cfg['name']}: window_samples {cfg['window_samples']}, but the "
                         f"frame ({frame_samples}) and the slack make {window}")
    return window
