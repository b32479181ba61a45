"""``deploy.py`` for a configuration with pilots: its OFDM constructor
arguments with the configuration's ``pilot_spacing`` beside them, for the
port's ``OFDMConfig`` and the reference's alike."""

from __future__ import annotations

from benchmark import deploy


def ofdm_kwargs(cfg: dict) -> dict:
    return {**deploy.ofdm_kwargs(cfg), "pilot_spacing": cfg["pilot_spacing"]}
