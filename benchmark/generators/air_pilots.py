"""Frames on the air as ``air.py`` makes them, for an OFDM configuration
with pilots: its waveform built with the configuration's ``pilot_spacing``
(``deploy_pilots.py``), so that the frozen TX writes the pilot sequence into
the pilot bins of every data symbol and the LTS, and the data into the
others.  Traffic parameters, the draws from ``seed`` and what is kept for
the check are ``air.py``'s.

``air.py`` reads its waveform's arguments from ``deploy``; this module runs
a copy of it of its own whose ``deploy`` is ``deploy.py`` with the pilots'
``ofdm_kwargs``, and leaves the shared modules as they are.
"""

from __future__ import annotations

import importlib.util
import types
from pathlib import Path

import torch

from benchmark import deploy, deploy_pilots


def _air() -> types.ModuleType:
    spec = importlib.util.spec_from_file_location("benchmark_air_pilots",
                                                  Path(__file__).with_name("air.py"))
    air = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(air)
    with_pilots = types.ModuleType("benchmark_deploy_pilots")
    with_pilots.__dict__.update(vars(deploy), ofdm_kwargs=deploy_pilots.ofdm_kwargs)
    air.deploy = with_pilots
    return air


AIR = _air()


def make_pool(cfg: dict, traffic: dict, seed: int,
              device: torch.device) -> tuple[list[torch.Tensor], list[dict]]:
    if cfg["waveform"] != "ofdm" or not cfg["use_pilots"]:
        raise ValueError(f"{cfg['name']}: air_pilots takes OFDM with pilots; air otherwise")
    return AIR.make_pool(cfg, traffic, seed, device)
