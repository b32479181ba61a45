"""Carry the reference package's state into the port.

The port learns nothing: its "parameters" are deterministic tables (LDPC
index tables, mixer bank, chirp templates, zoom tables) and configs.  These
helpers rebuild the port's objects from plain numpy arrays and dicts, so
state taken from ``ria_tpu`` (or stored) can be checked against the port's
own construction without the port importing JAX.
"""

from __future__ import annotations

import numpy as np

import torch

from ria_tpu_torch.fec.ldpc_matrix import CODE_PARAMS, LDPCCode
from ria_tpu_torch.sim.channel import ChannelConfig, ChannelState
from ria_tpu_torch.utils.device import resolve_device
from ria_tpu_torch.sync.chirp import ChirpConfig
from ria_tpu_torch.wave.mc_dpsk import MCDPSKConfig


def code_from_arrays(row_idx: np.ndarray, row_mask: np.ndarray,
                     h_data: np.ndarray) -> LDPCCode:
    """The port's LDPCCode from ``row_idx [m, D]``, ``row_mask [m, D]`` and
    ``h_data [m, k]``; the rate is the one whose (k, m) these shapes give."""
    row_idx = np.asarray(row_idx, np.int32)
    row_mask = np.asarray(row_mask, bool)
    h_data = np.asarray(h_data, np.float32)
    m, D = row_idx.shape
    if row_mask.shape != (m, D) or h_data.shape[0] != m:
        raise ValueError(f"inconsistent shapes {row_idx.shape}, {row_mask.shape}, {h_data.shape}")
    k = h_data.shape[1]
    rates = [r for r, km in CODE_PARAMS.items() if km == (k, m)]
    if not rates:
        raise ValueError(f"no code with k={k}, m={m}")
    n = k + m
    gather = np.zeros((m * D, n), dtype=np.float32)
    flat_mask = row_mask.reshape(-1)
    gather[np.arange(m * D)[flat_mask], row_idx.reshape(-1)[flat_mask]] = 1.0
    return LDPCCode(rate=rates[0], k=k, m=m, n=n, max_degree=D, row_idx=row_idx,
                    row_mask=row_mask, h_data=h_data, gather=gather)


def mcdpsk_config_from_dict(d: dict) -> MCDPSKConfig:
    """The port's MCDPSKConfig from ``dataclasses.asdict`` of a reference
    ``MCDPSKConfig`` (nested ``ChirpConfig`` included)."""
    fields = dict(d)
    if "chirp" in fields:
        fields["chirp"] = ChirpConfig(**fields["chirp"])
    return MCDPSKConfig(**fields)


def channel_config_from_dict(d: dict) -> ChannelConfig:
    """The port's ChannelConfig from ``dataclasses.asdict`` of a reference
    ``ChannelConfig``."""
    return ChannelConfig(**d)


def channel_state_from_arrays(h1, h2, x_tail, i_tail, q_tail, cfo_phase, mix_phase,
                              last_rms, device: str | torch.device = "cuda") -> ChannelState:
    """The port's ChannelState on ``device`` from the eight fields of a
    reference ``ChannelState`` as numpy arrays (in its field order): a
    stream stopped in the reference package carries on in the port."""
    dev = resolve_device(device)

    def real(a):
        return torch.as_tensor(np.array(a, np.float32), device=dev)

    def cplx(a):
        return torch.as_tensor(np.array(a, np.complex64), device=dev)

    return ChannelState(cplx(h1), cplx(h2), real(x_tail), real(i_tail), real(q_tail),
                        real(cfo_phase), real(mix_phase), real(last_rms))
