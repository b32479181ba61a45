"""Bit packing/unpacking helpers (MSB-first, matching the reference wire order).

The reference framework serializes bytes MSB-first everywhere (e.g.
src/fec/ldpc_encoder.cpp:145-148).  These helpers exist in two flavours,
as in ``ria_tpu.utils.bits`` (copied so the port imports no JAX): numpy
(host-side framing) and torch tensors on any device (the reference's
``jnp_*`` pair keeps its names).
"""

from __future__ import annotations

import numpy as np
import torch


def bytes_to_bits(data: bytes | np.ndarray) -> np.ndarray:
    """Bytes -> uint8 bit array, MSB first."""
    arr = np.frombuffer(bytes(data), dtype=np.uint8) if isinstance(data, (bytes, bytearray)) else np.asarray(data, dtype=np.uint8)
    return np.unpackbits(arr)


def bits_to_bytes(bits: np.ndarray) -> bytes:
    """uint8/bool bit array (MSB first) -> bytes. Pads the tail with zeros."""
    bits = np.asarray(bits).astype(np.uint8)
    return np.packbits(bits).tobytes()


def jnp_bits_to_bytes_array(bits: torch.Tensor) -> torch.Tensor:
    """[..., 8*k] bits -> [..., k] uint8, MSB first, on the bits' device."""
    shape = bits.shape[:-1] + (bits.shape[-1] // 8, 8)
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.uint8,
                           device=bits.device)
    grouped = bits.reshape(shape).to(torch.uint8)
    return torch.sum(grouped * weights, dim=-1).to(torch.uint8)


def jnp_bytes_to_bits(b: torch.Tensor) -> torch.Tensor:
    """[..., k] uint8 -> [..., 8*k] bits, MSB first, on the bytes' device."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=b.device)
    bits = (b.to(torch.uint8)[..., None] >> shifts) & 1
    return bits.reshape(b.shape[:-1] + (b.shape[-1] * 8,))
