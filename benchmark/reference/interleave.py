"""Frozen copy of the fixed-frame interleavers of ``ria_tpu_torch/fec/interleave.py``
(``apply_perm``, ``channel_perm``, ``frame_perm``, ``frame_interleave``),
held by the benchmark as its plain reference; it imports nothing of the port.
"""

from __future__ import annotations

import functools
from math import gcd

import numpy as np

from .ldpc_matrix import BLOCK_BITS

FRAME_CODEWORDS = 4
FRAME_BITS = FRAME_CODEWORDS * BLOCK_BITS  # 2592


def apply_perm(x, perm, inverse: bool = False):
    """out[perm[i]] = x[i] (scatter form); inverse applies out[i] = x[perm[i]]."""
    perm = np.asarray(perm)
    if inverse:
        return x[..., perm]
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return x[..., inv]


@functools.lru_cache(maxsize=None)
def channel_perm(bits_per_symbol: int, total_bits: int = BLOCK_BITS) -> np.ndarray:
    """perm[i] = destination of input bit i."""
    target = bits_per_symbol * 3
    if target >= total_bits:
        target = total_bits // 2
    step = None
    for s in range(target, total_bits):
        if gcd(s, total_bits) == 1:
            step = s
            break
    if step is None:
        for s in range(bits_per_symbol + 1, total_bits):
            if gcd(s, total_bits) == 1:
                step = s
                break
        step = step or bits_per_symbol + 1
    i = np.arange(total_bits)
    return (i * step) % total_bits


@functools.lru_cache(maxsize=None)
def frame_perm() -> np.ndarray:
    """perm[original_idx] = interleaved_idx for the fixed 4-CW frame."""
    perm = np.zeros(FRAME_BITS, dtype=np.int64)
    for cw in range(FRAME_CODEWORDS):
        for bit in range(BLOCK_BITS):
            perm[cw * BLOCK_BITS + bit] = bit * FRAME_CODEWORDS + (cw + bit) % FRAME_CODEWORDS
    return perm


def frame_interleave(cw_bits: np.ndarray) -> np.ndarray:
    """[..., 4, 648] coded bits -> [..., 2592] interleaved frame bits."""
    flat = cw_bits.reshape(cw_bits.shape[:-2] + (FRAME_BITS,))
    return apply_perm(flat, frame_perm())
