"""Frozen copy of ``ria_tpu_torch/utils/mt19937.py``, held by the benchmark as its plain
reference; it imports nothing of the port.

Exact MT19937 (32-bit Mersenne Twister), C++ `std::mt19937`-compatible.

The reference framework derives its LDPC parity-check matrix from a
pseudo-random construction driven by ``std::mt19937 rng(seed)`` with raw
32-bit draws (reference: src/fec/ldpc_encoder.cpp:77-116).  Bit-compatible
codewords therefore require an exact re-implementation of the generator —
numpy's RandomState seeds MT19937 differently (init_by_array), so we
implement the classic Knuth-initialized variant here.

This runs once per code rate at import/build time (host, pure Python); it is
not part of any device computation.
"""

from __future__ import annotations

_N = 624
_M = 397
_MATRIX_A = 0x9908B0DF
_UPPER_MASK = 0x80000000
_LOWER_MASK = 0x7FFFFFFF


class MT19937:
    """Minimal exact clone of C++ std::mt19937 (single uint32 seed)."""

    def __init__(self, seed: int):
        mt = [0] * _N
        mt[0] = seed & 0xFFFFFFFF
        for i in range(1, _N):
            mt[i] = (1812433253 * (mt[i - 1] ^ (mt[i - 1] >> 30)) + i) & 0xFFFFFFFF
        self.mt = mt
        self.index = _N

    def _generate(self) -> None:
        mt = self.mt
        for i in range(_N):
            y = (mt[i] & _UPPER_MASK) | (mt[(i + 1) % _N] & _LOWER_MASK)
            mt[i] = mt[(i + _M) % _N] ^ (y >> 1) ^ (_MATRIX_A if (y & 1) else 0)
        self.index = 0

    def __call__(self) -> int:
        if self.index >= _N:
            self._generate()
        y = self.mt[self.index]
        self.index += 1
        y ^= y >> 11
        y ^= (y << 7) & 0x9D2C5680
        y ^= (y << 15) & 0xEFC60000
        y ^= y >> 18
        return y & 0xFFFFFFFF
