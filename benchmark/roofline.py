"""The least time a launch of the LDPC decoder could take on a card.

Frozen from ``chip_smoke.py::bound_us``, with the tables counted from the
parity-check matrix instead of from the port's layout: each input byte read
once (channel LLRs and the row's factor, float32; the matrix in compressed
rows, a 16-bit variable index an edge and a 32-bit offset a check) and each
output byte written once (posteriors float32, info bits and the success
flag a byte each, the iteration count 32 bits), against the operations the
launch's codeword-iterations need: 14 an edge and 1 a variable each
iteration, counted from K1's source (gather side 5: g - c2v, two clamp
compares, the sign of g, the parity xor; check update 8: |v2c|, its sign,
the sign xor, two min compares, the exclusive pick, x factor, the sign
applied; variable sum 1; and the channel LLR added to each variable's sum).
"""

from __future__ import annotations

import json
from pathlib import Path

OPS_PER_EDGE = 14
PEAKS = Path(__file__).resolve().parent / "peaks.json"


def peaks(kind: str) -> dict | None:
    """The card's published peaks, or None for a card the table lacks."""
    with open(PEAKS) as f:
        return json.load(f).get(kind)


def decode_bytes(rows: int, n: int, k: int, m: int, edges: int) -> int:
    io = rows * (4 * n + 4) + rows * (4 * n + k + 1 + 4)
    return io + 2 * edges + 4 * (m + 1)


def decode_ops(codeword_iterations: int, n: int, edges: int) -> int:
    return codeword_iterations * (OPS_PER_EDGE * edges + n)


def decode_bound_s(rows: int, codeword_iterations: int, n: int, k: int, m: int, edges: int,
                   peak: dict) -> tuple[float, str]:
    """(least seconds, the side that binds) of one launch."""
    t_bytes = decode_bytes(rows, n, k, m, edges) / peak["hbm_bytes_per_s"]
    t_ops = decode_ops(codeword_iterations, n, edges) / peak["f32_ops_per_s"]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
