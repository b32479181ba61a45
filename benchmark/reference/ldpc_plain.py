"""The plain min-sum decoder, frozen from ``ria_tpu_torch/fec/ldpc.py``
(``LDPCDecoder.plain`` in float32, with ``_check_update``, ``_variable_sum``,
``_var_edges`` and ``ldpc_kernel.csc_tables``); it imports nothing of the port.

Normalized min-sum with a per-row factor, messages clamped to +/-50, a
hard-decision parity check after every iteration with a per-codeword freeze,
positive LLR => bit 0.  Each variable sums its check messages in ascending
edge order from 0.0, which is the order kernel K1 sums in: near the decoding
threshold BP doubles a last-bit difference about every three iterations, so
only a decoder that sums in K1's order can be held to K1 row by row.  Its
tables are worked out here from the parity-check matrix.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from .ldpc_matrix import LLR_CLAMP, LDPCCode


class DecodeResult(NamedTuple):
    info_bits: torch.Tensor   # [B, k] uint8
    success: torch.Tensor     # [B] bool
    iterations: torch.Tensor  # [B] int32
    llr_total: torch.Tensor   # [B, n] float32 (posterior LLRs)


def var_edges(row_idx: np.ndarray, row_mask: np.ndarray, n: int) -> np.ndarray:
    """[n, max degree] int64: each variable's edges ``e = check * D + d`` in
    ascending order, padded with ``m * D`` (a message slot held at 0)."""
    m, D = np.asarray(row_idx).shape
    edges = np.flatnonzero(np.asarray(row_mask).reshape(-1))
    var = np.asarray(row_idx).reshape(-1)[edges]
    col_edge = edges[np.argsort(var, kind="stable")]
    deg = np.bincount(var, minlength=n)
    col_ptr = np.concatenate([[0], np.cumsum(deg)])
    out = np.full((n, max(int(deg.max(initial=0)), 1)), m * D, np.int64)
    for v in range(n):
        out[v, : deg[v]] = col_edge[col_ptr[v] : col_ptr[v + 1]]
    return out


class PlainDecoder(nn.Module):
    """(llrs [B, n], factors [B]) -> DecodeResult on the inputs' device."""

    def __init__(self, code: LDPCCode, max_iters: int, device: torch.device):
        super().__init__()
        self.k, self.m, self.n, self.D = code.k, code.m, code.n, code.max_degree
        self.max_iters = max_iters
        self.register_buffer("gather", torch.as_tensor(code.gather, device=device))
        self.register_buffer("row_idx", torch.as_tensor(code.row_idx, device=device))
        self.register_buffer("row_mask", torch.as_tensor(code.row_mask, device=device))
        self.register_buffer("var_edges", torch.as_tensor(
            var_edges(code.row_idx, code.row_mask, code.n), device=device))

    def _check_update(self, v2c: torch.Tensor, factors: torch.Tensor) -> torch.Tensor:
        """Per-check two-min + sign-product, excluding self (min-sum)."""
        mask = self.row_mask
        sgn = torch.where(v2c < 0, -1.0, 1.0)
        sgn = torch.where(mask, sgn, 1.0)
        sign_prod = torch.prod(sgn, dim=-1, keepdim=True)
        absv = torch.where(mask, torch.abs(v2c), torch.inf)
        is_min = nn.functional.one_hot(torch.argmin(absv, dim=-1), self.D).bool()
        min1 = torch.amin(absv, dim=-1, keepdim=True)
        min2 = torch.amin(torch.where(is_min, torch.inf, absv), dim=-1, keepdim=True)
        excl_min = torch.where(is_min, min2, min1)
        c2v = sign_prod * sgn * excl_min * factors[:, None, None]
        return torch.where(mask, c2v, 0.0)

    def _variable_sum(self, c2v: torch.Tensor) -> torch.Tensor:
        """[B, n]: each variable's check messages summed in ascending edge
        order from 0.0, K1's order."""
        B = c2v.shape[0]
        flat = torch.cat([c2v.reshape(B, -1), c2v.new_zeros(B, 1)], dim=1)
        msgs = flat[:, self.var_edges]
        s = torch.zeros_like(msgs[:, :, 0])
        for j in range(msgs.shape[-1]):
            s = s + msgs[:, :, j]
        return s

    def forward(self, llrs: torch.Tensor, factors: torch.Tensor) -> DecodeResult:
        B = llrs.shape[0]
        m, D, g = self.m, self.D, self.gather
        llr_in = llrs.float()
        factors = factors.float()
        v2c = (llr_in @ g.T).reshape(B, m, D)
        llr_total = llr_in
        done = torch.zeros(B, dtype=torch.bool, device=llrs.device)
        iters = torch.zeros(B, dtype=torch.int32, device=llrs.device)
        it = 0
        while it < self.max_iters and not bool(done.all()):
            c2v = self._check_update(v2c, factors)
            llr_new = llr_in + self._variable_sum(c2v)
            edge = (llr_new @ g.T).reshape(B, m, D)
            v2c_new = torch.clamp(edge - c2v, -LLR_CLAMP, LLR_CLAMP)
            edge_bits = torch.where(self.row_mask, (edge < 0).float(), 0.0)
            ok = torch.all(torch.sum(edge_bits, dim=-1) % 2.0 == 0.0, dim=-1)
            upd = ~done
            llr_total = torch.where(upd[:, None], llr_new, llr_total)
            v2c = torch.where(upd[:, None, None], v2c_new, v2c)
            iters = iters + upd.int()
            done = done | ok
            it += 1
        info_bits = (llr_total[:, : self.k] < 0).to(torch.uint8)
        return DecodeResult(info_bits, done, iters, llr_total)
