"""The CUDA LDPC decoders by kernel: the counterpart of ``ria_tpu/fec/ldpc_pallas.py``.

- :func:`make_cuda_decoder` is kernel K1 (``csrc/ldpc_bp.cu``), the port of
  ``make_pallas_decoder``;
- :func:`make_cuda_decoder_v1` is kernel K2 (``csrc/ldpc_bp_v1.cu``), the
  port of ``make_pallas_decoder_v1``, kept for A/B
  (``python -m ria_tpu_torch.tools.ldpc_bench``).

Each returns ``decode(llrs [B, 648], factors [B] | None) -> DecodeResult``
as the Pallas builders do; ``factors=None`` means ``min_sum_factor`` on every
row.  There is no ``tile`` argument: both kernels exit per codeword and need
no padding.  There is no ``interpret`` argument either: neither kernel has a
CPU mode, so a CPU device or a CPU tensor raises.
"""

from __future__ import annotations

import torch

from ria_tpu_torch.fec import ldpc_kernel
from ria_tpu_torch.fec.ldpc import DecodeResult, LDPCDecoder, ldpc_decoder
from ria_tpu_torch.fec.ldpc_matrix import MIN_SUM_FACTOR
from ria_tpu_torch.utils.device import resolve_device


def _cuda_decoder(rate: str, max_iters: int | None, device) -> LDPCDecoder:
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"the LDPC kernels are CUDA only, got device {dev}")
    return ldpc_decoder(rate, max_iters, dev)


def _args(llrs: torch.Tensor, factors: torch.Tensor | None, min_sum_factor: float):
    if factors is None:
        factors = torch.full((llrs.shape[0],), min_sum_factor, dtype=torch.float32,
                             device=llrs.device)
    return llrs.float().contiguous(), factors.float().contiguous()


def make_cuda_decoder(rate: str, max_iters: int | None = None,
                      min_sum_factor: float = MIN_SUM_FACTOR,
                      device: str | torch.device = "cuda"):
    """Kernel K1: decode(llrs, factors=None) -> DecodeResult on CUDA tensors."""
    dec = _cuda_decoder(rate, max_iters, device)

    def decode(llrs: torch.Tensor, factors: torch.Tensor | None = None) -> DecodeResult:
        x, f = _args(llrs, factors, min_sum_factor)
        return DecodeResult(*ldpc_kernel.bp_decode(
            x, f, dec.row_idx, dec.row_mask, dec.col_ptr, dec.col_edge, dec.k,
            dec.max_iters))

    return decode


def make_cuda_decoder_v1(rate: str, max_iters: int | None = None,
                         min_sum_factor: float = MIN_SUM_FACTOR,
                         device: str | torch.device = "cuda"):
    """Kernel K2: decode(llrs, factors=None) -> DecodeResult on CUDA tensors.
    Its plain PyTorch version is :meth:`LDPCDecoder.plain_v1`."""
    dec = _cuda_decoder(rate, max_iters, device)

    def decode(llrs: torch.Tensor, factors: torch.Tensor | None = None) -> DecodeResult:
        x, f = _args(llrs, factors, min_sum_factor)
        return DecodeResult(*ldpc_kernel.bp_decode_v1(
            x, f, dec.row_idx, dec.row_mask, dec.slot_ptr, dec.slot_chk, dec.k,
            dec.max_iters))

    return decode
