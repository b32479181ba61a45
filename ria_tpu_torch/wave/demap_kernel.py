"""The OFDM demodulator's demap stage as a CUDA kernel (``csrc/ofdm_demap.cu``).

:func:`demap` launches it on CUDA tensors: each carrier's two EMA chains,
its effective noise variance and the DQPSK or QAM64 demapper, in one pass a
carrier.  Its plain version, which CPU tensors and every other modulation
take, is ``wave.ofdm.OFDMDemodulator.demap_plain``; the two agree bit for bit
on the card (the kernel forms every value as ATen does, in ATen's order).
The library ``ofdm_demap`` of ``utils/cuda_kernels.py`` is compiled on its
first load; the kernel launches on PyTorch's current stream, once per call
(``cuda_kernels.launches("ofdm_demap")``).  Nothing here runs at import
time: this module imports on a host with no CUDA toolkit and no card.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ria_tpu_torch.utils import cuda_kernels

# The kernel's modulations: each one's code in the source (``enum Mod``) and
# its bits a carrier.
MODULATIONS = {"DQPSK": (0, 2), "QAM64": (1, 6)}
_KERNEL = cuda_kernels.Kernel("ofdm_demap", "ofdm_demap", 3, 11)
_INT_MAX = 2**31 - 1


def load() -> None:
    """Compile the kernel's library if it is missing and load it, so that
    the first call pays for neither."""
    _KERNEL.fn()


def demap(eq: torch.Tensor, carrier_nv: torch.Tensor, ce_margin: float,
          mod: str) -> torch.Tensor:
    """Launch the demap stage on CUDA tensors: soft [..., S * D * bps]
    float32 of ``eq`` [..., S, D] complex64 and ``carrier_nv`` float32 of
    eq's shape (any strides: a noise variance broadcast over the symbols is
    read as it lies), as ``OFDMDemodulator.demap_plain`` defines it.  Refuses,
    before anything is built or launched, a modulation, type, shape or device
    it does not take."""
    if mod not in MODULATIONS:
        raise ValueError(f"the ofdm_demap kernel demaps {sorted(MODULATIONS)}, not {mod}")
    if eq.dtype != torch.complex64 or eq.dim() < 2:
        raise TypeError(f"eq must be a complex64 tensor [..., S, D], got {eq.dtype} "
                        f"{tuple(eq.shape)}")
    if (carrier_nv.dtype != torch.float32 or carrier_nv.shape != eq.shape
            or carrier_nv.device != eq.device):
        raise ValueError(f"carrier_nv must be float32 {tuple(eq.shape)} on {eq.device}, got "
                         f"{carrier_nv.dtype} {tuple(carrier_nv.shape)} on {carrier_nv.device}")
    if eq.device.type != "cuda":
        raise ValueError(f"the ofdm_demap kernel takes CUDA tensors, got {eq.device}")
    return _demap(eq, carrier_nv, ce_margin, mod)


def _demap(eq: torch.Tensor, carrier_nv: torch.Tensor, ce_margin: float,
           mod: str) -> torch.Tensor:
    code, bps = MODULATIONS[mod]
    *lead, S, D = eq.shape
    rows = math.prod(lead)
    e, nv = eq.resolve_conj().reshape(rows, S, D), carrier_nv.reshape(rows, S, D)
    if max(rows * S * D * bps, *e.stride(), *nv.stride()) > _INT_MAX:
        raise ValueError(f"{rows} rows of {S} x {D} carriers, strides {e.stride()} and "
                         f"{nv.stride()}: past the kernel's 32-bit ints")
    soft = torch.empty((*lead, S * D * bps), dtype=torch.float32, device=eq.device)
    if not soft.numel():  # nothing to demap launches nothing
        return soft
    # The margin goes as the bits of its float32 (the entry points take ints).
    ce_bits = int(np.float32(ce_margin).view(np.int32))
    cuda_kernels.launch(_KERNEL, e, nv, soft, rows, S, D, *e.stride(), *nv.stride(), code,
                        ce_bits)
    return soft
