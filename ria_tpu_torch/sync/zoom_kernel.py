"""The chirp search's window pass as a CUDA kernel (``csrc/zoom_front.cu``).

:func:`zoom_front` launches it on CUDA tensors; its plain version, which
CPU tensors take, is ``ria_tpu_torch.sync.chirp.zoom_front_plain``.  The
library ``zoom_front`` of ``utils/cuda_kernels.py`` is compiled on its first
load; the kernel launches on PyTorch's current stream, one launch per call
of the zoom branch on the card (``cuda_kernels.launches("zoom_front")``).
Nothing here runs at import time: this module imports on a host with no
CUDA toolkit and no card.
"""

from __future__ import annotations

import torch

from ria_tpu_torch.utils import cuda_kernels

_KERNEL = cuda_kernels.Kernel("zoom_front", "zoom_front", 4, 3)
_D = 16  # samples a group: ``_ZOOM_DECIM`` of sync/chirp.py, kD of the source


def load() -> None:
    """Compile the kernel's library if it is missing and load it, so that
    the first call pays for neither."""
    _KERNEL.fn()


def zoom_front(x: torch.Tensor, rot: torch.Tensor,
               nb: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the window pass on CUDA tensors: (zb [B, nb] complex64, blk
    [B, n // 16] float32) of ``x`` [B, n] float32 and the mixing ramp
    ``rot`` [16 (n // 16)] complex64 on the same card, as
    ``sync.chirp.zoom_front_plain`` defines them."""
    if x.device.type != "cuda":
        raise ValueError(f"the zoom_front kernel takes CUDA tensors, got {x.device}")
    if x.dtype != torch.float32 or x.dim() != 2:
        raise TypeError(f"x must be a 2-D float32 tensor, got {x.dtype} {tuple(x.shape)}")
    B, n = x.shape
    nblk = n // _D
    if rot.device != x.device or rot.dtype != torch.complex64 or rot.shape != (nblk * _D,):
        raise ValueError(f"rot must be complex64 [{nblk * _D}] on {x.device}, got "
                         f"{rot.dtype} {tuple(rot.shape)} on {rot.device}")
    if not rot.is_contiguous() or rot.data_ptr() % 16:
        raise ValueError("rot must be contiguous on a 16-byte boundary")
    if nb < nblk:
        raise ValueError(f"nb = {nb} under n // 16 = {nblk}")
    x = x.contiguous()
    zb = torch.empty((B, nb), dtype=torch.complex64, device=x.device)
    blk = torch.empty((B, nblk), dtype=torch.float32, device=x.device)
    if not B or not nb:  # an empty batch launches nothing
        return zb, blk
    cuda_kernels.launch(_KERNEL, x, rot, zb, blk, B, n, nb)
    return zb, blk
