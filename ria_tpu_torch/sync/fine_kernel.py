"""The chirp search's fine stage as CUDA kernels (``csrc/chirp_fine.cu``).

One peak refinement of the zoom branch (``sync.chirp.ChirpDetector.
_refine_peak``) on the card is :func:`refine_front`, the two matmuls, which
stay ``torch.matmul`` on the slice it writes, and :func:`refine_pick`; the
CFAR floor's median (``sync.chirp._median``) is :func:`median_select`.  Their
plain versions, which CPU tensors take, are ``sync.chirp.refine_front_plain``,
``refine_pick_plain`` and ``median_plain``; the two agree bit for bit on the
card: the kernels form every value as ATen does, in ATen's order, the prefix
sums in that of its innermost-dimension scan (``csrc/aten_order.cuh``, shared
with the Schmidl-Cox search, whose tests hold the installed ATen's text of it).
For a single row ATen's cumsum runs CUB's scan instead, and the card tests
hold the refinement's outputs at B = 1.  The median ranks as the radix sort
that ``torch.sort`` runs for rows longer than 4,096 (a negative NaN first,
-0 with +0 in the row's order); for shorter rows its bitonic sort ranks every
NaN last.

The library ``chirp_fine`` of ``utils/cuda_kernels.py`` is compiled on its
first load; the kernels launch on PyTorch's current stream, each once per call
on a non-empty batch, and ``cuda_kernels.launches`` counts them by entry point
(``chirp_refine_front``, ``chirp_refine_pick``, ``median_select``: 2, 2 and 1
a zoom-branch call).  Nothing here runs at import time: this module imports on
a host with no CUDA toolkit and no card.
"""

from __future__ import annotations

import numpy as np
import torch

from ria_tpu_torch.sync.sc_kernel import _align, _chain_doubles, _smem_limit, scan_log_threads
from ria_tpu_torch.utils import cuda_kernels

# The C entry points: pointer and int arguments of each (then the stream).
_KERNELS = {name: cuda_kernels.Kernel("chirp_fine", name, ptrs, ints)
            for name, (ptrs, ints) in {"chirp_refine_front": (5, 8),
                                       "chirp_refine_pick": (6, 5),
                                       "median_select": (2, 4)}.items()}
# Shared memory a block of ``median_select`` keeps for its static arrays,
# beyond what ``sc_kernel._smem_limit`` keeps.
_SELECT_STATIC = 1024


def load() -> None:
    """Compile the kernels' library if it is missing and load it, so that
    the first call pays for neither."""
    for kernel in _KERNELS.values():
        kernel.fn()


def _f32_bits(v: float) -> int:
    """The bits of ``v`` rounded to float32, as ATen rounds a Python scalar
    that meets a float32 tensor, as a signed int."""
    return int(np.float32(v).view(np.int32))


def front_smem_bytes(L: int, log_x: int) -> int:
    """``chirp_refine_front``'s shared memory: the slice's L squares (then
    their prefixes) and the chains of its prefix sum."""
    return _align(4 * L) + 8 * _chain_doubles(L, log_x)


def _typed(t: torch.Tensor, what: str, dtype: torch.dtype, dim: int) -> None:
    if t.dtype != dtype or t.dim() != dim:
        raise TypeError(f"{what} must be a {dim}-D {dtype} tensor, got {t.dtype} {tuple(t.shape)}")


def _on_card(device: torch.device, *others: torch.Tensor) -> None:
    if device.type != "cuda":
        raise ValueError(f"the chirp fine-stage kernels take CUDA tensors, got {device}")
    for t in others:
        if t.device != device:
            raise ValueError(f"tensors on {t.device} and {device}")


def refine_front(x: torch.Tensor, coarse_pos: torch.Tensor, chirp_len: int,
                 R: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(start [B] int32, y [B, L] float32, win [B, 2R + 1] float32) of x [B, n]
    float32 and the coarse peaks coarse_pos [B] int32 on one card, L =
    chirp_len + 2R, as ``sync.chirp.refine_front_plain`` defines them.
    Refuses, before anything is built or launched, what the kernel does not
    take."""
    _typed(x, "x", torch.float32, 2)
    _typed(coarse_pos, "coarse_pos", torch.int32, 1)
    B, n = x.shape
    L = chirp_len + 2 * R
    if coarse_pos.shape != (B,):
        raise ValueError(f"coarse_pos must be [{B}], got {tuple(coarse_pos.shape)}")
    if chirp_len < 1 or R < 0 or L > n:
        raise ValueError(f"a slice of {chirp_len} + 2 x {R} samples from windows of {n}")
    _on_card(x.device, coarse_pos)
    log_x = scan_log_threads(B, L)
    smem = front_smem_bytes(L, log_x)
    if smem > _smem_limit(x.device.index):
        raise ValueError(f"a slice of {L} samples takes {smem} bytes of shared memory, over "
                         f"the card's {_smem_limit(x.device.index)}")
    if x.stride(-1) != 1:
        x = x.contiguous()
    pos = coarse_pos.contiguous()
    start = torch.empty(B, dtype=torch.int32, device=x.device)
    y = torch.empty((B, L), dtype=torch.float32, device=x.device)
    win = torch.empty((B, 2 * R + 1), dtype=torch.float32, device=x.device)
    if B:
        cuda_kernels.launch(_KERNELS["chirp_refine_front"], x, pos, start, y, win, B, n,
                            x.stride(0) if B > 1 else n, L, chirp_len, 2 * R + 1, log_x, smem)
    return start, y, win


def refine_pick(cr: torch.Tensor, ci: torch.Tensor, win: torch.Tensor, start: torch.Tensor,
                energy: float, floor_ratio: float,
                denom_min: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(lag [B] int32, val [B] float32) of the refinement's correlations cr,
    ci and window energies win, each [B, 2R + 1] float32, and the slices'
    start [B] int32 on one card, as ``sync.chirp.refine_pick_plain`` defines
    them with these scalars.  Refuses, before anything is launched, what the
    kernel does not take."""
    for name, t in (("cr", cr), ("ci", ci), ("win", win)):
        _typed(t, name, torch.float32, 2)
    _typed(start, "start", torch.int32, 1)
    B, nwin = win.shape
    if cr.shape != (B, nwin) or ci.shape != (B, nwin) or start.shape != (B,) or nwin < 1:
        raise ValueError(f"cr, ci as win [{B}, {nwin}] (at least one lag) and start [{B}], "
                         f"got {tuple(cr.shape)}, {tuple(ci.shape)}, {tuple(start.shape)}")
    _on_card(win.device, cr, ci, start)
    lag = torch.empty(B, dtype=torch.int32, device=win.device)
    val = torch.empty(B, dtype=torch.float32, device=win.device)
    if B:
        cuda_kernels.launch(_KERNELS["chirp_refine_pick"], cr.contiguous(), ci.contiguous(),
                            win.contiguous(), start.contiguous(), lag, val, B, nwin,
                            _f32_bits(floor_ratio), _f32_bits(energy), _f32_bits(denom_min))
    return lag, val


def median_select(x: torch.Tensor) -> torch.Tensor:
    """The median of each row of x [B, m] float32 on a card, m >= 1: the mean
    of its (m - 1) // 2-th and m // 2-th smallest values, [B] float32, as
    ``sync.chirp.median_plain`` takes it.  Refuses, before anything is
    launched, what the kernel does not take."""
    _typed(x, "x", torch.float32, 2)
    B, m = x.shape
    if m < 1:
        raise ValueError("the median of an empty row")
    _on_card(x.device)
    if x.stride(-1) != 1:
        x = x.contiguous()
    out = torch.empty(B, dtype=torch.float32, device=x.device)
    # Rows that fit are staged in shared memory, else read on every pass.
    smem = 4 * m if 4 * m <= _smem_limit(x.device.index) - _SELECT_STATIC else 0
    if B:
        cuda_kernels.launch(_KERNELS["median_select"], x, out, B, m,
                            x.stride(0) if B > 1 else m, smem)
    return out
