"""The light preamble's LTS search as CUDA kernels (``csrc/lts_search.cu``).

:func:`search` runs the search of a ``wave.ofdm.LTSDetector`` on a CUDA
tensor: ``lts_pad``, then in ``sync.coarse`` ``lts_front`` and the
correlation's FFT pair with its product by the template's spectrum, then
``lts_pick`` in ``sync.fine``, and ``lts_decide`` last.  The FFTs and the
product stay PyTorch's, called on the same bits as the plain search calls
them (the inverse unscaled: ``lts_pick`` applies its 1 / nfft as ATen
would), so cuFFT runs the same plans.  Its plain version, which CPU tensors
take, is ``LTSDetector.search_plain``; the two agree bit for bit on the card:
the kernels form every value as ATen does, in ATen's order, the prefix sums
in that of its innermost-dimension scan (``csrc/aten_order.cuh``, whose
installed text ``tests/test_torch_sc_kernel.py`` holds).  For a single row
ATen's cumsum runs CUB's scan instead, and the card tests hold the search's
outputs at B = 1.

The library ``lts_search`` of ``utils/cuda_kernels.py`` is compiled on its
first load; the kernels launch on PyTorch's current stream, each once per
search of a non-empty batch (``cuda_kernels.launches("lts_front")`` and
``("lts_pick")`` count the searches).  Nothing here runs at import time:
this module imports on a host with no CUDA toolkit and no card.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ria_tpu_torch.sync.sc_kernel import _align, _chain_doubles, _smem_limit, scan_log_threads
from ria_tpu_torch.utils import cuda_kernels
from ria_tpu_torch.utils.trace import span

# The C entry points: pointer and int arguments of each (then the stream).
_KERNELS = {name: cuda_kernels.Kernel("lts_search", name, ptrs, ints)
            for name, (ptrs, ints) in {"lts_pad": (1, 3), "lts_front": (5, 9),
                                       "lts_pick": (6, 7), "lts_decide": (3, 1)}.items()}


def load() -> None:
    """Compile the kernels' library if it is missing and load it, so that
    the first search pays for neither."""
    for kernel in _KERNELS.values():
        kernel.fn()


def front_bytes(n: int, log_x: int) -> int:
    """``lts_front``'s row: the window's n squares (then their prefixes) and
    the chains of its prefix sum, in ATen's chunks of 2^(log_x + 1)."""
    return _align(4 * n) + _align(8 * _chain_doubles(n, log_x))


class _Plan(NamedTuple):
    """The launches' integer arguments for one batch of windows on one card."""

    lde: int        # e's row stride: the lags rounded up to 16 bytes
    log_x: int      # ATen's scan geometry for B rows of n
    row_bytes: int  # lts_front's row
    smem: int       # row_bytes where a block holds it, else 0 (a global scratch)


@functools.lru_cache(maxsize=256)
def _plan(B: int, n: int, L: int, smem_limit: int) -> _Plan:
    log_x = scan_log_threads(B, n)
    row_bytes = front_bytes(n, log_x)
    return _Plan((n - L + 3) & ~3, log_x, row_bytes, row_bytes if row_bytes <= smem_limit else 0)


def _call(entry: str, *args) -> None:
    cuda_kernels.launch(_KERNELS[entry], *args)


def search(det, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The LTS search of ``det`` (a ``wave.ofdm.LTSDetector`` built for
    windows of its ``n`` samples, not short) over x [B, n] float32 on a
    card: (detected, lts_start, corr, cfo_hz, repeats), each [B], as
    ``det.search_plain`` returns them.  ``LTSDetector.forward`` checks the
    window and the dtype; this refuses, before anything is built or
    launched, a tensor on another device than the detector's."""
    if det.lts_fft.device != x.device:
        raise ValueError(f"the detector is on {det.lts_fft.device}, x on {x.device}")
    if x.stride(-1) != 1:
        x = x.contiguous()
    dev = x.device
    B, n = x.shape
    if B == 0:
        f = torch.empty(0, dtype=torch.float32, device=dev)
        return (torch.empty(0, dtype=torch.bool, device=dev),
                torch.empty(0, dtype=torch.int32, device=dev), f, f,
                torch.empty(0, dtype=torch.int32, device=dev))
    ld = x.stride(0) if B > 1 else n
    L, nfft, sym = det.L, det.nfft, det.cfg.symbol_samples
    plan = _plan(B, n, L, _smem_limit(dev.index))
    # Each row's position, detection and repeats; its correlation and CFO.
    ints = torch.empty((3, B), dtype=torch.int32, device=dev)
    floats = torch.empty((2, B), dtype=torch.float32, device=dev)

    # The FFT input's zero tail opens the search, so that ``rx.sync`` keeps a
    # device-side range over all of it (the decision closes it).
    buf = torch.empty((B, nfft), dtype=torch.complex64, device=dev)
    _call("lts_pad", buf, B, n, nfft)
    with span("sync.coarse"):
        e = torch.empty((B, plan.lde), dtype=torch.float32, device=dev)
        emax = torch.empty(B, dtype=torch.float32, device=dev)
        scratch = 0 if plan.smem else torch.empty(B * plan.row_bytes, dtype=torch.uint8,
                                                  device=dev)
        _call("lts_front", x, buf, e, emax, scratch, B, n, ld, L, plan.lde, nfft, plan.log_x,
              plan.row_bytes, plan.smem)
        spec = torch.fft.fft(buf)
        del buf
        spec.mul_(det.lts_fft)
        xc = torch.fft.ifft(spec, norm="forward")
        del spec
    with span("sync.fine"):
        _call("lts_pick", xc, e, emax, det.lts_consts, ints, floats, B, n - L, plan.lde, nfft,
              sym, *det.refine_lags)
    detected = torch.empty(B, dtype=torch.bool, device=dev)
    lts_start = torch.empty(B, dtype=torch.int32, device=dev)
    _call("lts_decide", ints, detected, lts_start, B)
    return detected, lts_start, floats[0], floats[1], ints[2]
