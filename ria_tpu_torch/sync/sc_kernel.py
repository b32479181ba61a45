"""The Schmidl-Cox search as CUDA kernels (``csrc/sc_search.cu``).

:func:`search` runs the search of a ``wave.ofdm.SchmidlCoxDetector`` on a
CUDA tensor: ``sc_pad``, then ``sc_coarse`` in ``sync.coarse``, then in
``sync.fine`` ``sc_slice``, the correlation's FFT pair, ``sc_pick``, the
segment's analytic signal and its LTS pair product, and ``sc_decide`` last.
The FFTs and that 1,120-term product sum stay PyTorch's, called as the plain
search calls them, so cuFFT runs the same plans on the same bits.  Its plain
version, which CPU tensors take, is ``SchmidlCoxDetector.search_plain``; the
two agree bit for bit on the card: the kernels form every value as ATen
does, in ATen's order.  (For a single row ATen's prefix sums run CUB's scan
instead of its innermost-dimension kernel; the two orders matched on the
rows probed on the card, and the tests hold B = 1 on the five outputs.)
That order is torch's private code: ``tests/test_torch_sc_kernel.py`` holds
the installed ATen header's text of it to the text this follows.

The library ``sc_search`` of ``utils/cuda_kernels.py`` is compiled on its
first load; the kernels launch on PyTorch's current stream, each once per
search of a non-empty batch (``cuda_kernels.launches("sc_coarse")`` counts
the searches).  Nothing here runs at import time: this module imports on a
host with no CUDA toolkit and no card.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ria_tpu_torch.dsp.hilbert import analytic_signal
from ria_tpu_torch.utils import cuda_kernels
from ria_tpu_torch.utils.trace import span

# The C entry points: pointer and int arguments of each (then the stream).
_KERNELS = {name: cuda_kernels.Kernel("sc_search", name, ptrs, ints)
            for name, (ptrs, ints) in {"sc_pad": (2, 5), "sc_coarse": (7, 12),
                                       "sc_slice": (3, 5), "sc_pick": (7, 11),
                                       "sc_decide": (9, 1)}.items()}
_DEC = 8          # samples a group: ``_SC_DEC`` of wave/ofdm.py, kDec of the source
_SMEM_SLACK = 1024  # bytes of shared memory a block keeps for its static arrays


def load() -> None:
    """Compile the kernels' library if it is missing and load it, so that
    the first search pays for neither."""
    for kernel in _KERNELS.values():
        kernel.fn()


def scan_log_threads(num_rows: int, row_size: int) -> int:
    """log2 of the threads along a row that ATen's innermost-dimension scan
    (``get_log_num_threads_x_inner_scan``, ATen/native/cuda/ScanUtils.cuh)
    gives ``num_rows`` rows of ``row_size``: it scans a row in chunks of
    twice as many elements.  In uint32 arithmetic, as ATen computes it."""
    lx = max(int(row_size) - 1, 0).bit_length()
    ly = max(int(num_rows) - 1, 0).bit_length()
    diff = (lx - ly) & 0xFFFFFFFF
    return min(max(4, ((9 + diff) & 0xFFFFFFFF) // 2), 9)


def _chain_doubles(n: int, log_x: int) -> int:
    """float64 slots of one scan's chunk chain (``Scan.chain`` of the source)."""
    log_c = log_x + 1
    return -(-n // (1 << log_c)) * (log_c + 1)


def _align(nbytes: int) -> int:
    return (nbytes + 15) & ~15


def coarse_layout(B: int, n: int, half: int) -> tuple[int, ...]:
    """``sc_coarse``'s row: (log_x1, log_x2, off_a, off_r2, off_chain,
    row_bytes) for B windows of n samples and a lag of ``half`` groups: zb's
    8 bytes a group, then |zb|^2 (R1's prefix) and R2's prefix, 4 bytes a
    group, then the chains of its four prefix sums (P's two parts, R2, R1)."""
    n1 = n // _DEC
    n2 = n1 - half
    log_x1, log_x2 = scan_log_threads(B, n1), scan_log_threads(B, n2)
    off_a = 8 * n1
    off_r2 = off_a + 4 * n1
    off_chain = _align(off_r2 + 4 * n2)
    chain = 8 * (3 * _chain_doubles(n2, log_x2) + _chain_doubles(n1, log_x1))
    return log_x1, log_x2, off_a, off_r2, off_chain, _align(off_chain + chain)


def pick_bytes(R: int, L: int, log_x: int) -> int:
    """``sc_pick``'s shared memory: the slice's R floats, the correlation's
    R - L lags (complex64) and the chains of the slice's prefix sum."""
    return _align(4 * R) + _align(8 * (R - L)) + 8 * _chain_doubles(R, log_x)


@functools.lru_cache(maxsize=None)
def _smem_limit(index: int) -> int:
    props = torch.cuda.get_device_properties(index)
    return getattr(props, "shared_memory_per_block_optin", 49152) - _SMEM_SLACK


class _Plan(NamedTuple):
    """The launches' integer arguments for one batch size on one card."""

    seg_len: int      # the fine CFO's segment: a symbol and the LTS
    seg_nfft: int     # its analytic signal's FFT length
    coarse: tuple     # half, cp, log_x1, log_x2, off_a, off_r2, off_chain, row_bytes, smem
    pick: tuple       # log_x, shared bytes


@functools.lru_cache(maxsize=256)
def _plan(B: int, n: int, fft_size: int, cp_len: int, sym: int, L: int, R: int,
          smem_limit: int) -> _Plan:
    seg_len = sym + L
    half = fft_size // 2 // _DEC
    log_x1, log_x2, off_a, off_r2, off_chain, row_bytes = coarse_layout(B, n, half)
    smem = row_bytes if row_bytes <= smem_limit else 0  # else a global scratch
    log_x = scan_log_threads(B, R)
    return _Plan(seg_len, 1 << (seg_len - 1).bit_length(),
                 (half, cp_len // _DEC, log_x1, log_x2, off_a, off_r2, off_chain, row_bytes, smem),
                 (log_x, pick_bytes(R, L, log_x)))


def _call(entry: str, *args) -> None:
    cuda_kernels.launch(_KERNELS[entry], *args)


def search(det, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The Schmidl-Cox search of ``det`` (a ``wave.ofdm.SchmidlCoxDetector``
    built for windows of its ``n`` samples, not short) over x [B, n] float32
    on its card: (detected, lts_start, cfo_hz, metric, lts_corr), each [B],
    as ``det.search_plain`` returns them.  Refuses, before anything is built
    or launched, a tensor that is not 2-D float32 on a card of the detector's
    window."""
    if x.dim() != 2 or x.dtype != torch.float32:
        raise TypeError(f"x must be a 2-D torch.float32 tensor, got {x.dtype} {tuple(x.shape)}")
    if det.short or x.shape[1] != det.n:
        raise ValueError(f"a window of {x.shape[1]} samples, the detector's is {det.n}"
                         + (" (too short to search)" if det.short else ""))
    if x.device.type != "cuda":
        raise ValueError(f"the Schmidl-Cox search kernels take CUDA tensors, got {x.device}")
    if det.rot.device != x.device:
        raise ValueError(f"the detector is on {det.rot.device}, x on {x.device}")
    if x.stride(-1) != 1:
        x = x.contiguous()
    return _search(det, x)


def _search(det, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
    cfg = det.cfg
    dev = x.device
    B, n = x.shape
    if B == 0:
        f = torch.empty(0, dtype=torch.float32, device=dev)
        return (torch.empty(0, dtype=torch.bool, device=dev),
                torch.empty(0, dtype=torch.int32, device=dev), f, f, f)
    ld = x.stride(0) if B > 1 else n
    sym, L, R, nfft = cfg.symbol_samples, det.L, det.R, det.nfft
    plan = _plan(B, n, cfg.fft_size, cfg.cp_len, sym, L, R, _smem_limit(dev.index))
    # Each row's outputs: peak, lts_pos, lts_start; peak_val, cfo, lts_val, cfo_hz.
    ints = torch.empty((3, B), dtype=torch.int32, device=dev)
    floats = torch.empty((4, B), dtype=torch.float32, device=dev)
    peak, lts_pos, lts_start = ints
    peak_val, cfo, lts_val, cfo_hz = floats

    # The FFT inputs' zero padding opens the search, so that ``rx.sync``
    # keeps a device-side range over all of it (the decision closes it).
    slc = torch.empty((B, nfft), dtype=torch.complex64, device=dev)
    seg = torch.empty((B, plan.seg_nfft), dtype=torch.float32, device=dev)
    _call("sc_pad", slc, seg, B, R, nfft, plan.seg_len, plan.seg_nfft)
    with span("sync.coarse"):
        row_bytes, smem = plan.coarse[-2:]
        scratch = 0 if smem else torch.empty(B * row_bytes, dtype=torch.uint8, device=dev)
        _call("sc_coarse", x, det.rot, det.sc_consts, peak, peak_val, cfo, scratch, B, n, ld,
              *plan.coarse)
    with span("sync.fine"):
        _call("sc_slice", x, peak, slc, B, n, ld, R, nfft)
        xc = torch.fft.ifft(torch.fft.fft(slc, nfft) * det.lts_fft)
        _call("sc_pick", x, xc, peak, det.sc_consts, lts_pos, lts_val, seg, B, n, ld, R, L, sym,
              nfft, plan.seg_len, plan.seg_nfft, *plan.pick)
        segz = analytic_signal(seg)
        r = torch.sum(segz[:, :L] * torch.conj(segz[:, sym : sym + L]), dim=-1)
    detected = torch.empty(B, dtype=torch.bool, device=dev)
    _call("sc_decide", r, peak_val, cfo, lts_pos, lts_val, det.sc_consts, detected, lts_start,
          cfo_hz, B)
    return detected, lts_start, cfo_hz, peak_val, lts_val

