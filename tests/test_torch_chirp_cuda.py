"""The chirp search's window pass, CUDA kernel ``csrc/zoom_front.cu``, on the
card (needs a GPU; every test skips without one).  Imports no JAX:

    python -m pytest -q -m cuda tests/test_torch_chirp_cuda.py

The kernel against its plain version (``sync.chirp.zoom_front_plain``, run
on the card) at the served cell's shape, at B = 1 and at a window whose
length is neither a multiple of 16 nor of 4 (the scalar loads); its launch
count; and the MC-DPSK chain of the benchmark's cell
``mcdpsk_r14.gw256_awgn0`` with the kernel against the same chain with the
plain version, on the cell's pool of 8 batches at two seeds.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from ria_tpu_torch.sync import chirp, zoom_kernel
from ria_tpu_torch.utils import cuda_kernels

ROOT = Path(__file__).resolve().parents[1]
CELL = "mcdpsk_r14.gw256_awgn0"
D = 16
# The kernel adds each group's 16 products in the order of PyTorch's own
# reduction (csrc/zoom_front.cu), so the two agree bit for bit but for the
# sign of a zero.  The tolerance is what the order of a 16-term float32 sum
# may move: at most 2 * 15 * 2**-24 of the sum of the terms' magnitudes
# (each order within 15 roundings of the exact sum).
ORDER_TOL = 2 * 15 * 2.0**-24


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the window pass is a CUDA kernel")
    return torch.device("cuda", 0)


def _window(B: int, n: int, dev: torch.device, offset: int = 0) -> torch.Tensor:
    """[B, n] float32 noise at the benchmark's 0 dB scale, with all-zero
    groups: 40 groups of every row and the last 3,000 samples of row 0
    (the zero-padded tail of a station's window).  ``offset`` floats into
    a larger buffer, so that the rows start off a 16-byte boundary."""
    rng = np.random.default_rng(B * 7 + n)
    x = rng.normal(0.0, 0.35, (B, n)).astype(np.float32)
    x[:, 16 * 300 : 16 * 340] = 0.0
    x[0, n - 3000 :] = 0.0
    flat = torch.zeros(B * n + offset, dtype=torch.float32, device=dev)
    flat[offset:] = torch.as_tensor(x.reshape(-1), device=dev)
    return flat[offset:].view(B, n)


def _ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """The widest gap in units in the last place of ``want``."""
    want64 = want.double()
    ulp = torch.nextafter(want.abs(), torch.full_like(want, float("inf"))).double() - want64.abs()
    return float(((got.double() - want64).abs() / ulp).max())


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,offset", [(256, 207328, 0), (1, 207328, 0), (3, 207327, 0),
                                        (2, 207328, 1)],
                         ids=["cell", "one-row", "n-odd", "unaligned"])
def test_kernel_matches_plain(B, n, offset, cuda_device):
    det = chirp.ChirpDetector(chirp.ChirpConfig(), n, cuda_device)
    assert det.zoom
    nb, nblk = det.nfft // D, n // D
    x = _window(B, n, cuda_device, offset)
    assert (x.data_ptr() % 16 == 0 and n % 4 == 0) == (offset == 0 and n % 4 == 0)
    before = cuda_kernels.launches("zoom_front")
    zb, blk = zoom_kernel.zoom_front(x, det.rot, nb)
    torch.cuda.synchronize()
    assert cuda_kernels.launches("zoom_front") == before + 1
    want_zb, want_blk = chirp.zoom_front_plain(x, det.rot, nb)
    assert zb.shape == (B, nb) and zb.dtype == torch.complex64
    assert blk.shape == (B, nblk) and blk.dtype == torch.float32

    # Each group's sum of magnitudes, in double: the scale of the tolerance.
    xg = x[:, : nblk * D].double().reshape(B, nblk, D)
    rot = det.rot.reshape(nblk, D)
    scale = {"re": (xg * rot.real.double()).abs().sum(-1),
             "im": (xg * rot.imag.double()).abs().sum(-1), "blk": (xg * xg).sum(-1)}
    pairs = {"re": (zb.real[:, :nblk], want_zb.real[:, :nblk]),
             "im": (zb.imag[:, :nblk], want_zb.imag[:, :nblk]), "blk": (blk, want_blk)}
    for name, (got, want) in pairs.items():
        gap = (got.double() - want.double()).abs()
        print(f"{name}: B={B} n={n} offset={offset}: worst gap {_ulps(got, want):.3g} ulp, "
              f"{int((gap > 0).sum())} of {gap.numel()} groups differ")
        assert bool((gap <= ORDER_TOL * scale[name]).all()), name
    # The zero groups and the FFT's padding: exactly 0.
    assert bool((zb[:, 300:340] == 0).all()) and bool((blk[:, 300:340] == 0).all())
    tail = (n - 3000 + D - 1) // D
    assert bool((zb[0, tail:] == 0).all()) and bool((blk[0, tail:] == 0).all())
    assert bool((zb[:, nblk:] == 0).all())


@pytest.mark.cuda
def test_one_launch_per_detector_call(cuda_device):
    n = 207328
    det = chirp.chirp_detector(chirp.ChirpConfig(), n, cuda_device)
    x = _window(4, n, cuda_device)
    before = cuda_kernels.launches("zoom_front")
    for calls in (1, 2, 3):
        det(x)
        assert cuda_kernels.launches("zoom_front") == before + calls
    chirp.detect_dual_chirp(x[:1], chirp.ChirpConfig())
    assert cuda_kernels.launches("zoom_front") == before + 4


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [1, 2718281828])
def test_cell_chain_equals_the_plain_pass(seed, cuda_device, monkeypatch):
    """The MC-DPSK chain of the benchmark's cell, on its pool: every output
    of the chain with the kernel equal to the chain's with the plain pass."""
    from benchmark.harness import load_cell

    cell = load_cell(ROOT, CELL)
    pool, _ = cell.generator.make_pool(cell.config, cell.traffic, seed, cuda_device)
    program = cell.entry.Program(cell.config, cell.traffic, cuda_device)
    with torch.no_grad():
        before = cuda_kernels.launches("zoom_front")
        got = [program(batch.to(cuda_device)) for batch in pool]
        assert cuda_kernels.launches("zoom_front") == before + len(pool)
        with monkeypatch.context() as m:
            m.setattr(chirp, "zoom_front", chirp.zoom_front_plain)
            want = [program(batch.to(cuda_device)) for batch in pool]
        assert cuda_kernels.launches("zoom_front") == before + len(pool)
    for g, w in zip(got, want):
        assert bool(g["detected"].any())
        for name in ("detected", "start", "cfo_hz", "snr_db", "cw_success", "info_bits",
                     "iterations"):
            assert torch.equal(g[name], w[name]), name
