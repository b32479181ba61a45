"""The Schmidl-Cox search's CUDA kernels (``csrc/sc_search.cu``, wrapper
``sync/sc_kernel.py``) on the card (needs a GPU; every test skips without
one).  Imports no JAX:

    python -m pytest -q -m cuda tests/test_torch_sc_cuda.py

The kernels against the plain search (``SchmidlCoxDetector.search_plain``,
run on the card) on all five outputs, bit for bit: at the benchmark cells'
shapes, at B = 1, with leads at 0 and at the latest the window allows, on
rows of noise alone and all-zero rows, on rows off a 16-byte boundary and
on rows with zero tails; the launch count; and each served OFDM chain of the benchmark
with the kernels against the same chain with the plain search, on its
cell's pool at two seeds.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from ria_tpu_torch.sync import sc_kernel
from ria_tpu_torch.utils import cuda_kernels
from ria_tpu_torch.wave import ofdm

ROOT = Path(__file__).resolve().parents[1]
QAM64 = ofdm.OFDMConfig(modulation="QAM64", use_pilots=True, pilot_spacing=8)
DQPSK = ofdm.OFDMConfig(modulation="DQPSK")
SHAPES = {"qam64": (QAM64, 2048, 26160), "dqpsk": (DQPSK, 1024, 42720)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Schmidl-Cox search's kernels are CUDA kernels")
    return torch.device("cuda", 0)


def _frames(cfg: ofdm.OFDMConfig, count: int, seed: int) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [ofdm.tx_frame(rng.integers(0, 2, 4 * 648), cfg, "cox",
                          tx_cfo_hz=float(rng.uniform(-20.0, 20.0))) for _ in range(count)]


def windows(cfg: ofdm.OFDMConfig, B: int, n: int, dev: torch.device, seed: int = 0,
            offset: int = 0) -> torch.Tensor:
    """[B, n] float32 on the card: a frame at a lead in each row at 20 dB
    (rows 0 and 1 at lead 0 and at the latest lead that holds the frame),
    every 5th row noise alone, every 7th all zeros, every 3rd with its last
    3,000 samples zero.  ``offset`` floats into a larger buffer, so that the
    rows start off a 16-byte boundary."""
    rng = np.random.default_rng(seed + B + n)
    frames = _frames(cfg, 4, seed)
    x = np.zeros((B, n), np.float32)
    for b in range(B):
        f = frames[b % len(frames)]
        latest = max(n - len(f), 0)
        lead = 0 if b == 0 else latest if b == 1 else int(rng.integers(0, latest + 1))
        if b % 5 != 4:
            k = min(len(f), n - lead)
            x[b, lead : lead + k] = f[:k]
    sigma = float(np.sqrt(np.mean(frames[0] ** 2))) / 10.0
    noise = rng.standard_normal((B, n), dtype=np.float32) * np.float32(sigma)
    x += noise
    x[2::3, n - 3000 :] = 0.0
    x[3::7] = 0.0
    flat = torch.zeros(B * n + offset, dtype=torch.float32, device=dev)
    flat[offset:] = torch.as_tensor(x.reshape(-1), device=dev)
    return flat[offset:].view(B, n)


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bits, so that equality is bit for bit (zero signs, NaNs)."""
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def assert_equal(got, want, what: str) -> None:
    for name, g, w in zip(ofdm.SCSyncResult._fields, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, (what, name)
        same = _bits(g) == _bits(w)
        if not bool(same.all()):
            rows = torch.nonzero(~same).reshape(-1)[:8].tolist()
            raise AssertionError(f"{what}: {name} differs in {int((~same).sum())} rows, e.g. "
                                 f"{rows}: {g[rows].tolist()} against {w[rows].tolist()}")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["qam64", "dqpsk"])
def test_kernels_equal_plain_at_the_cells_shapes(cell, cuda_device):
    cfg, B, n = SHAPES[cell]
    det = ofdm.SchmidlCoxDetector(cfg, n, cuda_device)
    x = windows(cfg, B, n, cuda_device, seed=3)
    before = cuda_kernels.launches("sc_coarse")
    got = det(x)
    assert cuda_kernels.launches("sc_coarse") == before + 1
    want = det.search_plain(x)
    assert_equal(got, want, cell)
    # The search works: the frame at lead 0 is found, no all-zero row is.
    assert bool(got.detected[0]) and abs(int(got.lts_start[0]) - 5 * cfg.symbol_samples) <= 16
    assert not bool(got.detected[3::7].any())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["qam64", "dqpsk"])
@pytest.mark.parametrize("B,offset", [(1, 0), (5, 0), (3, 1), (64, 2)],
                         ids=["one-row", "five", "unaligned", "unaligned-64"])
def test_kernels_equal_plain_at_small_batches(cell, B, offset, cuda_device):
    """Few rows: ATen's prefix sums take the widest chunks (1,024), and at
    B = 1 CUB's scan, whose grouping varies with the timing of its tiles;
    the five outputs agree all the same.  Rows off a 16-byte boundary take
    the kernels' scalar loads."""
    cfg, _, n = SHAPES[cell]
    det = ofdm.schmidl_cox_detector(cfg, n, cuda_device)
    x = windows(cfg, B, n, cuda_device, seed=11, offset=offset)
    assert (x.data_ptr() % 16 == 0) == (offset == 0)
    assert_equal(det(x), det.search_plain(x), f"{cell} B={B} offset={offset}")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [48000, 120000])
def test_kernels_equal_plain_on_long_windows(n, cuda_device):
    """The API's 48,000-sample search window, and a window whose row does not
    fit in a block's shared memory (kept in a global scratch instead)."""
    det = ofdm.SchmidlCoxDetector(DQPSK, n, cuda_device)
    x = windows(DQPSK, 6, n, cuda_device, seed=5)
    assert_equal(det(x), det.search_plain(x), f"n={n}")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["qam64", "dqpsk"])
@pytest.mark.parametrize("B", [2048, 4, 1])
def test_kernels_equal_plain_on_rows_with_zero_tails(cell, B, cuda_device):
    """Rows whose last fifth (and every third row's last two thirds) is 0:
    the prefix sums stay constant there, the sliding energies read 0 and the
    floors decide, in the kernels as in the plain search."""
    cfg, _, n = SHAPES[cell]
    det = ofdm.schmidl_cox_detector(cfg, n, cuda_device)
    x = windows(cfg, B, n, cuda_device, seed=B + 17)
    x[:, n - n // 5 :] = 0
    x[::3, n // 3 :] = 0
    assert_equal(det(x), det.search_plain(x), f"{cell} B={B} zero tails")


@pytest.mark.cuda
def test_one_launch_per_search(cuda_device):
    n = 26160
    det = ofdm.schmidl_cox_detector(QAM64, n, cuda_device)
    x = windows(QAM64, 4, n, cuda_device)
    before = cuda_kernels.launches("sc_coarse")
    for calls in (1, 2, 3):
        det(x)
        assert cuda_kernels.launches("sc_coarse") == before + calls
    ofdm.schmidl_cox_search(x[0], QAM64)
    assert cuda_kernels.launches("sc_coarse") == before + 4
    det.search_plain(x)
    assert cuda_kernels.launches("sc_coarse") == before + 4


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["ofdm_qam64_r34.gw2048_awgn25", "ofdm_dqpsk_r14.gw1024_awgn10"])
@pytest.mark.parametrize("seed", [1, 2718281828])
def test_cell_chain_equals_the_plain_search(cell, seed, cuda_device, monkeypatch):
    """Each served OFDM chain of the benchmark, on its cell's pool: every
    output with the kernels equal to the chain's with the plain search."""
    from benchmark.harness import load_cell

    c = load_cell(ROOT, cell)
    pool, _ = c.generator.make_pool(c.config, c.traffic, seed, cuda_device)
    program = c.entry.Program(c.config, c.traffic, cuda_device)
    with torch.no_grad():
        before = cuda_kernels.launches("sc_coarse")
        got = [program(batch.to(cuda_device)) for batch in pool]
        assert cuda_kernels.launches("sc_coarse") == before + len(pool)
        with monkeypatch.context() as m:
            m.setattr(sc_kernel, "search", lambda det, x: det.search_plain(x))
            want = [program(batch.to(cuda_device)) for batch in pool]
        assert cuda_kernels.launches("sc_coarse") == before + len(pool)
    for g, w in zip(got, want):
        assert bool(g["detected"].any())
        for name in w:
            assert torch.equal(_bits(g[name]), _bits(w[name])), name
