"""The light preamble's LTS search's CUDA kernels (``csrc/lts_search.cu``,
wrapper ``sync/lts_kernel.py``) on the card (needs a GPU; every test skips
without one).  Imports no JAX:

    python -m pytest -q -m cuda tests/test_torch_lts_kernel_cuda.py

The kernels against the plain search (``LTSDetector.search_plain``, run on
the card) on all five outputs, bit for bit: on the benchmark cell's traffic
(``ofdm_dqpsk_r12.gw1024_awgn15``'s generator) at 1,024, 64 and 1 channels;
on windows with rows of noise alone (the argmax fallback), all-zero rows
(the energy floor), frames near the window's end (the clamps of the second
and third repeat), 3-LTS bursts, rows off a 16-byte boundary, a window too
long for shared memory and the API's coherent layout; the launch counts; and
the served light chain with the kernels against the same chain with the
plain search, on its cell's pool at two seeds.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from ria_tpu_torch.sync import lts_kernel
from ria_tpu_torch.utils import cuda_kernels
from ria_tpu_torch.wave import ofdm

ROOT = Path(__file__).resolve().parents[1]
CELL = "ofdm_dqpsk_r12.gw1024_awgn15"
CFG = ofdm.OFDMConfig(modulation="DQPSK", use_pilots=True, pilot_spacing=10)
N = 48000


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the LTS search's kernels are CUDA kernels")
    return torch.device("cuda", 0)


def _cell(channels: int):
    from benchmark.harness import load_cell

    cell = load_cell(ROOT, CELL)
    cell.traffic.update(channels=channels, pool=1)
    return cell


def windows(cfg: ofdm.OFDMConfig, B: int, n: int, dev: torch.device, seed: int = 0,
            offset: int = 0) -> torch.Tensor:
    """[B, n] float32 on the card under noise 15 dB below the frames: in row
    0 a frame at lead 2,000 (or 0 in a window too short for that), in rows 1 and 2 frames whose LTS pair sits at the
    window's end (the second repeat clamped, then the third), in row 3 a
    3-LTS burst, in the other rows frames at random leads; every 5th row
    noise alone, every 7th all zeros.  ``offset`` floats into a larger
    buffer, so that the rows start off a 16-byte boundary."""
    rng = np.random.default_rng(seed + B + n)
    sym = cfg.symbol_samples
    frames = [ofdm.tx_frame(rng.integers(0, 2, 4 * 648), cfg, "lts",
                            training_count=3 if i == 3 else 2,
                            tx_cfo_hz=float(rng.uniform(-20.0, 20.0))) for i in range(4)]
    x = np.zeros((B, n), np.float32)
    fixed = {0: 2000 if n >= 2000 + 3 * sym else 0, 1: n - 2 * sym + 7, 2: n - 3 * sym + 5}
    for b in range(B):
        f = frames[b % 4]
        lead = max(fixed.get(b, int(rng.integers(0, max(n - len(f), 1)))), 0)
        if b % 5 != 4:
            k = min(len(f), n - lead)
            x[b, lead : lead + k] = f[:k]
    sigma = float(np.sqrt(np.mean(frames[0] ** 2))) / np.sqrt(10.0 ** 1.5)
    x += rng.standard_normal((B, n), dtype=np.float32) * np.float32(sigma)
    x[6::7] = 0.0
    flat = torch.zeros(B * n + offset, dtype=torch.float32, device=dev)
    flat[offset:] = torch.as_tensor(x.reshape(-1), device=dev)
    return flat[offset:].view(B, n)


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bits, so that equality is bit for bit (zero signs, NaNs)."""
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def assert_equal(got, want, what: str) -> None:
    for name, g, w in zip(ofdm.LTSSyncResult._fields, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, (what, name)
        same = _bits(g) == _bits(w)
        if not bool(same.all()):
            rows = torch.nonzero(~same).reshape(-1)[:8].tolist()
            raise AssertionError(f"{what}: {name} differs in {int((~same).sum())} rows, e.g. "
                                 f"{rows}: {g[rows].tolist()} against {w[rows].tolist()}")


def _searches() -> tuple[int, int]:
    return cuda_kernels.launches("lts_front"), cuda_kernels.launches("lts_pick")


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [1024, 64, 1])
def test_kernels_equal_plain_on_the_cells_traffic(channels, cuda_device):
    """The cell's batches: every frame found at its sent start, and the five
    outputs equal to the plain search's; one launch of each kernel."""
    cell = _cell(channels)
    pool, sent = cell.generator.make_pool(cell.config, cell.traffic, 2**31 + 77 + channels,
                                          cuda_device)
    audio = pool[0].to(cuda_device)
    det = cell.entry.Program(cell.config, cell.traffic, cuda_device).rx.sync
    before = _searches()
    got = det(audio)
    assert _searches() == (before[0] + 1, before[1] + 1)
    assert_equal(got, det.search_plain(audio), f"{channels} channels")
    assert bool(got.detected.all())
    assert torch.equal(got.lts_start.cpu().long(), sent[0]["start"].long())


@pytest.mark.cuda
@pytest.mark.parametrize("B,offset", [(1024, 0), (64, 0), (13, 0), (1, 0), (5, 1), (64, 3)],
                         ids=["cell", "64", "13", "one-row", "unaligned", "unaligned-64"])
def test_kernels_equal_plain_on_edge_rows(B, offset, cuda_device):
    """Rows of noise alone (the argmax fallback), all-zero rows (the energy
    floor), frames whose repeats the window's end clamps, 3-LTS bursts
    (``repeats`` 3); rows off a 16-byte boundary take the scalar loads; at B
    = 1 ATen's cumsum runs CUB's scan."""
    det = ofdm.lts_detector(CFG, N, 0.5, cuda_device)
    x = windows(CFG, B, N, cuda_device, seed=5, offset=offset)
    assert (x.data_ptr() % 16 == 0) == (offset == 0)
    got = det(x)
    assert_equal(got, det.search_plain(x), f"B={B} offset={offset}")
    assert bool(got.detected[0]) and abs(int(got.lts_start[0]) - 2000) <= 16
    if B >= 7:
        assert not bool(got.detected[6::7].any()) and bool((got.repeats[3::4][:1] == 3).all())


@pytest.mark.cuda
@pytest.mark.parametrize("cfg,n,thr", [
    (CFG, 120000, 0.5),
    (ofdm.OFDMConfig(modulation="QAM16", use_pilots=True, pilot_spacing=5), 34240, 0.5),
    (CFG, 2 * 1120 + 64, 0.4)], ids=["long-window", "coherent-layout", "shortest-window"])
def test_kernels_equal_plain_on_other_windows(cfg, n, thr, cuda_device):
    """A window whose row does not fit in a block's shared memory (kept in a
    global scratch), the API's search of a coherent layout's template, and
    the shortest window the detector searches, at another threshold."""
    det = ofdm.LTSDetector(cfg, n, thr, cuda_device)
    x = windows(cfg, 6, n, cuda_device, seed=9)
    assert_equal(det(x), det.search_plain(x), f"{cfg.modulation} n={n}")


@pytest.mark.cuda
def test_one_launch_of_each_kernel_per_search(cuda_device):
    det = ofdm.lts_detector(CFG, N, 0.5, cuda_device)
    x = windows(CFG, 4, N, cuda_device)
    before = _searches()
    for calls in (1, 2, 3):
        det(x)
        assert _searches() == (before[0] + calls, before[1] + calls)
    ofdm.lts_search(x[0], CFG)
    det.search_plain(x)
    det(x[:0])
    assert _searches() == (before[0] + 4, before[1] + 4)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [1, 2718281828])
def test_cell_chain_equals_the_plain_search(seed, cuda_device, monkeypatch):
    """The served light chain on its cell's pool (cut to 256 channels): every
    output with the kernels equal to the chain's with the plain search."""
    cell = _cell(256)
    cell.traffic.update(pool=2)
    pool, _ = cell.generator.make_pool(cell.config, cell.traffic, seed, cuda_device)
    program = cell.entry.Program(cell.config, cell.traffic, cuda_device)
    with torch.no_grad():
        before = _searches()
        got = [program(batch.to(cuda_device)) for batch in pool]
        assert _searches() == (before[0] + len(pool), before[1] + len(pool))
        with monkeypatch.context() as m:
            m.setattr(lts_kernel, "search", lambda det, x: det.search_plain(x))
            want = [program(batch.to(cuda_device)) for batch in pool]
        assert _searches() == (before[0] + len(pool), before[1] + len(pool))
    for g, w in zip(got, want):
        assert bool(g["detected"].all())
        for name in w:
            assert torch.equal(_bits(g[name]), _bits(w[name])), name
