"""The chirp search's fine stage, CUDA kernels ``csrc/chirp_fine.cu`` (wrapper
``sync/fine_kernel.py``), on the card (needs a GPU; every test skips without
one).  Imports no JAX:

    python -m pytest -q -m cuda tests/test_torch_chirp_fine_cuda.py

The kernels against the plain path (``sync.chirp.refine_front_plain``,
``refine_pick_plain``, ``median_plain``, run on the card), bit for bit: the
refinement at both MC-DPSK cells' shapes and at B = 1, on rows whose coarse
peak is clamped at either end of the window, all-zero slices, slices whose
prefix sums sit on a float32 rounding midpoint (a row on which another order
of the float64 additions rounds otherwise), and ties between lags; the
median at both cells' row lengths, odd and even, with repeated values and
zeros of both signs, on strided rows and on rows too long to stage; the
launch counts; each MC-DPSK chain of the benchmark with the kernels against
the same chain with the plain path; and a probe of the installed ATen's scan
against the order the kernels follow.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from ria_tpu_torch.sync import chirp, fine_kernel
from ria_tpu_torch.sync.sc_kernel import scan_log_threads
from ria_tpu_torch.utils import cuda_kernels

ROOT = Path(__file__).resolve().parents[1]
R = chirp._ZOOM_REFINE
# The two MC-DPSK cells: windows a call and samples a window.
SHAPES = {"flagship": (256, 207328), "harq": (128, 606688), "one-row": (1, 207328)}
ENTRIES = ("chirp_refine_front", "chirp_refine_pick", "median_select")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the chirp fine stage's kernels are CUDA kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bits, so that equality is bit for bit (zero signs, NaNs)."""
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def assert_equal(got, want, what: str) -> None:
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, (what, i)
        same = _bits(g) == _bits(w)
        if not bool(same.all()):
            rows = torch.nonzero(~same.reshape(same.shape[0], -1).all(-1)).reshape(-1)
            raise AssertionError(f"{what}: output {i} differs in {len(rows)} rows, e.g. "
                                 f"{rows[:8].tolist()}")


def aten_scan_f32(sq: np.ndarray, log_x: int) -> np.ndarray:
    """float64 prefix sums of a row of float32 values in the order of ATen's
    innermost-dimension scan with 2^log_x threads along the row (chunks of
    twice as many elements, the running total added to each chunk's first,
    Sklansky's network inside), each rounded to float32: the order the
    kernels follow (``csrc/aten_order.cuh``)."""
    T = 1 << log_x
    x = np.asarray(sq, np.float32).astype(np.float64)
    out = np.empty(len(x))
    total = 0.0
    t = np.arange(T)
    for c0 in range(0, len(x), 2 * T):
        buf = np.zeros(2 * T)
        seg = x[c0 : c0 + 2 * T]
        buf[: len(seg)] = seg
        buf[0] = buf[0] + total
        for m in range(log_x + 1):
            s = 1 << m
            a = (t // s) * 2 * s + s
            buf[a + t % s] = buf[a + t % s] + buf[a - 1]
        out[c0 : c0 + len(seg)] = buf[: len(seg)]
        total = buf[-1]
    return out.astype(np.float32)


def midpoint_slice(L: int, at: int = 0) -> np.ndarray:
    """A slice whose squares' prefix sums sit on a float32 rounding midpoint:
    1 and 2^-24 (1 + 2^-24 lies halfway between two float32s) from ``at``,
    2^-60 everywhere else.  Added one by one to the running total each
    2^-60 is lost, so the prefixes round to even, to 1; ATen's scan sums
    them in trees first, whose sums carry the prefixes over the midpoint."""
    y = np.full(L, 2.0**-30, np.float32)
    y[at], y[at + 1] = 1.0, 2.0**-12
    return y


def windows(B: int, n: int, dev: torch.device, seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(x [B, n], coarse_pos [B] int32) on the card: noise at the benchmark's
    0 dB scale and a coarse peak on the stride-16 grid in each row; row 0's
    peak at 0 and row 1's past the window's end (both clamped), row 2's
    slice all zeros, and (B > 3) every 5th row's slice a midpoint slice."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    x = 0.35 * torch.randn((B, n), generator=gen, device=dev)
    rng = np.random.default_rng(seed)
    chirp_len = chirp.ChirpConfig().chirp_samples
    L = chirp_len + 2 * R
    pos = rng.integers(0, (n - chirp_len) // 16, B).astype(np.int32) * 16
    pos[0] = 0
    if B > 1:
        pos[1] = (n // 16) * 16
    if B > 2:
        lo = int(np.clip(pos[2] - R, 0, n - L))
        x[2, lo : lo + L] = 0.0
    for b in range(5, B, 5):
        lo = int(np.clip(pos[b] - R, 0, n - L))
        x[b, lo : lo + L] = torch.as_tensor(midpoint_slice(L, at=(b // 5) % 7), device=dev)
    return x, torch.as_tensor(pos, device=dev)


def _plain_refine(det, x, pos, Mr, Mi):
    start, y, win = chirp.refine_front_plain(x, pos, det.chirp_len, R)
    return (start, y, win), chirp.refine_pick_plain(y @ Mr, y @ Mi, win, start, det.energy)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_refine_equals_plain(shape, cuda_device):
    """Both refinements of a zoom-branch call, kernels against the plain
    path on the card: the front's (start, y, win) and the pick's (lag, val)
    bit for bit."""
    B, n = SHAPES[shape]
    det = chirp.chirp_detector(chirp.ChirpConfig(), n, cuda_device)
    assert det.zoom
    x, pos = windows(B, n, cuda_device, seed=B + n)
    for Mr, Mi in ((det.up_mr, det.up_mi), (det.down_mr, det.down_mi)):
        front = fine_kernel.refine_front(x, pos, det.chirp_len, R)
        got = det._refine_peak(x, pos, Mr, Mi)
        want_front, want = _plain_refine(det, x, pos, Mr, Mi)
        assert_equal(front, want_front, f"{shape}: front")
        assert_equal(got, want, f"{shape}: lag, val")
    L = det.chirp_len + 2 * R
    assert int(front[0][0]) == 0 and (B < 2 or int(front[0][1]) == n - L)
    if B > 2:  # the all-zero slice: the floor and clamp_min decide, lag 0 at value 0
        assert int(got[0][2]) == int(front[0][2]) and float(got[1][2]) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("B", [2, 128, 256])
def test_midpoint_slices_take_atens_order(B, cuda_device):
    """Slices whose prefixes sit on a float32 midpoint: ATen's scan on the
    card rounds them as the order the kernels follow does, and otherwise
    than a sum one by one; the kernel's window energies equal ATen's."""
    n = 60000
    chirp_len = chirp.ChirpConfig().chirp_samples
    L = chirp_len + 2 * R
    x = torch.zeros((B, n), device=cuda_device)
    pos = torch.full((B,), 1000, dtype=torch.int32, device=cuda_device)
    for b in range(B):
        x[b, 1000 - R : 1000 - R + L] = torch.as_tensor(midpoint_slice(L, at=b % 40),
                                                        device=cuda_device)
    got = fine_kernel.refine_front(x, pos, chirp_len, R)
    want = chirp.refine_front_plain(x, pos, chirp_len, R)
    assert_equal(got, want, f"B={B}")
    y = midpoint_slice(L)
    ordered = aten_scan_f32(y * y, scan_log_threads(B, L))
    one_by_one = np.cumsum((y * y).astype(np.float64)).astype(np.float32)
    assert ordered[-1] != one_by_one[-1]
    csum = np.concatenate([np.zeros(1, np.float32), ordered])
    want_win = csum[chirp_len : chirp_len + 2 * R + 1] - csum[: 2 * R + 1]
    assert want_win.dtype == np.float32
    assert np.array_equal(got[2][0].cpu().numpy(), want_win)


@pytest.mark.cuda
def test_probe_the_installed_atens_scan(cuda_device):
    """ATen's float64 cumsum of B rows on the card, rounded to float32,
    equals the order the kernels follow on rows that tell orders apart: a
    torch whose scan groups its additions otherwise fails here."""
    L = 24048
    for B in (2, 128, 256):
        rows = np.stack([midpoint_slice(L, at=b % 50) ** 2 for b in range(B)])
        t = torch.as_tensor(rows, device=cuda_device)
        got = torch.cumsum(t.double(), dim=-1).float().cpu().numpy()
        log_x = scan_log_threads(B, L)
        for b in (0, 1, B - 1):
            assert np.array_equal(got[b], aten_scan_f32(rows[b], log_x)), (B, b)


@pytest.mark.cuda
def test_pick_takes_the_first_of_equal_lags(cuda_device):
    """Rows whose correlation peaks at two lags with one value: the pick
    takes the first, as torch.argmax does; and rows of every other kind."""
    B, nwin = 64, 2 * R + 1
    rng = np.random.default_rng(7)
    cr = rng.normal(0, 1, (B, nwin)).astype(np.float32)
    ci = rng.normal(0, 1, (B, nwin)).astype(np.float32)
    win = rng.uniform(0.5, 2.0, (B, nwin)).astype(np.float32)
    for b in range(B):
        j0, j1 = sorted(rng.choice(nwin, 2, replace=False))
        cr[b, j0] = cr[b, j1] = 50.0
        ci[b, j0] = ci[b, j1] = 0.0
        win[b, j1] = win[b, j0]
    win[1] = 0.0                       # the floor and clamp_min decide
    cr[2], ci[2] = 0.0, 0.0            # all zero: lag 0
    win[3, ::2] = 1e-9                 # under the -60 dB floor
    args = [torch.as_tensor(a, device=cuda_device) for a in (cr, ci, win)]
    start = torch.arange(B, dtype=torch.int32, device=cuda_device) * 100
    got = chirp.refine_pick(*args, start, 12000.0)
    want = chirp.refine_pick_plain(*args, start, 12000.0)
    assert_equal(got, want, "pick")
    first = [int(np.argmax(cr[b] == 50.0)) for b in range(4, B)]
    assert (got[0][4:].cpu().numpy() == start[4:].cpu().numpy() + np.array(first)).all()
    assert int(got[0][2]) == 200 and float(got[1][2]) == 0.0


def median_rows(B: int, m: int, seed: int, zeros: bool = True) -> np.ndarray:
    """[B, m] float32 rows: values from a few dozen levels (many repeats),
    every 3rd row with a run of zeros of both signs around its middle, every
    4th all one value, every 5th normalized-correlation-like noise."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(0, 40, (B, m)) * 0.125 - 2.0).astype(np.float32)
    for b in range(B):
        if b % 5 == 4:
            x[b] = np.abs(rng.normal(0, 0.03, m)).astype(np.float32)
        if b % 4 == 3:
            x[b] = 0.75
        if zeros and b % 3 == 2:
            k = m // 3
            z = np.where(rng.random(k) < 0.5, np.float32(-0.0), np.float32(0.0))
            x[b, m // 2 - k // 2 : m // 2 - k // 2 + k] = z
            x[b, : m // 3] = np.abs(x[b, : m // 3]) + 1.0
            x[b, -(m // 3) :] = -np.abs(x[b, -(m // 3) :]) - 1.0
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("m", [11458, 36418, 11459, 36417, 4097, 60001, 60000])
def test_median_equals_the_sort(m, cuda_device):
    """The exact selection against ``torch.sort``'s median on the card, bit
    for bit, zero signs included: at both cells' row lengths, odd and even
    counts, and rows too long to stage in shared memory (60,000)."""
    for B in (7, 128):
        x = torch.as_tensor(median_rows(B, m, seed=m + B), device=cuda_device)
        assert_equal((chirp._median(x),), (chirp.median_plain(x),), f"m={m} B={B}")


@pytest.mark.cuda
def test_median_of_strided_rows_and_small_batches(cuda_device):
    """The zoom branch's median is over a prefix of each row (a strided
    view); one row; a row of one value; rows of 1 and 2 values."""
    x = torch.as_tensor(median_rows(9, 16384, seed=3), device=cuda_device)
    for view in (x[:, :11458], x[:1, :11458], x[:4, :1], x[:4, :2], x[:, 5:4101]):
        assert_equal((chirp._median(view),), (chirp.median_plain(view),), str(tuple(view.shape)))


@pytest.mark.cuda
def test_launches_per_call(cuda_device):
    """Two refinements and one median a zoom-branch call; none on the
    Schmidl-Cox search of the OFDM chains."""
    from ria_tpu_torch.wave import ofdm

    n = 207328
    det = chirp.chirp_detector(chirp.ChirpConfig(), n, cuda_device)
    x, _ = windows(4, n, cuda_device, seed=1)
    before = [cuda_kernels.launches(e) for e in ENTRIES]
    for calls in (1, 2, 3):
        det(x)
        assert [cuda_kernels.launches(e) - b for e, b in zip(ENTRIES, before)] == [
            2 * calls, 2 * calls, calls]
    cfg = ofdm.OFDMConfig(modulation="DQPSK")
    ofdm.SchmidlCoxDetector(cfg, 42720, cuda_device)(x[:, :42720].contiguous())
    assert [cuda_kernels.launches(e) - b for e, b in zip(ENTRIES, before)] == [6, 6, 3]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["mcdpsk_r14.gw256_awgn0", "mcdpsk_s4_r14.harq64x2_m19db"])
@pytest.mark.parametrize("seed", [1, 2718281828])
def test_cell_chain_equals_the_plain_path(cell, seed, cuda_device, monkeypatch):
    """Each MC-DPSK chain of the benchmark (``make_rx_pipeline``,
    ``make_harq_rx_pipeline``) on its cell's pool: every output with the
    kernels equal to the chain's with the plain fine stage."""
    from benchmark.harness import load_cell

    c = load_cell(ROOT, cell)
    c.traffic.update(pool=2)
    pool, _ = c.generator.make_pool(c.config, c.traffic, seed, cuda_device)
    program = c.entry.Program(c.config, c.traffic, cuda_device)
    with torch.no_grad():
        before = cuda_kernels.launches("median_select")
        got = [program(batch.to(cuda_device)) for batch in pool]
        assert cuda_kernels.launches("median_select") == before + len(pool)
        with monkeypatch.context() as m:
            m.setattr(chirp, "refine_front", chirp.refine_front_plain)
            m.setattr(chirp, "refine_pick", chirp.refine_pick_plain)
            m.setattr(chirp, "_median", chirp.median_plain)
            want = [program(batch.to(cuda_device)) for batch in pool]
        assert cuda_kernels.launches("median_select") == before + len(pool)
    for g, w in zip(got, want):
        assert bool(g["detected"].any())
        assert sorted(g) == sorted(w)
        for name in w:
            assert torch.equal(_bits(g[name]), _bits(w[name])), name
