"""Dual-chirp sync of the PyTorch port against the JAX package, both branches.

``detected`` and ``start`` must be equal; ``up_corr``/``down_corr`` within
1e-4 and ``cfo_hz`` within 1e-3 Hz (FFTs and sums in another order, f32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ria_tpu.sync import chirp as jchirp
from ria_tpu_torch.sync import chirp as tchirp

torch.set_num_threads(1)

TINY = dict(duration_ms=10.0, gap_ms=2.0)


def _windows(cfg_kwargs, n, rows, seed):
    """[len(rows), n] windows: each row is (lead, tx_cfo_hz) for a chirp
    sequence at that lead, or None for pure noise; all rows get noise."""
    cfg = tchirp.ChirpConfig(**cfg_kwargs)
    rng = np.random.default_rng(seed)
    out = rng.normal(0, 0.05, (len(rows), n)).astype(np.float32)
    for i, row in enumerate(rows):
        if row is not None:
            lead, cfo = row
            seq = tchirp.generate(cfg, cfo)
            out[i, lead : lead + len(seq)] += seq[: n - lead]
    return out


def _compare(cfg_kwargs, x):
    ref = jchirp.detect_dual_chirp(jnp.asarray(x), jchirp.ChirpConfig(**cfg_kwargs))
    got = tchirp.detect_dual_chirp(torch.as_tensor(x), tchirp.ChirpConfig(**cfg_kwargs))
    ref = [np.asarray(v) for v in ref]
    got = [v.numpy() for v in got]
    assert np.array_equal(got[0], ref[0]), (got[0], ref[0])
    assert np.array_equal(got[1], ref[1]), (got[1], ref[1])
    assert np.allclose(got[2], ref[2], rtol=0, atol=1e-3)
    assert np.allclose(got[3], ref[3], rtol=0, atol=1e-4)
    assert np.allclose(got[4], ref[4], rtol=0, atol=1e-4)
    assert got[1].dtype == np.int32 and got[0].dtype == bool
    return got


def test_full_rate_branch_matches_jax():
    cfg = tchirp.ChirpConfig(**TINY)
    n = cfg.total_samples + 3000
    assert tchirp.ChirpDetector(cfg, n, "cpu").zoom is False
    x = _windows(TINY, n, [(700, 0.0), (1200, 8.0), (300, -8.0), None], seed=3)
    det, start, cfo, _, _ = _compare(TINY, x)
    assert det.tolist() == [True, True, True, False]
    assert start[0] == 700 and start[3] == -1


def test_zoom_branch_matches_jax():
    """Production chirp at the bench.py chain-1 window (207,328 samples,
    nfft 262,144): a +8 Hz CFO row and a pure-noise row (CFAR reject)."""
    cfg = tchirp.ChirpConfig()
    n = 207328
    assert tchirp.ChirpDetector(cfg, n, "cpu").zoom is True
    x = _windows({}, n, [(5123, 8.0), None], seed=11)
    det, start, cfo, _, _ = _compare({}, x)
    assert det.tolist() == [True, False]
    assert abs(start[0] - 5123) <= 2 and abs(cfo[0] - 8.0) < 0.5


@pytest.mark.parametrize("positional", [False, True])
def test_num_samples_is_taken_and_ignored(positional):
    """The reference's ``detect_dual_chirp(samples, cfg, num_samples=None)``
    drops ``num_samples`` (``ria_tpu/sync/chirp.py:318``); the port takes it
    in the same place, by keyword or position, and returns what it returns
    without it, which is the reference's answer."""
    cfg = tchirp.ChirpConfig(**TINY)
    n = cfg.total_samples + 3000
    x = torch.as_tensor(_windows(TINY, n, [(700, 0.0), (1200, 8.0), None], seed=3))
    got = (tchirp.detect_dual_chirp(x, cfg, n) if positional
           else tchirp.detect_dual_chirp(x, cfg, num_samples=n))
    for g, w in zip(got, _compare(TINY, x.numpy())):
        assert np.array_equal(g.numpy(), w)
    assert got.detected.tolist() == [True, True, False]


def test_short_window_detects_nothing():
    cfg = tchirp.ChirpConfig(**TINY)
    x = np.zeros((2, cfg.total_samples), np.float32)
    _compare(TINY, x)


@pytest.mark.parametrize("n", [4, 5, 12958])
def test_median_is_numpy_median(n):
    """Even counts average the two middle values (torch.median takes the
    lower one); the CFAR decision up_val >= 6 * median depends on it."""
    x = np.random.default_rng(n).random((3, n)).astype(np.float32)
    got = tchirp._median(torch.as_tensor(x)).numpy()
    assert np.array_equal(got, np.median(x, axis=-1).astype(np.float32))
    assert np.array_equal(got, np.asarray(jnp.median(jnp.asarray(x), axis=-1)))


def test_median_pins_even_count():
    assert float(tchirp._median(torch.tensor([1.0, 2.0, 3.0, 4.0]))) == 2.5
    assert float(torch.median(torch.tensor([1.0, 2.0, 3.0, 4.0]))) == 2.0


def test_window_slice_clamps_like_dynamic_slice():
    x = torch.arange(20.0).reshape(2, 10)
    got = tchirp.window_slice(x, torch.tensor([-3, 8]), 4)
    assert got.tolist() == [[0.0, 1.0, 2.0, 3.0], [16.0, 17.0, 18.0, 19.0]]


def test_tables_equal_to_reference():
    cfg_t, cfg_j = tchirp.ChirpConfig(), jchirp.ChirpConfig()
    assert np.array_equal(tchirp.generate(cfg_t, 3.0), jchirp.generate(cfg_j, 3.0))
    for a, b in zip(tchirp._templates(cfg_t), jchirp._templates(cfg_j)):
        assert np.array_equal(a, b)
    zt, zj = tchirp._zoom_tables(cfg_t, 262144), jchirp._zoom_tables(cfg_j, 262144)
    for a, b in zip(zt[:3], zj[:3]):
        assert np.array_equal(a, b)
    for mt, mj in zip(zt[3:], zj[3:]):
        assert all(np.array_equal(a, b) for a, b in zip(mt, mj))


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        tchirp.ChirpDetector(tchirp.ChirpConfig(), 207328, device="cuda")


@pytest.mark.parametrize("B,n", [(1, 207328), (3, 207328), (2, 207327)])
def test_zoom_front_plain_is_the_inline_expressions(B, n):
    """The plain window pass returns what the zoom branch computed inline
    before (mix and box-sum, block energy), bit for bit, and the FFT of its
    zero-padded baseband is the FFT that padded it itself."""
    det = tchirp.ChirpDetector(tchirp.ChirpConfig(), n, "cpu")
    D, nb = tchirp._ZOOM_DECIM, det.nfft // tchirp._ZOOM_DECIM
    nblk = n // D
    x = torch.as_tensor(np.random.default_rng(n + B).normal(0, 0.3, (B, n)).astype(np.float32))
    x[:, 160:800] = 0.0
    zb, blk = tchirp.zoom_front_plain(x, det.rot, nb)
    old_zb = (x[:, : nblk * D] * det.rot).reshape(B, nblk, D).sum(-1)
    xb = x[:, : nblk * D]
    old_blk = (xb * xb).reshape(B, nblk, D).sum(-1)
    assert zb.shape == (B, nb) and zb.dtype == torch.complex64
    assert torch.equal(zb[:, :nblk], old_zb) and torch.equal(blk, old_blk)
    assert bool((zb[:, nblk:] == 0).all()) and bool((zb[:, 10:50] == 0).all())
    assert torch.equal(torch.fft.fft(zb), torch.fft.fft(old_zb, nb))
    assert all(torch.equal(a, b) for a, b in zip(tchirp.zoom_front(x, det.rot, nb), (zb, blk)))


def test_cpu_tensor_never_reaches_the_kernel(monkeypatch):
    """On the CPU the detector neither loads nor launches the window pass's
    kernel, and ``LAUNCHES`` stays as it was."""
    from ria_tpu_torch.sync import zoom_kernel

    def refuse(*args):
        raise AssertionError("the CUDA kernel was reached from a CPU tensor")

    monkeypatch.setattr(zoom_kernel, "load", refuse)
    monkeypatch.setattr(zoom_kernel, "zoom_front", refuse)
    before = zoom_kernel.LAUNCHES
    det = tchirp.ChirpDetector(tchirp.ChirpConfig(), 207328, "cpu")
    det(torch.as_tensor(_windows({}, 207328, [(4000, 2.0)], seed=5)))
    assert zoom_kernel.LAUNCHES == before


def test_kernel_wrapper_refuses_a_cpu_tensor(monkeypatch):
    """The wrapper raises on a CPU tensor before anything is built: it has
    no path that falls back to the plain version."""
    from ria_tpu_torch.fec import ldpc_kernel
    from ria_tpu_torch.sync import zoom_kernel

    def refuse(name):
        raise AssertionError("a library was loaded for a CPU tensor")

    monkeypatch.setattr(ldpc_kernel, "kernel", refuse)
    before = zoom_kernel.LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensors"):
        zoom_kernel.zoom_front(torch.zeros(2, 64), torch.zeros(64, dtype=torch.complex64), 8)
    assert zoom_kernel.LAUNCHES == before


def test_zoom_front_is_built_with_the_decoders_and_typed():
    """``zoom_front`` is a library of ``ldpc_kernel.build()``'s parallel
    nvcc run, and its C entry point, bound on a stand-in library (no nvcc
    here), takes a pointer for each pointer of the source's signature and
    for the stream, an int for each int."""
    import ctypes
    import re

    from ria_tpu_torch.fec import ldpc_kernel

    source, flags = ldpc_kernel.LIBRARIES["zoom_front"]
    assert source.name == "zoom_front.cu" and source.is_file()
    assert flags == ("-cudart", "shared")  # the runtime PyTorch has loaded
    sig = re.search(r'extern "C" int ria_zoom_front\(([^)]*)\)', source.read_text()).group(1)
    params = [p.strip() for p in sig.split(",")]
    kinds = ["ptr" if "*" in p else "int" for p in params]
    assert kinds == ["ptr"] * 4 + ["int"] * 3 + ["ptr"] and params[-1] == "void* stream"

    class StandIn:
        ria_zoom_front = type("Fn", (), {})()

    fn = ldpc_kernel.kernel_entry_point(StandIn(), "zoom_front")
    assert fn.argtypes == [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    assert fn.restype is ctypes.c_int
