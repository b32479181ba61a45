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
