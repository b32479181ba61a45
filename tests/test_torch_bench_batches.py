"""``entry.bench_batches`` against bench.py's own draws.

bench.py's ``main()`` passes one ``np.random.default_rng(0)`` through
``_mc_dpsk_case``, ``_ofdm_case``, ``_coherent_case`` and ``_ldpc_metrics``
(``bench.py:272-311``).  Here the three cases are called in that order on
one generator, with the JAX RX pipelines replaced by a stub (the cases only
build them; the stub keeps this test from compiling both chains), and the
LDPC batch is drawn by ``_ldpc_metrics``' own lines (``bench.py:174-185``),
which cannot run without timing the decoders.  Both generators record their
draws: every integer draw (info bits, payload bytes, leads) is equal, each
noise draw has the same size and a sigma within 1e-6 relative, the port's
info bits are the ones drawn, and every variant agrees within 1e-5.
"""

import numpy as np
import pytest
import torch

import bench
from ria_tpu.fec.ldpc import make_encoder
from ria_tpu.fec.ldpc_matrix import get_code
from ria_tpu_torch import entry
from ria_tpu_torch.phy.pipeline import _xla_cumsum
from ria_tpu_torch.utils.bits import bytes_to_bits

torch.set_num_threads(1)


class RecordingGenerator:
    """A numpy Generator that records its integer draws and noise sizes."""

    def __init__(self, seed):
        self._rng = np.random.Generator(np.random.PCG64(seed))
        self.integers_drawn, self.normals_drawn = [], []

    def integers(self, *args, **kwargs):
        out = self._rng.integers(*args, **kwargs)
        self.integers_drawn.append(np.asarray(out))
        return out

    def normal(self, loc, scale, size):
        self.normals_drawn.append((float(loc), float(scale), tuple(np.atleast_1d(size))))
        return self._rng.normal(loc, scale, size)


def _port_draws(monkeypatch):
    rngs = []

    def default_rng(seed):
        rngs.append(RecordingGenerator(seed))
        return rngs[-1]

    monkeypatch.setattr(entry.np.random, "default_rng", default_rng)
    got = entry.bench_batches(device="cpu")
    monkeypatch.undo()
    assert len(rngs) == 1
    return got, rngs[0]


def _bench_draws(monkeypatch):
    import ria_tpu.phy.pipeline as P

    monkeypatch.setattr(P, "make_rx_pipeline", lambda *a, **k: None)
    monkeypatch.setattr(P, "make_ofdm_rx_pipeline", lambda *a, **k: None)
    rng = RecordingGenerator(0)
    chains = [case(rng)[1] for case in (bench._mc_dpsk_case, bench._ofdm_case,
                                        bench._coherent_case)]
    # bench.py:174-185, the draw of _ldpc_metrics.
    rate, B = "R1_4", 512
    info = rng.integers(0, 2, (B, get_code(rate).k)).astype(np.uint8)
    coded = np.asarray(make_encoder(rate)(info)).astype(np.float32)
    llr = (1.0 - 2.0 * coded) * 4.0
    noise = rng.normal(0, 1.0, llr.shape).astype(np.float32)
    noise[B // 2 :] = rng.normal(0, 2.6, (B // 2, 648)).astype(np.float32)
    llr += noise
    ldpc = [llr + rng.normal(0, 0.05, llr.shape).astype(np.float32) for _ in range(4)]
    monkeypatch.undo()
    return chains + [ldpc], rng, llr


def test_bench_batches_are_bench_draws(monkeypatch):
    got, port_rng = _port_draws(monkeypatch)
    want, bench_rng, bench_llr = _bench_draws(monkeypatch)

    # Every integer draw equal: info bits, payload bytes and leads, in order.
    assert len(port_rng.integers_drawn) == len(bench_rng.integers_drawn) == 1 + 64 + 2 * 128 + 1
    for g, w in zip(port_rng.integers_drawn, bench_rng.integers_drawn):
        assert np.array_equal(g, w)
    # The same noise draws (sizes; sigmas up to the rms summation order).
    assert len(port_rng.normals_drawn) == len(bench_rng.normals_drawn) == 3 * 7 + 6
    for (gl, gs, gz), (wl, ws, wz) in zip(port_rng.normals_drawn, bench_rng.normals_drawn):
        assert (gl, gz) == (wl, wz) and abs(gs - ws) <= 1e-6 * ws

    # The info bits sent are the ones drawn.
    draws = bench_rng.integers_drawn
    assert np.array_equal(got.mc_dpsk.info, draws[0].reshape(64, 4, -1))
    for chain, first in ((got.ofdm_dqpsk_r12, 65), (got.ofdm_qam64_r34, 65 + 128)):
        k = chain.info.shape[-1]
        for b in range(64):
            bits = bytes_to_bits(draws[first + 2 * b].astype(np.uint8).tobytes())
            assert np.array_equal(chain.info[b, :, : 8 * (k // 8)].reshape(-1), bits)
            assert not chain.info[b, :, 8 * (k // 8):].any()
    assert np.array_equal(got.ldpc.info, draws[-1])

    # The batches the copies were made from: the LDPC batch is bench.py's
    # ``llr`` (its serving decode takes the first rows), and each copy
    # differs from its batch by the copies' noise.
    assert np.abs(got.ldpc.clean.numpy() - bench_llr).max() < 1e-5
    for chain, sigma in zip(got, [entry.BENCH_VARIANT_SIGMA] * 3
                            + [entry.LDPC_BENCH_VARIANT_SIGMA]):
        diff = (chain.variants[0] - chain.clean).numpy()
        assert 0.9 * sigma < diff.std() < 1.1 * sigma

    # The tensors bench.py times.
    for chain, w_variants in zip(got, want):
        assert len(chain.variants) == len(w_variants)
        for g, w in zip(chain.variants, w_variants):
            w = np.asarray(w)
            assert g.shape == w.shape and g.dtype == torch.float32
            assert np.abs(g.numpy() - w).max() < 1e-5


@pytest.mark.parametrize("n", [1, 16, 17, 50, 260, 1000, 5000])
def test_tx_cumsum_is_the_compiled_reference_cumsum(n):
    """The TX's phase cumsum takes the summation order of the compiled
    ``jnp.cumsum`` on the CPU, bit for bit (``torch.cumsum`` accumulates in
    double there, ulps of a ~800 rad phase away)."""
    import jax
    import jax.numpy as jnp

    x = (np.random.default_rng(n).normal(size=(3, n)) * 3 + np.pi).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=-1))(x))
    assert np.array_equal(_xla_cumsum(torch.as_tensor(x), -1).numpy(), want)
    assert np.array_equal(_xla_cumsum(torch.as_tensor(x.T.copy()), 0).numpy(), want.T)
