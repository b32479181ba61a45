"""The port's MC-DPSK RX chain as a whole, against the JAX package.

The same audio (from the port's TX) goes through ``ria_tpu.phy.pipeline.
make_rx_pipeline`` and the port's: ``detected``, ``start``, ``cw_success``,
``info_bits`` and ``iterations`` equal, every codeword decoded, ``cfo_hz``
and ``snr_db`` within 1e-3.
"""

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from ria_tpu.phy.pipeline import make_rx_pipeline as jax_rx_pipeline
from ria_tpu.wave.mc_dpsk import MCDPSKConfig as JConfig
from ria_tpu_torch.entry import RATE, _make_batch, entry, geometry
from ria_tpu_torch.phy.pipeline import make_rx_pipeline

torch.set_num_threads(1)


def _assert_chain_matches(jcfg, audio, info, ncw, window):
    cfg = geometry(production=jcfg.num_carriers == 10)[0]
    got = make_rx_pipeline(cfg, RATE, ncw, window, device="cpu")(audio)
    want = jax_rx_pipeline(jcfg, RATE, ncw, window)(audio.numpy())
    for name in ("detected", "start", "cw_success", "info_bits", "iterations"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape and np.array_equal(g, w), name
    for name in ("cfo_hz", "snr_db"):
        assert np.allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                           rtol=0, atol=1e-3), name
    assert got.detected.all() and got.cw_success.all()
    assert np.array_equal(got.info_bits.numpy(), info)
    return got


def test_tiny_geometry_matches_jax():
    cfg, ncw, batch, window = geometry()
    audio, info = _make_batch(cfg, ncw, batch, window, seed=0, device="cpu")
    # The port's batch is the reference's batch (same draws, same TX).
    ref_audio = graft._make_batch(graft._tiny_cfg(), ncw, batch, window, seed=0)
    assert np.allclose(audio.numpy(), ref_audio, rtol=0, atol=1e-5)
    _assert_chain_matches(graft._tiny_cfg(), audio, info, ncw, window)


def test_tiny_geometry_noisy_matches_jax():
    """Extra noise so the decoder iterates (1-2 iterations per codeword)."""
    cfg, ncw, _, window = geometry()
    audio, info = _make_batch(cfg, ncw, 8, window, seed=4, device="cpu")
    audio += torch.as_tensor(
        np.random.default_rng(9).normal(0, 0.35, audio.shape).astype(np.float32))
    got = _assert_chain_matches(graft._tiny_cfg(), audio, info, ncw, window)
    assert (got.iterations > 1).any()


def test_production_geometry_matches_jax():
    """bench.py chain-1 geometry (10-carrier DBPSK, R1/4, 4 codewords,
    window 207,328, leads in [0, 8000), 10 dB AWGN) at B = 2."""
    cfg, ncw, _, window = geometry(production=True)
    assert window == 207328
    audio, info = _make_batch(cfg, ncw, 2, window, seed=3, production=True,
                              device="cpu")
    got = _assert_chain_matches(JConfig(num_carriers=10, bits_per_symbol=1), audio, info,
                                ncw, window)
    assert got.info_bits.shape == (2, 4, 162)


def test_batch_hint_changes_nothing():
    """bench.py builds chain 1 as ``make_rx_pipeline(cfg, "R1_4", ncw,
    window, batch_hint=batch)`` (``bench.py:74``).  The port takes the
    reference's ``batch_hint`` in its place, by keyword or position, and
    decodes exactly as without it."""
    cfg, ncw, batch, window = geometry()
    audio, _ = _make_batch(cfg, ncw, batch, window, seed=2, device="cpu")
    want = make_rx_pipeline(cfg, RATE, ncw, window, device="cpu")(audio)
    for rx in (make_rx_pipeline(cfg, RATE, ncw, window, batch_hint=batch, device="cpu"),
               make_rx_pipeline(cfg, RATE, ncw, window, 0.75, batch, device="cpu")):
        assert rx.min_sum_factor == 0.75
        got = rx(audio)
        for name, g, w in zip(got._fields, got, want):
            assert torch.equal(g, w), name


def test_entry_runs_tiny_chain():
    rx, (audio,) = entry(device="cpu")
    out = rx(audio)
    assert audio.shape == (4, geometry()[3])
    assert out.detected.all() and out.cw_success.all()


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg, ncw, _, window = geometry()
    with pytest.raises(RuntimeError):
        make_rx_pipeline(cfg, RATE, ncw, window, device="cuda")
    with pytest.raises(RuntimeError):
        entry(device="cuda")
