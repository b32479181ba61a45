"""The port's OFDM RX chains (bench.py chains 2 and 3) against the JAX package.

The same audio (from the port's TX, ``entry._make_ofdm_batch``) goes through
``ria_tpu.phy.pipeline.make_ofdm_rx_pipeline`` and the port's, at the full
bench geometry and B = 2: ``detected``, ``lts_start``, ``cw_success``,
``info_bits`` and ``iterations`` equal, ``cfo_hz`` and ``snr_db`` within
1e-3.  Where a codeword fails (it runs every iteration on noise) its info
bits are compared only by ``cw_success``: the two plain decoders sum in
another order, and over 60-80 iterations of a row that never converges the
posteriors drift apart.  The port's batch is bench.py's batch, and config #4
is the one ``create_waveform`` builds.
"""

import dataclasses

import numpy as np
import pytest
import torch

import bench
from ria_tpu.phy.frame_v2 import WaveformMode
from ria_tpu.phy.pipeline import make_ofdm_rx_pipeline as jax_ofdm_rx
from ria_tpu.wave import ofdm as J
from ria_tpu.wave.api import create_waveform
from ria_tpu_torch.entry import _make_ofdm_batch, ofdm_geometry
from ria_tpu_torch.phy.pipeline import make_ofdm_rx_pipeline
from ria_tpu_torch.utils.bits import bits_to_bytes

torch.set_num_threads(1)


def _jax_cfg(cfg):
    return J.OFDMConfig(**dataclasses.asdict(cfg))


def _assert_chain_matches(geom, audio):
    got = make_ofdm_rx_pipeline(geom.cfg, geom.rate, geom.window, geom.ci_bits,
                                device="cpu")(audio)
    want = jax_ofdm_rx(_jax_cfg(geom.cfg), geom.rate, geom.window, geom.ci_bits)(audio.numpy())
    for name in ("detected", "lts_start", "cw_success", "info_bits", "iterations"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        if name == "info_bits":
            ok = got.cw_success.numpy()
            g, w = g[ok], w[ok]
        assert g.shape == w.shape and np.array_equal(g, w), name
    for name in ("cfo_hz", "snr_db"):
        assert np.allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                           rtol=0, atol=1e-3), name
    return got


@pytest.mark.parametrize("config", [3, 4])
def test_chain_matches_jax(config):
    geom = ofdm_geometry(config)
    audio, info = _make_ofdm_batch(geom, 2, seed=1, device="cpu")
    got = _assert_chain_matches(geom, audio)
    assert got.detected.all() and got.cw_success.all()
    assert np.array_equal(got.info_bits.numpy(), info)
    # The payload bytes come back: the first 8 * (k // 8) info bits of each codeword.
    nbits = 8 * (info.shape[-1] // 8)
    assert (bits_to_bytes(got.info_bits.numpy()[0, :, :nbits].reshape(-1))
            == bits_to_bytes(info[0, :, :nbits].reshape(-1)))


@pytest.mark.parametrize("config,extra_sigma", [(3, 0.25), (4, 0.07)])
def test_noisy_chain_and_empty_window_match_jax(config, extra_sigma):
    """Extra noise so BP iterates (and at config #4 some codewords fail),
    plus a window of noise only (undetected: sliced from 0, success
    masked)."""
    geom = ofdm_geometry(config)
    audio, _ = _make_ofdm_batch(geom, 3, seed=2, device="cpu")
    rng = np.random.default_rng(config)
    audio[:2] += torch.as_tensor(rng.normal(0, extra_sigma, (2, geom.window)).astype(np.float32))
    audio[2] = torch.as_tensor(rng.normal(0, 0.05, geom.window).astype(np.float32))
    got = _assert_chain_matches(geom, audio)
    assert got.detected[:2].all() and not got.detected[2]
    assert int(got.lts_start[2]) == -1 and not got.cw_success[2].any()
    assert (got.iterations[:2] > 1).any()


def test_batch_hint_in_the_reference_place():
    """The reference's ``make_ofdm_rx_pipeline(cfg, rate, window, ci_bits,
    batch_hint, min_sum_factor)``: its positional call ``(..., ci, 64)``
    gives the port's keyword call with ``batch_hint=64``, which decodes as
    the call without it (factor 0.9375), on audio noisy enough that BP
    iterates."""
    geom = ofdm_geometry(3)
    audio, _ = _make_ofdm_batch(geom, 2, seed=4, device="cpu")
    audio += torch.as_tensor(np.random.default_rng(6).normal(0, 0.25, audio.shape)
                             .astype(np.float32))
    args = (geom.cfg, geom.rate, geom.window, geom.ci_bits)
    positional = make_ofdm_rx_pipeline(*args, 64, device="cpu")
    assert positional.min_sum_factor == 0.9375
    want = make_ofdm_rx_pipeline(*args, device="cpu")(audio)
    assert (want.iterations > 1).any()
    for rx in (positional, make_ofdm_rx_pipeline(*args, batch_hint=64, device="cpu")):
        got = rx(audio)
        for name, g, w in zip(got._fields, got, want):
            assert torch.equal(g, w), name


@pytest.mark.parametrize("config,case", [(3, bench._ofdm_case), (4, bench._coherent_case)])
def test_batch_is_bench_batch(config, case):
    """bench.py's chain from np.random.default_rng(0): its first variant is
    the batch plus N(0, 1e-4) noise drawn after it."""
    geom = ofdm_geometry(config)
    _, variants, batch, window = case(np.random.default_rng(0))
    assert (batch, window) == (geom.batch, geom.window)
    audio, _ = _make_ofdm_batch(geom, seed=0, device="cpu")
    diff = np.asarray(variants[0]) - audio.numpy()
    assert np.abs(diff).max() < 1e-3 and 0.9e-4 < diff.std() < 1.1e-4


def test_geometries():
    g3, g4 = ofdm_geometry(3), ofdm_geometry(4)
    assert (g3.window, g3.ci_bits, g3.cfg.num_symbols_for_bits(2592)) == (42720, 118, 22)
    assert (g4.window, g4.ci_bits, g4.cfg.num_symbols_for_bits(2592)) == (26160, 306, 9)
    assert (g3.rate, g4.rate, g3.batch, g4.batch) == ("R1_2", "R3_4", 64, 64)
    wf = create_waveform(WaveformMode.OFDM_COX, "QAM64", "R3_4")
    assert dataclasses.asdict(g4.cfg) == dataclasses.asdict(wf.cfg)
    assert g4.ci_bits == wf._ci_bits
    with pytest.raises(ValueError):
        ofdm_geometry(1)


def test_soft_bits_stage():
    geom = ofdm_geometry(4)
    audio, _ = _make_ofdm_batch(geom, 2, seed=3, device="cpu")
    rx = make_ofdm_rx_pipeline(geom.cfg, geom.rate, geom.window, geom.ci_bits, device="cpu")
    sync, demod, soft = rx.soft_bits(audio)
    assert soft.shape == (8, 648) and soft.is_contiguous()
    assert demod.soft_bits.shape == (2, 9 * 51 * 6)
    out = rx(audio)
    assert torch.equal(out.lts_start, sync.lts_start)
    assert torch.equal(rx.decoder(soft, torch.full((8,), 0.9375)).info_bits.reshape(2, 4, -1),
                       out.info_bits)
