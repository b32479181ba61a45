"""MC-DPSK TX and demodulation of the PyTorch port against the JAX package.

Audio within 1e-5; soft bits within 2e-3 (the tolerance the repo already
uses between execution paths, tests/test_parallel.py and docs/SCALING.md);
SNR estimate and fading indices within 1e-3.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ria_tpu.phy.pipeline import make_tx_pipeline as jax_tx_pipeline
from ria_tpu.sync.chirp import ChirpConfig as JChirp
from ria_tpu.wave import mc_dpsk as jm
from ria_tpu_torch import convert
from ria_tpu_torch.phy.pipeline import make_tx_pipeline
from ria_tpu_torch.sync.chirp import ChirpConfig as TChirp
from ria_tpu_torch.wave import mc_dpsk as tm

torch.set_num_threads(1)

TINY_CHIRP = dict(duration_ms=10.0, gap_ms=2.0)
CONFIGS = {
    "dbpsk": dict(num_carriers=10, bits_per_symbol=1),
    "dbpsk_x2": dict(num_carriers=10, bits_per_symbol=1, spreading=2),
    "dqpsk": dict(num_carriers=4, samples_per_symbol=128, bits_per_symbol=2,
                  training_symbols=4),
    "dqpsk_x2": dict(num_carriers=4, samples_per_symbol=128, bits_per_symbol=2,
                     training_symbols=4, spreading=2),
}


def _cfgs(name):
    kw = CONFIGS[name]
    return (tm.MCDPSKConfig(chirp=TChirp(**TINY_CHIRP), **kw),
            jm.MCDPSKConfig(chirp=JChirp(**TINY_CHIRP), **kw))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_config_round_trip_and_tables(name):
    tcfg, jcfg = _cfgs(name)
    assert convert.mcdpsk_config_from_dict(dataclasses.asdict(jcfg)) == tcfg
    assert np.array_equal(tm._synth_matrix(tcfg), jm._synth_matrix(jcfg))
    assert np.array_equal(tm._training_matrix(tcfg), jm._training_matrix(jcfg))
    assert tcfg.frame_samples(2592) == jcfg.frame_samples(2592)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_modulate_and_preamble_match(name):
    tcfg, jcfg = _cfgs(name)
    bits = np.random.default_rng(1).integers(0, 2, 700)
    assert np.allclose(tm.modulate(bits, tcfg), jm.modulate(bits, jcfg), rtol=0, atol=1e-5)
    assert np.allclose(tm.preamble(tcfg, 2.5), jm.preamble(jcfg, 2.5), rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_tx_pipeline_matches(name):
    tcfg, jcfg = _cfgs(name)
    bits = np.random.default_rng(2).integers(0, 2, (3, 648)).astype(np.uint8)
    got = make_tx_pipeline(tcfg, 1, "cpu")(torch.as_tensor(bits)).numpy()
    want = np.asarray(jax_tx_pipeline(jcfg, 1)(jnp.asarray(bits)))
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.allclose(got, want, rtol=0, atol=1e-5)


def _frames(tcfg, num_data_symbols, seed, cfo_hz):
    """[3, (T+1+R)*sps] noisy training+ref+data frames with a carrier offset
    (rows 0-1), the last row faded to silence after its first symbols."""
    rng = np.random.default_rng(seed)
    nbits = num_data_symbols * tcfg.bits_per_mc_symbol
    rows = []
    for r in range(3):
        body = np.concatenate([tm.preamble(tcfg)[tcfg.chirp.total_samples :],
                               tm.modulate(rng.integers(0, 2, nbits), tcfg)])
        t = np.arange(len(body)) / tcfg.sample_rate
        shift = 0.0 if r == 2 else cfo_hz * (1 - 2 * r)
        body = body * np.cos(2 * np.pi * shift * t) + rng.normal(0, 0.03, len(body))
        if r == 2:
            body[(tcfg.training_symbols + 6) * tcfg.samples_per_symbol :] *= 0.01
        rows.append(body.astype(np.float32))
    return np.stack(rows), np.asarray([cfo_hz, -cfo_hz, 0.0], np.float32)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_demodulate_matches(name):
    tcfg, jcfg = _cfgs(name)
    nds = 24
    x, cfo = _frames(tcfg, nds, seed=5, cfo_hz=1.5)
    got = tm.demodulate(torch.as_tensor(x), torch.as_tensor(cfo), tcfg, nds)
    want = jm.demodulate(jnp.asarray(x), jnp.asarray(cfo), jcfg, nds)
    assert got.soft_bits.shape == tuple(want.soft_bits.shape)
    assert np.allclose(got.soft_bits.numpy(), np.asarray(want.soft_bits), rtol=0, atol=2e-3)
    for field in ("snr_estimate_db", "freq_fading_index", "temporal_fading_index",
                  "phase_noise_var"):
        assert np.allclose(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                           rtol=0, atol=1e-3), field
    assert np.allclose(got.zsym.numpy(), np.asarray(want.zsym), rtol=0, atol=1e-5)
