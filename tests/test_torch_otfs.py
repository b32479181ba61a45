"""The port's OTFS (``ria_tpu_torch.wave.otfs``) against ``ria_tpu.wave.otfs``.

Mirrors ``tests/test_otfs.py``: the ISFFT/SFFT inverse, the TF-equalized
mode with and without decision-directed phase tracking, and the raw-DD
differential mode, for BPSK, QPSK and QAM16.  The port and the jitted
``demodulate_presynced`` see the same numpy-noised frames and CFOs: soft
bits within 2e-3 with equal signs, SNR and noise variance within 1e-3, DD
symbols within 1e-3.  The TX (DD grid, frame) is bit-equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ria_tpu.wave import otfs as J
from ria_tpu_torch.fec.ldpc import decode_batch
from ria_tpu_torch.fec.ldpc_matrix import encode_np
from ria_tpu_torch.wave import otfs as T

torch.set_num_threads(1)

MODES = {
    "eq": dict(tf_equalization=True),
    "eq_tracked": dict(tf_equalization=True, phase_tracking=True),
    "raw": dict(dd_differential=True, tf_equalization=False),
}


def _assert_same(frames, cfo, cfg):
    got = T.demodulate_presynced(torch.as_tensor(frames), torch.as_tensor(cfo), cfg)
    want = J.demodulate_presynced(frames, cfo, J.OTFSConfig(**dataclasses.asdict(cfg)))
    soft, w_soft = got.soft_bits.numpy(), np.asarray(want.soft_bits)
    assert soft.shape == w_soft.shape
    assert np.abs(soft - w_soft).max() <= 2e-3
    assert np.array_equal(np.sign(soft), np.sign(w_soft))
    for name in ("snr_db", "noise_var", "dd_symbols"):
        assert np.allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                           rtol=0, atol=1e-3), name
    return got


def _frames(cfg, bits, snr_db, rng, count=2):
    tx = T.tx_frame(bits, cfg)
    rms = np.sqrt(np.mean(tx**2))
    out = np.tile(tx, (count, 1))
    return (out + rng.normal(0, rms * 10 ** (-snr_db / 20), out.shape)).astype(np.float32)


def test_isfft_sfft_inverse_and_reference():
    dd = np.random.default_rng(0).normal(size=(2, 2, 32, 16, 2)).astype(np.float32)
    dd = (dd[..., 0] + 1j * dd[..., 1]).astype(np.complex64)
    tf = T.isfft(torch.as_tensor(dd))
    assert np.allclose(tf.numpy(), np.asarray(J.isfft(jnp.asarray(dd))), atol=1e-4)
    assert np.allclose(T.sfft(tf).numpy(), dd, atol=1e-4)
    assert np.allclose(T.sfft(tf).numpy(), np.asarray(J.sfft(J.isfft(jnp.asarray(dd)))), atol=1e-4)


@pytest.mark.parametrize("mod", ["BPSK", "QPSK", "QAM16"])
@pytest.mark.parametrize("mode", ["eq", "eq_tracked", "raw"])
def test_tables_and_tx_bit_equal(mod, mode):
    cfg = T.OTFSConfig(modulation=mod, **MODES[mode])
    jcfg = J.OTFSConfig(**dataclasses.asdict(cfg))
    assert cfg.bits_per_frame() == jcfg.bits_per_frame()
    assert np.array_equal(cfg.data_cells(), jcfg.data_cells())
    bits = np.random.default_rng(1).integers(0, 2, cfg.bits_per_frame() - 5)
    assert np.array_equal(T.map_to_dd(bits, cfg), J.map_to_dd(bits, jcfg))
    assert np.array_equal(T.tx_frame(bits, cfg), J.tx_frame(bits, jcfg))
    assert np.array_equal(T._sync_sequence(cfg), J._sync_sequence(jcfg))


@pytest.mark.parametrize("mod,mode,snr_db", [
    ("QPSK", "eq", 18.0), ("QPSK", "eq_tracked", 18.0), ("QPSK", "raw", 18.0),
    ("BPSK", "eq_tracked", 12.0), ("QAM16", "eq", 22.0), ("QAM16", "eq_tracked", 22.0),
    ("QPSK", "eq", 0.0), ("QPSK", "eq_tracked", 0.0), ("QPSK", "raw", 4.0),
])
def test_demod_matches_jax(mod, mode, snr_db):
    """Two copies of one frame under independent noise and residual CFOs of
    1.3 and -2.2 Hz; where a frame holds a codeword (QPSK, QAM16) it
    decodes at 12 dB and up; at 0-4 dB many soft bits sit inside the +-20
    clip."""
    cfg = T.OTFSConfig(modulation=mod, **MODES[mode])
    rng = np.random.default_rng(7)
    info = rng.integers(0, 2, (1, 162))
    bits = rng.integers(0, 2, cfg.bits_per_frame())
    fits = cfg.bits_per_frame() >= 648
    if fits:
        bits[:648] = encode_np(info, "R1_4")[0]
    got = _assert_same(_frames(cfg, bits, snr_db, rng), np.array([1.3, -2.2], np.float32), cfg)
    if snr_db >= 12.0 and fits:
        dec = decode_batch(got.soft_bits[:, :648], np.full(2, 0.75, np.float32), "R1_4",
                           device="cpu")
        assert dec.success.all() and (dec.info_bits.numpy() == info).all()
    elif snr_db < 12.0:
        assert float((got.soft_bits.abs() < 19.0).float().mean()) > 0.1


def test_scalar_cfo_and_leading_axes():
    cfg = T.OTFSConfig(**MODES["eq_tracked"])
    rng = np.random.default_rng(9)
    frames = _frames(cfg, rng.integers(0, 2, cfg.bits_per_frame()), 15.0, rng, count=4)
    got = T.demodulate_presynced(torch.as_tensor(frames.reshape(2, 2, -1)), 0.5, cfg)
    want = J.demodulate_presynced(frames.reshape(2, 2, -1), np.float32(0.5),
                                  J.OTFSConfig(**dataclasses.asdict(cfg)))
    assert got.soft_bits.shape == (2, 2, cfg.bits_per_frame())
    assert np.abs(got.soft_bits.numpy() - np.asarray(want.soft_bits)).max() <= 2e-3
