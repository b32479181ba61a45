"""``ria_tpu_torch.wave.afdm`` against ``ria_tpu.wave.afdm`` on the CPU: the
AFDM cases of tests/test_css_afdm.py.  ``daft``/``idaft`` within 1e-5, the
block (de)modulators within 1e-5, ``AFDMWaveform`` audio within 1e-5 and its
receive outcome, bytes, start, CFO and soft bits (within 2e-3) equal on the
same noisy audio, with and without a carrier offset; ``c1 > 0`` raises.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ria_tpu.fec import ldpc as j_ldpc
from ria_tpu.phy import frame_v2 as JF
from ria_tpu.wave import afdm as J
from ria_tpu.wave.api import create_waveform as j_create
from ria_tpu_torch.phy import frame_v2 as TF
from ria_tpu_torch.wave import afdm as T
from ria_tpu_torch.wave.api import create_waveform as t_create

torch.set_num_threads(1)


def _cx(rng, *shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)


@pytest.mark.parametrize("N,c1,c2", [(64, 0.0, 0.0), (64, 0.01, 0.003), (128, 1.0 / 256, 0.0),
                                     (512, 1.0 / 1024, 0.002)])
def test_daft_idaft_match_reference(N, c1, c2):
    rng = np.random.default_rng(N)
    x = _cx(rng, 3, N)
    jc, tc = J.AFDMConfig(N=N, c1=c1, c2=c2), T.AFDMConfig(N=N, c1=c1, c2=c2)
    y_want = np.asarray(J.daft(jnp.asarray(x), jc))
    y_got = T.daft(torch.as_tensor(x), tc)
    assert y_got.dtype == torch.complex64
    assert np.max(np.abs(y_got.numpy() - y_want)) <= 1e-5 * np.sqrt(N)
    back_want = np.asarray(J.idaft(jnp.asarray(y_want), jc))
    back_got = T.idaft(torch.as_tensor(y_want.copy()), tc).numpy()
    assert np.max(np.abs(back_got - back_want)) <= 1e-5 * np.sqrt(N)
    assert np.allclose(T.idaft(y_got, tc).numpy(), x, atol=1e-4)      # test_daft_inverse


def test_audio_profile_blocks_match_reference():
    cfg_j, cfg_t = J.AFDMConfig(), T.AFDMConfig()
    rng = np.random.default_rng(1)
    qpsk = (((1 - 2 * rng.integers(0, 2, 64)) + 1j * (1 - 2 * rng.integers(0, 2, 64)))
            / np.sqrt(2)).astype(np.complex64)
    want_tx = J.modulate_block(qpsk, cfg_j)
    got_tx = T.modulate_block(qpsk, cfg_t, device="cpu")
    assert got_tx.dtype == np.float32 and np.max(np.abs(got_tx - want_tx)) <= 1e-5
    want_rx = J.demodulate_block(want_tx, cfg_j)
    got_rx = T.demodulate_block(want_tx, cfg_t, device="cpu")
    assert np.max(np.abs(got_rx - want_rx)) <= 1e-5 * np.max(np.abs(want_rx))
    scale = np.mean(got_rx / qpsk)
    assert np.allclose(got_rx / scale, qpsk, atol=0.05)   # test_afdm_audio_profile_roundtrip
    # Several blocks at once give what the blocks give one at a time.
    blocks = np.stack([want_tx, want_tx[::-1].copy()])
    both = T.demodulate_block(blocks, cfg_t, device="cpu")
    assert np.allclose(both[0], got_rx, atol=1e-6)
    assert np.allclose(both[1], T.demodulate_block(blocks[1], cfg_t, device="cpu"), atol=1e-6)


def test_chirped_profile_is_refused():
    with pytest.raises(ValueError, match="c1"):
        T.AFDMWaveform(cfg=T.AFDMConfig(c1=1.0 / 128), device="cpu")
    with pytest.raises(ValueError, match="c1"):
        t_create(TF.WaveformMode.AFDM, cfg=T.AFDMConfig(c1=0.01), device="cpu")


def test_shift_real_matches_reference():
    x = np.random.default_rng(4).normal(0, 0.2, 5000).astype(np.float32)
    want = J._shift_real(x, 7.5, 48000.0)
    got = T._shift_real(x, 7.5, 48000.0, device="cpu")
    assert got.dtype == np.float32 and np.max(np.abs(got - want)) <= 1e-5


@pytest.mark.parametrize("cfo,snr_db,seeds", [(0.0, 5.0, (100, 101, 102)),
                                              (10.0, 10.0, (300, 301)), (5.0, 30.0, (7,))])
def test_afdm_waveform_matches_reference(cfo, snr_db, seeds, monkeypatch):
    jw = j_create(JF.WaveformMode.AFDM)
    tw = t_create(TF.WaveformMode.AFDM, device="cpu")
    fb = JF.ControlFrame(type=JF.FrameType.KEEPALIVE, seq=1, src_hash=JF.hash_callsign("W1AW"),
                         dst_hash=JF.hash_callsign("VE3ABC")).serialize()
    want_tx = jw.tx_frame(fb, tx_cfo_hz=cfo)
    got_tx = tw.tx_frame(fb, tx_cfo_hz=cfo)
    assert got_tx.shape == want_tx.shape and np.max(np.abs(got_tx - want_tx)) <= 1e-5
    assert tw.frame_samples(2) == jw.frame_samples(2)

    # The soft bits each package hands its decoder.
    seen = {}
    j_decode, t_decode = j_ldpc.decode_with_retries, T.decode_with_retries

    def j_spy(llrs, rate, *a, **kw):
        seen["want"] = np.asarray(llrs)
        return j_decode(llrs, rate, *a, **kw)

    def t_spy(llrs, rate, *a, **kw):
        seen["got"] = np.asarray(llrs)
        return t_decode(llrs, rate, *a, **kw)

    monkeypatch.setattr(j_ldpc, "decode_with_retries", j_spy)
    monkeypatch.setattr(T, "decode_with_retries", t_spy)
    rms = float(np.sqrt(np.mean(want_tx ** 2)))
    for seed in seeds:
        rng = np.random.default_rng(seed)
        audio = np.concatenate([np.zeros(3000, np.float32), want_tx, np.zeros(3000, np.float32)])
        audio += rng.normal(0, rms * 10 ** (-snr_db / 20), audio.shape).astype(np.float32)
        ok_w, fb_w, info_w = jw.rx_frame(audio, num_codewords=1)
        ok_g, fb_g, info_g = tw.rx_frame(audio, num_codewords=1)
        assert ok_g and ok_g == ok_w and fb_g == fb_w and fb_g[:20] == fb
        assert info_g["start"] == info_w["start"] and info_g["detected"]
        assert info_g["cfo_hz"] == pytest.approx(info_w["cfo_hz"], abs=1e-3)
        assert np.array_equal(info_g["cw_ok"], np.asarray(info_w["cw_ok"]))
        assert np.max(np.abs(seen["got"] - seen["want"])) <= 2e-3
    noise = np.random.default_rng(1).normal(0, 0.05, 30000).astype(np.float32)
    assert tw.rx_frame(noise)[::2] == jw.rx_frame(noise)[::2] == (False, {"detected": False})
