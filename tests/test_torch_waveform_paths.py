"""The waveform paths of ``ria_tpu_torch.tools.waveform_paths`` against ``ria_tpu``.

Each path runs at its full window with B = 2 on the CPU port and through
the same composition of ``ria_tpu`` functions on the same audio: the sync
on the waveform class's search window (``sync.zc.detect`` with the DATA and
CONTROL roots for OTFS; ``dpsk.find_preamble`` and ``mfsk.find_preamble``
one channel at a time, since the reference's accept only a 1-D window),
the header codeword's demodulation from the sync's start over a zero-padded
chunk, and ``fec.ldpc.decode_batch`` with ``MIN_SUM_FACTOR`` and
``RECOMMENDED_ITERS["R1_4"]``.  Detected, start, frame type and success
are exact; CFO and SNR within 1e-3; soft bits within 2e-3 with equal
signs; info bits equal where the codeword decodes, and equal to those sent.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ria_tpu.fec.ldpc import decode_batch as jax_decode_batch
from ria_tpu.fec.ldpc_matrix import MIN_SUM_FACTOR, RECOMMENDED_ITERS
from ria_tpu.sync import css as Jcss
from ria_tpu.sync import zc as Jzc
from ria_tpu.wave import dpsk as Jdpsk
from ria_tpu.wave import mfsk as Jmfsk
from ria_tpu.wave import otfs as Jotfs
from ria_tpu_torch.tools import waveform_paths as W

torch.set_num_threads(1)

JAX_MODULE = {"otfs_eq": Jotfs, "otfs_raw": Jotfs, "dpsk": Jdpsk, "mfsk": Jmfsk}
JAX_CFG = {"otfs_eq": Jotfs.OTFSConfig, "otfs_raw": Jotfs.OTFSConfig,
           "dpsk": Jdpsk.DPSKConfig, "mfsk": Jmfsk.MFSKConfig}


def _reference(name, audio, chunk_len):
    """The path as a composition of ria_tpu functions, on numpy audio."""
    geom = W.path_geometry(name)
    jcfg = JAX_CFG[name](**dataclasses.asdict(geom.cfg))
    B = audio.shape[0]
    if name.startswith("otfs"):
        res = Jzc.detect(audio, Jzc.ZCConfig(),
                         root_mask=Jzc.ROOT_MASK_DATA | Jzc.ROOT_MASK_CONTROL)
        det, start = np.asarray(res.detected), np.asarray(res.start_sample)
        cfo, ftype = np.asarray(res.cfo_hz), np.asarray(res.frame_type)
    else:
        per = [JAX_MODULE[name].find_preamble(row[: W.SEARCH_WINDOW], jcfg) for row in audio]
        det = np.array([bool(r.detected) for r in per])
        start = np.array([int(r.data_start) for r in per], np.int32)
        cfo, ftype = np.zeros(B, np.float32), np.full(B, -1)
    chunks = np.zeros((B, chunk_len), np.float32)
    for b in range(B):
        s = int(start[b]) if det[b] else 0
        avail = audio[b, s : s + chunk_len]
        chunks[b, : len(avail)] = avail
    if name.startswith("otfs"):
        demod = Jotfs.demodulate_presynced(chunks, cfo, jcfg)
        snr = demod.snr_db
    else:
        demod = JAX_MODULE[name].demodulate(chunks, jcfg, W.LDPC_BITS)
        snr = demod.snr_estimate_db
    soft = np.asarray(demod.soft_bits)[:, : W.LDPC_BITS]
    dec = jax_decode_batch(soft, np.full(B, MIN_SUM_FACTOR, np.float32), W.RATE,
                           RECOMMENDED_ITERS[W.RATE])
    return dict(detected=det, start=start, frame_type=ftype, cfo_hz=cfo, snr_db=np.asarray(snr),
                soft_bits=soft, cw_success=np.asarray(dec.success) & det,
                info_bits=np.asarray(dec.info_bits))


@pytest.mark.parametrize("name", W.DECODE_PATHS)
def test_path_matches_jax(name):
    batch = W.make_path_batch(name, 2, seed=1, device="cpu")
    (audio,) = batch.inputs
    assert audio.shape == (2, W.path_geometry(name).window)
    path = W.make_path(name)
    got = path(audio)
    want = _reference(name, audio.numpy(), path.chunk)
    for field in ("detected", "start", "frame_type", "cw_success"):
        assert np.array_equal(getattr(got, field).numpy(), want[field]), field
    for field in ("cfo_hz", "snr_db"):
        assert np.allclose(getattr(got, field).numpy(), want[field], rtol=0, atol=1e-3), field
    soft = got.soft_bits.numpy()
    assert soft.shape == want["soft_bits"].shape
    assert np.abs(soft - want["soft_bits"]).max() <= 2e-3
    assert np.array_equal(np.sign(soft), np.sign(want["soft_bits"]))
    ok = got.cw_success.numpy()
    assert ok.all() and got.detected.all()
    assert np.array_equal(got.info_bits.numpy()[ok], want["info_bits"][ok])
    assert np.array_equal(got.info_bits.numpy(), batch.info)
    if name.startswith("otfs"):
        assert (got.frame_type.numpy() == Jzc.ZC_DATA).all()


def test_sync_path_matches_jax():
    batch = W.make_path_batch("css_zc_sync", 2, seed=2, device="cpu")
    zc_audio, css_audio = batch.inputs
    assert (zc_audio.shape, css_audio.shape) == ((2, 48000), (2, 96000))
    got = W.make_path("css_zc_sync")(zc_audio, css_audio)
    want_zc = Jzc.detect(zc_audio.numpy(), Jzc.ZCConfig(), root_mask=Jzc.ROOT_MASK_ALL)
    want_css = Jcss.detect(css_audio.numpy(), Jcss.CSSConfig())
    for g, w, exact, close in ((got.zc, want_zc, ("detected", "frame_type", "start_sample",
                                                    "root_index"),
                                ("correlation", "cfo_hz", "snr_estimate")),
                               (got.css, want_css, ("detected", "frame_type", "start_sample"),
                                ("correlation",))):
        for field in exact:
            assert np.array_equal(getattr(g, field).numpy(), np.asarray(getattr(w, field))), field
        for field in close:
            assert np.allclose(getattr(g, field).numpy(), np.asarray(getattr(w, field)),
                               rtol=0, atol=1e-3), field
    assert got.zc.detected.all() and got.css.detected.all()
    assert np.array_equal(got.zc.frame_type.numpy(), batch.frame_types[:, 0])
    assert np.array_equal(got.css.frame_type.numpy(), batch.frame_types[:, 1])


def test_geometries_and_batch():
    g = {name: W.path_geometry(name) for name in W.PATHS}
    assert (g["dpsk"].frame_samples, g["dpsk"].window) == (186368, 194368)
    assert (g["mfsk"].frame_samples, g["mfsk"].window) == (688128, 696128)
    assert g["otfs_eq"].window == g["otfs_raw"].window == 48000
    assert g["otfs_eq"].frame_samples == 2512 + 11520
    assert g["otfs_eq"].cfg.phase_tracking and not g["otfs_raw"].cfg.tf_equalization
    assert [g[n].snr_db for n in W.PATHS] == [18.0, 18.0, 6.0, -2.0, 0.0]
    with pytest.raises(ValueError):
        W.path_geometry("ofdm")
    a = W.make_path_batch("dpsk", 3, seed=4, device="cpu")
    b = W.make_path_batch("dpsk", 3, seed=4, device="cpu")
    assert torch.equal(a.inputs[0], b.inputs[0]) and np.array_equal(a.info, b.info)


def test_zero_padded_slice():
    x = torch.arange(20, dtype=torch.float32).reshape(2, 10)
    got = W.zero_padded_slice(x, torch.tensor([3, 8]), 4)
    assert torch.equal(got, torch.tensor([[3.0, 4, 5, 6], [18, 19, 0, 0]]))
