"""The twin of tools/bench_profile.py (``ria_tpu_torch.tools.bench_profile``)
on the CPU, at the tiny geometry of ``entry.geometry()``.

Its batch is drawn as the reference's ``main`` draws it (the same generator
calls in the same order; audio within 1e-5 of the reference's TX), and each
stage it times gives, on the same audio, what the reference's stage
function gives: ``detect_dual_chirp`` (``detected`` and ``start`` equal,
``cfo_hz`` within 1e-3), the frame slice + ``demodulate`` (soft bits within
2e-3, as tests/test_torch_mc_dpsk.py holds them), the fixed-factor decoder
(``success``, ``iterations`` and ``info_bits`` equal) and the whole chain
(as tests/test_torch_pipeline.py holds it).  The span split covers the
call; ``main`` prints the reference's four rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import __graft_entry__ as graft
from ria_tpu.fec.ldpc import make_decoder as jax_make_decoder
from ria_tpu.fec.ldpc import make_encoder as jax_make_encoder
from ria_tpu.fec.ldpc_matrix import RECOMMENDED_ITERS, get_code
from ria_tpu.phy.pipeline import make_rx_pipeline as jax_rx_pipeline
from ria_tpu.phy.pipeline import make_tx_pipeline as jax_tx_pipeline
from ria_tpu.sync.chirp import detect_dual_chirp
from ria_tpu.wave.mc_dpsk import demodulate
from ria_tpu_torch.entry import geometry
from ria_tpu_torch.tools import bench_profile as BP

torch.set_num_threads(1)

LEAD = 256  # the tiny window holds the frame 2,048 samples past its end


def _profile():
    cfg, ncw, batch, window = geometry()
    return BP.build(cfg, ncw, batch, window, LEAD, "cpu")


def _reference_audio(ncw, batch, window):
    """The reference tool's batch at this geometry, line for line."""
    jcfg = graft._tiny_cfg()
    rng = np.random.default_rng(0)
    info = rng.integers(0, 2, size=(batch * ncw, get_code("R1_4").k)).astype(np.uint8)
    coded = np.asarray(jax_make_encoder("R1_4")(info)).reshape(batch, ncw * 648)
    tx = np.asarray(jax_tx_pipeline(jcfg, ncw)(coded))
    audio = np.zeros((batch, window), np.float32)
    audio[:, LEAD:LEAD + tx.shape[1]] = tx
    rms = float(np.sqrt((audio ** 2).mean()))
    audio += rng.normal(0, rms * 10 ** (-10.0 / 20), audio.shape).astype(np.float32)
    return [audio + rng.normal(0, 1e-4, audio.shape).astype(np.float32)
            for _ in range(BP.NBUF)]


def test_batch_is_the_reference_tools():
    p = _profile()
    want = _reference_audio(p.ncw, p.batch, p.window)
    assert len(p.auds) == BP.NBUF
    for got, ref in zip(p.auds, want):
        assert np.allclose(got.numpy(), ref, rtol=0, atol=1e-5)


def test_stages_match_the_reference_stage_functions():
    p = _profile()
    jcfg = graft._tiny_cfg()
    audio = p.auds[1]
    x = jnp.asarray(audio.numpy())

    got, want = p.sync(audio), detect_dual_chirp(x, jcfg.chirp)
    assert np.array_equal(got.detected.numpy(), np.asarray(want.detected))
    assert np.array_equal(got.start.numpy(), np.asarray(want.start))
    assert np.allclose(got.cfo_hz.numpy(), np.asarray(want.cfo_hz), rtol=0, atol=1e-3)
    assert got.detected.all()

    n_sym = jcfg.num_data_symbols(p.ncw * 648)
    need = p.rx.frame_need
    start, cfo = jnp.asarray(p.start.numpy()), jnp.zeros(p.batch, jnp.float32)
    frames = jax.vmap(lambda a, i: jax.lax.dynamic_slice(a, (i,), (need,)))(x, start)
    ref_demod = demodulate(frames, cfo, jcfg, n_sym)
    got_demod = p.demod(audio, p.start, p.cfo)
    assert np.allclose(got_demod.soft_bits.numpy(), np.asarray(ref_demod.soft_bits),
                       rtol=0, atol=2e-3)

    soft = p.soft(audio)
    ref_soft = np.asarray(ref_demod.soft_bits)[..., : p.ncw * 648].reshape(-1, 648)
    got_dec = p.decode(soft)
    ref_dec = jax_make_decoder("R1_4", RECOMMENDED_ITERS["R1_4"], 0.75)(jnp.asarray(ref_soft))
    for name in ("success", "iterations", "info_bits"):
        assert np.array_equal(getattr(got_dec, name).numpy(),
                              np.asarray(getattr(ref_dec, name))), name
    assert got_dec.success.all()

    got_rx = p.rx(audio)
    ref_rx = jax_rx_pipeline(jcfg, "R1_4", p.ncw, p.window)(x)
    for name in ("detected", "start", "cw_success", "info_bits", "iterations"):
        assert np.array_equal(getattr(got_rx, name).numpy(), np.asarray(getattr(ref_rx, name)))
    for name in ("cfo_hz", "snr_db"):
        assert np.allclose(getattr(got_rx, name).numpy(), np.asarray(getattr(ref_rx, name)),
                           rtol=0, atol=1e-3), name


def test_span_split_covers_the_call():
    """Each stage span of ``RxPipeline.forward`` appears once in one profiled
    call, and the three cover at least 95% of its host time."""
    p = _profile()
    split = BP.span_split(lambda: p.rx(p.auds[0]), "cpu")
    assert split["clock"] == "host"
    assert list(split["spans"]) == list(BP.SPANS)
    assert all(s["ms"] > 0 and s["kernels"] > 0 for s in split["spans"].values())
    assert 0.95 <= split["covered"] <= 1.0


def test_main_prints_the_reference_rows(monkeypatch, capsys):
    cfg, ncw, batch, window = geometry()
    monkeypatch.setattr(BP, "geometry", lambda: (cfg, ncw, batch, window, LEAD))
    result = BP.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == f"geometry: batch={batch} window={window} ncw={ncw}"
    assert [ln.split()[0] for ln in lines[1:5]] == ["sync", "demod", "ldpc", "full"]
    assert all(ln.split()[2] == "ms" and ln.endswith("Msamp/s") for ln in lines[1:5])
    assert set(result["ms"]) == {"sync", "demod", "ldpc", "full"}
    assert all(v > 0 for v in result["ms"].values())
    assert result["split"]["covered"] >= 0.95
