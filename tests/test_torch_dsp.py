"""The port's dsp/ (fir, windows, util, nco) against ``ria_tpu.dsp`` on the
CPU: tap design bit for bit, FFT filtering within 1e-5, streaming equal to
one shot (mirrors tests/test_dsp.py), and the NCO and utilities."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ria_tpu.dsp import fir as j_fir
from ria_tpu.dsp import nco as j_nco
from ria_tpu.dsp import util as j_util
from ria_tpu.dsp import windows as j_win
from ria_tpu_torch.dsp import fir as t_fir
from ria_tpu_torch.dsp import nco as t_nco
from ria_tpu_torch.dsp import util as t_util
from ria_tpu_torch.dsp import windows as t_win

torch.set_num_threads(1)

TOL = 1e-5


@pytest.mark.parametrize("taps,cut", [(31, 3000.0), (101, 1000.0), (193, 1550.0), (129, 200.0)])
def test_design_bit_equal(taps, cut):
    np.testing.assert_array_equal(t_fir.design_lowpass(taps, cut, 48000.0),
                                  j_fir.design_lowpass(taps, cut, 48000.0))
    np.testing.assert_array_equal(t_fir.design_highpass(taps, cut, 48000.0),
                                  j_fir.design_highpass(taps, cut, 48000.0))
    np.testing.assert_array_equal(t_fir.design_bandpass(taps, cut, cut + 2700.0, 48000.0),
                                  j_fir.design_bandpass(taps, cut, cut + 2700.0, 48000.0))


def test_fir_lowpass_response():
    h = t_fir.design_lowpass(101, 1000.0, 48000.0)
    assert abs(h.sum() - 1.0) < 1e-5
    w = np.fft.rfftfreq(4096, 1 / 48000.0)
    H = np.abs(np.fft.rfft(h, 4096))
    assert H[np.argmin(np.abs(w - 100))] > 0.99
    assert H[np.argmin(np.abs(w - 5000))] < 0.01


@pytest.mark.parametrize("mode", ["same", "full"])
@pytest.mark.parametrize("shape,taps", [((1000,), 31), ((3, 9600), 193), ((2, 777), 129)])
def test_fft_convolve_matches_reference(mode, shape, taps):
    rng = np.random.default_rng(taps)
    x = rng.normal(size=shape).astype(np.float32)
    h = t_fir.design_bandpass(taps, 200.0, 2900.0, 48000.0)
    want = np.asarray(jax.jit(lambda a, b: j_fir.fft_convolve(a, b, mode))(x, h))
    got = t_fir.fft_convolve(torch.as_tensor(x), h, mode).numpy()
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= TOL


def test_fir_filter_with_tail_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 9600)).astype(np.float32)
    tail = rng.normal(size=(2, 192)).astype(np.float32)
    h = t_fir.design_lowpass(193, 1550.0, 48000.0)
    want_y, want_tail = jax.jit(j_fir.fir_filter)(x, h, tail)
    got_y, got_tail = t_fir.fir_filter(torch.as_tensor(x), h, torch.as_tensor(tail))
    assert np.max(np.abs(got_y.numpy() - np.asarray(want_y))) <= TOL
    np.testing.assert_array_equal(got_tail.numpy(), np.asarray(want_tail))


def test_fir_streaming_matches_batch():
    """Mirror of tests/test_dsp.py::test_fir_streaming_matches_batch."""
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=1000).astype(np.float32))
    h = t_fir.design_lowpass(31, 3000.0, 48000.0)
    y_full, _ = t_fir.fir_filter(x, h)
    y1, tail = t_fir.fir_filter(x[:400], h)
    y2, _ = t_fir.fir_filter(x[400:], h, tail)
    assert torch.allclose(y_full, torch.cat([y1, y2]), atol=1e-5)


@pytest.mark.parametrize("name,kw", [("hann", {}), ("hamming", {}), ("blackman", {}),
                                     ("kaiser", {}), ("kaiser", {"beta": 5.0})])
def test_windows_bit_equal(name, kw):
    for n in (16, 513, 1024):
        np.testing.assert_array_equal(t_win.window(name, n, **kw), j_win.window(name, n, **kw))


def test_util_matches_reference():
    rng = np.random.default_rng(2)
    x = rng.normal(0, 0.3, size=(3, 4000)).astype(np.float32)
    x[1] = 0.0
    xt = torch.as_tensor(x)
    for j, t in ((j_util.rms, t_util.rms), (j_util.peak, t_util.peak)):
        np.testing.assert_allclose(t(xt).numpy(), np.asarray(j(jnp.asarray(x))), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(t_util.normalize_rms(xt, 0.25).numpy(),
                               np.asarray(j_util.normalize_rms(jnp.asarray(x), 0.25)),
                               rtol=TOL, atol=TOL)
    lin = np.array([1e-15, 0.5, 2.0], np.float32)
    np.testing.assert_allclose(t_util.linear_to_db(torch.as_tensor(lin)).numpy(),
                               np.asarray(j_util.linear_to_db(jnp.asarray(lin))), atol=1e-4)
    assert t_util.linear_to_db(0.5) == pytest.approx(float(j_util.linear_to_db(0.5)), abs=1e-4)
    assert t_util.db_to_linear(6.0) == j_util.db_to_linear(6.0)


def test_nco_matches_reference():
    freqs = np.array([300.0, 1500.0, 2700.5], np.float32)
    want = np.asarray(jax.jit(lambda f: j_nco.phase_ramp(f, 4800, 48000.0, 0.25))(freqs))
    got = t_nco.phase_ramp(freqs, 4800, 48000.0, 0.25).numpy()
    assert np.max(np.abs(got - want)) <= 1e-3   # ramps reach 1,700 rad: ~1 ulp
    np.testing.assert_array_equal(t_nco.mixer_bank(freqs, 512, 48000.0),
                                  j_nco.mixer_bank(freqs, 512, 48000.0))
    t = np.arange(8192) / 48000.0
    x = (np.cos(2 * np.pi * 1000.0 * t) + 0.3 * np.sin(2 * np.pi * 2200.0 * t)).astype(np.float32)
    want_y, want_end = jax.jit(lambda a: j_nco.freq_shift_real(a, 37.5, 48000.0, 0.1))(x)
    got_y, got_end = t_nco.freq_shift_real(torch.as_tensor(x), 37.5, 48000.0, 0.1)
    assert np.max(np.abs(got_y.numpy() - np.asarray(want_y))) <= 1e-4
    assert abs(float(got_end) - float(want_end)) <= 1e-3
    # The shift moves the tone by 37.5 Hz.
    spec = np.abs(np.fft.rfft(got_y.numpy()[1000:-1000] * np.hanning(6192)))
    peak = np.argmax(spec) * 48000.0 / 6192
    assert abs(peak - 1037.5) < 8.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64])
def test_wide_cumsum_is_the_cpu_cumsum(dtype):
    """``wide_cumsum`` (the sync detectors' energy prefixes) gives the CPU's
    ``torch.cumsum`` bit for bit, batched and over a run of zeros, where the
    prefixes stay constant and a sliding sum reads exactly 0."""
    from ria_tpu_torch.utils.device import wide_cumsum
    from ria_tpu_torch.wave.ofdm import _sliding

    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 48000)).astype(np.float32) ** 2
    if dtype == torch.complex64:
        x = (x + 1j * rng.normal(size=x.shape)).astype(np.complex64)
    x[:, 30000:] = 0
    xt = torch.as_tensor(x)
    assert torch.equal(wide_cumsum(xt, dim=-1), torch.cumsum(xt, dim=-1))
    e = _sliding(xt, 1000)
    assert bool((e[:, 30000:] == 0).all())
