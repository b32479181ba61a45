"""The port's dsp/ (fir, windows, util, nco, biquad, resampler) against
``ria_tpu.dsp`` on the CPU: tap design bit for bit, FFT filtering within
1e-5, streaming equal to one shot (mirrors tests/test_dsp.py), the NCO and
utilities; the biquads, the AGC and the resampler (tolerances at their
tests)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ria_tpu.dsp import biquad as j_bq
from ria_tpu.dsp import fir as j_fir
from ria_tpu.dsp import nco as j_nco
from ria_tpu.dsp import resampler as j_rs
from ria_tpu.dsp import util as j_util
from ria_tpu.dsp import windows as j_win
from ria_tpu_torch.dsp import biquad as t_bq
from ria_tpu_torch.dsp import fir as t_fir
from ria_tpu_torch.dsp import nco as t_nco
from ria_tpu_torch.dsp import resampler as t_rs
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
    from ria_tpu_torch.dsp.util import _sliding
    from ria_tpu_torch.utils.device import wide_cumsum

    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 48000)).astype(np.float32) ** 2
    if dtype == torch.complex64:
        x = (x + 1j * rng.normal(size=x.shape)).astype(np.complex64)
    x[:, 30000:] = 0
    xt = torch.as_tensor(x)
    assert torch.equal(wide_cumsum(xt, dim=-1), torch.cumsum(xt, dim=-1))
    e = _sliding(xt, 1000)
    assert bool((e[:, 30000:] == 0).all())


# ------------------------------------------------------------ biquad and AGC
# Measured on these inputs (unit-normal rows of 4,800 samples, outputs up to
# 4.0): the biquads part from the reference by at most 5.4e-6.  XLA's CPU
# code contracts products of the recurrence into fused multiply-adds, and
# which ones it picks per compile: on these [3, 4800] inputs the lowpass,
# highpass and notch run z1 = fma(b1, x, -(a1 y)) + z2 and z2 = fma(-a2, y,
# b2 x), the bandpass y = fma(b0, x, z1) and z2 = fma(b2, x, -(a2 y)).  The
# port rounds every product, as the float32 recurrence reads.
# ``_biquad_emulated`` replays an order in numpy; the test holds the
# reference to one of the fused orders and the port to the plain one, bit
# for bit.  The AGC has no such pair and is equal bit for bit.
BIQUAD_ATOL = 2e-5
# (y, z1, z2): "plain" rounds each product; "fma" fuses one product into the
# sum ("fma" of z2 fuses a2 y, "fma_b" fuses b2 x).
BIQUAD_PLAIN = ("plain", "plain", "plain")
BIQUAD_FUSED = [(y, z1, z2) for y in ("plain", "fma") for z1 in ("plain", "fma")
                for z2 in ("plain", "fma", "fma_b")][1:]


def _biquad_emulated(x: np.ndarray, c, order: tuple) -> np.ndarray:
    f = np.float32
    b0, b1, b2, a1, a2 = (f(v) for v in (c.b0, c.b1, c.b2, c.a1, c.a2))

    def fma(a, b, d):  # one rounding of a*b + d (exact in float64 for float32 inputs)
        return f(np.float64(a) * np.float64(b) + np.float64(d))

    oy, oz1, oz2 = order
    z1 = z2 = f(0)
    out = np.empty_like(x)
    for i, xi in enumerate(x):
        y = fma(b0, xi, z1) if oy == "fma" else f(f(b0 * xi) + z1)
        n1 = fma(b1, xi, -f(a1 * y)) if oz1 == "fma" else f(f(b1 * xi) - f(a1 * y))
        z2_next = {"plain": lambda: f(f(b2 * xi) - f(a2 * y)),
                   "fma": lambda: fma(-a2, y, f(b2 * xi)),
                   "fma_b": lambda: fma(b2, xi, -f(a2 * y))}[oz2]()
        z1, z2 = f(n1 + z2), z2_next
        out[i] = y
    return out


@pytest.mark.parametrize("design", ["lowpass", "highpass", "bandpass", "notch"])
def test_biquad_matches_reference(design):
    c = getattr(t_bq, design)(1000.0, 0.707, 48000.0)
    assert vars(c) == vars(getattr(j_bq, design)(1000.0, 0.707, 48000.0))  # float64, exact
    x = np.random.default_rng(0).normal(size=(3, 4800)).astype(np.float32)
    want, (wz1, wz2) = j_bq.biquad_filter(jnp.asarray(x), c)
    got, (z1, z2) = t_bq.biquad_filter(torch.as_tensor(x), c)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=BIQUAD_ATOL)
    np.testing.assert_allclose(z1.numpy(), np.asarray(wz1), rtol=0, atol=BIQUAD_ATOL)
    np.testing.assert_allclose(z2.numpy(), np.asarray(wz2), rtol=0, atol=BIQUAD_ATOL)
    # Each package's order, replayed: the reference fused, the port not.
    ref_orders = [o for o in BIQUAD_FUSED
                  if np.array_equal(np.asarray(want)[0], _biquad_emulated(x[0], c, o))]
    assert ref_orders, "the reference follows none of the fused orders"
    print(f"{design}: the reference follows {ref_orders}")
    np.testing.assert_array_equal(got.numpy()[0], _biquad_emulated(x[0], c, BIQUAD_PLAIN))


def test_biquad_streams_in_blocks():
    """Carrying (z1, z2) across blocks gives the one-shot output exactly."""
    c = t_bq.lowpass(1500.0, 0.9, 48000.0)
    x = torch.as_tensor(np.random.default_rng(1).normal(size=(2, 3000)).astype(np.float32))
    whole, _ = t_bq.biquad_filter(x, c)
    a, state = t_bq.biquad_filter(x[:, :1100], c)
    b, _ = t_bq.biquad_filter(x[:, 1100:], c, state)
    torch.testing.assert_close(torch.cat([a, b], dim=-1), whole, rtol=0, atol=0)


def test_biquad_lowpass_attenuates():
    fs = 48000.0
    t = np.arange(4800) / fs
    lo = torch.as_tensor(np.sin(2 * np.pi * 200 * t).astype(np.float32))
    hi = torch.as_tensor(np.sin(2 * np.pi * 8000 * t).astype(np.float32))
    c = t_bq.lowpass(1000.0, 0.707, fs)
    y_lo, _ = t_bq.biquad_filter(lo, c)
    y_hi, _ = t_bq.biquad_filter(hi, c)
    assert float(y_lo[2000:].std()) > 0.6
    assert float(y_hi[2000:].std()) < 0.05


def test_agc_matches_reference_exactly():
    rng = np.random.default_rng(2)
    tone = (0.05 * np.sin(2 * np.pi * 1000 * np.arange(48000) / 48000)).astype(np.float32)
    x = np.stack([tone, (rng.normal(size=48000) * 0.3).astype(np.float32)])
    want, wgain = j_bq.agc(jnp.asarray(x), target=0.5)
    got, gain = t_bq.agc(torch.as_tensor(x), target=0.5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(gain.numpy(), np.asarray(wgain))
    tail = got.numpy()[0, -4800:]
    assert 0.3 < np.max(np.abs(tail)) < 0.8  # converges to the target


# ------------------------------------------------------------ resampler
# Measured: 3.0e-7 (48 kHz -> 8 kHz), 1.2e-6 (8 kHz -> 48 kHz) and 1.2e-3 on
# outputs up to 298 (48 kHz -> 44.1 kHz, L = 147: a 2^20-point float32 FFT)
# from the reference, i.e. within 4.1e-6 of each output's peak.
RESAMPLE_RTOL_OF_PEAK = 1e-5


@pytest.mark.parametrize("rates", [(48000, 8000), (8000, 48000), (48000, 44100), (8000, 8000)])
def test_resampler_matches_reference(rates):
    x = np.random.default_rng(sum(rates)).normal(size=(2, 4800)).astype(np.float32)
    want = np.asarray(j_rs.resample(jnp.asarray(x), *rates))
    got = t_rs.resample(torch.as_tensor(x), *rates).numpy()
    assert got.shape == want.shape
    assert t_rs.output_size(4800, *rates) == j_rs.output_size(4800, *rates)
    peak = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= RESAMPLE_RTOL_OF_PEAK * peak


def test_resampler_preserves_tone():
    fs_in, fs_out = 48000, 8000
    t = np.arange(fs_in) / fs_in
    x = torch.as_tensor(np.sin(2 * np.pi * 1000 * t).astype(np.float32))
    y = t_rs.resample(x, fs_in, fs_out).numpy()
    assert len(y) == fs_out
    spec = np.abs(np.fft.rfft(y[800:]))
    peak_hz = np.argmax(spec) * fs_out / len(y[800:])
    assert abs(peak_hz - 1000.0) < 5.0
