"""The port's OFDM waveform against ``ria_tpu.wave.ofdm`` (on the CPU).

Tolerances:
- tables, layouts and the numpy TX: equal (the same numpy code);
- ``analytic_signal``: within 1e-5 (float32 FFTs of another library);
- ``schmidl_cox_search`` and ``lts_search``: detected, start and repeats
  exact, CFO within 1e-3 Hz, correlations within 1e-5;
- ``_affine_prefix``: within 1e-5 relative (the log-depth prefix composes
  in another order than ``jax.lax.associative_scan``);
- ``demodulate_presynced``: soft bits within 2e-3, ``snr_db`` and
  ``noise_var`` within 1e-3, hard signs of the soft bits equal, for all nine
  modulations with pilots on and off, on frequency-selective channels (the
  pilot-interpolation branch, the D8PSK correction) and with the LMS and
  RLS equalizers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ria_tpu.dsp.hilbert import analytic_signal as j_analytic
from ria_tpu.wave import ofdm as J
from ria_tpu_torch.dsp.hilbert import analytic_signal
from ria_tpu_torch.wave import ofdm as T

torch.set_num_threads(1)

SCSYNC_FIELDS = T.SCSyncResult._fields
MODS = ["BPSK", "QPSK", "QAM16", "QAM32", "QAM64", "QAM256", "DBPSK", "DQPSK", "D8PSK"]


def _cfgs(**kw):
    return J.OFDMConfig(**kw), T.OFDMConfig(**kw)


@pytest.mark.parametrize("kw", [
    {}, {"use_pilots": True}, {"use_pilots": True, "pilot_spacing": 5},
    {"use_pilots": True, "pilot_spacing": 8, "modulation": "QAM64"},
    {"use_pilots": True, "pilot_spacing": 10}, {"num_carriers": 30, "fft_size": 512},
])
def test_layouts_and_sequences(kw):
    jc, tc = _cfgs(**kw)
    for a, b in zip(J.carrier_layout(jc), T.carrier_layout(tc)):
        assert np.array_equal(a, b)
    assert np.array_equal(J.pilot_sequence(jc), T.pilot_sequence(tc))
    assert np.array_equal(J.sync_sequence(jc), T.sync_sequence(tc))
    assert tc.num_data_carriers == jc.num_data_carriers
    assert tc.preamble_samples == jc.preamble_samples
    assert tc.num_symbols_for_bits(2592) == jc.num_symbols_for_bits(2592)


@pytest.mark.parametrize("mod", MODS)
def test_constellations(mod):
    assert np.array_equal(J.constellation_table(mod), T.constellation_table(mod))
    assert J.BITS_PER_SYMBOL[mod] == T.BITS_PER_SYMBOL[mod]
    assert J.CE_MARGIN[mod] == T.CE_MARGIN[mod]


@pytest.mark.parametrize("mod", MODS)
def test_tx_bit_equal(mod):
    jc, tc = _cfgs(modulation=mod, use_pilots=True, pilot_spacing=5)
    bits = np.random.default_rng(1).integers(0, 2, 1001)
    assert np.array_equal(J.tx_frame(bits, jc), T.tx_frame(bits, tc))
    assert np.array_equal(J.tx_frame(bits, jc, "lts", 3, 1.5), T.tx_frame(bits, tc, "lts", 3, 1.5))
    assert np.array_equal(J.modulate(bits, jc, 0.7, 33), T.modulate(bits, tc, 0.7, 33))
    assert np.array_equal(J.generate_preamble(jc, -2.0), T.generate_preamble(tc, -2.0))
    assert np.array_equal(J.generate_training(jc, 2, 1.0), T.generate_training(tc, 2, 1.0))


@pytest.mark.parametrize("n", [1000, 2240, 4096, 42720])
def test_analytic_signal(n):
    x = np.random.default_rng(n).normal(size=(2, n)).astype(np.float32)
    got = analytic_signal(torch.as_tensor(x)).numpy()
    want = np.asarray(j_analytic(jnp.asarray(x)))
    assert got.dtype == np.complex64 and got.shape == (2, n)
    assert np.allclose(got, want, rtol=0, atol=1e-5)


def _window(jc, preamble, snr_db, tx_cfo, seed, lead, length=32000, training=2, nbits=800):
    rng = np.random.default_rng(seed)
    tx = J.tx_frame(rng.integers(0, 2, nbits), jc, preamble, training, tx_cfo)
    audio = np.zeros(length, np.float32)
    audio[lead : lead + len(tx)] = tx
    rms = np.sqrt(np.mean(tx**2))
    return (audio + rng.normal(0, rms * 10 ** (-snr_db / 20), audio.shape)).astype(np.float32)


def _assert_sync_equal(got, want, fields):
    for f in ("detected", "lts_start") + (("repeats",) if "repeats" in fields else ()):
        assert np.array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f))), f
    assert np.allclose(got.cfo_hz.numpy(), np.asarray(want.cfo_hz), rtol=0, atol=1e-3)
    for f in fields:
        if f not in ("detected", "lts_start", "cfo_hz", "repeats"):
            assert np.allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                               rtol=0, atol=1e-5), f


@pytest.mark.parametrize("mod,snr,cfo,seed", [
    ("DQPSK", 15, 0.0, 0), ("DQPSK", 3, 12.5, 1), ("QAM64", 25, -7.0, 2),
    ("QAM16", 10, 30.0, 3), ("DBPSK", 0, -3.3, 4),
])
def test_schmidl_cox_search(mod, snr, cfo, seed):
    jc, tc = _cfgs(modulation=mod, use_pilots=mod.startswith("QAM"), pilot_spacing=8)
    rng = np.random.default_rng(seed)
    x = np.stack([_window(jc, "cox", snr, cfo, seed * 10 + i, int(rng.integers(0, 4000)))
                  for i in range(3)])
    want = J.schmidl_cox_search(jnp.asarray(x), jc)
    got = T.schmidl_cox_search(torch.as_tensor(x), tc)
    assert got.detected.all()
    _assert_sync_equal(got, want, SCSYNC_FIELDS)
    # The module, built once for the window, on a [1, 3, n] batch.
    det = T.SchmidlCoxDetector(tc, x.shape[-1], "cpu")
    again = det(torch.as_tensor(x)[None])
    assert again.lts_start.shape == (1, 3)
    assert torch.equal(again.lts_start[0], got.lts_start)


def test_schmidl_cox_noise_and_short_window():
    jc, tc = _cfgs()
    x = np.random.default_rng(7).normal(size=(2, 20000)).astype(np.float32)
    want = J.schmidl_cox_search(jnp.asarray(x), jc)
    got = T.schmidl_cox_search(torch.as_tensor(x), tc)
    _assert_sync_equal(got, want, SCSYNC_FIELDS)
    short = torch.zeros(2, tc.preamble_samples + 10)
    res = T.schmidl_cox_search(short, tc)
    assert not res.detected.any() and (res.lts_start == -1).all()


@pytest.mark.parametrize("training,snr,cfo,seed", [
    (2, 20, 0.0, 0), (2, 8, 6.0, 1), (3, 15, -4.0, 2), (2, 30, 15.0, 3),
])
def test_lts_search(training, snr, cfo, seed):
    jc, tc = _cfgs(modulation="QPSK", use_pilots=True, pilot_spacing=5)
    x = np.stack([_window(jc, "lts", snr, cfo, seed * 10 + i, 500 + 700 * i, training=training)
                  for i in range(2)])
    want = J.lts_search(jnp.asarray(x), jc)
    got = T.lts_search(torch.as_tensor(x), tc)
    assert got.detected.all()
    assert (got.repeats == training).all()
    _assert_sync_equal(got, want, T.LTSSyncResult._fields)


def test_lts_search_noise_threshold_and_short_window():
    jc, tc = _cfgs()
    x = np.random.default_rng(8).normal(size=(2, 9000)).astype(np.float32)
    for thr in (0.5, 0.05):
        want = J.lts_search(jnp.asarray(x), jc, thr)
        got = T.lts_search(torch.as_tensor(x), tc, thr)
        _assert_sync_equal(got, want, T.LTSSyncResult._fields)
    res = T.lts_search(torch.zeros(3, 2000), tc)
    assert not res.detected.any() and (res.repeats == 2).all()


@pytest.mark.parametrize("S", [1, 2, 9, 22, 33])
def test_affine_prefix(S):
    rng = np.random.default_rng(S)
    x = rng.uniform(0.1, 2.0, (3, S, 7)).astype(np.float32)
    init = rng.uniform(0.1, 2.0, (3, 7)).astype(np.float32)
    got = T._affine_prefix(torch.as_tensor(x), torch.as_tensor(init), 0.3).numpy()
    want = np.asarray(J._affine_prefix(jnp.asarray(x), jnp.asarray(init), 0.3))
    assert np.allclose(got, want, rtol=1e-5, atol=0)
    # Against the recurrence itself, in float64.
    s, seq = init.astype(np.float64), []
    for n in range(S):
        seq.append(s)
        s = 0.7 * s + 0.3 * x[:, n]
    assert np.allclose(got, np.stack(seq, axis=1), rtol=1e-5, atol=0)


def _demod_case(mod, pilots, snr_db, seed, multipath=False, rx_cfo_err=0.0, nbits=2592,
                **extra):
    """Frames of ``mod`` at the first LTS (a few samples early, inside the
    CP) with per-frame CFO, AWGN and optionally a 2-path channel (0.8 gain,
    30-sample echo: |H| varies ~0.2-1.8 across the band)."""
    jc, tc = _cfgs(modulation=mod, use_pilots=pilots, pilot_spacing=5, **extra)
    rng = np.random.default_rng(seed)
    S = jc.num_symbols_for_bits(nbits)
    need = (2 + S) * jc.symbol_samples
    frames, cfos = [], []
    for _ in range(2):
        cfo = float(rng.uniform(-5, 5))
        tx = J.tx_frame(rng.integers(0, 2, nbits), jc, tx_cfo_hz=cfo)
        if multipath:
            tx = tx + 0.8 * np.concatenate([np.zeros(30, np.float32), tx[:-30]])
        start = jc.preamble_samples - 2 * jc.symbol_samples - int(rng.integers(0, 20))
        x = tx[start : start + need]
        rms = np.sqrt(np.mean(x**2))
        frames.append(x + rng.normal(0, rms * 10 ** (-snr_db / 20), x.shape))
        cfos.append(cfo + rx_cfo_err)
    return (jc, tc, S, np.stack(frames).astype(np.float32), np.asarray(cfos, np.float32))


def _assert_demod_equal(jc, tc, S, x, cfo):
    want = J.demodulate_presynced(jnp.asarray(x), jnp.asarray(cfo), jc, S, 2)
    got = T.demodulate_presynced(torch.as_tensor(x), torch.as_tensor(cfo), tc, S, 2)
    a, b = np.asarray(want.soft_bits), got.soft_bits.numpy()
    assert a.shape == b.shape
    assert np.allclose(b, a, rtol=0, atol=2e-3)
    assert np.array_equal(np.sign(a), np.sign(b))
    for f in ("snr_db", "noise_var"):
        assert np.allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                           rtol=0, atol=1e-3), f
    for f in ("fading_index", "channel_mag", "symbols"):
        assert np.allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                           rtol=1e-4, atol=1e-4), f
    return want, got


@pytest.mark.parametrize("mod", MODS)
@pytest.mark.parametrize("pilots", [False, True])
def test_demodulate_presynced(mod, pilots):
    _assert_demod_equal(*_demod_case(mod, pilots, 18, MODS.index(mod)))


@pytest.mark.parametrize("mod", ["QAM16", "QAM64", "D8PSK", "DQPSK"])
def test_demodulate_presynced_selective(mod):
    """A frequency-selective channel: the coherent modes take the per-carrier
    pilot interpolation (CV of |H| > 0.15), D8PSK its two-pass correction
    (fading index > 0.30; a 1 Hz CFO error leaves it a phase error to fix)."""
    jc, tc, S, x, cfo = _demod_case(mod, True, 25, 11, multipath=True, rx_cfo_err=-1.0)
    want, _ = _assert_demod_equal(jc, tc, S, x, cfo)
    assert (np.asarray(want.fading_index) > 0.30).all()


@pytest.mark.parametrize("mod", ["QPSK", "QAM16", "QAM64"])
@pytest.mark.parametrize("rls", [False, True])
def test_demodulate_presynced_adaptive(mod, rls):
    _assert_demod_equal(*_demod_case(mod, True, 20, 5, multipath=True, adaptive_eq=True,
                                     adaptive_rls=rls))


def test_demodulate_from_bins_and_module_reuse():
    jc, tc, S, x, cfo = _demod_case("QAM16", True, 20, 3)
    _, data_bins, pilot_bins = J.carrier_layout(jc)
    rng = np.random.default_rng(0)
    shape = (2, 2 + S)
    Y = (rng.normal(size=shape + (59,)) + 1j * rng.normal(size=shape + (59,))).astype(np.complex64)
    want = jax.jit(lambda yd, yp: J.demodulate_from_bins(yd, yp, jc, S, 2))(
        jnp.asarray(Y[..., :len(data_bins)]), jnp.asarray(Y[..., len(data_bins):]))
    got = T.demodulate_from_bins(torch.as_tensor(Y[..., :len(data_bins)]),
                                 torch.as_tensor(Y[..., len(data_bins):]), tc, S, 2)
    assert np.allclose(got.soft_bits.numpy(), np.asarray(want.soft_bits), rtol=0, atol=2e-3)
    # One module serves every call of its geometry.
    dem = T.OFDMDemodulator(tc, S, 2, "cpu")
    ref = T.demodulate_presynced(torch.as_tensor(x), torch.as_tensor(cfo), tc, S, 2)
    assert torch.equal(dem(torch.as_tensor(x), torch.as_tensor(cfo)).soft_bits, ref.soft_bits)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
