"""LDPC decoders of the PyTorch port against the JAX package.

The port's plain decoder is held against ``ria_tpu.fec.ldpc.make_decoder_vf``
(f32) and against kernel K1's TPU original, ``make_pallas_decoder``, run by
the Pallas interpreter as the JAX package's own tests run it.  The seeds and
SNRs are those of tests/test_ldpc_pallas.py.  Tolerances: ``success`` on
every row, and ``iterations`` and ``info_bits`` on converged rows, exactly
equal; ``llr_total`` on converged rows within 1e-3 of the f32 reference (the
scatter sums the same messages in another order).  Against the interpreter
the posteriors' hard decisions must be equal and their values within 0.5:
the TPU kernel rounds every gathered LLR and every check message to bf16
(8 significant bits, unit roundoff 2^-9) before its one-hot dots, and a
posterior sums up to 13 messages of magnitude <= 37.5, so one iteration's
rounding alone can move it by up to 13 * 37.5 * 2^-9 = 0.95 (0.26 is the
largest deviation these cases show).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ria_tpu.fec.ldpc import make_decoder_vf as jax_decoder_vf
from ria_tpu.fec.ldpc import make_encoder as jax_encoder
from ria_tpu.fec.ldpc_pallas import make_pallas_decoder
from ria_tpu_torch.fec import ldpc_kernel
from ria_tpu_torch.fec.ldpc import decode_batch, ldpc_decoder, make_decoder, make_decoder_vf
from ria_tpu_torch.fec.ldpc import make_encoder
from ria_tpu_torch.fec.ldpc_matrix import CODE_PARAMS, encode_np, get_code

torch.set_num_threads(1)

ITERS = 30
LADDER = np.asarray([0.9375, 0.875, 0.75, 0.625, 0.5, 0.75, 0.875, 0.9375], np.float32)


def _awgn_llrs(rate, seed, B, snr_db):
    """BPSK over AWGN, LLR = 2y/sigma^2 (tests/test_ldpc_pallas.py)."""
    rng = np.random.default_rng(seed)
    info = rng.integers(0, 2, (B, get_code(rate).k))
    coded = encode_np(info, rate).astype(np.float64)
    sigma = 10 ** (-snr_db / 20)
    y = (1 - 2.0 * coded) + rng.normal(0, sigma, coded.shape)
    return (2 * y / sigma**2).astype(np.float32)


def _clean_llrs(rate, seed, B):
    rng = np.random.default_rng(seed)
    info = rng.integers(0, 2, (B, get_code(rate).k))
    return ((1 - 2.0 * encode_np(info, rate)) * 8.0).astype(np.float32)


def _mixed_llrs(rate, seed, B):
    """bench.py's LDPC batch: amplitude-4 LLRs, half the rows near the floor."""
    rng = np.random.default_rng(seed)
    info = rng.integers(0, 2, (B, get_code(rate).k))
    llr = (1.0 - 2.0 * encode_np(info, rate).astype(np.float32)) * 4.0
    noise = rng.normal(0, 1.0, llr.shape).astype(np.float32)
    noise[B // 2 :] = rng.normal(0, 2.6, (B - B // 2, llr.shape[1])).astype(np.float32)
    return llr + noise


CASES = {
    "clean_s7": ("R1_2", lambda: _clean_llrs("R1_2", 7, 8)),
    "noisy_s3": ("R1_2", lambda: _awgn_llrs("R1_2", 3, 16, 2.0)),
    "noisy_s11": ("R1_2", lambda: _awgn_llrs("R1_2", 11, 8, 1.5)),
    "noisy_s23": ("R1_2", lambda: _awgn_llrs("R1_2", 23, 16, 2.0)),
    "mixed_r14": ("R1_4", lambda: _mixed_llrs("R1_4", 5, 16)),
}


def _factors(B):
    return np.resize(LADDER, B)


@functools.lru_cache(maxsize=None)
def _reference(case):
    """(llrs, factors, f32 vf result, Pallas-interpreter result) as numpy."""
    rate, make = CASES[case]
    llr = make()
    fac = _factors(llr.shape[0])
    vf = jax_decoder_vf(rate, ITERS)(jnp.asarray(llr), jnp.asarray(fac))
    pal = make_pallas_decoder(rate, tile=8, max_iters=ITERS, interpret=True)(
        jnp.asarray(llr), jnp.asarray(fac))
    as_np = lambda r: tuple(np.asarray(x) for x in r)  # noqa: E731
    return llr, fac, as_np(vf), as_np(pal)


def _assert_matches(port, ref, llr_atol):
    info, success, iters, llr_total = (x.numpy() for x in port)
    r_info, r_success, r_iters, r_llr = ref
    assert np.array_equal(success, r_success)
    ok = success & r_success
    assert np.array_equal(iters[ok], r_iters[ok])
    assert np.array_equal(info[ok], r_info[ok])
    assert np.array_equal(llr_total[ok] < 0, r_llr[ok] < 0)
    assert np.allclose(llr_total[ok], r_llr[ok], rtol=0, atol=llr_atol)
    assert info.dtype == np.uint8 and iters.dtype == np.int32 and success.dtype == bool


@pytest.mark.parametrize("case", list(CASES))
def test_plain_decoder_matches_jax_vf(case):
    rate, _ = CASES[case]
    llr, fac, vf, _ = _reference(case)
    port = make_decoder_vf(rate, ITERS, "cpu")(torch.as_tensor(llr), torch.as_tensor(fac))
    _assert_matches(port, vf, 1e-3)
    assert port.success.any()


@pytest.mark.parametrize("case", list(CASES))
def test_plain_decoder_matches_pallas_interpreter(case):
    rate, _ = CASES[case]
    llr, fac, _, pal = _reference(case)
    port = make_decoder_vf(rate, ITERS, "cpu")(torch.as_tensor(llr), torch.as_tensor(fac))
    _assert_matches(port, pal, 0.5)


def test_noisy_cases_exercise_both_row_classes():
    _, _, vf, _ = _reference("noisy_s23")
    ok = vf[1]
    assert ok.any() and not ok.all()


def test_decode_batch_on_cpu_is_the_plain_decoder():
    llr, fac, _, _ = _reference("noisy_s3")
    got = decode_batch(torch.as_tensor(llr), torch.as_tensor(fac), "R1_2", ITERS, "cpu")
    want = make_decoder_vf("R1_2", ITERS, "cpu")(torch.as_tensor(llr), torch.as_tensor(fac))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_make_decoder_fixed_factor_and_zero_rows():
    """All-zero rows converge at iteration 1 (no check before the first
    update), as in the reference; the fixed-factor decoder equals the
    per-row one at that factor."""
    llr = _awgn_llrs("R1_4", 2, 6, 0.0)
    llr[0] = 0.0
    got = make_decoder("R1_4", ITERS, 0.75, "cpu")(torch.as_tensor(llr))
    want = make_decoder_vf("R1_4", ITERS, "cpu")(torch.as_tensor(llr), torch.full((6,), 0.75))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert bool(got.success[0]) and int(got.iterations[0]) == 1
    ref = jax_decoder_vf("R1_4", ITERS)(jnp.asarray(llr), jnp.full((6,), 0.75, jnp.float32))
    assert np.array_equal(got.success.numpy(), np.asarray(ref.success))


@pytest.mark.parametrize("rate", ["R3_4", "R5_6"])
def test_edgeless_variables_keep_channel_llr(rate):
    llr = _awgn_llrs(rate, 4, 4, 3.0)
    res = make_decoder_vf(rate, ITERS, "cpu")(torch.as_tensor(llr), torch.full((4,), 0.75))
    code = get_code(rate)
    free = ~code.gather.any(axis=0)
    assert np.array_equal(res.llr_total.numpy()[:, free], llr[:, free])


@pytest.mark.parametrize("rate", list(CODE_PARAMS))
def test_encoder_bit_exact(rate):
    rng = np.random.default_rng(17)
    info = rng.integers(0, 2, (9, get_code(rate).k)).astype(np.uint8)
    got = make_encoder(rate, "cpu")(torch.as_tensor(info)).numpy()
    want = np.asarray(jax_encoder(rate)(jnp.asarray(info)))
    assert got.dtype == np.uint8
    assert np.array_equal(got, want)


def test_kernel_wrapper_takes_no_cpu_tensor():
    """bp_decode launches K1 or raises: it never runs a CPU tensor."""
    dec = ldpc_decoder("R1_2", ITERS, "cpu")
    llr = torch.zeros((2, 648))
    with pytest.raises(ValueError):
        ldpc_kernel.bp_decode(llr, torch.full((2,), 0.75), dec.k1, dec.k, ITERS)


def test_library_name_tracks_source(tmp_path, monkeypatch):
    path = ldpc_kernel.library_path()
    assert path.parent == ldpc_kernel.BUILD_DIR and path.suffix == ".so"
    edited = tmp_path / "ldpc_bp.cu"
    edited.write_bytes(ldpc_kernel._SOURCE.read_bytes() + b"\n// edit\n")
    monkeypatch.setattr(ldpc_kernel, "_SOURCE", edited)
    assert ldpc_kernel.library_path() != path
