"""``plain_v1``'s bf16 mode, K2's plain version in the TPU kernel's arithmetic,
against the JAX package.

``ria_tpu.fec.ldpc_pallas.make_pallas_decoder_v1`` rounds the factor, the
gathered LLRs and each check message entering its scatter to bfloat16;
``LDPCDecoder.plain_v1`` with ``precision="bf16"`` rounds at the same
places, and K2's bf16-operand build equals it bit for bit on the card
(tests/test_torch_ldpc_cuda.py).  Here, on the CPU, against the Pallas
interpreter:

- per-row factors off the bfloat16 grid (0.7, 0.8, 0.9, 0.6: the retry
  ladder's are all exact in bfloat16, so only these show the factor's
  rounding), with the tolerance of tests/test_torch_ldpc_v1.py
  (``BF16_INTERP_ATOL``, and why) and bit for bit once XLA:CPU's
  contraction of ``g - c2v`` is replayed;
- the mirror of the reference's ``test_fused_kernel_bit_equal_to_v1``
  (tests/test_ldpc_pallas.py:88-119: R1/2, ``default_rng(23)``, 16 rows,
  2 dB, 30 iterations, factor 0.75) on its own LLRs: the port's two bf16
  decoders (``plain``, K1's arithmetic, and ``plain_v1``, K2's) under the
  reference's contract (``success``, ``info_bits`` and ``iterations`` equal
  on every row, both row classes present, posteriors within 1e-2 on
  converged rows), and ``plain_v1`` bf16 under the same contract against
  the interpreted K2.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ria_tpu.fec.ldpc import make_encoder as jax_encoder
from ria_tpu.fec.ldpc_pallas import make_pallas_decoder_v1
from ria_tpu_torch.fec import ldpc_kernel
from ria_tpu_torch.fec.ldpc import LDPCDecoder, _bf16, ldpc_decoder
from ria_tpu_torch.fec.ldpc_matrix import get_code
from ria_tpu_torch.tools import ldpc_bench
from ria_tpu_torch.utils import cuda_kernels

from test_torch_ldpc import ITERS, _assert_matches, _awgn_llrs
from test_torch_ldpc_v1 import BF16_INTERP_ATOL, assert_xla_contraction_replays

torch.set_num_threads(1)

# (rate, seed, rows, SNR dB, per-row factors resized over the rows)
OFF_GRID = {
    "r14_m1db": ("R1_4", 5, 16, -1.0, (0.7, 0.8, 0.9, 0.6)),
    "r12_2db": ("R1_2", 3, 16, 2.0, (0.7, 0.8)),
}


def _mirror_llrs():
    """tests/test_ldpc_pallas.py:95-101, line for line."""
    rng = np.random.default_rng(23)
    info = rng.integers(0, 2, (16, get_code("R1_2").k)).astype(np.uint8)
    coded = np.asarray(jax_encoder("R1_2")(info)).astype(np.float64)
    sigma = 10 ** (-2.0 / 20)
    y = (1 - 2.0 * coded) + rng.normal(0, sigma, coded.shape)
    return (2 * y / sigma**2).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _reference(case):
    """(rate, llrs, factors, interpreted K2 result as numpy)."""
    if case == "mirror":
        rate, llr, fac = "R1_2", _mirror_llrs(), np.full(16, 0.75, np.float32)
    else:
        rate, seed, B, snr_db, facs = OFF_GRID[case]
        llr = _awgn_llrs(rate, seed, B, snr_db)
        fac = np.resize(np.asarray(facs, np.float32), B)
    k2 = make_pallas_decoder_v1(rate, tile=8, max_iters=ITERS, interpret=True)(
        jnp.asarray(llr), jnp.asarray(fac))
    return rate, llr, fac, tuple(np.asarray(x) for x in k2)


def _port(case, precision="bf16", method="plain_v1", fac=None):
    rate, llr, ref_fac, _ = _reference(case)
    dec = ldpc_decoder(rate, ITERS, "cpu", precision)
    fac = ref_fac if fac is None else fac
    return getattr(dec, method)(torch.as_tensor(llr), torch.as_tensor(fac))


@pytest.mark.parametrize("case", list(OFF_GRID))
def test_plain_v1_bf16_matches_k2_interpreter_off_grid(case):
    port = _port(case)
    _assert_matches(port, _reference(case)[3], BF16_INTERP_ATOL)
    assert port.success.any()
    rate, llr, fac, k2 = _reference(case)
    assert_xla_contraction_replays(ldpc_decoder(rate, ITERS, "cpu", "bf16"), llr, fac, k2)


@pytest.mark.parametrize("case", list(OFF_GRID))
def test_plain_v1_bf16_rounds_the_factor(case):
    """The bf16 mode takes bf16(factor): the rounded factors give the same
    bits, and in float32, where nothing rounds it, they do not."""
    _, _, fac, _ = _reference(case)
    rounded = _bf16(torch.as_tensor(fac)).numpy()
    assert not np.array_equal(rounded, fac)
    for a, b in zip(_port(case), _port(case, fac=rounded)):
        assert torch.equal(a, b)
    assert not torch.equal(_port(case, "f32").llr_total, _port(case, "f32", fac=rounded).llr_total)


def test_mirror_of_fused_kernel_bit_equal_to_v1():
    """The reference's contract between its two kernels, held between the
    port's bf16 ``plain`` (K1's arithmetic) and bf16 ``plain_v1`` (K2's),
    and between ``plain_v1`` bf16 and the interpreted K2."""
    k1, k2 = _port("mirror", method="plain"), _port("mirror")
    _, _, _, interp = _reference("mirror")
    ok = k2.success.numpy()
    assert ok.any() and not ok.all()  # both row classes
    for got, want in ((k1, k2), (k2, interp)):
        info, success, iters, llr = (np.asarray(x) for x in got)
        w_info, w_success, w_iters, w_llr = (np.asarray(x) for x in want)
        assert np.array_equal(success, w_success) and np.array_equal(success, ok)
        assert np.array_equal(info, w_info)
        assert np.array_equal(iters, w_iters)
        assert np.allclose(llr[ok], w_llr[ok], rtol=0, atol=1e-2)
    rate, llr, fac, interp = _reference("mirror")
    assert_xla_contraction_replays(ldpc_decoder(rate, ITERS, "cpu", "bf16"), llr, fac, interp)


def test_unknown_precision_raises():
    llr, fac = torch.zeros((1, 648)), torch.ones(1)
    with pytest.raises(ValueError, match="precision"):
        LDPCDecoder(get_code("R1_4"), ITERS, "cpu", "bfloat16")
    dec = ldpc_decoder("R1_4", ITERS, "cpu")
    # The kernel wrappers refuse the precision before they build anything.
    with pytest.raises(ValueError, match="precision"):
        ldpc_kernel.bp_decode_v1(llr, fac, dec.k2, dec.k, ITERS, "fp16")
    with pytest.raises(ValueError, match="precision"):
        ldpc_kernel.k2_resources(dec.n, dec.k2.slots, "fp16")
    with pytest.raises(SystemExit):
        ldpc_bench.run(["--device", "cpu", "--precision", "fp16"])


def test_k2_libraries_per_precision():
    """K2 has a library for each precision, each from a source of its own
    (the bf16 build a design of its own, csrc/ldpc_bp_v1_bf16.cu), as K1's
    has."""
    assert ldpc_kernel.K2_LIBRARY == {"f32": "ldpc_bp_v1", "bf16": "ldpc_bp_v1_bf16"}
    assert ldpc_kernel.K1_LIBRARY == {"f32": "ldpc_bp", "bf16": "ldpc_bp_bf16"}
    src, defines = cuda_kernels.LIBRARIES["ldpc_bp_v1_bf16"]
    f32_src, f32_defines = cuda_kernels.LIBRARIES["ldpc_bp_v1"]
    assert src.name == "ldpc_bp_v1_bf16.cu" and src.exists() and src != f32_src
    assert defines == f32_defines == ()
    f32 = cuda_kernels.library_path(f32_src)
    bf16 = cuda_kernels.library_path(src, defines)
    assert bf16 != f32 and bf16.name.startswith("ldpc_bp_v1_bf16_") and bf16.parent == f32.parent
    assert bf16 != cuda_kernels.library_path(cuda_kernels.LIBRARIES["ldpc_bp_bf16"][0])
