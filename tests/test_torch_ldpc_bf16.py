"""The decoder's ``precision="bf16"`` against the JAX package.

``ria_tpu.fec.ldpc.make_decoder_vf(rate, iters, "bf16")`` rounds the operands
of its gather and scatter matmuls to bfloat16 and accumulates in float32;
the TPU kernel ``make_pallas_decoder`` does the same.  The port's plain
decoder rounds at the same three places (the channel LLRs at the first
gather, the posteriors at each gather, each check message before the
variable sum), and K1 has a build that does too (held to the plain decoder
bit for bit on the card by tests/test_torch_ldpc_cuda.py).

Cases: every rate of ``CODE_PARAMS`` (the reference has no R1_3 code), one
clean batch and one near the decoding threshold (both row classes), with the
per-row factor ladder of tests/test_ldpc_pallas.py.  Tolerances, against
both the reference's bf16 decoder and the Pallas interpreter: ``success``
equal on every row; ``iterations`` and ``info_bits`` equal on converged rows;
``llr_total`` within 1e-2 there (a sum of bfloat16 values, 8 significant
bits, in float32 is mostly exact in any order, so these cases agree to 0;
the bound leaves room for a sum that rounds).  ``"f32"``, the default, stays
bit for bit the decoder it was.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ria_tpu.fec.ldpc import make_decoder_vf as jax_decoder_vf
from ria_tpu.fec.ldpc_pallas import make_pallas_decoder
from ria_tpu_torch.fec import ldpc_kernel
from ria_tpu_torch.fec.ldpc import (
    LDPCDecoder,
    _bf16,
    ldpc_decoder,
    make_decoder,
    make_decoder_vf,
)
from ria_tpu_torch.fec.ldpc_matrix import CODE_PARAMS, LLR_CLAMP, get_code

from test_torch_ldpc import LADDER, _assert_matches, _awgn_llrs, _clean_llrs

torch.set_num_threads(1)

ITERS = 30
# Per rate, an SNR (dB) at which a 16-row batch of seed 3 has rows that
# converge and rows that run all 30 iterations.
NEAR_THRESHOLD_DB = {"R1_4": 0.0, "R1_2": 2.0, "R2_3": 4.0, "R3_4": 4.0, "R5_6": 4.0}
CASES = [(rate, kind) for rate in CODE_PARAMS for kind in ("clean", "near")]


def _llrs(rate, kind):
    if kind == "clean":
        return _clean_llrs(rate, 7, 8)
    return _awgn_llrs(rate, 3, 16, NEAR_THRESHOLD_DB[rate])


@functools.lru_cache(maxsize=None)
def _reference(rate, kind):
    """(llrs, factors, bf16 vf result, Pallas-interpreter result) as numpy."""
    llr = _llrs(rate, kind)
    fac = np.resize(LADDER, llr.shape[0])
    vf = jax_decoder_vf(rate, ITERS, "bf16")(jnp.asarray(llr), jnp.asarray(fac))
    pal = make_pallas_decoder(rate, tile=8, max_iters=ITERS, interpret=True)(
        jnp.asarray(llr), jnp.asarray(fac))
    as_np = lambda r: tuple(np.asarray(x) for x in r)  # noqa: E731
    return llr, fac, as_np(vf), as_np(pal)


def _port(rate, llr, fac, precision="bf16"):
    return make_decoder_vf(rate, ITERS, precision, device="cpu")(torch.as_tensor(llr),
                                                                  torch.as_tensor(fac))


@pytest.mark.parametrize("rate,kind", CASES)
def test_bf16_plain_decoder_matches_jax_vf(rate, kind):
    llr, fac, vf, _ = _reference(rate, kind)
    port = _port(rate, llr, fac)
    _assert_matches(port, vf, 1e-2)
    if kind == "clean":
        assert port.success.all()
    else:
        assert port.success.any() and not port.success.all()


@pytest.mark.parametrize("rate,kind", CASES)
def test_bf16_plain_decoder_matches_pallas_interpreter(rate, kind):
    llr, fac, _, pal = _reference(rate, kind)
    _assert_matches(_port(rate, llr, fac), pal, 1e-2)


def test_bf16_takes_one_more_iteration_on_row_14():
    """Row 14 of ``_awgn_llrs("R1_4", 3, 16, -1.0)`` (factor 0.875) converges
    at iteration 12 in float32 and at 13 with bfloat16 operands, in both
    packages and in the Pallas interpreter; every other row's outcome and
    iteration count is the same in both precisions."""
    llr = _awgn_llrs("R1_4", 3, 16, -1.0)
    fac = np.resize(LADDER, 16)
    iters = {}
    for prec in ("f32", "bf16"):
        ref = jax_decoder_vf("R1_4", ITERS, prec)(jnp.asarray(llr), jnp.asarray(fac))
        port = _port("R1_4", llr, fac, prec)
        assert np.array_equal(port.success.numpy(), np.asarray(ref.success))
        assert np.array_equal(port.iterations.numpy(), np.asarray(ref.iterations))
        iters[prec] = port.iterations.numpy()
    pal = make_pallas_decoder("R1_4", tile=8, max_iters=ITERS, interpret=True)(
        jnp.asarray(llr), jnp.asarray(fac))
    assert np.array_equal(np.asarray(pal.iterations), iters["bf16"])
    assert (iters["f32"][14], iters["bf16"][14]) == (12, 13)
    others = np.arange(16) != 14
    assert np.array_equal(iters["f32"][others], iters["bf16"][others])


def _parent_plain(dec, llrs, factors):
    """The plain decoder as it was before ``precision`` existed, line for
    line: float32 throughout, parity from the gathered posteriors."""
    B = llrs.shape[0]
    m, D, g = dec.m, dec.D, dec.gather
    llr_in, factors = llrs.float(), factors.float()
    v2c = (llr_in @ g.T).reshape(B, m, D)
    llr_total = llr_in
    done = torch.zeros(B, dtype=torch.bool)
    iters = torch.zeros(B, dtype=torch.int32)
    it = 0
    while it < dec.max_iters and not bool(done.all()):
        c2v = dec._check_update(v2c, factors)
        llr_new = llr_in + dec._variable_sum(c2v)
        edge = (llr_new @ g.T).reshape(B, m, D)
        v2c_new = torch.clamp(edge - c2v, -LLR_CLAMP, LLR_CLAMP)
        edge_bits = torch.where(dec.row_mask, (edge < 0).float(), 0.0)
        ok = torch.all(torch.sum(edge_bits, dim=-1) % 2.0 == 0.0, dim=-1)
        upd = ~done
        llr_total = torch.where(upd[:, None], llr_new, llr_total)
        v2c = torch.where(upd[:, None, None], v2c_new, v2c)
        iters = iters + upd.int()
        done = done | ok
        it += 1
    return (llr_total[:, : dec.k] < 0).to(torch.uint8), done, iters, llr_total


@pytest.mark.parametrize("rate", list(CODE_PARAMS))
def test_f32_is_the_parent_decoder_bit_for_bit(rate):
    """``"f32"`` and the default precision give every output of every row
    (converged or not) exactly as the parent's plain decoder did."""
    llr = torch.as_tensor(_awgn_llrs(rate, 3, 16, NEAR_THRESHOLD_DB[rate]))
    fac = torch.as_tensor(np.resize(LADDER, 16))
    want = _parent_plain(ldpc_decoder(rate, ITERS, "cpu"), llr, fac)
    for got in (make_decoder_vf(rate, ITERS, "f32", device="cpu")(llr, fac),
                make_decoder_vf(rate, ITERS, device="cpu")(llr, fac)):
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_make_decoder_takes_precision():
    """``make_decoder(rate, iters, factor, precision)`` in the reference's
    order: the bf16 plain decoder at one factor for every row."""
    llr = torch.as_tensor(_awgn_llrs("R1_2", 11, 8, 1.5))
    got = make_decoder("R1_2", ITERS, 0.75, "bf16", device="cpu")(llr)
    want = make_decoder_vf("R1_2", ITERS, "bf16", device="cpu")(llr, torch.full((8,), 0.75))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_unknown_precision_raises():
    llr = torch.zeros((1, 648))
    with pytest.raises(ValueError, match="precision"):
        make_decoder_vf("R1_2", ITERS, "fp16", device="cpu")
    with pytest.raises(ValueError, match="precision"):
        make_decoder("R1_2", ITERS, 0.75, "f16", device="cpu")
    with pytest.raises(ValueError, match="precision"):
        LDPCDecoder(get_code("R1_2"), ITERS, "cpu", "bfloat16")
    dec = ldpc_decoder("R1_2", ITERS, "cpu")
    # The kernel wrapper refuses the precision before it builds anything.
    with pytest.raises(ValueError, match="precision"):
        ldpc_kernel.bp_decode(llr, torch.ones(1), dec.k1, dec.k, ITERS, "fp16")


def test_bf16_rounding_is_jax_astype():
    """``_bf16`` rounds as ``astype(jnp.bfloat16)``: to nearest, ties to
    even, on random values, exact ties, subnormals and the clamp bound."""
    rng = np.random.default_rng(5)
    x = np.concatenate([
        rng.normal(0, 20, 4096),
        rng.normal(0, 1e-3, 1024),
        np.float32(1.0) + np.arange(-8, 9) * np.float32(2.0 ** -8),  # ties at 2^-8 steps
        [LLR_CLAMP, -LLR_CLAMP, 2.0 ** -134, -(2.0 ** -133), 3.0 * 2.0 ** -135, 0.0],
    ]).astype(np.float32)
    want = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    got = _bf16(torch.as_tensor(x)).numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
