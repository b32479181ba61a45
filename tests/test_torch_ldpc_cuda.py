"""Kernels K1 and K2 on the card against their plain PyTorch versions (needs a GPU).

Imports no JAX, so it runs on a GPU host that has none:

    python -m pytest -q -m cuda tests/test_torch_ldpc_cuda.py

Without a card every test skips.  Tolerances: ``success`` on every row, and
``iterations`` and ``info_bits`` on converged rows, exactly equal;
``llr_total`` on converged rows within 1e-3 (the kernels sum a variable's
messages in another order than the plain decoders' matmuls, and in another
order than each other).  The plain decoders themselves are held against the
JAX reference by tests/test_torch_ldpc.py and tests/test_torch_ldpc_v1.py,
the serving layer by tests/test_torch_ldpc_serving.py.
"""

import numpy as np
import pytest
import torch

from ria_tpu_torch.fec import ldpc as T
from ria_tpu_torch.fec import ldpc_kernel
from ria_tpu_torch.fec.ldpc import decode_batch, ldpc_decoder
from ria_tpu_torch.fec.ldpc_cuda import make_cuda_decoder, make_cuda_decoder_v1
from ria_tpu_torch.fec.ldpc_matrix import CODE_PARAMS, encode_np, get_code

torch.set_num_threads(1)

LADDER = np.asarray([0.9375, 0.875, 0.75, 0.625, 0.5], np.float32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 and K2 are CUDA C++ and have no CPU mode")
    return torch.device("cuda", 0)


def _llrs(rate, B, sigma, seed):
    rng = np.random.default_rng(seed)
    info = rng.integers(0, 2, (B, get_code(rate).k))
    llr = (1.0 - 2.0 * encode_np(info, rate).astype(np.float32)) * 4.0
    return llr + rng.normal(0, sigma, llr.shape).astype(np.float32)


def _bpsk_llrs(rate, seed, B, sigma):
    """BPSK over AWGN, LLR = 2y/sigma^2 (tests/test_torch_ldpc_serving.py)."""
    rng = np.random.default_rng(seed)
    info = rng.integers(0, 2, (B, get_code(rate).k)).astype(np.uint8)
    y = (1 - 2.0 * encode_np(info, rate).astype(np.float64)) + rng.normal(0, sigma, (B, 648))
    return (2 * y / sigma**2).astype(np.float32)


def _assert_matches(got, ref):
    got = [t.cpu() for t in got]
    ref = [t.cpu() for t in ref]
    assert torch.equal(got[1], ref[1])
    ok = got[1] & ref[1]
    assert torch.equal(got[2][ok], ref[2][ok])
    assert torch.equal(got[0][ok], ref[0][ok])
    assert torch.allclose(got[3][ok], ref[3][ok], rtol=0, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", list(CODE_PARAMS))
@pytest.mark.parametrize("sigma", [1.0, 2.0, 3.0])
def test_kernel_matches_plain(rate, sigma, cuda_device):
    llr = _llrs(rate, 64, sigma, seed=7)
    fac = np.resize(LADDER, 64)
    dec = ldpc_decoder(rate, 30, cuda_device)
    x, f = torch.as_tensor(llr, device=cuda_device), torch.as_tensor(fac, device=cuda_device)
    before = ldpc_kernel.LAUNCHES
    got = dec(x, f)
    torch.cuda.synchronize()
    assert ldpc_kernel.LAUNCHES == before + 1
    _assert_matches(got, dec.plain(x, f))
    # The plain decoder on the CPU, the one the JAX reference holds.
    cpu = ldpc_decoder(rate, 30, "cpu")
    _assert_matches(got, cpu.plain(torch.as_tensor(llr), torch.as_tensor(fac)))


@pytest.mark.cuda
def test_zero_rows_and_zero_iterations(cuda_device):
    x = torch.zeros((3, 648), device=cuda_device)
    f = torch.full((3,), 0.75, device=cuda_device)
    r = ldpc_decoder("R1_4", 50, cuda_device)(x, f)
    assert r.success.all() and (r.iterations == 1).all()
    r0 = ldpc_decoder("R1_4", 0, cuda_device)(x + 1.0, f)
    assert not r0.success.any() and (r0.iterations == 0).all()
    assert torch.equal(r0.llr_total, x + 1.0)


@pytest.mark.cuda
def test_decode_batch_launches_kernel(cuda_device):
    llr = torch.as_tensor(_llrs("R1_2", 5, 1.0, seed=3), device=cuda_device)
    before = ldpc_kernel.LAUNCHES
    r = decode_batch(llr, torch.full((5,), 0.75, device=cuda_device), "R1_2")
    assert ldpc_kernel.LAUNCHES == before + 1
    assert r.info_bits.shape == (5, 324) and r.success.device.type == "cuda"


@pytest.mark.cuda
def test_wrapper_rejects_bad_input(cuda_device):
    dec = ldpc_decoder("R1_2", 30, cuda_device)
    x = torch.zeros((4, 648), device=cuda_device)
    f = torch.full((4,), 0.75, device=cuda_device)
    args = (dec.row_idx, dec.row_mask, dec.col_ptr, dec.col_edge, dec.k, 30)
    with pytest.raises(TypeError):
        ldpc_kernel.bp_decode(x.double(), f, *args)
    with pytest.raises(ValueError):
        ldpc_kernel.bp_decode(x[:, :600], f, *args)
    with pytest.raises(ValueError):
        ldpc_kernel.bp_decode(x.t().contiguous().t(), f, *args)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", list(CODE_PARAMS))
@pytest.mark.parametrize("sigma", [1.0, 2.0, 3.0])
def test_k2_matches_plain_v1_and_k1(rate, sigma, cuda_device):
    llr = _llrs(rate, 64, sigma, seed=7)
    x = torch.as_tensor(llr, device=cuda_device)
    f = torch.as_tensor(np.resize(LADDER, 64), device=cuda_device)
    before = ldpc_kernel.LAUNCHES_V1
    got = make_cuda_decoder_v1(rate, 30, device=cuda_device)(x, f)
    torch.cuda.synchronize()
    assert ldpc_kernel.LAUNCHES_V1 == before + 1
    dec = ldpc_decoder(rate, 30, cuda_device)
    _assert_matches(got, dec.plain_v1(x, f))
    _assert_matches(got, make_cuda_decoder(rate, 30, device=cuda_device)(x, f))


@pytest.mark.cuda
def test_k2_zero_rows_zero_iterations_and_default_factor(cuda_device):
    x = torch.zeros((3, 648), device=cuda_device)
    r = make_cuda_decoder_v1("R1_4", 50, device=cuda_device)(x)
    assert r.success.all() and (r.iterations == 1).all()
    r0 = make_cuda_decoder_v1("R1_4", 0, device=cuda_device)(x + 1.0)
    assert not r0.success.any() and (r0.iterations == 0).all()
    assert torch.equal(r0.llr_total, x + 1.0)
    llr = torch.as_tensor(_llrs("R3_4", 8, 2.0, seed=5), device=cuda_device)
    got = make_cuda_decoder_v1("R3_4", 30, 0.625, device=cuda_device)(llr)
    want = ldpc_decoder("R3_4", 30, cuda_device).plain_v1(
        llr, torch.full((8,), 0.625, device=cuda_device))
    _assert_matches(got, want)


@pytest.mark.cuda
def test_k2_wrapper_rejects_bad_input(cuda_device):
    dec = ldpc_decoder("R1_2", 30, cuda_device)
    x = torch.zeros((4, 648), device=cuda_device)
    f = torch.full((4,), 0.75, device=cuda_device)
    args = (dec.row_idx, dec.row_mask, dec.slot_ptr, dec.slot_chk, dec.k, 30)
    with pytest.raises(TypeError):
        ldpc_kernel.bp_decode_v1(x.double(), f, *args)
    with pytest.raises(ValueError):
        ldpc_kernel.bp_decode_v1(x[:, :600], f, *args)
    with pytest.raises(ValueError):
        ldpc_kernel.bp_decode_v1(x.t().contiguous().t(), f, *args)
    with pytest.raises(ValueError):
        ldpc_kernel.bp_decode_v1(x, f, dec.row_idx, dec.row_mask, dec.col_ptr,
                                 dec.slot_chk, dec.k, 30)
    with pytest.raises(ValueError):
        ldpc_kernel.bp_decode_v1(x.cpu(), f.cpu(), *(t.cpu() for t in args[:4]), dec.k, 30)


@pytest.mark.cuda
def test_decode_with_retries_on_card(cuda_device):
    """The R1/2 ladder case of tests/test_torch_ldpc_serving.py: at most two
    K1 launches, and the result of the CPU port."""
    llr = _bpsk_llrs("R1_2", 5, 4, 10 ** (1.2 / 20))
    before = ldpc_kernel.LAUNCHES
    got = T.decode_with_retries(llr, "R1_2", device=cuda_device)
    torch.cuda.synchronize()
    assert ldpc_kernel.LAUNCHES - before == 2
    assert got.success.device.type == "cuda"
    _assert_matches(got, T.decode_with_retries(llr, "R1_2"))


@pytest.mark.cuda
def test_codec_and_candidates_on_card(cuda_device):
    for rate in CODE_PARAMS:
        codec = T.LDPCCodec(rate, device=cuda_device)
        data = bytes(range(40))
        before = ldpc_kernel.LAUNCHES
        ok, decoded = codec.decode_hard(codec.encode(data))
        assert ldpc_kernel.LAUNCHES == before + 1
        assert ok and decoded[: len(data)] == data
    llr = _bpsk_llrs("R1_4", 6, 4, 10 ** (-1.0 / 20))
    got = T.decode_candidates(llr, "R1_4", device=cuda_device)
    want = T.decode_candidates(llr, "R1_4")
    assert [len(c) for c in got] == [len(c) for c in want] and any(want)
    for cands, r_cands in zip(got, want):
        for (m, bits), (r_m, r_bits) in zip(cands, r_cands):
            assert np.array_equal(bits, r_bits) and abs(m - r_m) <= 1e-3
