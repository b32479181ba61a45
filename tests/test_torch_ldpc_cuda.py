"""Kernels K1 and K2 on the card against their plain PyTorch versions (needs a GPU).

Imports no JAX, so it runs on a GPU host that has none:

    python -m pytest -q -m cuda tests/test_torch_ldpc_cuda.py

Without a card every test skips.  Each kernel and its plain version sum in
the same order, so they are held equal bit for bit on every row, the rows
that never converge included: K1 and ``plain``
(``test_k1_equals_plain_bit_for_bit``), K2 and ``plain_v1``
(``test_k2_matches_plain_v1_and_k1``), and each bf16-operand build and its
plain version's ``precision="bf16"``.  K1 against K2 (they group their
sums differently) and the serving layer against the CPU port keep the
tolerances: ``success`` on every row, and ``iterations`` and ``info_bits``
on converged rows, exactly equal; ``llr_total`` on converged rows within
1e-3.  The plain decoders themselves are held against the JAX reference by
tests/test_torch_ldpc.py, tests/test_torch_ldpc_v1.py,
tests/test_torch_ldpc_bf16.py and tests/test_torch_ldpc_v1_bf16.py, the
serving layer by tests/test_torch_ldpc_serving.py.
"""

import numpy as np
import pytest
import torch

from ria_tpu_torch.fec import ldpc as T
from ria_tpu_torch.fec import ldpc_kernel
from ria_tpu_torch.fec.ldpc import decode_batch, ldpc_decoder
from ria_tpu_torch.fec.ldpc_cuda import make_cuda_decoder, make_cuda_decoder_v1
from ria_tpu_torch.fec.ldpc_matrix import CODE_PARAMS, encode_np, get_code
from ria_tpu_torch.tools import ldpc_bench

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


def _assert_equal(*results):
    """Every output of every row equal across ``results`` (on any device)."""
    first = [t.cpu() for t in results[0]]
    for other in results[1:]:
        for a, b in zip(first, other):
            assert torch.equal(a, b.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("rate", list(CODE_PARAMS))
def test_k1_equals_plain_bit_for_bit(rate, cuda_device):
    """K1 and the plain decoder on the card, and the plain decoder on the
    CPU, near the decoding threshold (at every rate some rows converge and
    some run all 80 iterations): every output of every row equal."""
    llr = _llrs(rate, 136, 3.0, seed=11)
    fac = np.resize(LADDER, 136)
    x, f = torch.as_tensor(llr, device=cuda_device), torch.as_tensor(fac, device=cuda_device)
    dec = ldpc_decoder(rate, 80, cuda_device)
    got, plain = dec(x, f), dec.plain(x, f)
    cpu = ldpc_decoder(rate, 80, "cpu").plain(x.cpu(), f.cpu())
    for a, b, c in zip(got, plain, cpu):
        assert torch.equal(a.cpu(), b.cpu()) and torch.equal(b.cpu(), c)
    assert (~got.success).any() and got.success.any()


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
    args = (dec.k1, dec.k, 30)
    with pytest.raises(TypeError):
        ldpc_kernel.bp_decode(x.double(), f, *args)
    with pytest.raises(ValueError):
        ldpc_kernel.bp_decode(x[:, :600], f, *args)
    with pytest.raises(ValueError):
        ldpc_kernel.bp_decode(x.t().contiguous().t(), f, *args)
    with pytest.raises(ValueError):
        ldpc_kernel.bp_decode(x, f[:3], *args)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", list(CODE_PARAMS))
@pytest.mark.parametrize("sigma", [1.0, 2.0, 3.0])
def test_k2_matches_plain_v1_and_k1(rate, sigma, cuda_device):
    """K2 equals ``plain_v1`` on the card and on the CPU, every output of
    every row (both sum in K2's order); against K1, which groups its sums
    otherwise, the tolerances of ``_assert_matches``."""
    llr = _llrs(rate, 64, sigma, seed=7)
    x = torch.as_tensor(llr, device=cuda_device)
    f = torch.as_tensor(np.resize(LADDER, 64), device=cuda_device)
    before = ldpc_kernel.LAUNCHES_V1
    got = make_cuda_decoder_v1(rate, 30, device=cuda_device)(x, f)
    torch.cuda.synchronize()
    assert ldpc_kernel.LAUNCHES_V1 == before + 1
    dec = ldpc_decoder(rate, 30, cuda_device)
    _assert_equal(got, dec.plain_v1(x, f), ldpc_decoder(rate, 30, "cpu").plain_v1(x.cpu(), f.cpu()))
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
    _assert_equal(got, want)


@pytest.mark.cuda
def test_k2_wrapper_rejects_bad_input(cuda_device):
    dec = ldpc_decoder("R1_2", 30, cuda_device)
    x = torch.zeros((4, 648), device=cuda_device)
    f = torch.full((4,), 0.75, device=cuda_device)
    args = (dec.k2, dec.k, 30)
    with pytest.raises(TypeError):
        ldpc_kernel.bp_decode_v1(x.double(), f, *args)
    with pytest.raises(ValueError):
        ldpc_kernel.bp_decode_v1(x[:, :600], f, *args)
    with pytest.raises(ValueError):
        ldpc_kernel.bp_decode_v1(x.t().contiguous().t(), f, *args)
    with pytest.raises(ValueError):
        ldpc_kernel.bp_decode_v1(x, f[:3], *args)
    with pytest.raises(ValueError):
        ldpc_kernel.bp_decode_v1(x.cpu(), f.cpu(), *args)


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
    _assert_matches(got, T.decode_with_retries(llr, "R1_2", device="cpu"))


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
    want = T.decode_candidates(llr, "R1_4", device="cpu")
    assert [len(c) for c in got] == [len(c) for c in want] and any(want)
    for cands, r_cands in zip(got, want):
        for (m, bits), (r_m, r_bits) in zip(cands, r_cands):
            assert np.array_equal(bits, r_bits) and abs(m - r_m) <= 1e-3


def _k1_vs_plain(dec, x, f):
    before = ldpc_kernel.LAUNCHES
    got = dec(x, f)
    torch.cuda.synchronize()
    assert ldpc_kernel.LAUNCHES == before + 1
    want = dec.plain(x, f)
    _assert_matches(got, want)
    return got


@pytest.mark.cuda
def test_k1_single_codeword_runs_every_iteration(cuda_device):
    """B = 1 on an A/B row (R1/4, -1 dB) that never converges: the block
    runs all 50 iterations alone, the serial floor chip_smoke.py times."""
    llr = torch.as_tensor(ldpc_bench.make_llrs("R1_4", 512, -1.0)[1], device=cuda_device)
    dec = ldpc_decoder("R1_4", 50, cuda_device)
    f = torch.full((512,), 0.75, device=cuda_device)
    plain = dec.plain(llr, f)
    row = int(torch.nonzero((plain.iterations == 50) & ~plain.success)[0])
    got = _k1_vs_plain(dec, llr[row : row + 1], f[:1])
    assert int(got.iterations[0]) == 50 and not bool(got.success[0])
    assert torch.allclose(got.llr_total, plain.llr_total[row : row + 1], rtol=0, atol=1e-3)


@pytest.mark.cuda
def test_k1_more_blocks_than_resident(cuda_device):
    """B = 2,048 codewords: more blocks than the card holds at once (528)."""
    llr = _llrs("R1_4", 2048, 3.4, seed=11)
    x = torch.as_tensor(llr, device=cuda_device)
    f = torch.as_tensor(np.resize(LADDER, 2048), device=cuda_device)
    got = _k1_vs_plain(ldpc_decoder("R1_4", 50, cuda_device), x, f)
    assert got.success.any() and not got.success.all()


@pytest.mark.cuda
def test_k1_eighty_iterations_r12(cuda_device):
    x = torch.as_tensor(_bpsk_llrs("R1_2", 8, 128, 10 ** (-3.0 / 20)), device=cuda_device)
    f = torch.full((128,), 0.75, device=cuda_device)
    got = _k1_vs_plain(ldpc_decoder("R1_2", 80, cuda_device), x, f)
    assert int(got.iterations.max()) == 80 and got.success.any()


@pytest.mark.cuda
def test_k1_takes_unaligned_rows(cuda_device):
    """A row that starts off the bulk copy's 16-byte grid is copied first."""
    llr = torch.as_tensor(_llrs("R1_2", 4, 1.5, seed=2), device=cuda_device)
    flat = torch.zeros(4 * 648 + 1, device=cuda_device)
    flat[1:] = llr.reshape(-1)
    x = flat[1:].view(4, 648)
    assert x.data_ptr() % 16
    f = torch.full((4,), 0.75, device=cuda_device)
    dec = ldpc_decoder("R1_2", 30, cuda_device)
    for a, b in zip(_k1_vs_plain(dec, x, f), dec(llr, f)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_k1_resources_hold_the_ab_batch(cuda_device):
    """No spill, at most 32 registers, and every codeword of the A/B point
    (512) resident at once."""
    dec = ldpc_decoder("R1_4", 50, cuda_device)
    res = ldpc_kernel.k1_resources(dec.n, dec.k1.slots)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert res["local_bytes"] == 0 and res["registers"] <= 32
    assert res["blocks_per_sm"] * sms >= 512


def _k2_vs_plain_v1(dec, x, f):
    before = ldpc_kernel.LAUNCHES_V1
    got = ldpc_kernel.bp_decode_v1(x, f, dec.k2, dec.k, dec.max_iters)
    torch.cuda.synchronize()
    assert ldpc_kernel.LAUNCHES_V1 == before + 1
    _assert_equal(got, dec.plain_v1(x, f))
    return got


@pytest.mark.cuda
def test_k2_single_codeword_runs_every_iteration(cuda_device):
    """B = 1 on an A/B row (R1/4, -1 dB) that never converges: the block
    runs all 50 iterations alone, the serial floor chip_smoke.py times."""
    llr = torch.as_tensor(ldpc_bench.make_llrs("R1_4", 512, -1.0)[1], device=cuda_device)
    dec = ldpc_decoder("R1_4", 50, cuda_device)
    f = torch.full((512,), 0.75, device=cuda_device)
    plain = dec.plain_v1(llr, f)
    row = int(torch.nonzero((plain.iterations == 50) & ~plain.success)[0])
    got = _k2_vs_plain_v1(dec, llr[row : row + 1], f[:1])
    assert int(got[2][0]) == 50 and not bool(got[1][0])
    assert torch.equal(got[3], plain.llr_total[row : row + 1])


@pytest.mark.cuda
def test_k2_more_blocks_than_resident(cuda_device):
    """B = 2,048 codewords: more blocks than the card holds at once (528)."""
    llr = _llrs("R1_4", 2048, 3.4, seed=11)
    x = torch.as_tensor(llr, device=cuda_device)
    f = torch.as_tensor(np.resize(LADDER, 2048), device=cuda_device)
    got = _k2_vs_plain_v1(ldpc_decoder("R1_4", 50, cuda_device), x, f)
    assert got[1].any() and not got[1].all()


@pytest.mark.cuda
def test_k2_eighty_iterations_r12(cuda_device):
    x = torch.as_tensor(_bpsk_llrs("R1_2", 8, 128, 10 ** (-3.0 / 20)), device=cuda_device)
    f = torch.full((128,), 0.75, device=cuda_device)
    got = _k2_vs_plain_v1(ldpc_decoder("R1_2", 80, cuda_device), x, f)
    assert int(got[2].max()) == 80 and got[1].any()


@pytest.mark.cuda
def test_k2_takes_unaligned_rows(cuda_device):
    """A row that starts off the bulk copy's 16-byte grid is copied first."""
    llr = torch.as_tensor(_llrs("R1_2", 4, 1.5, seed=2), device=cuda_device)
    flat = torch.zeros(4 * 648 + 1, device=cuda_device)
    flat[1:] = llr.reshape(-1)
    x = flat[1:].view(4, 648)
    assert x.data_ptr() % 16
    f = torch.full((4,), 0.75, device=cuda_device)
    dec = ldpc_decoder("R1_2", 30, cuda_device)
    want = ldpc_kernel.bp_decode_v1(llr, f, dec.k2, dec.k, 30)
    for a, b in zip(_k2_vs_plain_v1(dec, x, f), want):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_k2_resources_hold_the_ab_batch(cuda_device):
    """No spill, at most 32 registers, and every codeword of the A/B point
    (512) resident at once."""
    dec = ldpc_decoder("R1_4", 50, cuda_device)
    res = ldpc_kernel.k2_resources(dec.n, dec.k2.slots)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert res["local_bytes"] == 0 and res["registers"] <= 32
    assert res["blocks_per_sm"] * sms >= 512


@pytest.mark.cuda
def test_kernel_us_reads_the_profiler_and_falls_back_to_events(cuda_device, capsys):
    """``kernel_us`` reads K1's device time from the profiler; with a kernel
    name that no trace holds it times queued launches by CUDA events, which
    reads above the profiler's figure (the gap between launches) and under
    four times it."""
    from ria_tpu_torch.utils.timing import kernel_us

    dec = ldpc_decoder("R1_4", None, cuda_device)
    x = torch.as_tensor(_llrs("R1_4", 64, 0.5, 3), device=cuda_device)
    f = torch.full((64,), 0.75, device=cuda_device)
    for _ in range(3):
        dec(x, f)
    us, how = kernel_us(lambda: dec(x, f), "ldpc_bp_kernel")
    assert how.startswith("torch.profiler") and 1.0 < us < 50.0
    queued, how = kernel_us(lambda: dec(x, f), "no_such_kernel")
    assert how.startswith("CUDA events") and us < queued < 4 * us
    with capsys.disabled():
        print(f"\nkernel_us at R1_4 B=64: profiler {us:.2f} us, queued events {queued:.2f} us")


def _mixed_llrs(rate, B, seed):
    """bench.py's LDPC batch: amplitude-4 LLRs, half the rows at noise 2.6."""
    rng = np.random.default_rng(seed)
    info = rng.integers(0, 2, (B, get_code(rate).k))
    llr = (1.0 - 2.0 * encode_np(info, rate).astype(np.float32)) * 4.0
    noise = rng.normal(0, 1.0, llr.shape).astype(np.float32)
    noise[B // 2 :] = rng.normal(0, 2.6, (B - B // 2, llr.shape[1])).astype(np.float32)
    return llr + noise


def _bf16_case(rate, B, kind):
    """(LLRs, factors, iterations) of a bf16 card case: near the threshold,
    bench.py's mixed batch, the A/B point (``ldpc_bench``: R1/4, B = 512,
    -1 dB, factor 0.75, 50 iterations) or per-row factors off bfloat16's
    grid."""
    if kind == "ab":
        return ldpc_bench.make_llrs(rate, B, -1.0)[1], np.full(B, 0.75, np.float32), 50
    iters = 50 if kind == "mixed" else 80
    llr = _mixed_llrs(rate, B, 5) if kind == "mixed" else _llrs(rate, B, 3.0, seed=13)
    grid = np.float32([0.7, 0.8, 0.9, 0.6]) if kind == "off_grid" else LADDER
    return llr, np.resize(grid, B), iters


@pytest.mark.cuda
@pytest.mark.parametrize("rate,B,kind", [(r, b, "near") for r in CODE_PARAMS for b in (8, 256)]
                         + [("R1_4", 512, "mixed"), ("R1_4", 512, "ab")])
def test_k1_bf16_equals_plain_bf16_bit_for_bit(rate, B, kind, cuda_device):
    """K1's bf16 build (csrc/ldpc_bp_bf16.cu), counted in ``LAUNCHES_BF16``
    alone, against the plain decoder's ``precision="bf16"`` on the card and
    on the CPU: every output of every row equal, converged or not, at every
    rate, on bench.py's mixed batch and at the A/B point; and not the
    float32 build's posteriors."""
    llr, fac, iters = _bf16_case(rate, B, kind)
    x, f = torch.as_tensor(llr, device=cuda_device), torch.as_tensor(fac, device=cuda_device)
    dec = ldpc_decoder(rate, iters, cuda_device, "bf16")
    before = (ldpc_kernel.LAUNCHES, ldpc_kernel.LAUNCHES_BF16)
    got = dec(x, f)
    torch.cuda.synchronize()
    assert (ldpc_kernel.LAUNCHES, ldpc_kernel.LAUNCHES_BF16) == (before[0], before[1] + 1)
    plain = dec.plain(x, f)
    cpu = ldpc_decoder(rate, iters, "cpu", "bf16").plain(x.cpu(), f.cpu())
    for a, b, c in zip(got, plain, cpu):
        assert torch.equal(a.cpu(), b.cpu()) and torch.equal(b.cpu(), c)
    f32 = ldpc_decoder(rate, iters, cuda_device)(x, f)
    assert not torch.equal(f32.llr_total, got.llr_total)


@pytest.mark.cuda
def test_make_decoder_bf16_launches_the_bf16_build(cuda_device):
    x = torch.as_tensor(_llrs("R1_2", 16, 2.0, seed=3), device=cuda_device)
    before = ldpc_kernel.LAUNCHES_BF16
    got = T.make_decoder("R1_2", 30, 0.75, "bf16", device=cuda_device)(x)
    assert ldpc_kernel.LAUNCHES_BF16 == before + 1
    want = T.make_decoder_vf("R1_2", 30, "bf16", device="cpu")(x.cpu(), torch.full((16,), 0.75))
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("rate,B,kind", [(r, b, "near") for r in CODE_PARAMS for b in (8, 256)]
                         + [("R1_4", 512, "mixed"), ("R1_4", 512, "ab"),
                            ("R1_4", 256, "off_grid"), ("R1_2", 64, "off_grid")])
def test_k2_bf16_equals_plain_v1_bf16_bit_for_bit(rate, B, kind, cuda_device):
    """K2's bf16 build (csrc/ldpc_bp_v1_bf16.cu), counted in
    ``LAUNCHES_V1_BF16`` alone, against ``plain_v1``'s ``precision="bf16"``
    on the card and on the CPU: every output of every row equal, converged
    or not, at every rate, on bench.py's mixed batch and at the A/B point;
    and not the float32 build's posteriors.  ``off_grid`` takes per-row
    factors 0.7, 0.8, 0.9 and 0.6, which the bf16 build rounds (the
    ladder's are exact)."""
    llr, fac, iters = _bf16_case(rate, B, kind)
    x, f = torch.as_tensor(llr, device=cuda_device), torch.as_tensor(fac, device=cuda_device)
    dec = ldpc_decoder(rate, iters, cuda_device, "bf16")
    counts = ("LAUNCHES", "LAUNCHES_BF16", "LAUNCHES_V1", "LAUNCHES_V1_BF16")
    before = [getattr(ldpc_kernel, c) for c in counts]
    got = make_cuda_decoder_v1(rate, iters, device=cuda_device, precision="bf16")(x, f)
    torch.cuda.synchronize()
    assert [getattr(ldpc_kernel, c) - b for c, b in zip(counts, before)] == [0, 0, 0, 1]
    cpu = ldpc_decoder(rate, iters, "cpu", "bf16").plain_v1(x.cpu(), f.cpu())
    _assert_equal(got, dec.plain_v1(x, f), cpu)
    f32 = make_cuda_decoder_v1(rate, iters, device=cuda_device)(x, f)
    assert not torch.equal(f32.llr_total, got.llr_total)
    if kind != "near":  # near the threshold no row of R2/3-R5/6 at B = 8 converges
        assert got.success.any()
    if kind == "ab":  # rows that run all 50 iterations
        assert (~got.success).any() and int(got.iterations.max()) == 50


@pytest.mark.cuda
def test_k1_bf16_and_k2_bf16_under_the_reference_contract(cuda_device):
    """tests/test_ldpc_pallas.py::test_fused_kernel_bit_equal_to_v1 on the
    card: K1's and K2's bf16 builds on its LLRs (R1/2, ``default_rng(23)``,
    16 rows, 2 dB, 30 iterations, factor 0.75): success, info bits and
    iterations equal on every row, both row classes, posteriors within
    1e-2 on converged rows."""
    x = torch.as_tensor(_bpsk_llrs("R1_2", 23, 16, 10 ** (-2.0 / 20)), device=cuda_device)
    k1 = make_cuda_decoder("R1_2", 30, device=cuda_device, precision="bf16")(x)
    k2 = make_cuda_decoder_v1("R1_2", 30, device=cuda_device, precision="bf16")(x)
    ok = k2.success
    assert bool(ok.any()) and not bool(ok.all())
    assert torch.equal(k1.success, ok)
    assert torch.equal(k1.info_bits, k2.info_bits)
    assert torch.equal(k1.iterations, k2.iterations)
    assert torch.allclose(k1.llr_total[ok], k2.llr_total[ok], rtol=0, atol=1e-2)


@pytest.mark.cuda
def test_make_cuda_decoder_v1_bf16_launches_the_bf16_build(cuda_device):
    x = torch.as_tensor(_llrs("R1_2", 16, 2.0, seed=3), device=cuda_device)
    counts = ("LAUNCHES", "LAUNCHES_BF16", "LAUNCHES_V1", "LAUNCHES_V1_BF16")
    before = [getattr(ldpc_kernel, c) for c in counts]
    got = make_cuda_decoder_v1("R1_2", 30, 0.75, device=cuda_device, precision="bf16")(x)
    torch.cuda.synchronize()
    assert [getattr(ldpc_kernel, c) - b for c, b in zip(counts, before)] == [0, 0, 0, 1]
    want = ldpc_decoder("R1_2", 30, "cpu", "bf16").plain_v1(x.cpu(), torch.full((16,), 0.75))
    _assert_equal(got, want)


def _assert_holds_the_ab_batch(res, cuda_device):
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert res["local_bytes"] == 0 and res["registers"] <= 32
    assert res["blocks_per_sm"] * sms >= 512


@pytest.mark.cuda
def test_k2_bf16_resources_hold_the_ab_batch(cuda_device):
    """The bf16 build on its own tables: no spill, at most 32 registers, and
    every codeword of the A/B point (512) resident at once."""
    dec = ldpc_decoder("R1_4", 50, cuda_device, "bf16")
    _assert_holds_the_ab_batch(ldpc_kernel.k2_resources(dec.n, dec.k2.slots, "bf16"),
                               cuda_device)


@pytest.mark.cuda
def test_k1_bf16_resources_hold_the_ab_batch(cuda_device):
    """K1's bf16 build on its own tables, as K2's."""
    dec = ldpc_decoder("R1_4", 50, cuda_device, "bf16")
    _assert_holds_the_ab_batch(ldpc_kernel.k1_resources(dec.n, dec.k1.slots, "bf16"),
                               cuda_device)


@pytest.mark.cuda
def test_k2_bf16_library_is_built_from_its_source_and_defines(cuda_device):
    """Each bf16 build is a source of its own (csrc/ldpc_bp_v1_bf16.cu,
    csrc/ldpc_bp_bf16.cu), in a library of its own whose name carries it."""
    builds = ldpc_kernel.build()
    for bf16, f32 in (("ldpc_bp_v1_bf16", "ldpc_bp_v1"), ("ldpc_bp_bf16", "ldpc_bp")):
        src, defines = ldpc_kernel.LIBRARIES[bf16]
        assert src.name == f"{bf16}.cu" and defines == ()
        assert builds[bf16].path == ldpc_kernel.library_path(src, defines)
        assert builds[bf16].path != builds[f32].path and builds[bf16].path.exists()


@pytest.mark.cuda
@pytest.mark.parametrize("rate", ["R1_4", "R3_4"])
def test_bf16_builds_zero_rows_and_zero_iterations(rate, cuda_device):
    """The bf16 builds on all-zero rows (one iteration, every row converged)
    and with no iteration (the channel LLRs, signed zeros kept), as K1's
    float32 build; R3_4 has edgeless variables."""
    x = torch.zeros((3, 648), device=cuda_device)
    x[1, ::5] = -0.0
    f = torch.full((3,), 0.75, device=cuda_device)
    plain = ldpc_decoder(rate, 50, "cpu", "bf16")
    for make, ref in ((make_cuda_decoder, plain.plain), (make_cuda_decoder_v1, plain.plain_v1)):
        r = make(rate, 50, device=cuda_device, precision="bf16")(x, f)
        assert r.success.all() and (r.iterations == 1).all()
        want = ref(x.cpu(), f.cpu())
        assert torch.equal(r.llr_total.cpu().view(torch.int32), want.llr_total.view(torch.int32))
        r0 = make(rate, 0, device=cuda_device, precision="bf16")(x - 1.0, f)
        assert not r0.success.any() and (r0.iterations == 0).all()
        assert torch.equal(r0.llr_total, x - 1.0)
