"""The LDPC serving layer of the PyTorch port against the JAX package.

``decode_with_retries``, ``candidate_plan``, ``decode_candidates``,
``LDPCCodec``, ``make_tile_decoder`` and ``decode_chunked`` on the CPU (the
plain decoder) against their ``ria_tpu.fec.ldpc`` counterparts on the same
inputs.  The retry ladder and the candidate probes draw their perturbations
with numpy from the reference's seeds, so both sides decode the same rows.
Tolerances: ``success`` on every row, and ``iterations`` and ``info_bits``
on converged rows, exactly equal; ``llr_total`` on converged rows within
1e-3 (the port's matmuls sum in another order than XLA's); candidate
metrics within 1e-3.
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ria_tpu.fec import ldpc as J
from ria_tpu_torch.fec import ldpc as T
from ria_tpu_torch.fec.ldpc_matrix import CODE_PARAMS, encode_np, get_code
from ria_tpu_torch.utils.bits import bytes_to_bits

torch.set_num_threads(1)

GOLDEN = pathlib.Path(__file__).parent / "golden" / "ldpc_golden.txt"


def _bpsk_llrs(rate, seed, B, sigma):
    """tests/test_ldpc_pallas.py::test_retry_ladder_two_dispatches' input."""
    rng = np.random.default_rng(seed)
    info = rng.integers(0, 2, (B, get_code(rate).k)).astype(np.uint8)
    coded = encode_np(info, rate).astype(np.float64)
    y = (1 - 2.0 * coded) + rng.normal(0, sigma, coded.shape)
    return (2 * y / sigma**2).astype(np.float32)


def _assert_same_result(port, ref, llr_atol=1e-3):
    info, success, iters, llr = (x.cpu().numpy() for x in port)
    r_info, r_success, r_iters, r_llr = (np.asarray(x) for x in ref)
    assert np.array_equal(success, r_success)
    ok = success & r_success
    assert np.array_equal(iters[ok], r_iters[ok])
    assert np.array_equal(info[ok], r_info[ok])
    assert np.allclose(llr[ok], r_llr[ok], rtol=0, atol=llr_atol)
    return success


def _count_dispatches(monkeypatch):
    calls = []
    real = T.decode_batch

    def counted(llrs, *args, **kwargs):
        calls.append(len(llrs))
        return real(llrs, *args, **kwargs)

    monkeypatch.setattr(T, "decode_batch", counted)
    return calls


@pytest.mark.parametrize("case", ["ladder", "all_converge"])
def test_decode_with_retries_matches_jax(case, monkeypatch):
    sigma = 10 ** (1.2 / 20) if case == "ladder" else 10 ** (-4.0 / 20)
    llr = _bpsk_llrs("R1_2", 5, 4, sigma)
    ref = J.decode_with_retries(llr, "R1_2")
    calls = _count_dispatches(monkeypatch)
    port = T.decode_with_retries(llr, "R1_2")
    success = _assert_same_result(port, ref)
    if case == "ladder":
        # The primary batch fails somewhere and the ladder rescues a row.
        assert calls[0] == 4 and len(calls) == 2 and calls[1] > calls[0]
        primary = T.decode_batch(llr, np.full(4, 0.9375, np.float32), "R1_2")
        assert (success & ~primary.success.numpy()).any()
    else:
        assert calls == [4] and success.all()


@pytest.mark.parametrize("num_failed", range(7))
def test_candidate_plan_matches_jax(num_failed):
    assert T.candidate_plan(num_failed) == J.candidate_plan(num_failed)


@pytest.mark.parametrize("num_failed", [4, 0])
@pytest.mark.parametrize("kind", ["noise", "codewords"])
def test_decode_candidates_matches_jax(kind, num_failed, monkeypatch):
    """On test_decode_candidates_bounded_allocation's input (pure noise: no
    candidate on either side) and on noisy R1/4 codewords at +1 dB, which
    yield candidates.  Not at a lower SNR: there a few probe rows sit at the
    decode floor, where the order in which f32 sums are taken decides
    whether they converge (1 to 3 of these 116 rows differ between the JAX
    and the port's plain decoder at 0 dB), and so does the candidate set."""
    if kind == "noise":  # no row converges: 20 iterations say as much as 50
        llrs = np.random.default_rng(0).normal(0, 4, (4, 648)).astype(np.float32)
        iters = 20
    else:
        llrs = _bpsk_llrs("R1_4", 6, 4, 10 ** (-1.0 / 20))
        iters = None
    ref = J.decode_candidates(llrs, "R1_4", iters, num_failed=num_failed)
    calls = _count_dispatches(monkeypatch)
    port = T.decode_candidates(llrs, "R1_4", iters, num_failed=num_failed)
    assert calls == [len(T.candidate_plan(num_failed)) * 4]
    assert calls[0] <= 29 * 4
    if num_failed == 0:
        assert calls[0] < len(T.candidate_plan(4)) * 4
    assert [len(c) for c in port] == [len(c) for c in ref]
    assert (sum(len(c) for c in port) > 0) == (kind == "codewords")
    for cands, r_cands in zip(port, ref):
        for (m, info), (r_m, r_info) in zip(cands, r_cands):
            assert np.array_equal(info, np.asarray(r_info))
            assert abs(m - r_m) <= 1e-3


def _golden_vectors():
    out = {}
    for line in GOLDEN.read_text().splitlines():
        parts = line.split()
        if len(parts) == 5 and parts[1] == "in" and parts[3] == "out":
            out[parts[0]] = (bytes.fromhex(parts[2]), bytes.fromhex(parts[4]))
    return out


@pytest.mark.parametrize("rate", sorted(_golden_vectors()))
def test_codec_encode_reproduces_golden(rate):
    data, expected = _golden_vectors()[rate]
    assert T.LDPCCodec(rate).encode(data) == expected


@pytest.mark.parametrize("rate", list(CODE_PARAMS))
def test_codec_hard_roundtrip(rate):
    codec = T.LDPCCodec(rate)
    data = bytes(range(40))
    coded = codec.encode(data)
    assert len(coded) == codec.coded_size(len(data))
    ok, decoded = codec.decode_hard(coded)
    assert ok and codec.last_success
    assert decoded[: len(data)] == data


def test_codec_multiblock_soft_matches_jax():
    """R3/4 (k = 486, not byte-aligned) over four blocks of noisy LLRs.  The
    decoded bytes need not equal the sent ones: R3/4's 161 edgeless
    variables keep their channel LLR, so a noise flip there stays."""
    rate = "R3_4"
    data = bytes(np.random.default_rng(3).integers(0, 256, 200, dtype=np.uint8))
    coded = bytes_to_bits(T.LDPCCodec(rate).encode(data)).astype(np.float32)
    rng = np.random.default_rng(4)
    llrs = ((1 - 2 * coded) * 4.0 + rng.normal(0, 2.0, coded.shape)).astype(np.float32)
    port, ref = T.LDPCCodec(rate), J.LDPCCodec(rate)
    got, want = port.decode_soft(llrs), ref.decode_soft(llrs)
    assert got == want
    assert got[0] and len(got[1]) == 243  # 4 blocks x 486 bits
    assert (port.last_success, port.last_iters) == (ref.last_success, ref.last_iters)
    assert port.last_iters > 1
    assert T.LDPCCodec(rate).decode_soft(np.zeros(0)) == (False, b"")


def test_make_tile_decoder_on_cpu_is_the_plain_decoder():
    fn, pad_to = T.make_tile_decoder("R1_2", 30, 0.9375)
    assert pad_to is None
    jfn, jpad = J.make_tile_decoder("R1_2", 30, 0.9375)
    assert jpad is None
    llr = _bpsk_llrs("R1_2", 11, 8, 10 ** (-1.5 / 20))
    _assert_same_result(fn(torch.as_tensor(llr)), jfn(jnp.asarray(llr)))


def test_decode_chunked_matches_jax():
    llr = _bpsk_llrs("R1_4", 2, 20, 10 ** (1.0 / 20))
    ref = J.decode_chunked(llr, "R1_4", chunk=8, max_iters=30)
    port = T.decode_chunked(llr, "R1_4", chunk=8, max_iters=30)
    assert port.llr_total.shape == (20, 648)
    success = _assert_same_result(port, ref)
    assert success.any() and not success.all()
    whole = T.decode_batch(llr, np.full(20, 0.75, np.float32), "R1_4", 30)
    for a, b in zip(port, whole):
        assert torch.equal(a, b)


def test_decode_batch_device_rule():
    """A numpy batch goes to ``device``; a tensor keeps its own, and naming
    another device raises instead of moving it."""
    llr = _bpsk_llrs("R1_2", 3, 2, 0.5)
    r = T.decode_batch(llr, np.full(2, 0.75, np.float32), "R1_2", 30, device="cpu")
    assert r.success.device.type == "cpu" and bool(r.success.all())
    with pytest.raises(ValueError):
        T.decode_batch(torch.as_tensor(llr), np.full(2, 0.75, np.float32), "R1_2", 30,
                       device="meta")
