"""LDPC tables of the PyTorch port against the JAX package (host numpy)."""

import pathlib

import numpy as np
import pytest
import torch

from ria_tpu.fec import ldpc_matrix as jm
from ria_tpu_torch import convert
from ria_tpu_torch.fec import ldpc_matrix as tm
from ria_tpu_torch.fec.ldpc import make_encoder
from ria_tpu_torch.fec.ldpc_kernel import csc_tables
from ria_tpu_torch.utils.bits import bits_to_bytes, bytes_to_bits
from ria_tpu_torch.utils.mt19937 import MT19937

torch.set_num_threads(1)

GOLDEN = pathlib.Path(__file__).parent / "golden" / "ldpc_golden.txt"
RATES = list(tm.CODE_PARAMS)
EDGES = {"R1_4": 2437, "R1_2": 1623, "R2_3": 1510, "R3_4": 1134, "R5_6": 756}
NO_EDGE_VARS = {"R1_4": 0, "R1_2": 0, "R2_3": 0, "R3_4": 161, "R5_6": 323}


def _assert_same_code(a, b):
    assert (a.k, a.m, a.n, a.max_degree) == (b.k, b.m, b.n, b.max_degree)
    for name in ("row_idx", "row_mask", "h_data", "gather"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert np.array_equal(x, y), name


def test_constants_match_reference():
    assert tm.CODE_PARAMS == jm.CODE_PARAMS
    assert tm.RATE_ENUM == jm.RATE_ENUM
    assert tm.RECOMMENDED_ITERS == jm.RECOMMENDED_ITERS
    assert (tm.MIN_SUM_FACTOR, tm.LLR_CLAMP, tm.BLOCK_BITS) == (0.75, 50.0, 648)
    # The reference's quirk: R1_3 has an enum and an iteration count, no code.
    assert "R1_3" in tm.RATE_ENUM and "R1_3" in tm.RECOMMENDED_ITERS
    assert "R1_3" not in tm.CODE_PARAMS


def test_mt19937_matches_cpp():
    rng = MT19937(5489)
    draws = [rng() for _ in range(10000)]
    assert draws[9999] == 4123659995


@pytest.mark.parametrize("rate", RATES)
def test_get_code_equal(rate):
    code = tm.get_code(rate)
    _assert_same_code(code, jm.get_code(rate))
    assert code.max_degree == 7
    assert int(code.row_mask.sum()) == EDGES[rate]


@pytest.mark.parametrize("rate", RATES)
def test_csc_tables_match_gather(rate):
    """The kernel's variable->edge lists hold exactly the one-hot gather's
    edges, in ascending slot order; variables with no edges have none."""
    code = tm.get_code(rate)
    col_ptr, col_edge = csc_tables(code.row_idx, code.row_mask, code.n)
    assert col_ptr.dtype == np.int32 and col_edge.dtype == np.int32
    assert col_ptr[0] == 0 and col_ptr[-1] == EDGES[rate] == len(col_edge)
    degree = np.diff(col_ptr)
    assert int(np.sum(degree == 0)) == NO_EDGE_VARS[rate]
    if rate == "R1_4":
        assert degree.max() == 13
    for v in range(code.n):
        edges = col_edge[col_ptr[v] : col_ptr[v + 1]]
        assert np.array_equal(edges, np.flatnonzero(code.gather[:, v])), v


@pytest.mark.parametrize("rate", RATES)
def test_code_from_arrays_equals_port_tables(rate):
    ref = jm.get_code(rate)
    code = convert.code_from_arrays(ref.row_idx, ref.row_mask, ref.h_data)
    assert code.rate == rate
    _assert_same_code(code, tm.get_code(rate))
    for x, y in zip(csc_tables(code.row_idx, code.row_mask, code.n),
                    csc_tables(ref.row_idx, ref.row_mask, ref.n)):
        assert np.array_equal(x, y)


def test_code_from_arrays_rejects_unknown_shapes():
    with pytest.raises(ValueError):
        convert.code_from_arrays(np.zeros((10, 7), np.int32), np.ones((10, 7), bool),
                                 np.zeros((10, 20), np.float32))


def _golden_vectors():
    out = {}
    for line in GOLDEN.read_text().splitlines():
        parts = line.split()
        if len(parts) == 5 and parts[1] == "in" and parts[3] == "out":
            out[parts[0]] = (bytes.fromhex(parts[2]), bytes.fromhex(parts[4]))
    return out


@pytest.mark.parametrize("rate", RATES)
def test_encoder_reproduces_golden(rate):
    """Multi-block byte encode through the port's encoder, as the reference
    codec does: k bits per block, zero-padded tail, n coded bits per block."""
    data, expected = _golden_vectors()[rate]
    k = tm.get_code(rate).k
    bits = bytes_to_bits(data)
    blocks = -(-len(bits) // k)
    padded = np.zeros(blocks * k, np.uint8)
    padded[: len(bits)] = bits
    coded = make_encoder(rate, "cpu")(torch.as_tensor(padded.reshape(blocks, k)))
    assert bits_to_bytes(coded.numpy().reshape(-1)) == expected
