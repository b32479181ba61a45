"""Kernel K2's plain version, ``LDPCDecoder.plain_v1``, against the JAX package.

``plain_v1`` is held against ``ria_tpu.fec.ldpc.make_decoder_vf`` (f32) and
against K2's TPU original, ``make_pallas_decoder_v1``, run by the Pallas
interpreter as the JAX package's own tests run it, on the cases of
tests/test_torch_ldpc.py plus an R3/4 case (161 variables with no edge).
Tolerances, and why, are those of tests/test_torch_ldpc.py: against the f32
reference and against ``plain``, ``success`` on every row and ``iterations``
and ``info_bits`` on converged rows exactly equal, ``llr_total`` on converged
rows within 1e-3 (the slot-major scatter sums the same messages in another
order); against the interpreter, equal success sets and hard decisions on
converged rows and posteriors within 0.5, because the TPU kernel rounds the
gathered LLRs and the check messages to bf16.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ria_tpu.fec.ldpc import make_decoder_vf as jax_decoder_vf
from ria_tpu.fec.ldpc_matrix import get_code as jax_get_code
from ria_tpu.fec.ldpc_pallas import make_pallas_decoder_v1
from ria_tpu_torch import convert
from ria_tpu_torch.fec.ldpc import LDPCDecoder, ldpc_decoder
from ria_tpu_torch.fec import ldpc_kernel
from ria_tpu_torch.fec.ldpc_kernel import slot_tables
from ria_tpu_torch.fec.ldpc_matrix import CODE_PARAMS
from test_torch_ldpc import CASES, ITERS, LADDER, _assert_matches, _awgn_llrs

torch.set_num_threads(1)

V1_CASES = {**CASES, "noisy_r34": ("R3_4", lambda: _awgn_llrs("R3_4", 4, 8, 4.0))}


@functools.lru_cache(maxsize=None)
def _reference(case):
    """(llrs, factors, f32 vf result, K2-interpreter result) as numpy."""
    rate, make = V1_CASES[case]
    llr = make()
    fac = np.resize(LADDER, llr.shape[0])
    vf = jax_decoder_vf(rate, ITERS)(jnp.asarray(llr), jnp.asarray(fac))
    k2 = make_pallas_decoder_v1(rate, tile=8, max_iters=ITERS, interpret=True)(
        jnp.asarray(llr), jnp.asarray(fac))
    as_np = lambda r: tuple(np.asarray(x) for x in r)  # noqa: E731
    return llr, fac, as_np(vf), as_np(k2)


def _plain_v1(case):
    rate, _ = V1_CASES[case]
    llr, fac, _, _ = _reference(case)
    return ldpc_decoder(rate, ITERS, "cpu").plain_v1(torch.as_tensor(llr), torch.as_tensor(fac))


@pytest.mark.parametrize("case", list(V1_CASES))
def test_plain_v1_matches_jax_vf(case):
    port = _plain_v1(case)
    _assert_matches(port, _reference(case)[2], 1e-3)
    assert port.success.any()


@pytest.mark.parametrize("case", list(V1_CASES))
def test_plain_v1_matches_k2_interpreter(case):
    """Iterations are compared too: on these cases the interpreter's bf16
    rounding moves no converged row's iteration count (it can elsewhere:
    on ``_awgn_llrs("R1_4", 3, 16, -1.0)`` both interpreters converge row
    14 an iteration later than the f32 decoders)."""
    _assert_matches(_plain_v1(case), _reference(case)[3], 0.5)


@pytest.mark.parametrize("case", list(V1_CASES))
def test_plain_v1_matches_plain(case):
    rate, _ = V1_CASES[case]
    llr, fac, _, _ = _reference(case)
    plain = ldpc_decoder(rate, ITERS, "cpu").plain(torch.as_tensor(llr), torch.as_tensor(fac))
    _assert_matches(_plain_v1(case), tuple(x.numpy() for x in plain), 1e-3)


def test_r34_case_has_edgeless_variables_and_both_row_classes():
    llr, _, vf, _ = _reference("noisy_r34")
    ok = vf[1]
    assert ok.any() and not ok.all()
    port = _plain_v1("noisy_r34")
    free = ~jax_get_code("R3_4").gather.any(axis=0)
    assert int(free.sum()) == 161
    assert np.array_equal(port.llr_total.numpy()[:, free], llr[:, free])


@pytest.mark.parametrize("rate", ["R1_4", "R1_2"])
def test_check_update_forms_agree_on_ties(rate):
    """K2's tie-count check update equals the argmin form of ``plain`` on
    messages full of duplicated minima, values at the +-50 clamp, zeros and
    the code's masked (padding) slots."""
    dec = ldpc_decoder(rate, ITERS, "cpu")
    rng = np.random.default_rng(9)
    B = 64
    values = np.asarray([0.0, 0.5, 1.0, 1.0, 2.5, 50.0, 50.0], np.float32)
    v2c = rng.choice(values, (B, dec.m, dec.D)) * rng.choice([-1.0, 1.0], (B, dec.m, dec.D))
    v2c = torch.as_tensor(v2c.astype(np.float32))
    factors = torch.as_tensor(np.resize(LADDER, B))
    want = dec._check_update(v2c, factors)
    got = LDPCDecoder._check_update_v1(v2c.transpose(1, 2), dec.row_mask.T, factors)
    assert torch.equal(got.transpose(1, 2), want)
    absv = torch.where(dec.row_mask, v2c.abs(), torch.inf)
    ties = (absv == absv.amin(dim=-1, keepdim=True)).sum(dim=-1)
    assert bool((ties > 1).any()) and bool((ties == 1).any())
    assert not bool(dec.row_mask.all())


@pytest.mark.parametrize("rate", list(CODE_PARAMS))
def test_slot_tables_rebuild_k2_onehots(rate):
    """The per-slot lists hold exactly K2's one-hot ``G[d]``
    (ldpc_pallas.py:236-240), built from the JAX package's tables."""
    ref = jax_get_code(rate)
    code = convert.code_from_arrays(ref.row_idx, ref.row_mask, ref.h_data)
    m, n, D = code.m, code.n, code.max_degree
    G = np.zeros((D, m, n), np.float32)
    for i in range(m):
        for d in range(D):
            if ref.row_mask[i, d]:
                G[d, i, ref.row_idx[i, d]] = 1.0
    slot_ptr, slot_chk = slot_tables(code.row_idx, code.row_mask, n)
    assert slot_ptr.dtype == np.int32 and slot_chk.dtype == np.int32
    assert slot_ptr.shape == (D, n + 1) and slot_ptr[0, 0] == 0
    assert slot_ptr[-1, -1] == len(slot_chk) == int(ref.row_mask.sum())
    assert np.array_equal(slot_ptr[1:, 0], slot_ptr[:-1, -1])
    rebuilt = np.zeros_like(G)
    for d in range(D):
        for v in range(n):
            checks = slot_chk[slot_ptr[d, v] : slot_ptr[d, v + 1]]
            assert np.all(np.diff(checks) > 0)
            rebuilt[d, checks, v] = 1.0
    assert np.array_equal(rebuilt, G)


def test_k2_library_name_tracks_its_source(tmp_path):
    """K2 builds into its own library, whose name changes with its source."""
    path = ldpc_kernel.library_path(ldpc_kernel._SOURCE_V1)
    assert path.parent == ldpc_kernel.BUILD_DIR and path.name.startswith("ldpc_bp_v1_")
    assert path != ldpc_kernel.library_path()
    edited = tmp_path / "ldpc_bp_v1.cu"
    edited.write_bytes(ldpc_kernel._SOURCE_V1.read_bytes() + b"\n// edit\n")
    assert ldpc_kernel.library_path(edited) != path
