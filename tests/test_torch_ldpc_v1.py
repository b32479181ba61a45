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

``plain_v1``'s bf16 mode computes that rounding, and is held against the
same interpreter results: ``success`` on every row and ``iterations`` and
``info_bits`` on converged rows exactly equal, ``llr_total`` on converged
rows within ``BF16_INTERP_ATOL``.  That is not 1e-2, as for K1's bf16
mode (tests/test_torch_ldpc_bf16.py), because the interpreter is XLA:CPU
code that contracts the kernel's ``g - c2v`` into a fused multiply-add (the
message's product with the factor not rounded) on every slot where some
check has no edge (slots 2-6 of R1/2 and R1/4, 5-6 of R2/3, none of R3/4 and R5/6).
There ``where(mask, ...)`` keeps XLA from sharing the message between the
scatter and the v2c update, so the v2c update's fusion recomputes the
product and LLVM, which XLA:CPU lets contract, folds it into the
subtraction (``vfnmadd``).  On a slot where every check has an edge, the
message is one fusion's stored float32 output and nothing contracts
(:func:`test_xla_recomputes_the_product_on_the_partly_masked_slots` reads
this from the compiled program).  Where the contraction moves a gathered
value across a bfloat16 rounding boundary, a message moves by one bfloat16
ulp (``noisy_s23``: 0.03125 on a converged row).  With that contraction
replayed (:func:`plain_v1_xla`) the port's bf16 BP equals the interpreter
bit for bit on every row.  The TPU kernel's source rounds the product
before it subtracts, as the port and the CUDA K2 do.
"""

import functools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ria_tpu.fec.ldpc import make_decoder_vf as jax_decoder_vf
from ria_tpu.fec.ldpc_matrix import get_code as jax_get_code
from ria_tpu.fec.ldpc_pallas import make_pallas_decoder_v1
from ria_tpu_torch import convert
from ria_tpu_torch.fec.ldpc import DecodeResult, LDPCDecoder, _bf16, ldpc_decoder
from ria_tpu_torch.fec import ldpc_kernel
from ria_tpu_torch.fec.ldpc_kernel import slot_tables
from ria_tpu_torch.fec.ldpc_matrix import CODE_PARAMS, LLR_CLAMP
from test_torch_ldpc import CASES, ITERS, LADDER, _assert_matches, _awgn_llrs

torch.set_num_threads(1)

V1_CASES = {**CASES, "noisy_r34": ("R3_4", lambda: _awgn_llrs("R3_4", 4, 8, 4.0))}
# Largest |llr_total| difference on converged rows between plain_v1's bf16
# mode and the interpreted K2 (0.03125 measured; see the module docstring).
BF16_INTERP_ATOL = 0.0625


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


def _plain_v1(case, precision="f32"):
    rate, _ = V1_CASES[case]
    llr, fac, _, _ = _reference(case)
    return ldpc_decoder(rate, ITERS, "cpu", precision).plain_v1(torch.as_tensor(llr),
                                                                 torch.as_tensor(fac))


def plain_v1_xla(dec, llrs, factors, fused):
    """``dec.plain_v1`` in bf16 as the interpreted K2 computes it on XLA:CPU:
    on the edge slots in ``fused``, ``g - c2v`` rounds once (the message's
    product with the factor kept exact, as a fused multiply-add does; exact
    in float64, where the subtraction of a bfloat16 value rounds at most
    once more, never to another float32).  Otherwise line for line
    ``plain_v1``."""
    B = llrs.shape[0]
    idx, mask = dec.row_idx.T, dec.row_mask.T
    on = torch.zeros((dec.D, 1), dtype=torch.bool)
    on[list(fused)] = True
    llr_in, factors = llrs.float(), _bf16(factors.float())
    f64 = factors.double()[:, None, None]

    def gather(x):
        return torch.where(mask, _bf16(x)[:, idx], 0.0)

    v2c = gather(llr_in)
    llr_total = llr_in
    done = torch.zeros(B, dtype=torch.bool)
    iters = torch.zeros(B, dtype=torch.int32)
    it = 0
    while it < dec.max_iters and not bool(done.all()):
        c2v = LDPCDecoder._check_update_v1(v2c, mask, factors)
        excl = LDPCDecoder._check_update_v1(v2c, mask, torch.ones_like(factors))  # +-excl
        llr_new = llr_in + dec._slot_sum(_bf16(c2v))
        g = gather(llr_new)
        fma = (g.double() - excl.double() * f64).float()
        v2c_new = torch.clamp(torch.where(on, fma, g - c2v), -LLR_CLAMP, LLR_CLAMP)
        ok = torch.all((mask & (g < 0)).sum(dim=1) % 2 == 0, dim=-1)
        upd = ~done
        llr_total = torch.where(upd[:, None], llr_new, llr_total)
        v2c = torch.where(upd[:, None, None], v2c_new, v2c)
        iters = iters + upd.int()
        done = done | ok
        it += 1
    return DecodeResult((llr_total[:, : dec.k] < 0).to(torch.uint8), done, iters, llr_total)


def xla_fused_slots(row_mask) -> tuple[int, ...]:
    """The edge slots on which the interpreted K2 contracts ``g - c2v``:
    those where some check has no edge (see the module docstring)."""
    return tuple(d for d in range(row_mask.shape[1]) if not bool(row_mask[:, d].all()))


def _hlo_computations(text: str) -> dict[str, list[str]]:
    """{name: instruction lines} of an HLO module's text."""
    comps, name = {}, None
    for line in text.splitlines():
        head = re.match(r"^(?:ENTRY )?%(\S+) ", line)
        if head and line.rstrip().endswith("{"):
            name = head.group(1)
            comps[name] = []
        elif line.startswith("}"):
            name = None
        elif name:
            comps[name].append(line)
    return comps


def slots_recomputing_the_product(rate: str) -> tuple[int, ...]:
    """The edge slots whose v2c update (``clip(g - c2v)``) the interpreted
    K2's compiled XLA:CPU program fuses with a multiply, that is, with the
    message's product recomputed beside the subtraction rather than read
    back as a stored value."""
    D = jax_get_code(rate).max_degree
    decode = make_pallas_decoder_v1(rate, tile=8, max_iters=3, interpret=True)
    text = decode.lower(jnp.zeros((8, 648), jnp.float32),
                        jnp.ones(8, jnp.float32)).compile().as_text()
    comps = _hlo_computations(text)
    for body in comps.values():
        root = next((line for line in body if "ROOT" in line and " tuple(" in line), None)
        if root is None:
            continue
        # The loop body returns the D slots' v2c updates first.
        names = re.findall(r"%([\w.\-]+)", root.split(" tuple(", 1)[1])[:D]
        defs = {m.group(1): line for line in body
                if (m := re.match(r"\s*%([\w.\-]+) = ", line))}
        called = [re.search(r"calls=%([\w.\-]+)", defs.get(name, "")) for name in names]
        if all(called) and all(any(" clamp(" in line for line in comps[c.group(1)])
                               for c in called):
            return tuple(d for d, c in enumerate(called)
                         if any(" multiply(" in line for line in comps[c.group(1)]))
    raise AssertionError("no loop body returning the slots' v2c updates")


def assert_xla_contraction_replays(dec, llr, fac, ref):
    """``plain_v1_xla`` on :func:`xla_fused_slots` replays the interpreted K2
    ``ref`` bit for bit: every output of every row."""
    got = plain_v1_xla(dec, torch.as_tensor(llr), torch.as_tensor(fac),
                       xla_fused_slots(dec.row_mask))
    for a, b in zip(got, ref):
        assert np.array_equal(a.numpy(), b)


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


@pytest.mark.parametrize("case", list(V1_CASES))
def test_plain_v1_bf16_matches_k2_interpreter(case):
    port = _plain_v1(case, "bf16")
    _assert_matches(port, _reference(case)[3], BF16_INTERP_ATOL)
    assert port.success.any()


@pytest.mark.parametrize("case", list(V1_CASES))
def test_plain_v1_bf16_is_k2_interpreter_but_for_xla_contraction(case):
    rate, _ = V1_CASES[case]
    llr, fac, _, k2 = _reference(case)
    assert_xla_contraction_replays(ldpc_decoder(rate, ITERS, "cpu", "bf16"), llr, fac, k2)


@pytest.mark.parametrize("rate", list(CODE_PARAMS))
def test_xla_recomputes_the_product_on_the_partly_masked_slots(rate):
    """The slots :func:`plain_v1_xla` contracts are read from the compiled
    program, not fitted to the cases: the interpreted K2's XLA:CPU program
    recomputes the message's product inside the v2c update exactly on the
    slots where some check has no edge.  (Its machine code, dumped with
    ``XLA_FLAGS=--xla_dump_to=<dir>``, holds ``vfnmadd`` in those fusions and
    none in the others.)"""
    want = xla_fused_slots(ldpc_decoder(rate, ITERS, "cpu").row_mask)
    assert slots_recomputing_the_product(rate) == want
    assert want == {"R1_2": (2, 3, 4, 5, 6), "R1_4": (2, 3, 4, 5, 6), "R2_3": (5, 6),
                    "R3_4": (), "R5_6": ()}[rate]


@pytest.mark.parametrize("rate", ["R1_4", "R1_2", "R3_4"])
def test_slot_sum_is_k2_order(rate):
    """``_slot_sum`` against K2's grouping written out term by term in
    numpy float32: per variable, per slot, the slot group's messages from
    0.0 in ascending check order, each group added to the sum from 0.0.
    Messages span 2**-12 to 2**6, so most sums round and their order shows:
    the groups summed in descending check order differ."""
    dec = ldpc_decoder(rate, ITERS, "cpu")
    code_idx, code_mask = dec.row_idx.numpy(), dec.row_mask.numpy()
    slot_ptr, slot_chk = slot_tables(code_idx, code_mask, dec.n)
    rng = np.random.default_rng(31)
    B = 3
    c2v = (rng.choice([-1.0, 1.0], (B, dec.D, dec.m))
           * 2.0 ** rng.uniform(-12, 6, (B, dec.D, dec.m))).astype(np.float32)
    c2v *= code_mask.T[None]
    got = dec._slot_sum(torch.as_tensor(c2v)).numpy()
    f = np.float32
    want = np.zeros((B, dec.n), np.float32)
    backward = np.zeros((B, dec.n), np.float32)
    for b in range(B):
        for v in range(dec.n):
            acc = back = f(0.0)
            for d in range(dec.D):
                checks = slot_chk[slot_ptr[d, v] : slot_ptr[d, v + 1]]
                s = t = f(0.0)
                for c in checks:
                    s = f(s + c2v[b, d, c])
                for c in checks[::-1]:
                    t = f(t + c2v[b, d, c])
                acc, back = f(acc + s), f(back + t)
            want[b, v], backward[b, v] = acc, back
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert not np.array_equal(got, backward)
