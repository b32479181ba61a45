"""Kernel K1's host-built tables (``ldpc_kernel.k1_layout``) for all five rates.

K1 stores each check message at its variable's slot of a CSC-ordered array
(``epos``) and sums each variable's contiguous, zero-padded segment.  These
tests hold the tables to that contract on the host, where the CUDA kernel
cannot run: ``edge_pos`` inverts ``col_edge``; every variable has one job
whose segment holds exactly its edges in ascending edge order; the int16
tables and the job packing round-trip; the variable pass is balanced; and
summing one iteration's messages over the segments, in the kernel's order,
gives the posterior of the plain decoder bit for bit (the plain decoder
sums each variable's messages in the same ascending edge order).  Last, a
step-by-step emulation of K1's schedule (the next check update run before
the vote, the sentinel edges with no mask, the per-codeword freeze) in
float32 equals the plain decoder bit for bit, every row, on the noisy cases
of tests/test_torch_ldpc.py; and with the TPU kernel's rounding (the
gathered channel LLRs and posteriors and the summed check messages rounded
to bfloat16, the parity from the float32 posteriors) it equals the plain
decoder's ``precision="bf16"`` bit for bit.

The bf16 build (``csrc/ldpc_bp_bf16.cu``) gets there another way, held here
too: bfloat16 rounding to nearest even is symmetric in sign, so each
check's two magnitudes are rounded once and every message stored as
bfloat16 bits with its sign; its tables (``k1_layout(..., "bf16")``) hold
each variable's messages in order, 8 to a cell or 2 to a word job, padded
with +0; and its schedule (round at the store, the float32 message rebuilt
from the check's state in the gather, each posterior rounded once) equals
the plain bf16 decoder bit for bit.  The float32 tables are pinned to
their digests: the bf16 build has tables of its own and leaves them as they
were.
"""

import hashlib


import numpy as np
import pytest
import torch

from ria_tpu_torch.fec import ldpc_kernel as K
from ria_tpu_torch.fec.ldpc import _bf16, ldpc_decoder
from ria_tpu_torch.fec.ldpc_matrix import CODE_PARAMS, LLR_CLAMP, get_code
from test_torch_ldpc import CASES, ITERS, LADDER, _awgn_llrs

torch.set_num_threads(1)

RATES = list(CODE_PARAMS)


def _layout(rate):
    code = get_code(rate)
    return code, K.k1_layout(code.row_idx, code.row_mask, code.n)


def _segments(layout, n):
    """{variable: its slots in the message array, in the order K1 sums them}."""
    seg = {}
    for job in layout.jobs.reshape(-1):
        if job >= 0:
            v, first, cells = K.unpack_job(int(job))
            assert v not in seg, v
            seg[v] = [4 * (first + q * layout.stride) + lane
                      for q in range(cells) for lane in range(4)]
    assert sorted(seg) == list(range(n))
    return seg


def _table_order(code, lay):
    """[m, D]: the edge slot d of ``row_idx`` that table slot d' of each
    check holds, -1 on a masked table slot."""
    perm = np.full((code.m, code.max_degree), -1)
    for c in range(code.m):
        for d2 in range(code.max_degree):
            v = lay.row[d2, c]
            if v < code.n:
                (d,) = np.flatnonzero(code.row_mask[c] & (code.row_idx[c] == v))
                perm[c, d2] = d
    return perm


@pytest.mark.parametrize("rate", RATES)
def test_edge_pos_inverts_col_edge(rate):
    code = get_code(rate)
    col_ptr, col_edge = K.csc_tables(code.row_idx, code.row_mask, code.n)
    pos = K.edge_positions(code.row_idx, code.row_mask, code.n)
    assert pos.shape == (code.m, code.max_degree) and pos.dtype == np.int32
    assert np.all(pos[~code.row_mask] == -1)
    assert np.array_equal(np.sort(pos[code.row_mask]), np.arange(len(col_edge)))
    flat = np.flatnonzero(code.row_mask.reshape(-1))
    assert np.array_equal(col_edge[pos.reshape(-1)[flat]], flat)


@pytest.mark.parametrize("rate", RATES)
def test_segments_hold_each_variables_edges_in_order(rate):
    """Each variable's slots hold its edges in ascending edge order, after
    at most 3 zero (unused) lanes, in as few 4-slot cells as fit them."""
    code, lay = _layout(rate)
    col_ptr, col_edge = K.csc_tables(code.row_idx, code.row_mask, code.n)
    D = code.max_degree
    perm = _table_order(code, lay)
    owner = np.full(lay.slots, -1)  # edge e = c * D + d held by each slot
    for c in range(code.m):
        for d2 in range(D):
            if perm[c, d2] >= 0:
                assert owner[lay.epos[d2, c]] == -1
                owner[lay.epos[d2, c]] = c * D + perm[c, d2]
    assert np.count_nonzero(owner >= 0) == len(col_edge)
    for v, slots in _segments(lay, code.n).items():
        edges = col_edge[col_ptr[v] : col_ptr[v + 1]]
        held = owner[slots]
        lead = int(np.argmax(held >= 0)) if len(edges) else 0
        assert lead <= 3 and len(slots) == 4 * -(-(lead + len(edges)) // 4)
        assert np.all(held[:lead] == -1) and np.all(held[lead + len(edges) :] == -1)
        assert np.array_equal(held[lead : lead + len(edges)], edges)
        assert np.all(np.diff(edges) > 0)
    used = [x for slots in _segments(lay, code.n).values() for x in slots]
    assert len(set(used)) == len(used) and max(used) < lay.slots  # no cell shared


@pytest.mark.parametrize("rate", RATES)
def test_int16_tables_and_job_packing_round_trip(rate):
    """Each check's table slots hold exactly its edges (in some order), -1
    on the rest; the jobs unpack to what they pack."""
    code, lay = _layout(rate)
    assert lay.row.dtype == np.int16 and lay.epos.dtype == np.int16
    assert lay.row.shape == lay.epos.shape == (code.max_degree, code.m)
    assert lay.jobs.dtype == np.int32 and lay.jobs.shape == (2, K.K1_THREADS)
    for c in range(code.m):
        got = lay.row[:, c]
        real = got < code.n
        assert np.array_equal(np.sort(got[real]), np.sort(code.row_idx[c][code.row_mask[c]]))
        assert np.all(got[~real] == code.n) and np.all(lay.epos[~real, c] == lay.slots)
        assert np.all(lay.epos[real, c] < lay.slots) and np.all(got >= 0)
    assert lay.slots <= 16380
    for job in lay.jobs.reshape(-1):
        if job >= 0:
            v, first, cells = K.unpack_job(int(job))
            assert int(job) == v | cells << 10 | first << 15


@pytest.mark.parametrize("rate", RATES)
def test_variable_pass_is_balanced(rate):
    """A thread's chain of shared loads per iteration (one per 4-slot cell)
    is never longer than the heaviest variable's degree, and no longer than
    that variable's own cells where the light variables can be paired
    without exceeding them (R1_4: 4 loads for 13 edges)."""
    code, lay = _layout(rate)
    col_ptr, _ = K.csc_tables(code.row_idx, code.row_mask, code.n)
    deg = np.diff(col_ptr)
    loads = np.zeros(K.K1_THREADS, int)
    edges = np.zeros(K.K1_THREADS, int)
    for slot in range(2):
        for t, job in enumerate(lay.jobs[slot]):
            if job >= 0:
                v, _, cells = K.unpack_job(int(job))
                loads[t] += cells
                edges[t] += deg[v]
    assert loads.max() <= deg.max()
    assert loads.max() <= max(-(-deg.max() // 4), 2)
    if rate == "R1_4":
        assert loads.max() == 4 and edges.max() == deg.max() == 13


def _csc_posterior(lay, n, llr, c2v):
    """The kernel's variable pass in torch: the messages ``c2v [B, m, D]``
    (in the table's slot order) stored at ``epos``, each variable's slots
    summed in K1's order from 0.0, then the LLR."""
    B = c2v.shape[0]
    msgs = torch.zeros((B, lay.slots + 1))  # the last slot stays 0
    epos = torch.as_tensor(lay.epos.T.astype(np.int64))
    real = epos < lay.slots
    msgs[:, epos[real]] = c2v[:, real]
    seg = _segments(lay, n)
    width = max(len(s) for s in seg.values())
    idx = torch.full((n, width), lay.slots, dtype=torch.long)
    for v, slots in seg.items():
        idx[v, : len(slots)] = torch.as_tensor(slots)
    padded = msgs[:, idx]  # [B, n, width]
    s = torch.zeros((B, n))
    for j in range(width):
        s = s + padded[:, :, j]
    return llr + s


@pytest.mark.parametrize("rate", RATES)
def test_csc_sum_equals_plain_posterior(rate):
    code, lay = _layout(rate)
    dec = ldpc_decoder(rate, 1, "cpu")
    llr = torch.as_tensor(_awgn_llrs(rate, 3, 16, 1.0))
    fac = torch.as_tensor(np.resize(LADDER, 16))
    v2c = (llr @ dec.gather.T).reshape(16, code.m, code.max_degree)
    c2v = dec._check_update(v2c, fac)
    perm = torch.as_tensor(_table_order(code, lay))
    in_table = torch.where(perm >= 0, c2v[:, torch.arange(code.m)[:, None], perm.clamp(min=0)],
                           0.0)
    want = dec.plain(llr, fac).llr_total  # one iteration: LLR + these messages
    got = _csc_posterior(lay, code.n, llr, in_table)
    assert torch.equal(got, want)
    assert not torch.equal(c2v, torch.zeros_like(c2v))


def _emulate_k1(rate, llr, fac, max_iters, operand=lambda x: x):
    """K1's schedule, step by step, in float32 over a batch, as the kernel
    runs it: slots with no edge gather the sentinel variable (+inf) with no
    mask; the prologue's check update; then per iteration the variable
    pass, the gather with v2c and parity, the speculative next check update
    (skipped on the last), and the vote, after which a converged row
    freezes.  ``operand`` is the kernel's ``operand()``: the identity, or
    the bf16 build's rounding."""
    code, lay = _layout(rate)
    B, n = llr.shape
    row = torch.as_tensor(lay.row.T.astype(np.int64))  # [m, D], n on no-edge slots
    slot = torch.arange(code.max_degree)

    def check_update(v2c):  # -> (m1f, m2f, argmin, sign bits); messages() forms c2v
        absv = v2c.abs()
        amin = torch.argmin(absv, dim=-1, keepdim=True)
        min1 = absv.amin(dim=-1, keepdim=True)
        min2 = torch.where(slot == amin, torch.inf, absv).amin(dim=-1, keepdim=True)
        neg = (v2c < 0).sum(dim=-1, keepdim=True) % 2
        odd = (neg ^ (v2c < 0).long()).bool()
        return min1 * fac[:, None, None], min2 * fac[:, None, None], amin, odd

    def messages(state):
        m1f, m2f, amin, odd = state
        mag = torch.where(slot == amin, m2f, m1f)
        return torch.where(odd, -mag, mag)

    def gather(post):
        return torch.cat([post, torch.full((B, 1), torch.inf)], dim=1)[:, row]

    post = llr.clone()
    state = check_update(operand(gather(post)))
    live = torch.ones(B, dtype=torch.bool)
    ok = torch.zeros(B, dtype=torch.bool)
    iters = torch.zeros(B, dtype=torch.int32)
    for it in range(max_iters):
        c2v = messages(state)
        new_post = _csc_posterior(lay, n, llr, operand(c2v))
        post = torch.where(live[:, None], new_post, post)
        g = gather(post)
        v2c = torch.clamp(operand(g) - c2v, -LLR_CLAMP, LLR_CLAMP)
        parity = ((g < 0).sum(dim=-1) % 2).any(dim=-1)
        iters = torch.where(live, it + 1, iters)
        if it + 1 < max_iters:
            nxt = check_update(v2c)
            state = tuple(torch.where(live[:, None, None], a, b) for a, b in zip(nxt, state))
        ok |= live & ~parity
        live &= parity
        if not live.any():
            break
    return (post[:, : code.k] < 0).to(torch.uint8), ok, iters, post


@pytest.mark.parametrize("case", ["noisy_s3", "noisy_s23", "mixed_r14"])
def test_k1_schedule_emulation_matches_plain(case):
    rate, make = CASES[case]
    llr = torch.as_tensor(make())
    fac = torch.as_tensor(np.resize(LADDER, llr.shape[0]))
    got = _emulate_k1(rate, llr, fac, ITERS)
    want = ldpc_decoder(rate, ITERS, "cpu").plain(llr, fac)
    assert torch.equal(got[1], want.success)
    ok = got[1]
    assert torch.equal(got[2][ok], want.iterations[ok])
    assert torch.equal(got[0][ok], want.info_bits[ok])
    assert torch.allclose(got[3][ok], want.llr_total[ok], rtol=0, atol=1e-3)
    assert (want.iterations[ok] > 1).any()
    # Bit for bit on every row, the rows that never converge included.
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["noisy_s3", "noisy_s23", "mixed_r14"])
def test_k1_bf16_schedule_emulation_matches_plain_bf16(case):
    """The bf16 build's schedule against ``LDPCDecoder.plain`` with
    ``precision="bf16"``: every output of every row equal."""
    rate, make = CASES[case]
    llr = torch.as_tensor(make())
    fac = torch.as_tensor(np.resize(LADDER, llr.shape[0]))
    got = _emulate_k1(rate, llr, fac, ITERS, operand=_bf16)
    want = ldpc_decoder(rate, ITERS, "cpu", "bf16").plain(llr, fac)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    f32 = ldpc_decoder(rate, ITERS, "cpu").plain(llr, fac)
    assert not torch.equal(want.llr_total, f32.llr_total)


# sha256 of row, epos, jobs, then "slots stride", of the float32 tables,
# first 16 hex digits: K1's float32 tables as of commit 137700e.
F32_DIGESTS = {"R1_4": "a09d4452ae7ca605", "R1_2": "16c3406669091d92",
               "R2_3": "dbd2ceb11e255821", "R3_4": "3c546b61d3c1af18",
               "R5_6": "8a76ee3438591341"}


def layout_digest(lay) -> str:
    h = hashlib.sha256()
    for a in (lay.row, lay.epos, lay.jobs):
        h.update(np.ascontiguousarray(a).tobytes())
    h.update(f"{lay.slots} {lay.stride}".encode())
    return h.hexdigest()[:16]


@pytest.mark.parametrize("rate", RATES)
def test_f32_tables_are_pinned(rate):
    code = get_code(rate)
    assert layout_digest(K.k1_layout(code.row_idx, code.row_mask, code.n)) == F32_DIGESTS[rate]
    assert layout_digest(K.k1_layout(code.row_idx, code.row_mask, code.n, "f32")) == \
        F32_DIGESTS[rate]


def _bf16_bits(x: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 bits, round to nearest even, by integer
    arithmetic (the kernel's __float2bfloat16_rn for every non-NaN value)."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


def sign_sample(seed: int = 20261017) -> np.ndarray:
    """A seeded sample of float32 values: random bit patterns (subnormals
    and infinities among them), every exact tie of bfloat16 rounding near
    them (low half 0x8000, both parities of the kept bit), values one ulp
    either side of a tie, the largest finite values, +-0 and +-inf; no NaN."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2**32, 200_000, dtype=np.uint64).astype(np.uint32)
    sub = rng.integers(1, 2**23, 20_000, dtype=np.uint64).astype(np.uint32)  # subnormals
    hi = rng.integers(0, 2**16, 20_000, dtype=np.uint64).astype(np.uint32) << 16
    ties = np.concatenate([hi | 0x8000, hi | 0x7FFF, hi | 0x8001])
    edge = np.array([0, 0x7F7FFFFF, 0x7F7F8000, 0x7F800000, 0x00008000, 0x00018000, 1],
                    np.uint32)
    u = np.concatenate([bits, sub, ties, edge])
    x = u.view(np.float32)
    return np.abs(x[~np.isnan(x)])


def test_bf16_rounding_is_symmetric_in_sign():
    """The rounding of -x is the rounding of x with its sign bit flipped,
    for torch's conversion (the plain decoders') and for the kernels'
    integer form: so one rounding of a check's magnitude, sign applied after,
    is each of its messages rounded."""
    x = sign_sample()
    assert np.isinf(x).any() and (x == 0).any()
    assert ((x > 0) & (x < np.finfo(np.float32).tiny)).any()           # subnormals
    assert ((x.view(np.uint32) & 0xFFFF) == 0x8000).sum() > 10_000      # exact ties
    for value in (x, -x):
        torch_bits = torch.as_tensor(value).to(torch.bfloat16).view(torch.int16).numpy()
        assert np.array_equal(torch_bits.view(np.uint16), _bf16_bits(value))
    pos = _bf16_bits(x)
    assert np.array_equal(_bf16_bits(-x), pos ^ 0x8000)
    assert np.array_equal(torch.as_tensor(-x).to(torch.bfloat16).float().numpy(),
                          -torch.as_tensor(x).to(torch.bfloat16).float().numpy())


def _bf16_layout(rate):
    code = get_code(rate)
    return code, K.k1_layout(code.row_idx, code.row_mask, code.n, "bf16")


def _bf16_segments(layout, n):
    """{variable: its bfloat16 slots, in the order the bf16 build sums them}:
    8 a cell for a job of cells, 2 for a word job."""
    seg = {}
    for job in layout.jobs.reshape(-1):
        if job >= 0:
            v, first, cells = K.unpack_job(int(job))
            assert v not in seg, v
            seg[v] = ([8 * (first + q * layout.stride) + lane
                       for q in range(cells) for lane in range(8)]
                      if cells else [2 * first, 2 * first + 1])
    assert sorted(seg) == list(range(n))
    return seg


@pytest.mark.parametrize("rate", RATES)
def test_bf16_cells_hold_each_variables_edges_in_order(rate):
    """The bf16 tables: each variable's slots hold its edges in ascending
    edge order, after at most 7 unused (zero) lanes, in as few 8-slot cells
    as fit them, or in one 2-slot word where it has at most 2 edges; no slot
    is shared, no message sits past ``slots``, and the byte offsets fit the
    kernel's 16 bits."""
    code, lay = _bf16_layout(rate)
    col_ptr, col_edge = K.csc_tables(code.row_idx, code.row_mask, code.n)
    D = code.max_degree
    perm = _table_order(code, lay)
    owner = np.full(lay.slots, -1)
    for c in range(code.m):
        for d2 in range(D):
            if perm[c, d2] >= 0:
                assert owner[lay.epos[d2, c]] == -1
                owner[lay.epos[d2, c]] = c * D + perm[c, d2]
    assert np.count_nonzero(owner >= 0) == len(col_edge)
    seg = _bf16_segments(lay, code.n)
    words = 0
    for v, slots in seg.items():
        edges = col_edge[col_ptr[v] : col_ptr[v + 1]]
        held = owner[slots]
        lead = int(np.argmax(held >= 0)) if len(edges) else 0
        if len(slots) == 2:
            words += 1
            assert len(edges) <= 2 and lead == 0
        else:
            assert len(edges) > 2 and lead <= 7
            assert len(slots) == 8 * -(-(lead + len(edges)) // 8)
        assert np.all(held[:lead] == -1) and np.all(held[lead + len(edges) :] == -1)
        assert np.array_equal(held[lead : lead + len(edges)], edges)
    used = [x for slots in seg.values() for x in slots]
    assert len(set(used)) == len(used) and max(used) < lay.slots
    assert lay.slots % 8 == 0 and lay.slots * 2 <= 65520
    assert words == int((np.diff(col_ptr) <= 2).sum())
    if rate == "R1_4":  # 486 variables of degree 1 load a word, not a cell
        assert words == 486 and max(len(x) for x in seg.values()) == 16


def test_tables_carry_their_precision():
    """Each decoder's tables are its build's; a wrapper refuses tables of
    the other precision before it builds anything."""
    f32, bf16 = ldpc_decoder("R1_4", ITERS, "cpu"), ldpc_decoder("R1_4", ITERS, "cpu", "bf16")
    assert (f32.k1.precision, bf16.k1.precision) == ("f32", "bf16")
    assert (f32.k2.precision, bf16.k2.precision) == ("f32", "bf16")
    assert f32.k1.slots != bf16.k1.slots
    llr, fac = torch.zeros((1, 648)), torch.ones(1)
    with pytest.raises(ValueError, match="precision"):
        K.bp_decode(llr, fac, f32.k1, f32.k, ITERS, "bf16")
    with pytest.raises(ValueError, match="precision"):
        K.bp_decode_v1(llr, fac, bf16.k2, bf16.k, ITERS, "f32")
    with pytest.raises(ValueError, match="precision"):
        K.k1_layout(get_code("R1_4").row_idx, get_code("R1_4").row_mask, 648, "fp16")


def _widen(h: torch.Tensor) -> torch.Tensor:
    """bfloat16 bits (int32, low 16) -> their float32 values, exactly."""
    return ((h & 0xFFFF) << 16).to(torch.int32).view(torch.float32)


def _round_bits(x: torch.Tensor) -> torch.Tensor:
    """float32 -> bfloat16 bits (int32, low 16), round to nearest even."""
    return x.to(torch.bfloat16).view(torch.int16).to(torch.int32) & 0xFFFF


def emulate_k1_bf16(rate, llr, fac, max_iters):
    """The bf16 build's schedule, step by step, over a batch, on its own
    tables: the check update rounds m1f and m2f once and stores each
    message as bfloat16 bits with its sign flipped in; the variable pass
    sums each variable's slots (8-lane cells or a 2-lane word, zero lanes
    +0) widened exactly, in order from 0.0, and rounds the posterior once;
    the gather reads the rounded posteriors (+inf on the sentinel), rebuilds
    each float32 c2v from the check's state (m1f, m2f, first argmin, sign
    bits), clamps g - c2v and reads the parity from the rounded posterior's
    sign bit; the next update runs before the vote, a converged row freezes."""
    code, lay = _bf16_layout(rate)
    B, n = llr.shape
    D = code.max_degree
    row = torch.as_tensor(lay.row.T.astype(np.int64))      # [m, D], n on no-edge slots
    epos = torch.as_tensor(lay.epos.T.astype(np.int64))    # [m, D], slots on no-edge slots
    seg = _bf16_segments(lay, n)
    width = max(len(x) for x in seg.values())
    idx = torch.full((n, width), lay.slots + 8, dtype=torch.long)  # a slot that stays 0
    for v, slots in seg.items():
        idx[v, : len(slots)] = torch.as_tensor(slots)
    slot = torch.arange(D)

    def update(v2c, msgs):
        absv = v2c.abs()
        amin = torch.argmin(absv, dim=-1, keepdim=True)
        min1 = absv.amin(dim=-1, keepdim=True)
        min2 = torch.where(slot == amin, torch.inf, absv).amin(dim=-1, keepdim=True)
        neg = v2c < 0
        odd = neg ^ (neg.sum(dim=-1, keepdim=True) % 2 == 1)
        m1f, m2f = min1 * fac[:, None, None], min2 * fac[:, None, None]
        h = torch.where(slot == amin, _round_bits(m2f), _round_bits(m1f)) ^ (odd.int() << 15)
        msgs = msgs.clone()
        msgs[:, epos] = h                                   # the trash cell takes the rest
        return (m1f, m2f, amin, odd), msgs

    def gather(postr):
        return torch.cat([postr, torch.full((B, 1), torch.inf)], dim=1)[:, row]

    msgs = torch.zeros((B, lay.slots + 9), dtype=torch.int32)
    post = llr.clone()
    state = None
    if max_iters > 0:
        state, msgs = update(_widen(_round_bits(gather(llr))), msgs)
    live = torch.ones(B, dtype=torch.bool)
    ok = torch.zeros(B, dtype=torch.bool)
    iters = torch.zeros(B, dtype=torch.int32)
    for it in range(max_iters):
        vals = _widen(msgs[:, idx])
        s = torch.zeros((B, n))
        for j in range(width):
            s = s + vals[:, :, j]
        post = torch.where(live[:, None], llr + s, post)
        g = gather(_widen(_round_bits(post)))
        m1f, m2f, amin, odd = state
        mag = torch.where(slot == amin, m2f, m1f)
        v2c = torch.clamp(g - torch.where(odd, -mag, mag), -LLR_CLAMP, LLR_CLAMP)
        parity = (torch.signbit(g).sum(dim=-1) % 2 == 1).any(dim=-1)
        iters = torch.where(live, it + 1, iters)
        ok |= live & ~parity
        live &= parity
        if it + 1 < max_iters:
            nxt, new_msgs = update(v2c, msgs)
            state = tuple(torch.where(live[:, None, None], a, b) for a, b in zip(nxt, state))
            msgs = torch.where(live[:, None], new_msgs, msgs)
        if not live.any():
            break
    return (post[:, : code.k] < 0).to(torch.uint8), ok, iters, post


BF16_CASES = ["noisy_s3", "noisy_s11", "noisy_s23", "mixed_r14", "noisy_r34", "zeros_r56"]


def _bf16_case(case):
    if case == "noisy_r34":
        return "R3_4", _awgn_llrs("R3_4", 4, 8, 4.0)
    if case == "zeros_r56":  # signed zeros among the LLRs; R5_6 has 323 edgeless variables
        llr = _awgn_llrs("R5_6", 6, 8, 4.5)
        llr[:, ::7] = -0.0
        return "R5_6", llr
    rate, make = CASES[case]
    return rate, make()


@pytest.mark.parametrize("case", BF16_CASES)
def test_k1_bf16_hopper_schedule_emulation_matches_plain_bf16(case):
    """The bf16 build's schedule against ``LDPCDecoder.plain`` with
    ``precision="bf16"``: every output of every row equal, posteriors bit
    for bit, the rows that never converge included."""
    rate, llr = _bf16_case(case)
    llr = torch.as_tensor(llr)
    fac = torch.as_tensor(np.resize(LADDER, llr.shape[0]))
    got = emulate_k1_bf16(rate, llr, fac, ITERS)
    want = ldpc_decoder(rate, ITERS, "cpu", "bf16").plain(llr, fac)
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)
    assert torch.equal(got[3].view(torch.int32), want[3].view(torch.int32))
    assert (want.iterations > 1).any()
    assert (~want.success).any() == (case != "mixed_r14")  # rows that never converge
