"""Kernel K1's host-built tables (``ldpc_kernel.k1_layout``) for all five rates.

K1 stores each check message at its variable's slot of a CSC-ordered array
(``epos``) and sums each variable's contiguous, zero-padded segment.  These
tests hold the tables to that contract on the host, where the CUDA kernel
cannot run: ``edge_pos`` inverts ``col_edge``; every variable has one job
whose segment holds exactly its edges in ascending edge order; the int16
tables and the job packing round-trip; the variable pass is balanced; and
summing one iteration's messages over the segments, in the kernel's order,
gives the posterior of the plain decoder within 1e-5 (the plain decoder
sums through a one-hot matmul, in another order).  Last, a step-by-step
emulation of K1's schedule (the next check update run before the vote, the
sentinel edges with no mask, the per-codeword freeze) in float32 equals the
plain decoder on the noisy cases of tests/test_torch_ldpc.py.
"""

import numpy as np
import pytest
import torch

from ria_tpu_torch.fec import ldpc_kernel as K
from ria_tpu_torch.fec.ldpc import ldpc_decoder
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
    assert torch.allclose(got, want, rtol=0, atol=1e-5)
    assert not torch.equal(c2v, torch.zeros_like(c2v))


def _emulate_k1(rate, llr, fac, max_iters):
    """K1's schedule, step by step, in float32 over a batch, as the kernel
    runs it: slots with no edge gather the sentinel variable (+inf) with no
    mask; the prologue's check update; then per iteration the variable
    pass, the gather with v2c and parity, the speculative next check update
    (skipped on the last), and the vote, after which a converged row
    freezes."""
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
    state = check_update(gather(post))
    live = torch.ones(B, dtype=torch.bool)
    ok = torch.zeros(B, dtype=torch.bool)
    iters = torch.zeros(B, dtype=torch.int32)
    for it in range(max_iters):
        c2v = messages(state)
        new_post = _csc_posterior(lay, n, llr, c2v)
        post = torch.where(live[:, None], new_post, post)
        g = gather(post)
        v2c = torch.clamp(g - c2v, -LLR_CLAMP, LLR_CLAMP)
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
