"""Kernel K2's host-built tables (``ldpc_kernel.k2_layout``) for all five rates,
and its schedule emulated on the host.

K2 stores each check message straight into the cell its variable sums, in
the order K2 sums them: variable-major, then edge slot, then ascending
check, each slot group starting a fresh 4-slot cell.  These tests hold the
tables to that contract on the host, where the CUDA kernel cannot run:
every variable's cells hold exactly its edges, grouped by slot and in
ascending check order, with the group ends where the job's bits say; the
int16 tables and the job packing round-trip; the variable pass is
balanced; sentinels sit only where a check has no edge, and every check
has the >= 2 real edges the sentinel argument needs.  Last, a step-by-step
float32 emulation of the new kernel's schedule (sentinel edges, the next
check update run before the vote, the grouped sums, term by term so that
every add rounds as the card's does) is bit-equal to a term-by-term
emulation of K2's first port (git 5fb6243: per-slot lists and mask
tests), and to ``plain_v1``, which sums in K2's order; with the TPU
kernel's rounding (``precision="bf16"``: the factor, the gathered LLRs and
each summed message rounded to bfloat16) that schedule is bit-equal to
``plain_v1``'s bf16 mode.

The bf16 build (``csrc/ldpc_bp_v1_bf16.cu``) has tables of its own
(``k2_layout(..., "bf16")``: bfloat16 messages, K2's 4-slot units two to a
16-byte cell, a word job for a variable of at most 2 edges), held here to
the same grouping; its schedule (each check's two magnitudes rounded once
and stored as bfloat16 bits with their signs, the float32 message rebuilt
from the check's state in the gather, each posterior rounded once) is
emulated step by step and equals ``plain_v1``'s bf16 mode bit for bit.  The
float32 tables are pinned to their digests.
"""

import numpy as np
import pytest
import torch

from ria_tpu_torch.fec import ldpc_kernel as K
from ria_tpu_torch.fec.ldpc import _bf16, ldpc_decoder
from ria_tpu_torch.fec.ldpc_matrix import CODE_PARAMS, LLR_CLAMP, get_code
from test_torch_ldpc import CASES, ITERS, LADDER, _awgn_llrs

torch.set_num_threads(1)

RATES = list(CODE_PARAMS)


def _signed_zeros():
    llr = _awgn_llrs("R1_2", 5, 8, 2.0)
    llr[:, ::7] = -0.0  # a -0.0 channel LLR becomes +0.0 in K2's posterior
    return llr


EMU_CASES = {**CASES,
             "noisy_r34": ("R3_4", lambda: _awgn_llrs("R3_4", 4, 8, 4.0)),
             "noisy_r56": ("R5_6", lambda: _awgn_llrs("R5_6", 6, 8, 4.5)),
             "signed_zeros": ("R1_2", _signed_zeros)}


def _layout(rate):
    code = get_code(rate)
    return code, K.k2_layout(code.row_idx, code.row_mask, code.n)


def _jobs(lay, n):
    """{variable: (its slots in the message array in the order K2 reads them,
    the job cell that ends each group)}."""
    seg = {}
    for job in lay.jobs.reshape(-1):
        if job >= 0:
            v, first, ends = K.unpack_k2_job(int(job))
            assert v not in seg, v
            cells = ends.bit_length()
            seg[v] = ([4 * (first + q * lay.stride) + lane
                       for q in range(cells) for lane in range(4)],
                      [q for q in range(cells) if ends >> q & 1])
    assert sorted(seg) == list(range(n))
    return seg


def _table_order(code, lay):
    """[m, D]: the edge slot d of ``row_idx`` that table slot d' of each
    check holds, -1 on a table slot with no edge."""
    perm = np.full((code.m, code.max_degree), -1)
    for c in range(code.m):
        for d2 in range(code.max_degree):
            v = lay.row[d2, c]
            if v < code.n:
                (d,) = np.flatnonzero(code.row_mask[c] & (code.row_idx[c] == v))
                perm[c, d2] = d
    return perm


@pytest.mark.parametrize("rate", RATES)
def test_every_check_has_two_real_edges(rate):
    """The sentinel argument of csrc/ldpc_bp_v1.cu needs >= 2 real edges a
    check, and D <= 7 slots."""
    code = get_code(rate)
    assert code.row_mask.sum(axis=1).min() >= 2 and code.max_degree <= 7


@pytest.mark.parametrize("rate", RATES)
def test_k2_cells_hold_each_variables_edges_grouped_by_slot(rate):
    """A variable's cells hold its edges in slot_tables' order (slot, then
    ascending check); each slot group starts a fresh cell, fills its lanes
    in order after at most 3 zero lanes, and ends in a cell the job marks;
    every other lane holds no message."""
    code, lay = _layout(rate)
    slot_ptr, slot_chk = K.slot_tables(code.row_idx, code.row_mask, code.n)
    D = code.max_degree
    perm = _table_order(code, lay)
    owner = np.full(lay.slots, -1)  # edge c * D + d held by each message slot
    for c in range(code.m):
        for d2 in range(D):
            if perm[c, d2] >= 0:
                assert owner[lay.epos[d2, c]] == -1
                owner[lay.epos[d2, c]] = c * D + perm[c, d2]
    assert np.count_nonzero(owner >= 0) == int(code.row_mask.sum())
    used = []
    for v, (slots, ends) in _jobs(lay, code.n).items():
        used += slots
        held = owner[slots].reshape(-1, 4)
        q, got_ends = 0, []
        for d in range(D):
            checks = slot_chk[slot_ptr[d, v] : slot_ptr[d, v + 1]]
            if not len(checks):
                continue
            assert np.all(np.diff(checks) > 0)
            cells = -(-len(checks) // 4)
            group = held[q : q + cells].reshape(-1)
            lead = int(np.argmax(group >= 0))
            assert lead <= 4 - len(checks) if len(checks) < 4 else lead == 0
            assert np.all(group[:lead] == -1) and np.all(group[lead + len(checks) :] == -1)
            assert np.array_equal(group[lead : lead + len(checks)], checks * D + d)
            q += cells
            got_ends.append(q - 1)
        assert q == len(held) and got_ends == ends
    assert len(set(used)) == len(used) and max(used, default=0) < lay.slots  # no cell shared


@pytest.mark.parametrize("rate", RATES)
def test_k2_int16_tables_and_job_packing_round_trip(rate):
    """Each check's table slots hold exactly its edges (in some order); the
    sentinel (variable n, message slot ``slots``) sits on the rest and only
    there; the jobs unpack to what they pack."""
    code, lay = _layout(rate)
    assert lay.row.dtype == np.int16 and lay.epos.dtype == np.int16
    assert lay.row.shape == lay.epos.shape == (code.max_degree, code.m)
    assert lay.jobs.dtype == np.int32 and lay.jobs.shape == (2, K.K2_THREADS)
    for c in range(code.m):
        got = lay.row[:, c]
        real = got < code.n
        assert np.array_equal(np.sort(got[real]), np.sort(code.row_idx[c][code.row_mask[c]]))
        assert real.sum() == code.row_mask[c].sum()
        assert np.all(got[~real] == code.n) and np.all(lay.epos[~real, c] == lay.slots)
        assert np.all(lay.epos[real, c] < lay.slots) and np.all(got >= 0)
    assert (code.n + lay.slots + 8) * 4 <= 65535 and lay.slots % 4 == 0
    for job in lay.jobs.reshape(-1):
        if job >= 0:
            v, first, ends = K.unpack_k2_job(int(job))
            assert int(job) == v | first << 10 | ends << 23


@pytest.mark.parametrize("rate", RATES)
def test_k2_variable_pass_is_balanced(rate):
    """A thread's chain of 128-bit loads per iteration (one per cell) is
    never longer than the heaviest variable's cells (7 at R1_4), and only
    one-cell variables are second jobs."""
    code, lay = _layout(rate)
    seg = _jobs(lay, code.n)
    cells = {v: len(slots) // 4 for v, (slots, _) in seg.items()}
    loads = np.zeros(K.K2_THREADS, int)
    for row in range(2):
        for t, job in enumerate(lay.jobs[row]):
            if job >= 0:
                v = K.unpack_k2_job(int(job))[0]
                loads[t] += cells[v]
                assert row == 0 or cells[v] <= 1
    assert loads.max() == max(cells.values())
    if rate == "R1_4":
        assert loads.max() == 7


def _emulate_new(rate, llr, fac, max_iters, precision="f32"):
    """The new K2's schedule, step by step, in float32 over a batch: slots
    with no edge gather the sentinel variable (+inf) and store to a trash
    slot, with no mask; the prologue's check update from the channel LLRs;
    then per iteration the grouped variable pass over the stored cells, the
    gather with v2c, parity and pass 1, the speculative next check update
    (after the vote in iteration 1, skipped on the last), and the vote,
    after which a converged row freezes.  ``"bf16"`` rounds where the bf16
    build's ``operand()`` does: the factor, each gathered LLR and each
    message the variable pass loads (the stored messages stay float32)."""
    rnd = _bf16 if precision == "bf16" else (lambda x: x)
    fac = rnd(fac)
    code, lay = _layout(rate)
    B, n = llr.shape
    row = torch.as_tensor(lay.row.T.astype(np.int64))      # [m, D], n on no-edge slots
    epos = torch.as_tensor(lay.epos.T.astype(np.int64))    # [m, D], slots on no-edge slots
    seg = _jobs(lay, n)
    width = max(len(s) for s, _ in seg.values())
    idx = torch.full((n, width), lay.slots + 1, dtype=torch.long)  # a slot that stays 0
    ends = torch.zeros((n, width // 4), dtype=torch.bool)
    for v, (slots, e) in seg.items():
        idx[v, : len(slots)] = torch.as_tensor(slots)
        ends[v, e] = True

    def gather(post):
        return rnd(torch.cat([post, torch.full((B, 1), torch.inf)], dim=1)[:, row])

    def update(v2c, msgs):  # pass 1, pass 2 and the stores
        a = v2c.abs()
        min1 = a.amin(dim=-1, keepdim=True)
        sign = v2c < 0
        odd = sign ^ (sign.sum(dim=-1, keepdim=True) % 2 == 1)
        is_min = a == min1
        min2 = torch.where(is_min, torch.inf, a).amin(dim=-1, keepdim=True)
        m1f = min1 * fac[:, None, None]
        tief = torch.where(is_min.sum(dim=-1, keepdim=True) > 1, min1, min2) * fac[:, None, None]
        mag = torch.where(is_min, tief, m1f)
        msgs = msgs.clone()
        msgs[:, epos] = torch.where(odd, -mag, mag)
        msgs[:, lay.slots :] = 0.0  # the trash cell holds any finite value
        return msgs

    def variable_pass(msgs):
        x = rnd(msgs[:, idx])                              # [B, n, width]
        acc = torch.zeros((B, n))
        s = torch.zeros((B, n))
        for q in range(width // 4):
            for lane in range(4):
                s = s + x[:, :, 4 * q + lane]
            acc = torch.where(ends[:, q], acc + s, acc)
            s = torch.where(ends[:, q], 0.0, s)
        return llr + acc

    msgs = torch.zeros((B, lay.slots + 4))
    post = llr.clone()
    if max_iters > 0:
        msgs = update(gather(post), msgs)
    live = torch.ones(B, dtype=torch.bool)
    ok = torch.zeros(B, dtype=torch.bool)
    iters = torch.zeros(B, dtype=torch.int32)
    for it in range(max_iters):
        post = torch.where(live[:, None], variable_pass(msgs), post)
        g = gather(post)
        v2c = torch.clamp(g - msgs[:, epos], -LLR_CLAMP, LLR_CLAMP)
        parity = ((g < 0).sum(dim=-1) % 2 == 1).any(dim=-1)
        iters = torch.where(live, it + 1, iters)
        ok |= live & ~parity
        live &= parity
        if it + 1 < max_iters:
            msgs = torch.where(live[:, None], update(v2c, msgs), msgs)
        if not live.any():
            break
    return (post[:, : code.k] < 0).to(torch.uint8), ok, iters, post


def _emulate_first_k2(rate, llr, fac, max_iters):
    """K2's first port, step by step, in float32 over a batch: slot-major planes
    under mask tests, the two-pass check update, and the posterior through
    the per-slot variable->check lists of ``slot_tables``: for each slot d
    a sum from 0.0 over the variable's checks in ascending order, added
    from 0.0 in slot order to the posterior's sum."""
    code = get_code(rate)
    B, n = llr.shape
    m, D = code.m, code.max_degree
    idx = torch.as_tensor(code.row_idx.T.astype(np.int64))  # [D, m]
    mask = torch.as_tensor(code.row_mask.T)
    slot_ptr, slot_chk = K.slot_tables(code.row_idx, code.row_mask, n)
    lists = []  # per slot: [n, longest list] indices into the plane, m on padding (0)
    for d in range(D):
        size = np.diff(slot_ptr[d])
        lst = torch.full((n, max(int(size.max()), 1)), m, dtype=torch.long)
        for v in np.flatnonzero(size):
            lst[v, : size[v]] = torch.as_tensor(slot_chk[slot_ptr[d, v] : slot_ptr[d, v + 1]])
        lists.append(lst)

    def check_update(v2c):  # v2c [B, D, m]
        a = v2c.abs()
        min1 = torch.where(mask, a, torch.inf).amin(dim=1, keepdim=True)
        neg = ((mask & (v2c < 0)).sum(dim=1, keepdim=True) % 2 == 1)
        eq = mask & (a == min1)
        ties = eq.sum(dim=1, keepdim=True)
        min2 = torch.where(mask & ~eq, a, torch.inf).amin(dim=1, keepdim=True)
        excl = torch.where(a == min1, torch.where(ties > 1, min1, min2), min1)
        sgn = torch.where(neg ^ (v2c < 0), -1.0, 1.0)
        return torch.where(mask, (sgn * excl) * fac[:, None, None], 0.0)

    v2c = torch.where(mask, llr[:, idx], 0.0)
    post = llr.clone()
    live = torch.ones(B, dtype=torch.bool)
    ok = torch.zeros(B, dtype=torch.bool)
    iters = torch.zeros(B, dtype=torch.int32)
    for it in range(max_iters):
        c2v = check_update(v2c)
        acc = torch.zeros((B, n))
        for d in range(D):
            plane = torch.cat([c2v[:, d], torch.zeros((B, 1))], dim=1)[:, lists[d]]
            s = torch.zeros((B, n))
            for j in range(plane.shape[-1]):
                s = s + plane[:, :, j]
            acc = acc + s
        post = torch.where(live[:, None], llr + acc, post)
        g = torch.where(mask, post[:, idx], 0.0)
        new = torch.where(mask, torch.clamp(g - c2v, -LLR_CLAMP, LLR_CLAMP), 0.0)
        parity = ((mask & (g < 0)).sum(dim=1) % 2 == 1).any(dim=-1)
        v2c = torch.where(live[:, None, None], new, v2c)
        iters = torch.where(live, it + 1, iters)
        ok |= live & ~parity
        live &= parity
        if not live.any():
            break
    return (post[:, : code.k] < 0).to(torch.uint8), ok, iters, post


def _assert_bits_equal(got, want):
    """Every output of every row equal, posteriors bit for bit."""
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)
    assert torch.equal(got[3].view(torch.int32), want[3].view(torch.int32))


@pytest.mark.parametrize("case", list(EMU_CASES))
def test_k2_schedule_emulation_is_bit_equal_to_first_k2_order(case):
    rate, make = EMU_CASES[case]
    llr = torch.as_tensor(make())
    fac = torch.as_tensor(np.resize(LADDER, llr.shape[0]))
    got = _emulate_new(rate, llr, fac, ITERS)
    _assert_bits_equal(got, _emulate_first_k2(rate, llr, fac, ITERS))
    if case == "signed_zeros":
        assert bool((torch.as_tensor(make()).view(torch.int32) == -2**31).any())
    # And plain_v1, which sums in K2's order: every output of every row.
    _assert_bits_equal(got, ldpc_decoder(rate, ITERS, "cpu").plain_v1(llr, fac))


@pytest.mark.parametrize("case", list(EMU_CASES) + ["off_grid_r14"])
def test_k2_bf16_schedule_emulation_is_bit_equal_to_plain_v1_bf16(case):
    """The bf16 build's schedule against ``plain_v1``'s bf16 mode, every
    output of every row bit for bit; ``off_grid_r14`` has per-row factors
    0.7 and 0.8, which bfloat16 rounds (the ladder's are exact in it)."""
    if case == "off_grid_r14":
        rate, llr = "R1_4", _awgn_llrs("R1_4", 3, 16, 0.0)
        fac = np.resize(np.float32([0.7, 0.8]), 16)
    else:
        rate, make = EMU_CASES[case]
        llr = make()
        fac = np.resize(LADDER, llr.shape[0])
    llr, fac = torch.as_tensor(llr), torch.as_tensor(fac)
    got = _emulate_new(rate, llr, fac, ITERS, "bf16")
    _assert_bits_equal(got, ldpc_decoder(rate, ITERS, "cpu", "bf16").plain_v1(llr, fac))
    assert not torch.equal(got[3], _emulate_new(rate, llr, fac, ITERS)[3]) or case == "clean_s7"


def test_emulations_cover_iterations_and_failures():
    """The cases run rows past iteration 1 and rows that never converge."""
    runs = []
    for rate, make in (EMU_CASES["noisy_s23"], EMU_CASES["noisy_r56"]):
        llr = torch.as_tensor(make())
        runs.append(_emulate_new(rate, llr, torch.as_tensor(np.resize(LADDER, len(llr))), ITERS))
    assert any((r[2] > 1).any() for r in runs) and any((~r[1]).any() for r in runs)


# sha256 of row, epos, jobs, then "slots stride", of the float32 tables,
# first 16 hex digits: K2's float32 tables as of commit 137700e.
F32_DIGESTS = {"R1_4": "8ef7a4038ed1d8ee", "R1_2": "979e347cce7b0777",
               "R2_3": "e699191f4b64effc", "R3_4": "665c4473b8995020",
               "R5_6": "94060785bf92ddbe"}


@pytest.mark.parametrize("rate", RATES)
def test_f32_tables_are_pinned(rate):
    from test_torch_ldpc_k1_tables import layout_digest

    code = get_code(rate)
    assert layout_digest(K.k2_layout(code.row_idx, code.row_mask, code.n)) == F32_DIGESTS[rate]


def _bf16_layout(rate):
    code = get_code(rate)
    return code, K.k2_layout(code.row_idx, code.row_mask, code.n, "bf16")


def _bf16_jobs(lay, n):
    """{variable: (its bfloat16 slots in the order the bf16 build reads
    them, 4 a unit, two units a cell; the units that end a group)}; a word
    job is one unit of its 2 slots and 2 that stay zero (-1)."""
    seg = {}
    for job in lay.jobs.reshape(-1):
        if job >= 0:
            v, first, ends = K.unpack_k2_job(int(job))
            assert v not in seg, v
            if not ends:
                seg[v] = ([2 * first, 2 * first + 1, -1, -1], [0])
                continue
            units = ends.bit_length()
            seg[v] = ([8 * (first + (u // 2) * lay.stride) + 4 * (u % 2) + lane
                       for u in range(units) for lane in range(4)],
                      [u for u in range(units) if ends >> u & 1])
    assert sorted(seg) == list(range(n))
    return seg


@pytest.mark.parametrize("rate", RATES)
def test_k2_bf16_cells_hold_each_variables_edges_grouped_by_slot(rate):
    """The bf16 tables: a variable's units hold its edges in slot_tables'
    order (slot, then ascending check), each slot group in fresh 4-slot
    units, two to a cell, ending in a unit the job marks; a variable of at
    most 2 edges holds them in one word, in that order; every other slot
    holds no message and no slot is shared."""
    code, lay = _bf16_layout(rate)
    slot_ptr, slot_chk = K.slot_tables(code.row_idx, code.row_mask, code.n)
    D = code.max_degree
    perm = _table_order(code, lay)
    owner = np.full(lay.slots, -1)
    for c in range(code.m):
        for d2 in range(D):
            if perm[c, d2] >= 0:
                assert owner[lay.epos[d2, c]] == -1
                owner[lay.epos[d2, c]] = c * D + perm[c, d2]
    assert np.count_nonzero(owner >= 0) == int(code.row_mask.sum())
    used, words = [], 0
    for v, (slots, ends) in _bf16_jobs(lay, code.n).items():
        real = [x for x in slots if x >= 0]
        used += real
        in_order = [c * D + d for d in range(D)
                    for c in slot_chk[slot_ptr[d, v] : slot_ptr[d, v + 1]]]
        if len(real) == 2:  # a word job
            words += 1
            assert len(in_order) <= 2
            assert list(owner[real][: len(in_order)]) == in_order
            assert np.all(owner[real][len(in_order) :] == -1)
            continue
        assert len(in_order) > 2
        held = owner[slots].reshape(-1, 4)
        q, got_ends = 0, []
        for d in range(D):
            checks = slot_chk[slot_ptr[d, v] : slot_ptr[d, v + 1]]
            if not len(checks):
                continue
            units = -(-len(checks) // 4)
            group = held[q : q + units].reshape(-1)
            lead = int(np.argmax(group >= 0))
            assert lead <= 4 - len(checks) if len(checks) < 4 else lead == 0
            assert np.all(group[:lead] == -1) and np.all(group[lead + len(checks) :] == -1)
            assert np.array_equal(group[lead : lead + len(checks)], checks * D + d)
            q += units
            got_ends.append(q - 1)
        assert q == len(held) and got_ends == ends
    assert len(set(used)) == len(used) and max(used) < lay.slots and lay.slots % 8 == 0
    base = K.k2_message_base(code.n, "bf16")
    assert base + 2 * lay.slots + 16 <= 65535 and base // 4 + lay.slots // 2 <= 8191
    if rate == "R1_4":  # 486 words; the heaviest variable reads 4 cells, not 7
        assert words == 486
        assert max(len(x) for x, _ in _bf16_jobs(lay, code.n).values()) == 4 * 7


def emulate_k2_bf16(rate, llr, fac, max_iters):
    """The bf16 build's schedule, step by step, over a batch, on its own
    tables: the factor rounded once; the update (K2's two passes) rounds m1f
    and tief once and stores each message as bfloat16 bits with its sign;
    the variable pass reads each variable's units, widened exactly, sums each
    slot group from 0.0 and adds it at the unit its ends bit marks, adds the
    channel LLR and rounds the posterior once, adding +0.0 (a rounded -0.0
    becomes +0.0); the gather reads those (+inf on the sentinel), rebuilds
    each float32 c2v from the check's state (m1f, tief, the slots equal to
    min1, the sign bits), clamps g - c2v and takes the parity and the
    check's sign bits from sign bits, where ``plain_v1`` compares with 0;
    the next update runs before the vote (after it in iteration 1), a
    converged row freezes."""
    from test_torch_ldpc_k1_tables import _round_bits, _widen

    fac = _bf16(fac)
    code, lay = _bf16_layout(rate)
    B, n = llr.shape
    row = torch.as_tensor(lay.row.T.astype(np.int64))
    epos = torch.as_tensor(lay.epos.T.astype(np.int64))
    seg = _bf16_jobs(lay, n)
    width = max(len(x) for x, _ in seg.values())
    idx = torch.full((n, width), lay.slots + 8, dtype=torch.long)  # a slot that stays 0
    ends = torch.zeros((n, width // 4), dtype=torch.bool)
    for v, (slots, e) in seg.items():
        idx[v, : len(slots)] = torch.as_tensor([x if x >= 0 else lay.slots + 8 for x in slots])
        ends[v, e] = True

    def gather(postr):
        return torch.cat([postr, torch.full((B, 1), torch.inf)], dim=1)[:, row]

    def update(v2c, msgs, sign):
        a = v2c.abs()
        min1 = a.amin(dim=-1, keepdim=True)
        odd = sign ^ (sign.sum(dim=-1, keepdim=True) % 2 == 1)
        is_min = a == min1
        min2 = torch.where(is_min, torch.inf, a).amin(dim=-1, keepdim=True)
        m1f = min1 * fac[:, None, None]
        tief = torch.where(is_min.sum(dim=-1, keepdim=True) > 1, min1, min2) * fac[:, None, None]
        h = torch.where(is_min, _round_bits(tief), _round_bits(m1f)) ^ (odd.int() << 15)
        msgs = msgs.clone()
        msgs[:, epos] = h
        return (m1f, tief, is_min, odd), msgs

    def variable_pass(msgs):
        x = _widen(msgs[:, idx])
        acc = torch.zeros((B, n))
        s = torch.zeros((B, n))
        for q in range(width // 4):
            for lane in range(4):
                s = s + x[:, :, 4 * q + lane]
            acc = torch.where(ends[:, q], acc + s, acc)
            s = torch.where(ends[:, q], 0.0, s)
        return llr + acc

    msgs = torch.zeros((B, lay.slots + 9), dtype=torch.int32)
    post = llr.clone()
    state = None
    if max_iters > 0:
        v2c = gather(_bf16(llr))
        state, msgs = update(v2c, msgs, v2c < 0)  # the channel LLRs may hold -0.0
    live = torch.ones(B, dtype=torch.bool)
    ok = torch.zeros(B, dtype=torch.bool)
    iters = torch.zeros(B, dtype=torch.int32)
    for it in range(max_iters):
        post = torch.where(live[:, None], variable_pass(msgs), post)
        g = gather(_bf16(post) + 0.0)
        m1f, tief, is_min, odd = state
        mag = torch.where(is_min, tief, m1f)
        v2c = torch.clamp(g - torch.where(odd, -mag, mag), -LLR_CLAMP, LLR_CLAMP)
        parity = (torch.signbit(g).sum(dim=-1) % 2 == 1).any(dim=-1)
        iters = torch.where(live, it + 1, iters)
        ok |= live & ~parity
        live &= parity
        if it + 1 < max_iters:
            nxt, new_msgs = update(v2c, msgs, torch.signbit(v2c))
            state = tuple(torch.where(live[:, None, None], a, b) for a, b in zip(nxt, state))
            msgs = torch.where(live[:, None], new_msgs, msgs)
        if not live.any():
            break
    return (post[:, : code.k] < 0).to(torch.uint8), ok, iters, post


@pytest.mark.parametrize("case", list(EMU_CASES) + ["off_grid_r14"])
def test_k2_bf16_hopper_schedule_emulation_is_bit_equal_to_plain_v1_bf16(case):
    """The bf16 build's schedule against ``plain_v1``'s bf16 mode: every
    output of every row bit for bit; ``off_grid_r14`` has per-row factors
    0.7 and 0.8, which the build rounds."""
    if case == "off_grid_r14":
        rate, llr = "R1_4", _awgn_llrs("R1_4", 3, 16, 0.0)
        fac = np.resize(np.float32([0.7, 0.8]), 16)
    else:
        rate, make = EMU_CASES[case]
        llr = make()
        fac = np.resize(LADDER, llr.shape[0])
    llr, fac = torch.as_tensor(llr), torch.as_tensor(fac)
    got = emulate_k2_bf16(rate, llr, fac, ITERS)
    _assert_bits_equal(got, ldpc_decoder(rate, ITERS, "cpu", "bf16").plain_v1(llr, fac))


def test_rounded_posterior_plus_zero_has_the_sign_k2_compares():
    """K2's bf16 build stores each rounded posterior plus +0.0 and reads
    ``g < 0`` as g's sign bit: on every non-NaN float32 of the sample (tiny
    negatives that round to -0.0 among them) the sign bit of
    ``round(x) + 0.0`` is ``round(x) < 0``, and its value is round(x)'s."""
    from test_torch_ldpc_k1_tables import sign_sample

    x = torch.as_tensor(np.concatenate([sign_sample(), -sign_sample(), np.float32([-1e-45])]))
    g = _bf16(x)
    assert bool((torch.signbit(g) & (g == 0)).any())  # rounded -0.0 occurs
    stored = g + 0.0
    assert torch.equal(torch.signbit(stored), g < 0)
    assert torch.equal(stored, g)  # equal as values (-0.0 == +0.0)
