"""The scale-out programs on the card (needs a GPU).

Imports no JAX, so it runs on a GPU host that has none:

    python -m pytest -q -m cuda tests/test_torch_parallel_cuda.py

Without a card every test skips.  Four ranks on the card (gloo when they
share one card, NCCL with a card each) run G1 (the batch mesh on bench.py's
chain-1 batch, 16 rows a rank) and G3 (the production stream RX, its frame's
chirp straddling the first block boundary) of
``ria_tpu_torch.tools.parallel_paths``.  Each rank holds every K1 launch of
its call against the plain decoder on the same LLRs; every rank launches K1
and none launches K2; the results equal the single-process port on the card
(decisions exact, CFO and SNR within 1e-3, soft bits within 2e-3) and the
bits sent.  The CPU side is held against the JAX package by
tests/test_torch_parallel.py.
"""

import pytest
import torch

from ria_tpu_torch.parallel.launch import launch
from ria_tpu_torch.tools import parallel_paths as P

torch.set_num_threads(1)

N = P.RANKS


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: every decode of every rank is K1, which is CUDA C++")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def run(cuda_device):
    cases, data, sent = P.production_cases(N, device=cuda_device)
    cases = [c for c in cases if c.name in ("G1", "G3")]
    outs = launch(P.run_rank, N, args=(cases, 0), device=cuda_device, timeout_s=300.0,
                  rank_args=[(d,) for d in P.rank_data(cases, data, N)])
    return {c.name: c for c in cases}, data, sent, outs


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["G1", "G3"])
def test_every_rank_decodes_through_k1(run, name):
    _, _, _, outs = run
    for r, out in enumerate(outs):
        res = out[name]
        assert res["k1_launches"] >= 1 and res["k2_launches"] == 0, (name, r)
        assert len(res["k1_calls"]) == res["k1_launches"], (name, r)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["G1", "G3"])
def test_ranks_equal_the_single_process_port(run, cuda_device, name):
    cases, data, sent, outs = run
    case = cases[name]
    P.same_on_every_rank(name, [o[name]["result"] for o in outs])
    got = outs[0][name]["result"]
    P.hold_single(case, got, P.single_process(case, data[name], got, N, cuda_device))
    P.check_sent(case, got, sent[name])
