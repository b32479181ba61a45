"""One HARQ round with chase combining on the card (needs a GPU; every test
skips without one).  Imports no JAX:

    python -m pytest -q -m cuda tests/test_torch_harq_cuda.py

On the benchmark cell's traffic (``mcdpsk_s4_r14.harq64x2_m19db``, cut to 8
channels a call): the round's outcome on the card equal bit for bit to its
CPU path on the same LLRs (``chase_round`` with the plain decoder, K1's
computation) for 1, 2 and 4 copies, with one K1 launch in ``rx.decode``
and copies - 1 in ``rx.chase``; no host synchronisation inside
``forward``; and the round against the benchmark's plain round on the card.
"""

from pathlib import Path

import pytest
import torch

from ria_tpu_torch.fec.chase import chase_round
from ria_tpu_torch.fec.ldpc import ldpc_decoder
from ria_tpu_torch.fec.ldpc_matrix import RECOMMENDED_ITERS
from ria_tpu_torch.phy import pipeline
from ria_tpu_torch.utils import cuda_kernels

ROOT = Path(__file__).resolve().parents[1]
CELL = "mcdpsk_s4_r14.harq64x2_m19db"
SEED = 2**31 + 404
K1 = "ldpc_bp_decode"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the round decodes with kernel K1")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _cell(copies: int):
    from benchmark.harness import load_cell

    cell = load_cell(ROOT, CELL)
    cell.traffic.update(channels=8, copies=copies, pool=1)
    return cell


def _cpu_decode(llrs: torch.Tensor):
    factors = torch.full((llrs.shape[0],), 0.75, dtype=torch.float32)
    return ldpc_decoder("R1_4", RECOMMENDED_ITERS["R1_4"], torch.device("cpu"))(llrs, factors)


@pytest.mark.cuda
@pytest.mark.parametrize("copies", [1, 2, 4])
def test_round_equals_its_cpu_path(cuda_device, monkeypatch, copies):
    cell = _cell(copies)
    pool, _ = cell.generator.make_pool(cell.config, cell.traffic, SEED + copies, cuda_device)
    program = cell.entry.Program(cell.config, cell.traffic, cuda_device)
    seen = {}
    real = pipeline.chase_round

    def counted(llrs, received, alone, decode):
        seen["decode"] = cuda_kernels.launches(K1) - seen["start"]
        out = real(llrs, received, alone, decode)
        seen["chase"] = cuda_kernels.launches(K1) - seen["start"] - seen["decode"]
        seen["inputs"] = (llrs.cpu(), received.cpu())
        return out

    monkeypatch.setattr(pipeline, "chase_round", counted)
    with torch.no_grad():
        seen["start"] = cuda_kernels.launches(K1)
        got = {k: v.cpu() for k, v in program(pool[0].to(cuda_device)).items()}
    assert (seen["decode"], seen["chase"]) == (1, copies - 1)
    llrs, received = seen["inputs"]
    want = chase_round(llrs, received, _cpu_decode(llrs.reshape(-1, 648)), _cpu_decode)
    for name, w in zip(want._fields, want):
        assert got[name].dtype == w.dtype and torch.equal(got[name], w), name
    assert bool(received.any())


@pytest.mark.cuda
def test_no_host_sync_inside_forward(cuda_device):
    cell = _cell(2)
    pool, _ = cell.generator.make_pool(cell.config, cell.traffic, SEED, cuda_device)
    program = cell.entry.Program(cell.config, cell.traffic, cuda_device)
    audio = pool[0].to(cuda_device)
    with torch.no_grad():
        program(audio)                  # first call: libraries and lazy CUDA work
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = program(audio)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert out["source"].shape == (8, 4)


@pytest.mark.cuda
def test_round_equals_the_plain_round(cuda_device):
    cell = _cell(2)
    pool, sent = cell.generator.make_pool(cell.config, cell.traffic, SEED + 9, cuda_device)
    with torch.no_grad():
        got = {k: v.cpu() for k, v in
               cell.entry.Program(cell.config, cell.traffic, cuda_device)(
                   pool[0].to(cuda_device)).items()}
        want = {k: v.cpu() for k, v in
                cell.entry.reference(cell.config, cell.traffic, cuda_device)(
                    pool[0].to(cuda_device)).items()}
    numbers = cell.entry.compare([got], [want], sent)
    assert all(v <= cell.limits[k] for k, v in numbers.items()), numbers
    assert numbers["cw_mismatch"] == 0 and numbers["sync_mismatch"] == 0
