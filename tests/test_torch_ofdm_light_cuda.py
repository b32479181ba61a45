"""The OFDM chain behind the light preamble on the card (needs a GPU; every
test skips without one).  Imports no JAX:

    python -m pytest -q -m cuda tests/test_torch_ofdm_light_cuda.py

On the benchmark cell's traffic (``ofdm_dqpsk_r12.gw1024_awgn15``, cut to 64
channels a call and to one): every output of
``make_ofdm_rx_pipeline(..., preamble="lts")`` on the card equal to the
benchmark's frozen light chain on the card (``benchmark/reference/light.py``),
every frame found at its sent start and decoded to the sent bits, with one
``ofdm_demap`` and one K1 launch a call; and the LTS search dispatched with
no host synchronisation, counted in ``LTS_SEARCHES``.
"""

from pathlib import Path

import pytest
import torch

from ria_tpu_torch.utils import cuda_kernels
from ria_tpu_torch.wave import ofdm

ROOT = Path(__file__).resolve().parents[1]
CELL = "ofdm_dqpsk_r12.gw1024_awgn15"
SEED = 2**31 + 505


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the chain demaps and decodes with CUDA kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _cell(channels: int):
    from benchmark.harness import load_cell

    cell = load_cell(ROOT, CELL)
    cell.traffic.update(channels=channels, pool=1)
    return cell


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [64, 1])
def test_chain_equals_the_frozen_chain(cuda_device, channels):
    cell = _cell(channels)
    pool, sent = cell.generator.make_pool(cell.config, cell.traffic, SEED + channels,
                                          cuda_device)
    audio = pool[0].to(cuda_device)
    program = cell.entry.Program(cell.config, cell.traffic, cuda_device)
    with torch.no_grad():
        program(audio)                  # first call: libraries and lazy CUDA work
        demaps = cuda_kernels.launches("ofdm_demap")
        decodes = cuda_kernels.launches("ldpc_bp_decode")
        got = {k: v.cpu() for k, v in program(audio).items()}
        launched = (cuda_kernels.launches("ofdm_demap") - demaps,
                    cuda_kernels.launches("ldpc_bp_decode") - decodes)
        want = {k: v.cpu() for k, v in
                cell.entry.reference(cell.config, cell.traffic, cuda_device)(audio).items()}
    assert launched == (1, 1)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    assert bool(got["detected"].all())
    assert torch.equal(got["start"].long(), sent[0]["start"].long())
    assert bool(got["cw_success"].all())
    assert torch.equal(got["info_bits"], sent[0]["info_bits"])


@pytest.mark.cuda
def test_search_reads_nothing_back(cuda_device):
    cell = _cell(8)
    pool, sent = cell.generator.make_pool(cell.config, cell.traffic, SEED, cuda_device)
    audio = pool[0].to(cuda_device)
    rx = cell.entry.Program(cell.config, cell.traffic, cuda_device).rx
    with torch.no_grad():
        rx.sync(audio)
        torch.cuda.synchronize()
        ofdm.LTS_SEARCHES.clear()
        torch.cuda.set_sync_debug_mode("error")
        try:
            res = rx.sync(audio)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert dict(ofdm.LTS_SEARCHES) == {"searches": 1, "windows": 8}
    assert torch.equal(res.lts_start.cpu().long(), sent[0]["start"].long())
