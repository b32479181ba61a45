"""On the card: each cell's control (its reference one precision step down,
or the program's own bfloat16 path, as ``workloads/<cell>.json`` names it)
comes out not correct against the cell's limits on three seeds, and the
program comes out correct on the same seeds, at the cell's own size."""

import json

import pytest

from benchmark.tests.conftest import copy_root

CELLS = ["mcdpsk_r14.gw256_awgn0", "ofdm_dqpsk_r14.gw1024_awgn10",
         "mcdpsk_r14.decode512_m1db"]
SEEDS = [2**31 + 101, 2**31 + 102, 2**31 + 103]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_holds(cuda_device, tmp_path, cell):
    import torch

    from benchmark import calibrate, harness

    torch.backends.cuda.matmul.allow_tf32 = False
    root = copy_root(tmp_path, small=False)
    spec = json.loads((root / "benchmark" / "workloads" / f"{cell}.json").read_text())
    c = harness.load_cell(root, cell)
    for row in calibrate.readings(c, SEEDS, cuda_device, control=spec["control"]):
        assert any(row[k] > lim for k, lim in c.limits.items()), row
    for row in calibrate.readings(c, SEEDS, cuda_device):
        assert all(row[k] <= lim for k, lim in c.limits.items()), row
