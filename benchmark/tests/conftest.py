"""The benchmark's own tests: run from the root of a checkout with
``python -m pytest benchmark/tests``.  Tests that need a card carry the
``cuda`` marker and skip inside a fixture when none is present."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU (a CUDA kernel has no CPU mode); skips without one")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def copy_root(dest: Path, small: bool = True) -> Path:
    """A checkout holding ``BENCHMARK.json``, ``benchmark/`` and (linked)
    ``ria_tpu_torch/``; with ``small``, every traffic cut to a size the CPU
    runs in a second: 2 channels or 16 codewords a call, 2 calls in the
    pool, 2 traced calls."""
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (dest / "ria_tpu_torch").symlink_to(ROOT / "ria_tpu_torch")
    if small:
        for f in (dest / "benchmark" / "traffic").glob("*.json"):
            t = json.loads(f.read_text())
            t["channels" if "channels" in t else "codewords"] = 2 if "channels" in t else 16
            t.update(pool=2, trace_calls=2)
            f.write_text(json.dumps(t))
    return dest


def run_cpu(root: Path, workload: str, seed: int = 2**31 + 7, trace: int = 0) -> dict:
    """One run of a cell on the CPU, the harness's look for a card skipped."""
    import time

    from benchmark import harness

    return harness.run(["--workload", workload, "--seed", str(seed), "--seconds", "0.2",
                        "--trace", str(trace)], time.perf_counter(), root, device="cpu")
