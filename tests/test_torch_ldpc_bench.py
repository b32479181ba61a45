"""The LDPC A/B entry point of the port (``ria_tpu_torch.tools.ldpc_bench``).

Its LLRs must equal those of the JAX tool's recipe (tools/pallas_bench.py)
bit for bit; on the CPU it runs the plain decoder only, and asking for a
kernel there raises.
"""

import numpy as np
import pytest
import torch

from ria_tpu.fec.ldpc import make_encoder as jax_encoder
from ria_tpu_torch.fec import ldpc_kernel
from ria_tpu_torch.fec.ldpc import ldpc_decoder
from ria_tpu_torch.fec.ldpc_cuda import make_cuda_decoder, make_cuda_decoder_v1
from ria_tpu_torch.fec.ldpc_matrix import get_code
from ria_tpu_torch.tools import ldpc_bench

torch.set_num_threads(1)


@pytest.mark.parametrize("rate,snr_db", [("R1_4", -1.0), ("R3_4", 4.0)])
def test_make_llrs_matches_jax_recipe(rate, snr_db):
    """tools/pallas_bench.py:39-46, recomputed with the JAX encoder."""
    B = 24
    rng = np.random.default_rng(0)
    info = rng.integers(0, 2, (B, get_code(rate).k)).astype(np.uint8)
    coded = np.asarray(jax_encoder(rate)(info)).astype(np.float64)
    sigma = 10 ** (-snr_db / 20)
    y = (1 - 2.0 * coded) + rng.normal(0, sigma, coded.shape)
    want = (2 * y / sigma**2).astype(np.float32)
    got_info, got = ldpc_bench.make_llrs(rate, B, snr_db)
    assert got.dtype == np.float32 and np.array_equal(got, want)
    assert np.array_equal(got_info, info)


def test_main_on_cpu_runs_plain_only(capsys):
    assert ldpc_bench.main(["--device", "cpu", "--batch", "16", "--reps", "1"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("device cpu: plain only")
    assert len(out) == 2 and out[1].startswith("plain    ok=")
    assert "bitacc=" in out[1] and "cw/s" in out[1] and "ms/batch" in out[1]
    rows = ldpc_bench.run(["--device", "cpu", "--batch", "16", "--reps", "1"])
    assert list(rows) == ["plain"] and 0.5 < rows["plain"].ok <= 1.0
    assert rows["plain"].bitacc == 1.0


@pytest.mark.parametrize("kernel", ["k1", "k2"])
def test_kernels_on_cpu_raise(kernel):
    with pytest.raises(ValueError):
        ldpc_bench.main(["--device", "cpu", "--batch", "8", "--decoders", kernel])


def test_cuda_builders_take_no_cpu():
    for make in (make_cuda_decoder, make_cuda_decoder_v1):
        with pytest.raises(ValueError):
            make("R1_2", device="cpu")
    dec = ldpc_decoder("R1_2", 30, "cpu")
    with pytest.raises(ValueError):
        ldpc_kernel.bp_decode_v1(torch.zeros((2, 648)), torch.full((2,), 0.75), dec.k2,
                                 dec.k, 30)
