"""The LDPC A/B entry point of the port (``ria_tpu_torch.tools.ldpc_bench``).

Its LLRs must equal those of the JAX tool's recipe (tools/pallas_bench.py)
bit for bit; on the CPU it runs the plain decoder only, and asking for a
kernel there raises.  ``--precision`` takes ``f32`` (the default, the
output as before) or ``bf16`` (the kernels' bf16 builds; plain stays f32).
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


def test_precision_parsing(monkeypatch):
    """``--precision`` defaults to f32 and takes f32 or bf16 only; each
    reaches the decoder factories."""
    seen = []
    plain = ldpc_bench.DECODERS["plain"]
    monkeypatch.setitem(ldpc_bench.DECODERS, "plain",
                        lambda rate, dev, precision: seen.append(precision) or plain(rate, dev,
                                                                                    precision))
    for argv in ([], ["--precision", "f32"], ["--precision", "bf16"]):
        ldpc_bench.run(["--device", "cpu", "--batch", "8", "--reps", "1", *argv])
    assert seen == ["f32", "f32", "bf16"]
    for bad in ("fp16", "bfloat16", ""):
        with pytest.raises(SystemExit):
            ldpc_bench.run(["--device", "cpu", "--precision", bad])


def test_main_on_cpu_bf16_runs_plain_f32_only(capsys):
    """``--device cpu --precision bf16``: plain only, float32, and it says so;
    its row equals the float32 run's."""
    argv = ["--device", "cpu", "--batch", "16", "--reps", "1"]
    assert ldpc_bench.main([*argv, "--precision", "bf16"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("device cpu: plain only")
    assert out[1] == "precision bf16: it picks the builds of k1 and k2; plain stays f32"
    assert len(out) == 3 and out[2].startswith("plain    ok=")
    rows = ldpc_bench.run([*argv, "--precision", "bf16"])
    want = ldpc_bench.run(argv)
    assert list(rows) == ["plain"]
    for a, b in zip(rows["plain"].result, want["plain"].result):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        ldpc_bench.main([*argv, "--precision", "bf16", "--decoders", "k2"])


@pytest.mark.parametrize("reps", [1, 4])
def test_rows_count_their_calls(monkeypatch, reps):
    """Each row's ``calls`` is the number of times its decoder ran: the
    checked call, 3 warm-up calls and ``--reps`` timed ones."""
    ran = []
    plain = ldpc_bench.DECODERS["plain"]

    def counted(rate, dev, precision):
        dec = plain(rate, dev, precision)
        return lambda llrs: ran.append(1) or dec(llrs)

    monkeypatch.setitem(ldpc_bench.DECODERS, "plain", counted)
    rows = ldpc_bench.run(["--device", "cpu", "--batch", "8", "--reps", str(reps)])
    assert rows["plain"].calls == len(ran) == 1 + 3 + reps
