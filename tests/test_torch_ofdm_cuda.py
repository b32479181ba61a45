"""The OFDM RX chains (bench.py chains 2 and 3) on the card (needs a GPU).

Imports no JAX, so it runs on a GPU host that has none:

    python -m pytest -q -m cuda tests/test_torch_ofdm_cuda.py

Without a card every test skips.  Each chain runs at its bench geometry and
B = 4 on the card and on the CPU (plain decoder) on the same audio:
``detected``, ``lts_start``, ``cw_success``, ``info_bits`` and
``iterations`` equal, ``cfo_hz`` and ``snr_db`` within 1e-3, the sent bits
back, and exactly one launch of K1 (none of K2) per call.  The CPU chain
itself is held against the JAX package by tests/test_torch_ofdm_pipeline.py.
"""

import numpy as np
import pytest
import torch

from ria_tpu_torch.entry import _make_ofdm_batch, ofdm_geometry
from ria_tpu_torch.phy.pipeline import make_ofdm_rx_pipeline
from ria_tpu_torch.utils import cuda_kernels
from ria_tpu_torch.wave import ofdm

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the chain decodes with K1, which is CUDA C++")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("config", [3, 4])
def test_chain_on_card_matches_cpu(config, cuda_device):
    geom = ofdm_geometry(config)
    audio, info = _make_ofdm_batch(geom, 4, seed=5, device="cpu")
    rx = make_ofdm_rx_pipeline(geom.cfg, geom.rate, geom.window, geom.ci_bits,
                               device=cuda_device)
    x = audio.to(cuda_device)
    rx(x)
    torch.cuda.synchronize()
    cuda_kernels.reset_launches()
    got = rx(x)
    torch.cuda.synchronize()
    assert (cuda_kernels.launches("ldpc_bp_decode"),
            cuda_kernels.launches("ldpc_bp_v1_decode")) == (1, 0)
    want = make_ofdm_rx_pipeline(geom.cfg, geom.rate, geom.window, geom.ci_bits,
                                 device="cpu")(audio)
    for name in ("detected", "lts_start", "cw_success", "info_bits", "iterations"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), name
    for name in ("cfo_hz", "snr_db"):
        assert torch.allclose(getattr(got, name).cpu(), getattr(want, name), rtol=0, atol=1e-3)
    assert got.cw_success.all()
    assert np.array_equal(got.info_bits.cpu().numpy(), info)


@pytest.mark.cuda
def test_sync_and_demod_modules_on_card(cuda_device):
    """The light-preamble LTS search and the LMS demodulator, which the bench
    chains do not run, on the card against the CPU."""
    cfg = ofdm.OFDMConfig(modulation="QAM16", use_pilots=True, pilot_spacing=5,
                          adaptive_eq=True)
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, 1296)
    tx = ofdm.tx_frame(bits, cfg, preamble="lts", tx_cfo_hz=3.0)
    audio = np.zeros((2, len(tx) + 4000), np.float32)
    audio[0, 700 : 700 + len(tx)] = tx
    audio[1, 1900 : 1900 + len(tx)] = tx
    audio += rng.normal(0, 0.05 * np.sqrt(np.mean(tx**2)), audio.shape).astype(np.float32)
    cpu = torch.as_tensor(audio)
    got = ofdm.lts_search(cpu.to(cuda_device), cfg)
    want = ofdm.lts_search(cpu, cfg)
    assert torch.equal(got.lts_start.cpu(), want.lts_start) and want.detected.all()
    assert torch.allclose(got.cfo_hz.cpu(), want.cfo_hz, rtol=0, atol=1e-3)
    S = cfg.num_symbols_for_bits(len(bits))
    need = (2 + S) * cfg.symbol_samples
    frames = torch.stack([cpu[b, int(s) : int(s) + need] for b, s in enumerate(want.lts_start)])
    d_got = ofdm.demodulate_presynced(frames.to(cuda_device), want.cfo_hz.to(cuda_device),
                                      cfg, S)
    d_want = ofdm.demodulate_presynced(frames, want.cfo_hz, cfg, S)
    assert torch.allclose(d_got.soft_bits.cpu(), d_want.soft_bits, rtol=0, atol=2e-3)
