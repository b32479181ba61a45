"""The single-frame waveform paths on the card (needs a GPU).

Imports no JAX, so it runs on a GPU host that has none:

    python -m pytest -q -m cuda tests/test_torch_waveform_paths_cuda.py

Without a card every test skips.  Each path of
``ria_tpu_torch.tools.waveform_paths`` runs at B = 64 on the card and on
the CPU on the same audio: detected, start, frame type and success equal,
CFO and SNR within 1e-3, soft bits within 2e-3; detection and
``cw_decode_rate`` at least 0.95 with the sent bits back; exactly one K1
launch (and no K2 launch) per decode call.  The CPU paths themselves are
held against the JAX package by tests/test_torch_waveform_paths.py.
"""

import numpy as np
import pytest
import torch

from ria_tpu_torch.tools import waveform_paths as W
from ria_tpu_torch.utils import cuda_kernels

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the paths decode with K1, which is CUDA C++")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", W.DECODE_PATHS)
def test_path_on_card_matches_cpu(name, cuda_device):
    batch = W.make_path_batch(name, W.BATCH, seed=0, device="cpu")
    (audio,) = batch.inputs
    path = W.make_path(name)
    x = audio.to(cuda_device)
    path(x)
    torch.cuda.synchronize()
    cuda_kernels.reset_launches()
    got = path(x)
    torch.cuda.synchronize()
    assert (cuda_kernels.launches("ldpc_bp_decode"),
            cuda_kernels.launches("ldpc_bp_v1_decode")) == (1, 0)
    want = path(audio)
    for field in ("detected", "start", "frame_type", "cw_success"):
        assert torch.equal(getattr(got, field).cpu(), getattr(want, field)), field
    for field in ("cfo_hz", "snr_db"):
        assert torch.allclose(getattr(got, field).cpu(), getattr(want, field), rtol=0, atol=1e-3)
    assert float((got.soft_bits.cpu() - want.soft_bits).abs().max()) <= 2e-3
    ok = got.cw_success.cpu().numpy()
    assert got.detected.float().mean() >= 0.95 and ok.mean() >= 0.95
    assert np.array_equal(got.info_bits.cpu().numpy()[ok], batch.info[ok])


@pytest.mark.cuda
def test_sync_path_on_card_matches_cpu(cuda_device):
    batch = W.make_path_batch("css_zc_sync", W.BATCH, seed=0, device="cpu")
    path = W.make_path("css_zc_sync")
    got = path(*(x.to(cuda_device) for x in batch.inputs))
    want = path(*batch.inputs)
    for g, w, col in ((got.zc, want.zc, 0), (got.css, want.css, 1)):
        for field in ("detected", "frame_type", "start_sample"):
            assert torch.equal(getattr(g, field).cpu(), getattr(w, field)), field
        assert torch.allclose(g.correlation.cpu(), w.correlation, rtol=0, atol=1e-3)
        hit = (g.detected.cpu().numpy() & (g.frame_type.cpu().numpy() == batch.frame_types[:, col]))
        assert hit.mean() >= 0.95
    assert torch.allclose(got.zc.cfo_hz.cpu(), want.zc.cfo_hz, rtol=0, atol=1e-3)
