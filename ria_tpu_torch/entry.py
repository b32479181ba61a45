"""The port's main path in one call: the MC-DPSK RX chain over a batch.

Twin of ``__graft_entry__.entry()`` and ``_make_batch``.  ``entry()`` returns
``(rx, (audio,))``: the batched RX pipeline and a batch of noisy frames for it.
The default is the small ``_tiny_cfg`` geometry of the CPU tests;
``production=True`` gives the geometry bench.py times as chain 1: 64 channels
of 10-carrier DBPSK, R1/4, 4 codewords per frame, a window of
``frame_samples(2592) + 12000`` = 207,328 samples, leads in [0, 8000) and
10 dB AWGN.
"""

from __future__ import annotations

import numpy as np
import torch

from ria_tpu_torch.fec.ldpc import make_encoder
from ria_tpu_torch.fec.ldpc_matrix import get_code
from ria_tpu_torch.phy.pipeline import LDPC_BITS, make_rx_pipeline, make_tx_pipeline
from ria_tpu_torch.sync.chirp import ChirpConfig
from ria_tpu_torch.utils.device import resolve_device
from ria_tpu_torch.wave.mc_dpsk import MCDPSKConfig

RATE = "R1_4"


def _tiny_cfg() -> MCDPSKConfig:
    """Small-geometry config so CPU runs are fast."""
    chirp = ChirpConfig(duration_ms=10.0, gap_ms=2.0)
    return MCDPSKConfig(num_carriers=4, samples_per_symbol=128,
                        bits_per_symbol=2, training_symbols=4, chirp=chirp)


def geometry(production: bool = False) -> tuple[MCDPSKConfig, int, int, int]:
    """(cfg, num_codewords, batch, window) of the tiny or production batch."""
    if production:
        cfg = MCDPSKConfig(num_carriers=10, bits_per_symbol=1)
        ncw, batch = 4, 64
        return cfg, ncw, batch, cfg.frame_samples(ncw * LDPC_BITS) + 12000
    cfg = _tiny_cfg()
    return cfg, 1, 4, cfg.frame_samples(LDPC_BITS) + 2048


def _make_batch(cfg: MCDPSKConfig, num_codewords: int, batch: int, window: int,
                seed: int = 0, production: bool = False,
                device: str | torch.device = "cuda") -> tuple[torch.Tensor, np.ndarray]:
    """TX a batch of frames (encoded random R1/4 codewords) into audio windows.

    Returns (audio [batch, window] f32 on ``device``, info bits
    [batch, num_codewords, k] uint8).  All randomness comes from
    ``np.random.default_rng(seed)``, drawn in the order of the reference's
    batch builders: info bits, then (production) one lead per channel, then
    the noise.  Tiny batches sit at lead 256 under N(0, 0.02) noise;
    production batches at leads in [0, 8000) under 10 dB AWGN.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    k = get_code(RATE).k
    info = rng.integers(0, 2, size=(batch * num_codewords, k)).astype(np.uint8)
    coded = make_encoder(RATE, dev)(torch.as_tensor(info, device=dev))
    tx = make_tx_pipeline(cfg, num_codewords, dev)(
        coded.reshape(batch, num_codewords * LDPC_BITS))
    audio = torch.zeros((batch, window), dtype=torch.float32, device=dev)
    for b in range(batch):
        lead = int(rng.integers(0, 8000)) if production else 256
        n = min(tx.shape[1], window - lead)
        audio[b, lead : lead + n] = tx[b, :n]
    if production:
        sigma = float(torch.sqrt(torch.mean(tx * tx))) * 10 ** (-10 / 20)
    else:
        sigma = 0.02
    audio += torch.as_tensor(rng.normal(0, sigma, audio.shape).astype(np.float32), device=dev)
    return audio, info.reshape(batch, num_codewords, k)


def entry(production: bool = False, device: str | torch.device = "cuda"):
    """(rx, (audio,)): the RX chain and a batch for it, on ``device`` (the
    card by default; ``device="cpu"`` for the host)."""
    cfg, ncw, batch, window = geometry(production)
    rx = make_rx_pipeline(cfg, RATE, ncw, window, device=device)
    audio, _ = _make_batch(cfg, ncw, batch, window, production=production, device=device)
    return rx, (audio,)
