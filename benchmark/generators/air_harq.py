"""Retransmissions on the air: every channel of a call holds ``copies``
transmissions of one MC-DPSK frame, each in a window of its own at its own
lead, under its own white Gaussian noise, as a gateway holds a NACKed
frame's first copy and its retransmissions.

Traffic parameters: ``channels`` a call, ``copies`` a channel, ``pool``
distinct calls, ``snr_db`` (each copy's noise power against the mean power
of the call's frames), ``max_lead`` (each copy's lead uniform in [0,
max_lead)).  From ``seed``: a numpy generator draws the info bits of every
codeword, then every lead, a generator on the device draws the noise.  Each
frame is built once by ``air.py``'s frozen MC-DPSK TX and sent ``copies``
times.  The pool, [channels, copies, window] a call, lies in pinned host
memory.

Beside each call it keeps what was sent, for the check: every codeword's
``info_bits`` [channels, codewords, k] and every copy's ``start``
[channels, copies], the sample of its chirp's start.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.generators import air
from benchmark.reference import ldpc_matrix


def make_pool(cfg: dict, traffic: dict, seed: int,
              device: torch.device) -> tuple[list[torch.Tensor], list[dict]]:
    if cfg["waveform"] != "mcdpsk":
        raise ValueError(f"{cfg['name']}: air_harq sends MC-DPSK frames")
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    B, R, ncw = traffic["channels"], traffic["copies"], cfg["codewords_per_frame"]
    window = cfg["window_samples"]
    code = ldpc_matrix.get_code(cfg["rate"])
    pool, sent = [], []
    for _ in range(traffic["pool"]):
        info = rng.integers(0, 2, (B * ncw, code.k), dtype=np.uint8)
        coded = ldpc_matrix.encode_np(info, cfg["rate"])
        tx = air._mcdpsk_tx(cfg, coded.reshape(B, ncw * code.n), device)
        leads = rng.integers(0, traffic["max_lead"], (B, R))
        if int(leads.max()) + tx.shape[1] > window:
            raise ValueError(f"a frame at lead {int(leads.max())} overruns the window")
        idx = (torch.as_tensor(leads, device=device)[..., None]
               + torch.arange(tx.shape[1], device=device))
        audio = torch.zeros((B, R, window), dtype=torch.float32, device=device)
        audio.scatter_(2, idx, tx[:, None, :].expand(B, R, -1))
        sigma = float(torch.sqrt(torch.mean(tx * tx))) * 10 ** (-traffic["snr_db"] / 20)
        audio += sigma * torch.randn((B, R, window), generator=gen, device=device)
        pool.append(audio.cpu().pin_memory() if device.type == "cuda" else audio)
        sent.append({"info_bits": torch.from_numpy(info.reshape(B, ncw, code.k)),
                     "start": torch.as_tensor(leads)})
    return pool, sent
