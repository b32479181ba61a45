"""Channel LLRs of codewords sent over BPSK and white Gaussian noise, the
recipe of ``ria_tpu_torch/tools/ldpc_bench.py`` (frozen): info bits,
the frozen LDPC encoder, ``y = 1 - 2c + N(0, sigma)`` with
``sigma = 10 ** (-snr_db / 20)`` and ``llr = 2 y / sigma ** 2``.

Traffic parameters: ``codewords`` a call, ``pool`` distinct calls,
``snr_db``.  Everything is drawn from ``seed`` by one numpy generator; the
pool lies in pinned host memory.  Beside each call it keeps the sent
``info_bits`` [codewords, k], for the check.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import ldpc_matrix


def make_pool(cfg: dict, traffic: dict, seed: int, device: torch.device) -> tuple[list[torch.Tensor], list[dict]]:
    rng = np.random.default_rng(seed)
    B, rate = traffic["codewords"], cfg["rate"]
    k = ldpc_matrix.get_code(rate).k
    sigma = 10 ** (-traffic["snr_db"] / 20)
    pool, sent = [], []
    for _ in range(traffic["pool"]):
        info = rng.integers(0, 2, (B, k)).astype(np.uint8)
        coded = ldpc_matrix.encode_np(info, rate).astype(np.float64)
        y = (1 - 2.0 * coded) + rng.normal(0, sigma, coded.shape)
        llr = torch.from_numpy((2 * y / sigma**2).astype(np.float32))
        pool.append(llr.pin_memory() if device.type == "cuda" else llr)
        sent.append({"info_bits": torch.from_numpy(info)})
    return pool, sent
