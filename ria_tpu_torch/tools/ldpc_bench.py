"""A/B benchmark of the LDPC decoders of the port: K1, K2 and the plain decoder.

The twin of ``tools/pallas_bench.py``, which times the two Pallas TPU kernels
against the XLA decoder.  Run from the root of a checkout:

    python -m ria_tpu_torch.tools.ldpc_bench [--rate R1_4] [--batch 512]
        [--snr-db -1] [--reps 20] [--device cuda] [--decoders k1,k2,plain]

The LLRs follow the JAX tool's recipe (``np.random.default_rng(0)``: info
bits, encoder, BPSK plus N(0, sigma) with ``sigma = 10**(-snr/20)``,
``llr = 2y/sigma^2``), so they equal its LLRs bit for bit.  Decoders, all
with the fixed factor 0.75 and the rate's iteration count, as the JAX tool
runs them:

- ``k1``: kernel K1 (:func:`make_cuda_decoder`);
- ``k2``: kernel K2 (:func:`make_cuda_decoder_v1`);
- ``plain``: the plain PyTorch decoder (:func:`make_decoder_vf`; the port's
  ``make_decoder`` would launch K1 on a CUDA tensor).

The JAX tool's ``--tile`` is gone: both kernels run one codeword per thread
block and exit per codeword, so there is no tile to choose and no padding.
Each decoder gets 3 warm-up calls, then ``--reps`` calls between CUDA events
(on the CPU, between host clock reads).  One line per decoder gives the
success share ``ok=``, ``bitacc=`` on the successful rows, cw/s, ms/batch and
the mean iterations; then the speed-ups ``k1/plain`` and ``k2/k1``.
``--device cpu`` runs ``plain`` only, and says so: the kernels have no CPU
mode, and asking for ``k1`` or ``k2`` there raises.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from ria_tpu_torch.fec.ldpc import DecodeResult, make_decoder_vf
from ria_tpu_torch.fec.ldpc_cuda import make_cuda_decoder, make_cuda_decoder_v1
from ria_tpu_torch.fec.ldpc_matrix import MIN_SUM_FACTOR, encode_np, get_code
from ria_tpu_torch.utils.device import resolve_device


class Row(NamedTuple):
    result: DecodeResult  # of the first (checked) call
    ok: float             # share of rows that converged
    bitacc: float         # info-bit agreement on the converged rows
    ms: float             # per batch
    cw_per_s: float
    mean_iters: float


def make_llrs(rate: str, B: int, snr_db: float) -> tuple[np.ndarray, np.ndarray]:
    """(info bits [B, k] uint8, LLRs [B, 648] f32) by the JAX tool's recipe."""
    rng = np.random.default_rng(0)
    info = rng.integers(0, 2, (B, get_code(rate).k)).astype(np.uint8)
    coded = encode_np(info, rate).astype(np.float64)
    sigma = 10 ** (-snr_db / 20)
    y = (1 - 2.0 * coded) + rng.normal(0, sigma, coded.shape)
    return info, (2 * y / sigma**2).astype(np.float32)


def _plain(rate: str, device: torch.device):
    vf = make_decoder_vf(rate, device=device)

    def decode(llrs: torch.Tensor) -> DecodeResult:
        return vf(llrs, torch.full((llrs.shape[0],), MIN_SUM_FACTOR, device=llrs.device))

    return decode


DECODERS = {
    "k1": lambda rate, dev: make_cuda_decoder(rate, device=dev),
    "k2": lambda rate, dev: make_cuda_decoder_v1(rate, device=dev),
    "plain": _plain,
}


def _ms_per_call(fn, reps: int, device: torch.device) -> float:
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def run(argv=None) -> dict[str, Row]:
    """Parse ``argv``, time each decoder, print its line; returns the rows."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rate", default="R1_4")
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--snr-db", type=float, default=-1.0)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--decoders", default=None,
                    help="comma list of k1, k2, plain (default: all three on CUDA, "
                         "plain on the CPU)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if args.decoders is not None:
        names = args.decoders.split(",")
    elif dev.type == "cuda":
        names = ["k1", "k2", "plain"]
    else:
        names = ["plain"]
        print("device cpu: plain only (k1 and k2 are CUDA kernels with no CPU mode)")
    info, llr_np = make_llrs(args.rate, args.batch, args.snr_db)
    llr = torch.as_tensor(llr_np, device=dev)
    B = args.batch

    rows = {}
    for name in names:
        dec = DECODERS[name](args.rate, dev)
        r = dec(llr)
        ok = r.success.cpu().numpy()
        bits = r.info_bits.cpu().numpy()
        acc = float((bits[ok] == info[ok]).mean()) if ok.any() else 0.0
        for _ in range(3):
            dec(llr)
        ms = _ms_per_call(lambda: dec(llr), args.reps, dev)
        rows[name] = Row(r, float(ok.mean()), acc, ms, B / ms * 1e3,
                         float(r.iterations.float().mean()))
        print(f"{name:8s} ok={ok.mean():.3f} bitacc={acc:.5f} "
              f"{B / ms * 1e3:,.0f} cw/s ({ms:.4f} ms/batch) "
              f"mean_iters={rows[name].mean_iters:.2f}", flush=True)
    for a, b in (("k1", "plain"), ("k2", "k1")):
        if a in rows and b in rows:
            print(f"speedup {a}/{b}: {rows[b].ms / rows[a].ms:.2f}x")
    return rows


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
