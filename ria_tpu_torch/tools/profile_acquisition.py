"""Acquisition and decode latency, the twin of ``tools/profile_acquisition.py``.

Milliseconds per call, on ``--device``, of:

- the dual-chirp sync search over a 120,000-sample window x B;
- the ZC sync search over a 48,000-sample window x B;
- the MC-DPSK demodulation of a 4-codeword frame x B;
- the OFDM demodulation (``demodulate_presynced``) of a 4-codeword DQPSK
  frame x B;
- the Schmidl-Cox search over a 48,000-sample window x B;
- the R1/4 LDPC decode of 4B noise codewords (K1 on the card).

Each call cycles through distinct input buffers (white noise from
``numpy.random.default_rng(0)``), after one warm-up call a buffer.  On the
card the calls are timed by CUDA events (``utils/timing.py::cuda_ms``, the
median of its windows); on the CPU by the host clock.  The default device
is the card: without one the command raises.

Usage: python -m ria_tpu_torch.tools.profile_acquisition [--batch 32]
           [--iters 12] [--device cpu]
"""

from __future__ import annotations

import argparse
import itertools
import time

import numpy as np
import torch

from ria_tpu_torch.utils.device import resolve_device

NBUF = 4  # distinct input buffers a row cycles through


def _time(fn, make_arg, dev: torch.device, iters: int, windows: int = 3) -> float:
    """Milliseconds per call of ``fn`` over NBUF distinct buffers of
    ``make_arg()`` on ``dev``: CUDA events on the card (median of
    ``windows`` windows of ``iters`` calls), the host clock on the CPU."""
    from ria_tpu_torch.utils.timing import cuda_ms

    bufs = [torch.as_tensor(make_arg(), device=dev) for _ in range(NBUF)]
    for b in bufs:
        fn(b)
    cycle = itertools.cycle(bufs)
    if dev.type == "cuda":
        return cuda_ms(lambda: fn(next(cycle)), iters, windows)[0]
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(next(cycle))
    return (time.perf_counter() - t0) / iters * 1e3


def profile(batch: int = 32, iters: int = 12, device: str | torch.device = "cuda",
            log=print) -> dict:
    """The six rows -> {row: ms per call}, each printed through ``log`` as
    it is measured."""
    from ria_tpu_torch.fec.ldpc import make_decoder
    from ria_tpu_torch.sync.chirp import detect_dual_chirp
    from ria_tpu_torch.sync.zc import ZCConfig, detect as zc_detect
    from ria_tpu_torch.wave.mc_dpsk import MCDPSKConfig, demodulate
    from ria_tpu_torch.wave.ofdm import OFDMConfig, demodulate_presynced, schmidl_cox_search

    dev = resolve_device(device)
    B = batch
    rng = np.random.default_rng(0)
    clock = "CUDA events" if dev.type == "cuda" else "host clock"
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    log(f"device: {name}  batch: {B}  ({clock})")
    out = {}

    mc = MCDPSKConfig()
    dt = _time(lambda x: detect_dual_chirp(x, mc.chirp),
               lambda: rng.normal(0, 0.1, (B, 120000)).astype(np.float32), dev, iters)
    out["chirp_sync_120k"] = dt
    log(f"chirp sync   120k window x{B}: {dt:8.2f} ms  ({B * 120000 / dt / 1e3:8.1f} Msamp/s)")

    def mk48():
        return rng.normal(0, 0.1, (B, 48000)).astype(np.float32)

    dt = _time(lambda x: zc_detect(x, ZCConfig()), mk48, dev, iters)
    out["zc_sync_48k"] = dt
    log(f"ZC sync       48k window x{B}: {dt:8.2f} ms  ({B * 48000 / dt / 1e3:8.1f} Msamp/s)")

    nsym = mc.num_data_symbols(4 * 648)
    need = (mc.training_symbols + 1 + nsym) * mc.samples_per_symbol
    cfo = torch.zeros(B, device=dev)
    dt = _time(lambda f: demodulate(f, cfo, mc, nsym),
               lambda: rng.normal(0, 0.1, (B, need)).astype(np.float32), dev, iters)
    out["mc_dpsk_demod_4cw"] = dt
    log(f"mc-dpsk demod 4-CW frame x{B}: {dt:8.2f} ms")

    of = OFDMConfig()
    S = of.num_symbols_for_bits(4 * 648)
    need = (2 + S) * of.symbol_samples
    dt = _time(lambda f: demodulate_presynced(f, cfo, of, S, 2),
               lambda: rng.normal(0, 0.1, (B, need)).astype(np.float32), dev, iters)
    out["ofdm_demod_4cw"] = dt
    log(f"ofdm demod    4-CW frame x{B}: {dt:8.2f} ms")

    dt = _time(lambda x: schmidl_cox_search(x, of), mk48, dev, iters)
    out["schmidl_cox_48k"] = dt
    log(f"schmidl-cox   48k window x{B}: {dt:8.2f} ms")

    dec = make_decoder("R1_4", device=dev)
    dt = _time(dec, lambda: rng.normal(0, 4, (B * 4, 648)).astype(np.float32), dev, iters)
    out["ldpc_r14_4b"] = dt
    log(f"ldpc R1/4     {B * 4} cw (noise): {dt:8.2f} ms")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--iters", type=int, default=12, help="calls a timing window")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    profile(args.batch, args.iters, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
