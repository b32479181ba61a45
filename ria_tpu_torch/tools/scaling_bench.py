"""Rank scaling of the sharded RX programs, the twin of ``tools/scaling_bench.py``.

Runs one program on 1, 2 and 4 ranks, one launch each
(:func:`ria_tpu_torch.parallel.launch.launch`), and reports its time per
call: the median of 5 calls on each rank (CUDA events on the card, the host
clock on the CPU), the slowest rank's median.

- default: the (ch x cw) batch mesh (``make_sharded_rx``), ``per_rank``
  channels a rank (weak scaling: 8 a rank at the small geometry, 16 with
  ``--full`` at the production one);
- ``--stream``: the time-block stream RX (``make_stream_rx``) on a fixed
  16 s production stream (strong scaling; ideal time = one rank's / n);
- ``--ofdm-stream``: the OFDM stream RX on a fixed ~10.9 s stream; it needs
  4 ranks, so fewer are reported as skipped.

Ranks sharing one card (``--backend gloo``, the default with fewer cards
than ranks) check the distributed program, not its scaling: they time-share
the card.  With a card per rank the default is NCCL.  The last line is a
JSON object of the rows.

    python -m ria_tpu_torch.tools.scaling_bench [--stream | --ofdm-stream]
        [--full] [--backend nccl|gloo] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ria_tpu_torch.fec.ldpc_matrix import encode_np, get_code
from ria_tpu_torch.parallel import distributed
from ria_tpu_torch.parallel.launch import launch
from ria_tpu_torch.phy.pipeline import make_tx_pipeline
from ria_tpu_torch.tools import parallel_paths as P
from ria_tpu_torch.utils.device import resolve_device
from ria_tpu_torch.wave.mc_dpsk import MCDPSKConfig
from ria_tpu_torch.wave.ofdm import OFDMConfig

RANK_COUNTS = (1, 2, 4)
REPS = 5  # timed calls a rank (the reference's iterations)


def _batch_case(cfg: MCDPSKConfig, ncw: int, B: int, window: int, rng: np.random.Generator):
    """The reference's batch for B channels: frames at sample 1,000 under
    10 dB AWGN, drawn from ``rng`` (info bits, then the noise)."""
    info = rng.integers(0, 2, (B * ncw, get_code(P.RATE).k)).astype(np.uint8)
    coded = encode_np(info, P.RATE).reshape(B, ncw * 648)
    tx = make_tx_pipeline(cfg, ncw, "cpu")(torch.as_tensor(coded)).numpy()
    audio = np.zeros((B, window), np.float32)
    audio[:, 1000 : 1000 + tx.shape[1]] = tx[:, : window - 1000]
    rms = float(np.sqrt(np.mean(tx**2)))
    audio += rng.normal(0, rms * 10 ** (-10 / 20), audio.shape).astype(np.float32)
    return audio


def _time(case: P.Case, x, n: int, reps: int, device, backend: str) -> tuple[float, dict]:
    """(the slowest rank's median ms per call, rank 0's result) of ``case``
    on n ranks."""
    outs = launch(P.run_rank, n, args=((case,), reps), device=device, backend=backend,
                  rank_args=[(d,) for d in P.rank_data([case], {case.name: x}, n)],
                  timeout_s=600.0)
    return max(o[case.name]["ms"] for o in outs), outs[0][case.name]["result"]


def run(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--stream", action="store_true")
    mode.add_argument("--ofdm-stream", action="store_true")
    ap.add_argument("--full", action="store_true",
                    help="production geometry for the batch mesh")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="default: nccl with a card per rank, else gloo")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    rows = []

    def report(n: int, backend: str, ms: float, label: str, **extra) -> None:
        rows.append({"ranks": n, "backend": backend, "ms": ms, **extra})
        print(f"ranks={n}  backend={backend}  {label}  {ms:8.2f} ms  "
              + "  ".join(f"{k}={v:.2f}" if isinstance(v, float) else f"{k}={v}"
                          for k, v in extra.items()), flush=True)

    if args.stream:
        cfg = MCDPSKConfig(num_carriers=10, bits_per_symbol=1)
        total = 8 * 96000
        stream, _ = P.mc_stream(cfg, 4, total, (150000,), 0.0, 10.0, seed=0)
        print(f"stream strong scaling: {total / 48000:.0f}s audio ({card})")
        base = None
        for n in RANK_COUNTS:
            backend = args.backend or distributed.choose_backend(dev, n)
            block = total // n
            case = P.Case("stream", "stream_rx", (cfg, P.RATE, 4, block, 1))
            ms, out = _time(case, stream, n, REPS, dev, backend)
            base = base or ms
            report(n, backend, ms, f"block={block}", msamp_per_s=total / ms / 1e3,
                   strong_eff=base / (n * ms), decode=float(np.mean(out["cw_success"])))
    elif args.ofdm_stream:
        cfg = OFDMConfig(modulation="DQPSK", use_pilots=False)
        rate, ci = "R1_2", cfg.bits_per_ofdm_symbol()
        total = 8 * 65536
        stream, _ = P.ofdm_stream(cfg, rate, total, 3 * 65536 - 3000, 15.0, seed=0)
        print(f"OFDM stream strong scaling: {total / 48000:.1f}s audio ({card})")
        for n in RANK_COUNTS:
            backend = args.backend or distributed.choose_backend(dev, n)
            block = total // n
            if n < 4:
                print(f"ranks={n}: skipped (the OFDM stream RX needs 4 ranks, one a codeword)")
                continue
            case = P.Case("ofdm stream", "ofdm_stream_rx", (cfg, rate, block, ci))
            ms, out = _time(case, stream, n, REPS, dev, backend)
            report(n, backend, ms, f"block={block}", msamp_per_s=total / ms / 1e3,
                   decode=float(np.mean(out["cw_success"])))
    else:
        if args.full:
            cfg, ncw, per_rank = MCDPSKConfig(num_carriers=10, bits_per_symbol=1), 4, 16
        else:
            cfg, ncw, per_rank = P._tiny_cfg(), 2, 8
        window = cfg.frame_samples(ncw * 648) + 4000
        rng = np.random.default_rng(0)
        print(f"batch mesh weak scaling: {per_rank} channels a rank, window {window} ({card})")
        base = None
        for n in RANK_COUNTS:
            backend = args.backend or distributed.choose_backend(dev, n)
            B = per_rank * n
            audio = _batch_case(cfg, ncw, B, window, rng)
            case = P.Case("batch", "mesh_rx", (cfg, P.RATE, ncw, window))
            ms, out = _time(case, audio, n, REPS, dev, backend)
            rate = B * window / ms * 1e3
            base = base or rate
            report(n, backend, ms, f"batch={B}", msamp_per_s=rate / 1e6,
                   scaling_eff=rate / (base * n), decode=float(out.cw_success.mean()))
    print(json.dumps({"scaling": rows, "card": card}))
    return rows


def stream_main(argv: list[str] | None = None) -> list[dict]:
    """The reference's ``stream_main``: :func:`run` with ``--stream`` (strong
    scaling of the time-block stream RX); ``argv`` adds options."""
    return run(["--stream", *(argv or [])])


def ofdm_stream_main(argv: list[str] | None = None) -> list[dict]:
    """The reference's ``ofdm_stream_main``: :func:`run` with
    ``--ofdm-stream``; ``argv`` adds options."""
    return run(["--ofdm-stream", *(argv or [])])


def main(argv: list[str] | None = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
