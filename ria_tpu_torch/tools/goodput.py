"""Measured end-to-end session goodput, the twin of ``tools/goodput.py``.

Runs a full PING -> CONNECT -> bulk DATA session through ``DualStationSim``
with honest channel noise and measures DELIVERED payload bits per VIRTUAL
AIR SECOND: handshake, mode negotiation, ACK turnaround, ARQ retransmits
and half-duplex pacing all included (only the transfer window is timed,
from the first ``send_message`` to the last delivery, the reference's
session-throughput convention).

Reference proof points (include/ultra/types.hpp:354-365, high_throughput
preset, measured over its cli_simulator), :data:`ROWS`:
  AWGN 25 dB      -> 64-QAM R3/4  7.5 kbps  (100% of runs)
  Good 20 dB      -> 16-QAM R2/3  4.9 kbps  (96%)
  Moderate 20 dB  ->               2.7 kbps  (60%)

Stations and channels run on ``--device`` (default ``cuda``: without a card
the command raises).  The channels' normals come from ``draws`` (a pair of
sources, as ``DualStationSim`` takes them), by default two
``torch.Generator``s seeded ``seed`` and ``seed + 1``.

Usage: python -m ria_tpu_torch.tools.goodput [--channel awgn --snr 25]
           [--seeds 3] [--seed-base 100] [--bytes 4096] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ria_tpu_torch.tools.session_paths import Session, run_until
from ria_tpu_torch.utils.device import resolve_device

ROWS = [
    # (channel, snr, reference kbps, reference delivery rate)
    ("awgn", 25.0, 7.5, 1.00),
    ("good", 20.0, 4.9, 0.96),
    ("moderate", 20.0, 2.7, 0.60),
]
NOT_CONNECTED = {"connected": False, "goodput_bps": 0.0, "delivered": 0.0}


def transfer(sim, seed: int, payload_bytes: int = 4096, max_ticks: int = 3000,
             got: list | None = None):
    """The goodput session on ``sim`` (either package's ``DualStationSim``),
    one block per ``yield``; returns the result dict of
    :func:`measure_goodput`.  The chunks B delivers are appended to ``got``."""
    got = [] if got is None else got
    delivered_at: list[int] = []

    def _on_msg(m):
        got.append(m)
        delivered_at.append(sim.ticks)

    sim.bravo.conn.on_message = _on_msg
    if not sim.alpha.conn.connect("BRAVO"):
        return dict(NOT_CONNECTED)
    if not (yield from run_until(sim, sim.both_connected, 600)):
        return dict(NOT_CONNECTED)
    connect_ticks = sim.ticks

    # A deterministic bulk payload, chunked to the link's frame capacity.
    rng = np.random.default_rng(seed)
    payload = rng.integers(32, 127, payload_bytes, dtype=np.uint8).tobytes()
    cap = max(1, sim.alpha.conn.message_capacity())
    t_start = sim.ticks
    for i in range(0, len(payload), cap):
        sim.alpha.conn.send_message(payload[i : i + cap])

    want = len(payload)
    yield from run_until(sim, lambda: sum(len(m) for m in got) >= want, max_ticks)
    delivered = sum(len(m) for m in got)
    t_end = delivered_at[-1] if delivered_at else sim.ticks
    air_s = max(t_end - t_start, 1) * sim.block_ms / 1000.0
    link = sim.alpha.conn.link
    return {
        "connected": True,
        "goodput_bps": delivered * 8 / air_s,
        "delivered": delivered / want,
        "air_s": air_s,
        "connect_s": connect_ticks * sim.block_ms / 1000.0,
        "link": f"{link.waveform.name} {link.modulation} {link.rate} G{link.burst_group}",
        "retransmits": sim.alpha.conn.arq.stats.retransmissions,
    }


def session(channel: str, snr_db: float, seed: int) -> Session:
    """The goodput session as ``session_paths.lock_step`` runs it."""
    return Session(f"goodput {channel}({snr_db:g}) seed {seed}", channel, snr_db, seed,
                   "goodput", 0)


def make_sim(channel: str, snr_db: float, seed: int, device: str | torch.device = "cuda",
             draws=None):
    from ria_tpu_torch.sim.channel import PRESETS
    from ria_tpu_torch.sim.simulator import DualStationSim

    return DualStationSim(PRESETS[channel](snr_db), seed=seed, device=resolve_device(device),
                          draws=draws)


def measure_goodput(channel: str, snr_db: float, seed: int, payload_bytes: int = 4096,
                    max_ticks: int = 3000, draws=None,
                    device: str | torch.device = "cuda") -> dict:
    """One seeded bulk-transfer session -> {"connected", "goodput_bps"
    (delivered bits / virtual transfer seconds), "delivered" (fraction),
    "air_s", "connect_s", "link", "retransmits"}."""
    gen = transfer(make_sim(channel, snr_db, seed, device, draws), seed, payload_bytes,
                   max_ticks)
    try:
        while True:
            next(gen)
    except StopIteration as stop:
        return stop.value


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--channel", default=None)
    ap.add_argument("--snr", type=float, default=None)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--seed-base", type=int, default=100)
    ap.add_argument("--bytes", type=int, default=4096)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    rows = [(args.channel, args.snr, None, None)] if args.channel else ROWS
    for channel, snr, ref_kbps, ref_rate in rows:
        oks = 0
        bps: list[float] = []
        for s in range(args.seeds):
            r = measure_goodput(channel, snr, args.seed_base + s, args.bytes, device=device)
            full = r.get("delivered", 0.0) >= 1.0
            oks += full
            if full:
                bps.append(r["goodput_bps"])
            print(f"  {channel}@{snr:.0f} seed {args.seed_base + s}: "
                  f"{r['goodput_bps']:.0f} bps delivered={r.get('delivered', 0):.0%} "
                  f"link={r.get('link', '?')} connect={r.get('connect_s', 0):.1f}s")
        med = sorted(bps)[len(bps) // 2] if bps else 0.0
        refs = f" (reference {ref_kbps} kbps @ {ref_rate:.0%})" if ref_kbps else ""
        print(f"{channel} @ {snr:.0f} dB: {oks}/{args.seeds} delivered, "
              f"median {med:.0f} bps{refs}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
