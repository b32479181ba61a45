"""Full adaptive-session SNR sweep, the twin of ``tools/adaptive_session_sweep.py``
(BASELINE config #5).

Runs complete protocol sessions (chirp-synced PING handshake, CONNECT with
measured-SNR waveform selection, DATA, DISCONNECT) at a grid of SNRs from
the MC-DPSK floor to the coherent-QAM ceiling on a fading channel, with no
forced waveform, modulation or rate: the stack itself must pick a working
mode at every SNR (the reference's threaded_simulator dual-modem trace
scenario, SURVEY.md section 6 config #5).

Prints one line per SNR point: the negotiated link, messages delivered,
retransmissions and chase recoveries.  Exit 0 iff every point connects and
delivers every message.  Each session is ``tools/cli_simulator.py::
run_session`` on ``--device`` (default ``cuda``: without a card the command
raises).  The reference clears JAX's compiled executables after each point;
the port compiles nothing, and its module caches are bounded (the
detectors and demodulators at 64 entries a kind, the rest keyed by the
configurations the sweep meets), so nothing is cleared here.

Usage:
  python -m ria_tpu_torch.tools.adaptive_session_sweep                 # default grid
  python -m ria_tpu_torch.tools.adaptive_session_sweep --snrs -11,-5,5,15,25 --channel good
"""

from __future__ import annotations

import argparse
import sys
import time
import types

from ria_tpu_torch.tools.cli_simulator import run_session
from ria_tpu_torch.utils.device import resolve_device

# Default grid: the floor of each operating regime on its intended channel.
#   -8 dB  session floor on good fading with honest stationary noise:
#          PING + spread-4 CONNECT escalation territory
#   -5 dB  MC-DPSK 4x/2x
#    0 dB  MC-DPSK DBPSK
#    6 dB  MC-DPSK DQPSK
#   12 dB  OFDM DQPSK low rate
#   18 dB  OFDM DQPSK/QAM16 mid rate
#   25 dB  coherent QAM high rate
DEFAULT_SNRS = [-8.0, -5.0, 0.0, 6.0, 12.0, 18.0, 25.0]


def session_args(snr: float, channel: str, num_messages: int = 2, device="cuda"):
    """The namespace ``run_session`` takes for one point of the sweep."""
    return types.SimpleNamespace(snr=snr, channel=channel, waveform="AUTO", mod="AUTO",
                                 rate="AUTO", num_messages=num_messages, file=False,
                                 save_signals=None, device=device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--snrs", default=None,
                    help="comma-separated SNR grid (default: regime floors)")
    ap.add_argument("--channel", default="good",
                    choices=["awgn", "good", "moderate", "poor", "flutter"])
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--num-messages", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    snrs = [float(s) for s in args.snrs.split(",")] if args.snrs else DEFAULT_SNRS
    print(f"adaptive_session_sweep: channel={args.channel} seed={args.seed} snrs={snrs} "
          f"device {device}")

    rows, ok = [], True
    for snr in snrs:
        print(f"SNR {snr:+.0f} dB:")
        t0 = time.time()
        r = run_session(session_args(snr, args.channel, args.num_messages, device), args.seed)
        passed = r["connected"] and r["messages"] == args.num_messages
        ok &= passed
        rows.append((snr, r.get("final_link", r.get("link", "-")), r["messages"],
                     r.get("retransmissions", 0), r.get("chase", 0),
                     "PASS" if passed else "FAIL", time.time() - t0))

    print("\n  SNR   negotiated link              msgs retx chase  result")
    for snr, link, msgs, retx, chase, status, wall in rows:
        print(f"  {snr:+5.0f}  {link:28s} {msgs}/{args.num_messages}  "
              f"{retx:3d}  {chase:3d}   {status}  ({wall:.0f}s)")
    print("SWEEP:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
