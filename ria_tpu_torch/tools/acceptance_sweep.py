"""Rate-selection acceptance sweep, the twin of ``tools/acceptance_sweep.py``
(reference waveform_selection.hpp:33-48).

Re-validates the reference's seed-matrix proof points: fourteen cases, each
a waveform-level loopback (sync + demod + LDPC decode of a data frame)
through a preset channel, ``--seeds`` seeds a case:

- OFDM DQPSK R3/4 at AWGN 20 dB, R2/3 at Good 20 dB, R1/2 at Good 15 dB,
  R1/4 at Good 10 dB;
- the MC-DPSK floors: DBPSK at -4 dB, DQPSK at +5 dB, DBPSK with 2x and
  4x spreading at -8 dB (AWGN);
- OFDM QAM16 R1/2 at 18 dB, QAM32 R3/4 at 22 dB, OFDM-COX QAM64 R3/4 at
  25 dB;
- the coherent OFDM-COX rows: QPSK R1/2 at 20 dB, QAM16 R3/4 at 25 dB,
  QAM32 R3/4 at 30 dB.

A case passes when every seed decodes its payload, or all but one on the
fading channels (a slow Rayleigh dip can swallow a whole frame at any code
rate; ARQ handles it in sessions).

Everything runs on ``--device`` (default ``cuda``: without a card the
command raises).  The reference draws seed ``s``'s channel from
``jax.random.PRNGKey(1000 + s)``; here the channel's standard normals come
from ``draws(key, shape, cfg)``, by default a ``torch.Generator`` seeded
``key`` (:func:`generator_draws`), so a seed's channel is the port's own
unless a caller replays the reference's keys.

Usage: python -m ria_tpu_torch.tools.acceptance_sweep [--seeds 5] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
from dataclasses import dataclass

import numpy as np
import torch

from ria_tpu_torch.utils.device import resolve_device

PAYLOAD = b"acceptance sweep payload for seeds!"
KEY_BASE = 1000  # seed s draws its channel from key KEY_BASE + s


@dataclass(frozen=True)
class Case:
    name: str
    mode: str             # a WaveformMode name
    modulation: str
    rate: str
    snr_db: float
    channel: str          # a preset of sim.channel.PRESETS
    fixed_frame: bool     # a fixed 4-codeword frame at ``rate`` (else a DataFrame)
    spreading: int = 1
    one_outage: bool = False  # fading: all seeds but one must pass

    def need(self, seeds: int) -> int:
        return seeds - 1 if self.one_outage else seeds


CASES = (
    Case("OFDM DQPSK R3/4 AWGN 20dB", "OFDM_CHIRP", "DQPSK", "R3_4", 20.0, "awgn", True),
    Case("OFDM DQPSK R2/3 Good 20dB", "OFDM_CHIRP", "DQPSK", "R2_3", 20.0, "good", True,
         one_outage=True),
    Case("OFDM DQPSK R1/2 Good 15dB", "OFDM_CHIRP", "DQPSK", "R1_2", 15.0, "good", True,
         one_outage=True),
    Case("OFDM DQPSK R1/4 Good 10dB", "OFDM_CHIRP", "DQPSK", "R1_4", 10.0, "good", True,
         one_outage=True),
    Case("MC-DPSK DBPSK R1/4 AWGN -4dB (floor)", "MC_DPSK", "DBPSK", "R1_4", -4.0, "awgn",
         False),
    Case("MC-DPSK DQPSK R1/4 AWGN +5dB (floor)", "MC_DPSK", "DQPSK", "R1_4", 5.0, "awgn",
         False),
    Case("MC-DPSK DBPSK 2x R1/4 AWGN -8dB (floor)", "MC_DPSK", "DBPSK", "R1_4", -8.0, "awgn",
         False, spreading=2),
    Case("MC-DPSK DBPSK 4x R1/4 AWGN -8dB", "MC_DPSK", "DBPSK", "R1_4", -8.0, "awgn", False,
         spreading=4),
    Case("OFDM QAM16 R1/2 AWGN 18dB", "OFDM_CHIRP", "QAM16", "R1_2", 18.0, "awgn", True),
    Case("OFDM QAM32 R3/4 AWGN 22dB", "OFDM_CHIRP", "QAM32", "R3_4", 22.0, "awgn", True),
    Case("OFDM QAM64 R3/4 AWGN 25dB", "OFDM_COX", "QAM64", "R3_4", 25.0, "awgn", True),
    Case("COX coherent QPSK R1/2 AWGN 20dB", "OFDM_COX", "QPSK", "R1_2", 20.0, "awgn", True),
    Case("COX coherent 16QAM R3/4 AWGN 25dB", "OFDM_COX", "QAM16", "R3_4", 25.0, "awgn", True),
    Case("COX coherent 32QAM R3/4 AWGN 30dB", "OFDM_COX", "QAM32", "R3_4", 30.0, "awgn", True),
)


def generator_draws(device: str | torch.device = "cuda",
                    generator_device: str | torch.device | None = None):
    """``draws(key, shape, cfg)``: one :func:`~ria_tpu_torch.sim.channel.apply_channel`
    call's normals from a ``torch.Generator`` seeded ``key`` on
    ``generator_device`` (default ``device``), moved to ``device``."""
    from ria_tpu_torch.sim.channel import GeneratorDraws

    def draws(key: int, shape: tuple, cfg):
        return GeneratorDraws(key, device, generator_device).block(shape, cfg)

    return draws


def make_waveform(case: Case, device):
    from ria_tpu_torch.phy.frame_v2 import WaveformMode
    from ria_tpu_torch.wave.api import create_waveform

    kw = {"spreading": case.spreading} if case.spreading > 1 else {}
    return create_waveform(WaveformMode[case.mode], case.modulation, case.rate,
                           device=device, **kw)


def run_case(case: Case, seeds: int, device: str | torch.device = "cuda", draws=None,
             log=print) -> dict:
    """``seeds`` loopbacks of ``case`` -> {"name", "passes", "seeds", "need",
    "passed", "outcomes": per seed whether the payload came back,
    "frames": per seed the decoded frame bytes (None where the frame
    failed its CRC)}.  Prints the reference's line through ``log``."""
    from ria_tpu_torch.phy.frame_v2 import DataFrame, make_fixed_data_frame
    from ria_tpu_torch.sim.channel import PRESETS, apply_channel

    dev = resolve_device(device)
    draws = draws or generator_draws(dev)
    wf = make_waveform(case, dev)
    outcomes, frames = [], []
    for s in range(seeds):
        if case.fixed_frame:
            frame = make_fixed_data_frame("W1AW", "VE3ABC", s, PAYLOAD, case.rate)
        else:
            frame = DataFrame.make_data("W1AW", "VE3ABC", s, PAYLOAD)
        tx = wf.tx_frame(frame.serialize())
        audio = np.concatenate([np.zeros(4000, np.float32), tx, np.zeros(6000, np.float32)])
        ch = PRESETS[case.channel](case.snr_db)
        out = apply_channel(audio, ch, draws(KEY_BASE + s, audio.shape, ch), device=dev)
        rx = wf.rx_frame(out.samples.cpu().numpy())
        ok = rx.ok
        if ok:
            g = DataFrame.deserialize(rx.frame_bytes)
            ok = g is not None and g.payload.rstrip(b"\x00")[: len(PAYLOAD)] == PAYLOAD
        outcomes.append(bool(ok))
        frames.append(rx.frame_bytes if rx.ok else None)
    passes, need = sum(outcomes), case.need(seeds)
    log(f"{case.name:44s} {passes}/{seeds} {'PASS' if passes >= need else 'FAIL'}")
    return {"name": case.name, "passes": passes, "seeds": seeds, "need": need,
            "passed": passes >= need, "outcomes": outcomes, "frames": frames}


def sweep(seeds: int = 5, device: str | torch.device = "cuda", draws=None, cases=CASES,
          log=print) -> list[dict]:
    return [run_case(c, seeds, device, draws, log) for c in cases]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    ok = all(r["passed"] for r in sweep(args.seeds, args.device))
    print("SWEEP:", "ALL PASS" if ok else "FAILURES PRESENT")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
