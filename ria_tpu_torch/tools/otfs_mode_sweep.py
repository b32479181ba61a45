"""OTFS mode x channel success matrix, the twin of ``tools/otfs_mode_sweep.py``
(the basis of ``phy/channel_probe.py``'s routing).

Frame success of OTFS_EQ (TF-equalized coherent QPSK with decision-directed
gain tracking), OTFS_RAW (DD differential, no equalization) and OFDM DQPSK
R1/2 over the ITU-R Good, Moderate and Poor presets at ``--snr-db``.  The
OTFS arms decode one R1/2 payload with ``LDPCCodec.decode_soft`` (K1 on the
card), the OFDM arm a fixed data frame with ``rx_frame``.

Everything runs on ``--device`` (default ``cuda``: without a card the
command raises).  The reference draws seed ``s``'s channel from
``jax.random.PRNGKey(s)``; here the normals come from ``draws(key, shape,
cfg)``, by default a ``torch.Generator`` seeded ``key``
(``acceptance_sweep.generator_draws``).

Usage: python -m ria_tpu_torch.tools.otfs_mode_sweep [--seeds 10] [--snr-db 20]
           [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ria_tpu_torch.tools.acceptance_sweep import generator_draws
from ria_tpu_torch.utils.device import resolve_device

PAYLOAD = b"OTFS PAYLOAD TEST!!!"
MODES = ("OTFS_EQ", "OTFS_RAW", "OFDM")
CHANNELS = ("good", "moderate", "poor")


def make_arms(device: str | torch.device = "cuda", draws=None) -> dict:
    """{mode: arm(seed, channel config) -> the payload came back}."""
    from ria_tpu_torch.fec.ldpc import LDPCCodec
    from ria_tpu_torch.phy.frame_v2 import WaveformMode, make_fixed_data_frame
    from ria_tpu_torch.sim.channel import apply_channel
    from ria_tpu_torch.utils.bits import bytes_to_bits
    from ria_tpu_torch.wave.api import create_waveform
    from ria_tpu_torch.wave.otfs import OTFSConfig, demodulate_presynced, tx_frame

    dev = resolve_device(device)
    draws = draws or generator_draws(dev)
    codec = LDPCCodec("R1_2", device=dev)
    bits = bytes_to_bits(codec.encode(PAYLOAD))

    def channel(audio, seed, ch):
        out = apply_channel(audio, ch, draws(seed, audio.shape, ch), device=dev)
        return out.samples.cpu().numpy()

    def otfs_once(cfg, seed, ch):
        tx = tx_frame(bits, cfg)
        audio = np.concatenate([np.zeros(2000, np.float32), tx, np.zeros(2000, np.float32)])
        out = channel(audio, seed, ch)
        res = demodulate_presynced(torch.as_tensor(out[2000:], device=dev),
                                   torch.zeros((), device=dev), cfg)
        soft = res.soft_bits.cpu().numpy()[: len(bits)]
        ok, dec = codec.decode_soft(soft)
        return bool(ok and dec[: len(PAYLOAD)] == PAYLOAD)

    def ofdm_once(seed, ch):
        wf = create_waveform(WaveformMode.OFDM_CHIRP, "DQPSK", "R1_2", device=dev)
        frame = make_fixed_data_frame("W1AW", "VE3ABC", seed, PAYLOAD, "R1_2")
        tx = wf.tx_frame(frame.serialize())
        audio = np.concatenate([np.zeros(4000, np.float32), tx, np.zeros(6000, np.float32)])
        return bool(wf.rx_frame(channel(audio, seed, ch)).ok)

    eq = OTFSConfig(modulation="QPSK", tf_equalization=True, phase_tracking=True)
    raw = OTFSConfig(dd_differential=True, tf_equalization=False)
    return {"OTFS_EQ": lambda s, ch: otfs_once(eq, s, ch),
            "OTFS_RAW": lambda s, ch: otfs_once(raw, s, ch),
            "OFDM": ofdm_once}


def sweep(seeds: int = 10, snr_db: float = 20.0, device: str | torch.device = "cuda",
          draws=None, log=print) -> dict:
    """{channel: {mode: per-seed success}}; prints the reference's table
    through ``log``, a row a channel."""
    from ria_tpu_torch.sim.channel import PRESETS

    arms = make_arms(device, draws)
    log(f"{'channel':10s} " + " ".join(f"{m:>9s}" for m in arms))
    table = {}
    for chname in CHANNELS:
        table[chname] = {m: [fn(s, PRESETS[chname](snr_db)) for s in range(seeds)]
                         for m, fn in arms.items()}
        log(f"{chname:10s} " + " ".join(f"{f'{sum(w)}/{seeds}':>9s}"
                                         for w in table[chname].values()))
    return table


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seeds", type=int, default=10)
    ap.add_argument("--snr-db", type=float, default=20.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    sweep(args.seeds, args.snr_db, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
