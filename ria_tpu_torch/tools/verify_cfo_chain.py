"""CFO-chain verification, the twin of ``tools/verify_cfo_chain.py``.

Injects a known carrier frequency offset into an MC-DPSK frame, runs the
dual-chirp sync estimator, and checks that the phase slope of carrier 0's
baseband before and after the estimator's correction differs by the
estimate: the applied correction equals the measured one.  The pre- and
post-correction baseband can be dumped as ``.cf32``.

Sync and the analytic signal run on ``--device`` (default ``cuda``: without
a card the command raises; ``cpu`` runs on the host).

Usage: python -m ria_tpu_torch.tools.verify_cfo_chain [--device cpu] [--cfo 12.0]
           [--dump-prefix PATH]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ria_tpu_torch.utils.device import resolve_device


def phase_slope_hz(z: np.ndarray, sample_rate: float = 48000.0) -> float:
    """Average frequency of a complex baseband signal from its phase slope."""
    d = z[1:] * np.conj(z[:-1])
    return float(np.angle(np.sum(d)) * sample_rate / (2 * np.pi))


def measure(cfo_hz: float = 12.0, device: str | torch.device = "cuda",
            dump_prefix: str | None = None) -> dict:
    """The reference tool's chain for ``cfo_hz`` -> {"applied", "estimate",
    "slope_pre", "slope_post", "correction", "ok"} (Hz; ``ok`` the tool's
    PASS rule: the estimate within 3 Hz of the CFO and the correction
    within 0.5 Hz of the estimate)."""
    from ria_tpu_torch.dsp.hilbert import analytic_signal
    from ria_tpu_torch.dsp.nco import freq_shift_real
    from ria_tpu_torch.sync.chirp import detect_dual_chirp
    from ria_tpu_torch.wave.mc_dpsk import MCDPSKConfig, modulate, preamble

    dev = resolve_device(device)
    cfg = MCDPSKConfig()
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, 648)
    clean = np.concatenate([preamble(cfg), modulate(bits, cfg)])
    shifted, _ = freq_shift_real(torch.as_tensor(clean, dtype=torch.float32, device=dev),
                                 cfo_hz, cfg.sample_rate)
    audio = np.concatenate([np.zeros(4000, np.float32),
                            shifted.cpu().numpy().astype(np.float32),
                            np.zeros(4000, np.float32)])
    audio += rng.normal(0, 0.02, audio.shape).astype(np.float32)

    sync = detect_dual_chirp(torch.as_tensor(audio, device=dev), cfg.chirp)
    est = float(sync.cfo_hz)

    # Carrier-0 symbol-integrated phasors over the training symbols: carrier
    # 0's training phase is constant, and the integration rejects the others.
    start = int(sync.start) + cfg.chirp.total_samples
    sps = cfg.samples_per_symbol
    span = audio[start : start + cfg.training_symbols * sps]
    z = analytic_signal(torch.as_tensor(span, device=dev)).cpu().numpy()
    t = np.arange(len(z)) / cfg.sample_rate
    pre = z * np.exp(-2j * np.pi * cfg.carrier_freqs[0] * t)
    post = pre * np.exp(-2j * np.pi * est * t)
    if dump_prefix:
        pre.astype(np.complex64).tofile(dump_prefix + "_pre.cf32")
        post.astype(np.complex64).tofile(dump_prefix + "_post.cf32")

    slope_pre, slope_post = phase_slope_hz(pre), phase_slope_hz(post)
    correction = slope_pre - slope_post
    return {"applied": cfo_hz, "estimate": est, "slope_pre": slope_pre,
            "slope_post": slope_post, "correction": correction,
            "ok": abs(est - cfo_hz) < 3.0 and abs(correction - est) < 0.5}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--cfo", type=float, default=12.0)
    ap.add_argument("--dump-prefix", default=None)
    args = ap.parse_args(argv)

    r = measure(args.cfo, args.device, args.dump_prefix)
    print(f"applied CFO: {args.cfo:+.2f} Hz   dual-chirp estimate: {r['estimate']:+.2f} Hz")
    if args.dump_prefix:
        print(f"dumped {args.dump_prefix}_pre.cf32 / _post.cf32")
    print(f"phase slope pre-correction:  {r['slope_pre']:+.2f} Hz")
    print(f"phase slope post-correction: {r['slope_post']:+.2f} Hz")
    print(f"applied correction (pre-post): {r['correction']:+.2f} Hz "
          f"(expect {r['estimate']:+.2f})")
    print("PASS" if r["ok"] else "FAIL")
    return 0 if r["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
