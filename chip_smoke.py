#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``ria_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with one CUDA card visible:

    python3 chip_smoke.py

It builds the LDPC kernels K1 (``ria_tpu_torch/csrc/ldpc_bp.cu``) and K2
(``ria_tpu_torch/csrc/ldpc_bp_v1.cu``) from the checkout's sources and runs
eight phases, each printing its lines and raising on failure:

1. device: the card's name and power limit, as nvidia-smi gives them;
2. build: nvcc for sm_90a, both sources at once, with each build time and
   ptxas resource lines;
3. kernels vs plain: K1 against the plain PyTorch decoder, and K2 against
   its plain version (``plain_v1``) and against K1, on the card, for every
   rate at B = 8 and 256 and for R1/4 at B = 512 (mixed difficulty);
4. main path: the MC-DPSK RX chain at the bench.py chain-1 geometry (64
   channels, window 207,328, R1/4, 4 codewords, 10 dB AWGN) from the port's
   own TX, checked against the transmitted bits and against the same chain
   on the CPU, with K1's launch count from that run;
5. A/B entry point: ``ria_tpu_torch.tools.ldpc_bench`` at its default size
   (R1/4, B = 512, -1 dB), K1, K2 and the plain decoder reporting the same
   success set and bit accuracy, with K2's launch count from that run; then
   K1 and K2 against their plain versions on those LLRs;
6. serving layer on the card: ``LDPCCodec`` round trips for every rate,
   ``decode_with_retries`` in at most two K1 launches and
   ``decode_candidates``, each equal to the CPU port's result;
7. timing with CUDA events: the RX chain in samples/s; K1 against the plain
   decoder and K2 against ``plain_v1`` and K1, at B = 256 (the main path's
   codewords), B = 512 mixed and the A/B entry point's LLRs; each kernel's
   device time per launch from torch.profiler;
8. a JSON line of the kernels, then the last line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Any failure ends the run with a non-zero exit code and no result line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

RATES_SIGMA = {"R1_4": 2.4, "R1_2": 1.8, "R2_3": 1.5, "R3_4": 1.4, "R5_6": 1.4}
FACTORS = np.array([0.9375, 0.875, 0.75, 0.625, 0.5], np.float32)
LLR_ATOL = 1e-3
MIXED_MAX_FLIPS = 0.01  # share of rows of the B = 512 mixed batch
BENCH_ARGS = ["--rate", "R1_4", "--batch", "512", "--snr-db", "-1", "--reps", "20"]


def log(msg: str) -> None:
    print(msg, flush=True)


def llr_batch(rate: str, B: int, rng: np.random.Generator, mixed: bool = False):
    """(llrs [B, 648], factors [B]) from encoded random codewords: amplitude-4
    LLRs plus Gaussian noise; the mixed batch is bench.py's LDPC batch (half
    the rows at sigma 2.6, near the decode floor)."""
    from ria_tpu_torch.fec.ldpc_matrix import encode_np, get_code

    info = rng.integers(0, 2, (B, get_code(rate).k))
    coded = encode_np(info, rate).astype(np.float32)
    llr = (1.0 - 2.0 * coded) * 4.0
    if mixed:
        noise = rng.normal(0, 1.0, llr.shape).astype(np.float32)
        noise[B // 2 :] = rng.normal(0, 2.6, (B - B // 2, llr.shape[1])).astype(np.float32)
    else:
        noise = rng.normal(0, RATES_SIGMA[rate], llr.shape).astype(np.float32)
    return llr + noise, np.resize(FACTORS, B)


def bpsk_llrs(rate: str, seed: int, B: int, sigma: float) -> np.ndarray:
    """BPSK over AWGN, LLR = 2y/sigma^2 (tests/test_torch_ldpc_serving.py)."""
    from ria_tpu_torch.fec.ldpc_matrix import encode_np, get_code

    rng = np.random.default_rng(seed)
    info = rng.integers(0, 2, (B, get_code(rate).k)).astype(np.uint8)
    y = (1 - 2.0 * encode_np(info, rate).astype(np.float64)) + rng.normal(0, sigma, (B, 648))
    return (2 * y / sigma**2).astype(np.float32)


def compare(ref, got):
    """(rows that disagree, max |llr| error on rows both converged).  A row
    disagrees when success differs, or, converged in both, when its info
    bits or iteration count differ or its posterior is off by > LLR_ATOL."""
    s_ref, s_got = ref.success.cpu(), got.success.cpu()
    both = s_ref & s_got
    err = (ref.llr_total.cpu() - got.llr_total.cpu()).abs().amax(dim=1)
    bad = s_ref != s_got
    bad |= both & (ref.iterations.cpu() != got.iterations.cpu())
    bad |= both & (ref.info_bits.cpu() != got.info_bits.cpu()).any(dim=1)
    bad |= both & (err > LLR_ATOL)
    max_err = float(err[both].max()) if bool(both.any()) else 0.0
    return int(bad.sum()), max_err


def cuda_ms(fn, reps: int, windows: int = 7) -> tuple[float, float, float]:
    """(median, min, max) over ``windows`` windows of the milliseconds per
    call of ``fn`` on the card, each window timed by CUDA events around
    ``reps`` calls."""
    per_call = []
    for _ in range(windows):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        per_call.append(start.elapsed_time(end) / reps)
    return float(np.median(per_call)), min(per_call), max(per_call)


def device_us(fn, kernel: str, reps: int = 20) -> float | None:
    """Device microseconds per launch of the CUDA kernel whose name holds
    ``kernel``, from torch.profiler over ``reps`` calls of ``fn``; None when
    the trace shows no such kernel."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if kernel in e.key]
    count = sum(e.count for e in events)
    return sum(e.device_time_total for e in events) / count if count else None


def main() -> int:
    # -- 1. device ------------------------------------------------------------
    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is False; a CUDA card is required")
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()
    card = smi[0].strip()
    kind = torch.cuda.get_device_name(0)
    log(f"[1 device] {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} visible")
    log(card)
    dev = torch.device("cuda", 0)

    from ria_tpu_torch.entry import RATE, _make_batch, geometry
    from ria_tpu_torch.fec import ldpc as L
    from ria_tpu_torch.fec import ldpc_kernel
    from ria_tpu_torch.fec.ldpc import ldpc_decoder
    from ria_tpu_torch.fec.ldpc_cuda import make_cuda_decoder_v1
    from ria_tpu_torch.fec.ldpc_matrix import CODE_PARAMS, MIN_SUM_FACTOR
    from ria_tpu_torch.phy.pipeline import make_rx_pipeline
    from ria_tpu_torch.tools import ldpc_bench

    # -- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    builds = ldpc_kernel.build()
    log(f"[2 build] {len(builds)} libraries in {time.perf_counter() - t0:.2f} s")
    for b in builds.values():
        log(f"[2 build] {b.path.name}: nvcc {b.seconds:.2f} s")
        for line in b.log.splitlines():
            if "registers" in line or "bytes stack" in line:
                log(f"  ptxas: {line.strip()}")

    # -- 3. kernels vs plain, on the card -------------------------------------
    rng = np.random.default_rng(1234)
    max_err = {"K1": 0.0, "K2": 0.0}
    cases = [(rate, B, False) for rate in CODE_PARAMS for B in (8, 256)] + [(RATE, 512, True)]
    for rate, B, mixed in cases:
        llr, fac = llr_batch(rate, B, rng, mixed)
        dec = ldpc_decoder(rate, None, dev)
        x, f = torch.as_tensor(llr, device=dev), torch.as_tensor(fac, device=dev)
        k1 = dec(x, f)
        k2 = make_cuda_decoder_v1(rate, device=dev)(x, f)
        plain, plain_v1 = dec.plain(x, f), dec.plain_v1(x, f)
        torch.cuda.synchronize()
        allowed = int(MIXED_MAX_FLIPS * B) if mixed else 0
        tag = f"{rate} B={B}{' mixed' if mixed else ''}"
        for name, ref_name, ref, got in (("K1", "plain", plain, k1),
                                         ("K2", "plain_v1", plain_v1, k2),
                                         ("K2", "K1", k1, k2)):
            n_bad, err = compare(ref, got)
            if ref_name.startswith("plain"):
                max_err[name] = max(max_err[name], err)
            log(f"[3 kernels] {tag}: {name} vs {ref_name}: success {int(got.success.sum())}/{B} "
                f"({ref_name} {int(ref.success.sum())}), mean iterations "
                f"{got.iterations.float().mean():.2f}, rows differing {n_bad} "
                f"(allowed {allowed}), max |llr err| {err:.3g}")
            if n_bad > allowed:
                raise AssertionError(f"{name} disagrees with {ref_name} on {n_bad} rows ({tag})")

    # -- 4. main path ---------------------------------------------------------
    cfg, ncw, batch, window = geometry(production=True)
    audio, info = _make_batch(cfg, ncw, batch, window, seed=0, production=True, device=dev)
    rx = make_rx_pipeline(cfg, RATE, ncw, window, device=dev)
    torch.cuda.synchronize()
    ldpc_kernel.LAUNCHES = ldpc_kernel.LAUNCHES_V1 = 0
    out = rx(audio)
    torch.cuda.synchronize()
    launches = ldpc_kernel.LAUNCHES
    det = out.detected.cpu().numpy()
    ok = out.cw_success.cpu().numpy()
    bits = out.info_bits.cpu().numpy()
    log(f"[4 main path] B={batch} window={window}: detected {int(det.sum())}/{batch}, "
        f"cw_decode_rate {ok.mean():.4f}, K1 launches {launches}")
    if out.info_bits.shape != (batch, ncw, info.shape[-1]):
        raise AssertionError(f"info_bits shape {tuple(out.info_bits.shape)}")
    if not torch.isfinite(out.snr_db).all() or not torch.isfinite(out.cfo_hz).all():
        raise AssertionError("non-finite snr_db or cfo_hz")
    if not det.all():
        raise AssertionError(f"only {int(det.sum())}/{batch} channels detected")
    if ok.mean() < 0.95:
        raise AssertionError(f"cw_decode_rate {ok.mean():.4f} < 0.95")
    if not (bits == info)[ok].all():
        raise AssertionError("decoded info bits differ from the transmitted bits")
    if launches < 1:
        raise AssertionError("the main path did not launch K1")
    # The same chain on the CPU (the plain decoder), on the same audio.
    cpu = make_rx_pipeline(cfg, RATE, ncw, window, device="cpu")(audio.cpu())
    for name in ("detected", "start", "cw_success", "info_bits", "iterations"):
        if not torch.equal(getattr(cpu, name), getattr(out, name).cpu()):
            raise AssertionError(f"{name} differs between the card and the CPU")
    cfo_err = float((cpu.cfo_hz - out.cfo_hz.cpu()).abs().max())
    snr_err = float((cpu.snr_db - out.snr_db.cpu()).abs().max())
    log(f"[4 main path] card vs CPU: detected/start/cw_success/info_bits/iterations equal, "
        f"max |cfo err| {cfo_err:.3g} Hz, max |snr err| {snr_err:.3g} dB")
    if cfo_err > 1e-3 or snr_err > 1e-3:
        raise AssertionError("cfo_hz or snr_db differs between the card and the CPU")

    # -- 5. A/B entry point ---------------------------------------------------
    log(f"[5 A/B] python -m ria_tpu_torch.tools.ldpc_bench {' '.join(BENCH_ARGS)}")
    ldpc_kernel.LAUNCHES = ldpc_kernel.LAUNCHES_V1 = 0
    rows = ldpc_bench.run(BENCH_ARGS)
    torch.cuda.synchronize()
    launches_v1, launches_ab = ldpc_kernel.LAUNCHES_V1, ldpc_kernel.LAUNCHES
    log(f"[5 A/B] K1 launches {launches_ab}, K2 launches {launches_v1}")
    if list(rows) != ["k1", "k2", "plain"]:
        raise AssertionError(f"ldpc_bench ran {list(rows)}")
    success = {name: row.result.success.cpu() for name, row in rows.items()}
    for name in ("k2", "plain"):
        if not torch.equal(success[name], success["k1"]):
            raise AssertionError(f"ldpc_bench: {name}'s success set differs from k1's")
        if rows[name].bitacc != rows["k1"].bitacc:
            raise AssertionError(f"ldpc_bench: {name}'s bitacc differs from k1's")
    # At -1 dB a few rows converge to another codeword, so bitacc may sit below 1.
    if not (rows["k1"].ok > 0.5 and rows["k1"].bitacc > 0.99):
        raise AssertionError(f"ldpc_bench: ok={rows['k1'].ok}, bitacc={rows['k1'].bitacc}")
    if launches_v1 < 1 or launches_ab < 1:
        raise AssertionError("the A/B entry point did not launch both kernels")
    # Each kernel against its plain version on the entry point's own LLRs.
    ab_llr = torch.as_tensor(ldpc_bench.make_llrs("R1_4", 512, -1.0)[1], device=dev)
    ab_fac = torch.full((512,), MIN_SUM_FACTOR, device=dev)
    allowed = int(MIXED_MAX_FLIPS * 512)
    for name, ref_name, ref in (
            ("k1", "plain", rows["plain"].result),
            ("k2", "plain_v1", ldpc_decoder("R1_4", None, dev).plain_v1(ab_llr, ab_fac))):
        n_bad, err = compare(ref, rows[name].result)
        max_err[name.upper()] = max(max_err[name.upper()], err)
        log(f"[5 A/B] {name} vs {ref_name}: rows differing {n_bad} (allowed {allowed}), "
            f"max |llr err| {err:.3g}")
        if n_bad > allowed:
            raise AssertionError(f"ldpc_bench: {name} disagrees with {ref_name} on {n_bad} rows")

    # -- 6. serving layer on the card -----------------------------------------
    ldpc_kernel.LAUNCHES = ldpc_kernel.LAUNCHES_V1 = 0
    data = bytes(range(40))
    for rate in CODE_PARAMS:
        codec = L.LDPCCodec(rate, device=dev)
        ok_rt, decoded = codec.decode_hard(codec.encode(data))
        if not ok_rt or decoded[: len(data)] != data:
            raise AssertionError(f"LDPCCodec({rate}) on the card: round trip failed")
    log(f"[6 serving] LDPCCodec round trip on the card for {len(CODE_PARAMS)} rates, "
        f"K1 launches {ldpc_kernel.LAUNCHES}")
    llr = bpsk_llrs("R1_2", 5, 4, 10 ** (1.2 / 20))
    before = ldpc_kernel.LAUNCHES
    got = L.decode_with_retries(llr, "R1_2", device=dev)
    torch.cuda.synchronize()
    retry_launches = ldpc_kernel.LAUNCHES - before
    n_bad, err = compare(L.decode_with_retries(llr, "R1_2"), got)
    log(f"[6 serving] decode_with_retries R1/2 B=4: success {int(got.success.sum())}/4, "
        f"K1 launches {retry_launches}, rows differing from the CPU port {n_bad}, "
        f"max |llr err| {err:.3g}")
    if not 1 <= retry_launches <= 2 or n_bad:
        raise AssertionError("decode_with_retries on the card")
    llr = bpsk_llrs("R1_4", 6, 4, 10 ** (-1.0 / 20))
    got = L.decode_candidates(llr, "R1_4", device=dev)
    want = L.decode_candidates(llr, "R1_4")
    same = [len(c) for c in got] == [len(c) for c in want] and all(
        np.array_equal(bits, w_bits) and abs(m - w_m) <= LLR_ATOL
        for cands, w_cands in zip(got, want)
        for (m, bits), (w_m, w_bits) in zip(cands, w_cands))
    log(f"[6 serving] decode_candidates R1/4 B=4: candidates per codeword "
        f"{[len(c) for c in got]} (CPU port {[len(c) for c in want]})")
    if not same or not any(want):
        raise AssertionError("decode_candidates on the card differs from the CPU port")
    if ldpc_kernel.LAUNCHES_V1:
        raise AssertionError("the serving layer launched K2")

    # -- 7. timing ------------------------------------------------------------
    log(f"[7 timing] card: {card}")
    for _ in range(3):
        rx(audio)
    rx_ms, rx_lo, rx_hi = cuda_ms(lambda: rx(audio), 10)
    log(f"[7 timing] RX chain B={batch} window={window}: median {rx_ms:.3f} ms/call "
        f"(min {rx_lo:.3f}, max {rx_hi:.3f}, 7 windows of 10 calls), "
        f"{batch * window / rx_ms * 1e3:.4g} samples/s")
    _, _, soft = rx.soft_bits(audio)
    dec = ldpc_decoder(RATE, None, dev)
    k2_dec = make_cuda_decoder_v1(RATE, device=dev)
    times = {}
    for label, x in (("B=256 main path", soft),
                     ("B=512 mixed", torch.as_tensor(llr_batch(RATE, 512, rng, True)[0],
                                                     device=dev)),
                     ("B=512 A/B -1 dB", ab_llr)):
        f = torch.full((x.shape[0],), MIN_SUM_FACTOR, device=dev)
        fns = {"K1": lambda: dec(x, f), "K2": lambda: k2_dec(x, f),
               "plain": lambda: dec.plain(x, f), "plain_v1": lambda: dec.plain_v1(x, f)}
        for fn in fns.values():
            for _ in range(3):
                fn()
        # In turns on the same card (medians of windows): plain, K1, K1, plain;
        # then plain_v1, K2, K1, K2, plain_v1.
        p1 = cuda_ms(fns["plain"], 5)[0]
        k1a = cuda_ms(fns["K1"], 20)[0]
        k1b = cuda_ms(fns["K1"], 20)[0]
        p2 = cuda_ms(fns["plain"], 5)[0]
        q1 = cuda_ms(fns["plain_v1"], 5)[0]
        k2a = cuda_ms(fns["K2"], 20)[0]
        k1c = cuda_ms(fns["K1"], 20)[0]
        k2b = cuda_ms(fns["K2"], 20)[0]
        q2 = cuda_ms(fns["plain_v1"], 5)[0]
        us = {name: device_us(fns[name], kernel)
              for name, kernel in (("K1", "ldpc_bp_kernel"), ("K2", "ldpc_bp_v1_kernel"))}
        times[label] = {"K1": ((k1a + k1b) / 2, (p1 + p2) / 2),
                        "K2": ((k2a + k2b) / 2, (q1 + q2) / 2)}
        log(f"[7 timing] LDPC {RATE} {label}: mean iterations "
            f"{dec(x, f).iterations.float().mean():.2f}; K1 {k1a:.4f} / {k1b:.4f} / {k1c:.4f} ms, "
            f"plain {p1:.4f} / {p2:.4f} ms; K2 {k2a:.4f} / {k2b:.4f} ms, plain_v1 {q1:.4f} / "
            f"{q2:.4f} ms")
        log(f"[7 timing] LDPC {RATE} {label}: device time per launch (torch.profiler, 20 "
            "launches): " + ", ".join(
                f"{name} " + ("not measured" if t is None else f"{t:.2f} us")
                for name, t in us.items()))

    # -- 8. result ------------------------------------------------------------
    main_times = times["B=256 main path"]
    kernels = [
        {"name": "ldpc_bp", "route": "cuda", "source": "ria_tpu_torch/csrc/ldpc_bp.cu",
         "replaces": "ria_tpu/fec/ldpc_pallas.py:39", "launches": launches,
         "max_abs_err": max_err["K1"], "ms": main_times["K1"][0],
         "plain_ms": main_times["K1"][1]},
        {"name": "ldpc_bp_v1", "route": "cuda", "source": "ria_tpu_torch/csrc/ldpc_bp_v1.cu",
         "replaces": "ria_tpu/fec/ldpc_pallas.py:218", "launches": launches_v1,
         "max_abs_err": max_err["K2"], "ms": main_times["K2"][0],
         "plain_ms": main_times["K2"][1]},
    ]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
