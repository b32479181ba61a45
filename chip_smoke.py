#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``ria_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with one CUDA card visible:

    python3 chip_smoke.py

It builds the LDPC kernels K1 (``ria_tpu_torch/csrc/ldpc_bp.cu``) and K2
(``ria_tpu_torch/csrc/ldpc_bp_v1.cu``) from the checkout's sources and runs
these phases, each printing its lines and raising on failure:

1. device: the card's name and power limit, as nvidia-smi gives them;
2. build: nvcc for sm_90a, both sources at once, with each build time and
   ptxas resource lines; K1's and K2's registers, spill and shared bytes as
   the CUDA runtime reports them, and how many codewords the card holds at
   once (it fails on any spill, or if fewer than the A/B point's 512 fit);
   K1's at R1/2 and R3/4 too, the rates the OFDM chains decode (no spill);
3. kernels vs plain: K1 against the plain PyTorch decoder, and K2 against
   its plain version (``plain_v1``) and against K1, on the card, for every
   rate at B = 8 and 256 and for R1/4 at B = 512 (mixed difficulty);
4. main path: the MC-DPSK RX chain at the bench.py chain-1 geometry (64
   channels, window 207,328, R1/4, 4 codewords, 10 dB AWGN) from the port's
   own TX, checked against the transmitted bits and against the same chain
   on the CPU, with K1's launch count from that run;
4b. OFDM chains: bench.py's chains 2 and 3 (north-star configs #3, DQPSK
   R1/2 at 15 dB, window 42,720, and #4, QAM64 R3/4 at 25 dB, window
   26,160; 64 channels each) from the port's own TX: all detected,
   cw_decode_rate >= 0.95, bits equal to those sent, one K1 launch and no K2
   launch in the call, and the same chain on the CPU equal;
4c. single-frame waveform paths (``ria_tpu_torch.tools.waveform_paths``), 64
   channels each from the port's own TX: OTFS EQ and OTFS raw-DD (ZC sync,
   one R1/4 codeword, window 48,000, 18 dB), DQPSK (Barker sync, window
   194,368, 6 dB), 8-tone MFSK (sweep sync one channel at a time, window
   696,128, -2 dB), each decoded by ``decode_batch``: detection and
   cw_decode_rate >= 0.95, bits equal to those sent, one K1 launch and no
   K2 launch in the call; and ZC (four roots, 48,000) with CSS (four
   shifts, 96,000) sync at 0 dB, the frame type sent found on >= 0.95 of
   channels; every path equal to the same path on the CPU port;
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
   device time per launch from torch.profiler, its bound (the larger of
   bytes over 3.35 TB/s and operations over 67 TFLOP/s, the H100 SXM's
   published peaks) and the share of the bound it reaches, and the K1/K2
   device-time ratio; the serial floor (K1 and K2 at B = 1 on an A/B row
   that runs all 50 iterations); K1's host microseconds per call; for each
   OFDM chain its ms per call and samples/s, and K1's device time on the
   chain's own 256 codewords with its bound and share; for every chain and
   for its sync and sync-to-soft-bits stages, the ms per call, the device
   kernels, copies and memsets of one call and the share of the call the
   device is busy (profiler trace), and for the whole call its three
   heaviest device kernels; for each waveform path its ms per call split
   into sync, demod and decode (CUDA events between the stages of the same
   calls), K1's device time on its 64 codewords with bound and share, and
   one profiler trace of each stage and of the call;
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
# Published peaks of one H100 SXM (NVIDIA's data sheet, at its 700 W limit).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Operations of min-sum BP per edge and iteration, counted from K1's source:
# gather side 5 (g - c2v, two clamp compares, the sign of g, the parity xor);
# check update 8 (|v2c|, its sign, the sign xor, two min compares, the
# exclusive pick, x factor, the sign applied); variable sum 1.  Plus 1 per
# variable and iteration (channel LLR + the sum).
OPS_PER_EDGE = 14


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


def bound_us(dec, kernel: str, B: int, iterations: int) -> tuple[float, str]:
    """(least microseconds, the side that binds) for one launch of ``kernel``
    on B codewords of ``dec``'s code that need ``iterations`` codeword-
    iterations in all: each input byte read once (LLRs, factors, the
    kernel's tables) and each output byte written once (posteriors, info
    bits, success, iterations), against the operations these iterations
    need."""
    n, k = dec.n, dec.k
    io = B * (4 * n + 4) + B * (4 * n + k + 1 + 4)
    t = dec.k1 if kernel == "K1" else dec.k2
    tables = sum(x.numel() * x.element_size() for x in (t.row, t.epos, t.jobs))
    edges = int(dec.row_mask.sum())
    ops = iterations * (OPS_PER_EDGE * edges + n)
    t_bytes = (io + tables) / HBM_BYTES_PER_S * 1e6
    t_ops = ops / F32_OPS_PER_S * 1e6
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def staged_ms(path, audio: torch.Tensor, reps: int, windows: int = 7) -> dict:
    """{stage: (median, min, max)} over ``windows`` windows of the
    milliseconds per call of a waveform path's sync, demod and decode stages
    and of the whole call, from CUDA events recorded between the stages of
    the same ``reps`` calls."""
    per = {stage: [] for stage in ("sync", "demod", "decode", "call")}
    for _ in range(windows):
        events = [[torch.cuda.Event(enable_timing=True) for _ in range(4)] for _ in range(reps)]
        for ev in events:
            ev[0].record()
            sync = path.sync(audio)
            ev[1].record()
            demod, soft = path.demodulate(audio, sync)
            ev[2].record()
            path.decode(sync, demod, soft)
            ev[3].record()
        torch.cuda.synchronize()
        for i, stage in enumerate(("sync", "demod", "decode")):
            per[stage].append(sum(ev[i].elapsed_time(ev[i + 1]) for ev in events) / reps)
        per["call"].append(sum(ev[0].elapsed_time(ev[3]) for ev in events) / reps)
    return {stage: (float(np.median(v)), min(v), max(v)) for stage, v in per.items()}


def top_kernels(stage: str, top: list[tuple[str, float]]) -> str:
    """The whole call's heaviest device activities, for a trace line."""
    if stage != "whole call":
        return ""
    return "; most device time: " + ", ".join(f"{name[:60]} {us / 1e3:.3f} ms"
                                              for name, us in top)


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

    from ria_tpu_torch.entry import RATE, _make_batch, _make_ofdm_batch, geometry, ofdm_geometry
    from ria_tpu_torch.fec import ldpc as L
    from ria_tpu_torch.fec import ldpc_kernel
    from ria_tpu_torch.fec.ldpc import ldpc_decoder
    from ria_tpu_torch.fec.ldpc_cuda import make_cuda_decoder_v1
    from ria_tpu_torch.fec.ldpc_matrix import CODE_PARAMS, MIN_SUM_FACTOR, RECOMMENDED_ITERS
    from ria_tpu_torch.phy.pipeline import make_ofdm_rx_pipeline, make_rx_pipeline
    from ria_tpu_torch.tools import ldpc_bench
    from ria_tpu_torch.tools import waveform_paths as W
    from ria_tpu_torch.utils.timing import cuda_ms, device_us, trace_call

    # -- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    builds = ldpc_kernel.build()
    log(f"[2 build] {len(builds)} libraries in {time.perf_counter() - t0:.2f} s")
    for b in builds.values():
        log(f"[2 build] {b.path.name}: nvcc {b.seconds:.2f} s")
        for line in b.log.splitlines():
            if "registers" in line or "bytes stack" in line:
                log(f"  ptxas: {line.strip()}")
    rate_dec = ldpc_decoder(RATE, None, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, res in (("K1", ldpc_kernel.k1_resources(rate_dec.n, rate_dec.k1.slots)),
                      ("K2", ldpc_kernel.k2_resources(rate_dec.n, rate_dec.k2.slots))):
        resident = res["blocks_per_sm"] * sms
        log(f"[2 build] {name} at {RATE}: {res['registers']} registers and "
            f"{res['local_bytes']} bytes of local (spill) memory per thread, "
            f"{res['shared_bytes']} shared bytes per block; {res['blocks_per_sm']} blocks per "
            f"SM x {sms} SMs = {resident} codewords resident at once")
        if res["local_bytes"] or resident < 512:
            raise AssertionError(f"{name} spills, or fewer than 512 codewords are resident")
    for rate in ("R1_2", "R3_4"):
        dec_r = ldpc_decoder(rate, None, dev)
        res = ldpc_kernel.k1_resources(dec_r.n, dec_r.k1.slots)
        log(f"[2 build] K1 at {rate}: {res['registers']} registers and {res['local_bytes']} "
            f"bytes of local (spill) memory per thread, {res['shared_bytes']} shared bytes per "
            f"block; {res['blocks_per_sm']} blocks per SM x {sms} SMs = "
            f"{res['blocks_per_sm'] * sms} codewords resident at once")
        if res["local_bytes"]:
            raise AssertionError(f"K1 spills at {rate}")

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
    launches, launches_v1_main = ldpc_kernel.LAUNCHES, ldpc_kernel.LAUNCHES_V1
    det = out.detected.cpu().numpy()
    ok = out.cw_success.cpu().numpy()
    bits = out.info_bits.cpu().numpy()
    log(f"[4 main path] B={batch} window={window}: detected {int(det.sum())}/{batch}, "
        f"cw_decode_rate {ok.mean():.4f}, K1 launches {launches}, K2 launches "
        f"{launches_v1_main}")
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

    # -- 4b. OFDM chains ------------------------------------------------------
    ofdm = {}
    for config, path in ((3, "ofdm_dqpsk_r12"), (4, "ofdm_qam64_r34")):
        geom = ofdm_geometry(config)
        o_audio, o_info = _make_ofdm_batch(geom, seed=0, device=dev)
        orx = make_ofdm_rx_pipeline(geom.cfg, geom.rate, geom.window, geom.ci_bits, device=dev)
        torch.cuda.synchronize()
        ldpc_kernel.LAUNCHES = ldpc_kernel.LAUNCHES_V1 = 0
        o_out = orx(o_audio)
        torch.cuda.synchronize()
        o_launches = (ldpc_kernel.LAUNCHES, ldpc_kernel.LAUNCHES_V1)
        det = o_out.detected.cpu().numpy()
        ok = o_out.cw_success.cpu().numpy()
        tag = (f"[4b OFDM] config #{config} {geom.cfg.modulation} {geom.rate} at "
               f"{geom.snr_db:g} dB, B={geom.batch} window={geom.window}")
        log(f"{tag}: detected {int(det.sum())}/{geom.batch}, cw_decode_rate {ok.mean():.4f}, "
            f"K1 launches {o_launches[0]}, K2 launches {o_launches[1]}")
        if o_out.info_bits.shape != o_info.shape:
            raise AssertionError(f"info_bits shape {tuple(o_out.info_bits.shape)}")
        if not torch.isfinite(o_out.snr_db).all() or not torch.isfinite(o_out.cfo_hz).all():
            raise AssertionError("non-finite snr_db or cfo_hz")
        if not det.all():
            raise AssertionError(f"only {int(det.sum())}/{geom.batch} channels detected")
        if ok.mean() < 0.95:
            raise AssertionError(f"cw_decode_rate {ok.mean():.4f} < 0.95")
        if not (o_out.info_bits.cpu().numpy() == o_info)[ok].all():
            raise AssertionError("decoded info bits differ from the transmitted bits")
        if o_launches != (1, 0):
            raise AssertionError(f"the chain launched K1 {o_launches[0]} and K2 "
                                 f"{o_launches[1]} times; 1 and 0 expected")
        cpu = make_ofdm_rx_pipeline(geom.cfg, geom.rate, geom.window, geom.ci_bits,
                                    device="cpu")(o_audio.cpu())
        for name in ("detected", "lts_start", "cw_success", "info_bits", "iterations"):
            if not torch.equal(getattr(cpu, name), getattr(o_out, name).cpu()):
                raise AssertionError(f"{name} differs between the card and the CPU ({path})")
        cfo_err = float((cpu.cfo_hz - o_out.cfo_hz.cpu()).abs().max())
        snr_err = float((cpu.snr_db - o_out.snr_db.cpu()).abs().max())
        log(f"{tag}: card vs CPU: detected/lts_start/cw_success/info_bits/iterations equal, "
            f"max |cfo err| {cfo_err:.3g} Hz, max |snr err| {snr_err:.3g} dB")
        if cfo_err > 1e-3 or snr_err > 1e-3:
            raise AssertionError(f"cfo_hz or snr_db differs between the card and the CPU ({path})")
        ofdm[path] = (geom, orx, o_audio, o_launches)

    # -- 4c. single-frame waveform paths --------------------------------------
    wpaths = {}
    for name in W.PATHS:
        batch_w = W.make_path_batch(name, W.BATCH, seed=0, device="cpu")
        x = tuple(t.to(dev) for t in batch_w.inputs)
        path = W.make_path(name)
        torch.cuda.synchronize()
        ldpc_kernel.LAUNCHES = ldpc_kernel.LAUNCHES_V1 = 0
        w_out = path(*x)
        torch.cuda.synchronize()
        w_launches = (ldpc_kernel.LAUNCHES, ldpc_kernel.LAUNCHES_V1)
        w_cpu = path(*batch_w.inputs)
        geom_w = path.geom
        tag = (f"[4c paths] {name} B={W.BATCH} window={geom_w.window} at {geom_w.snr_db:g} dB")
        if name == "css_zc_sync":
            for label, got_s, want_s, col in (("ZC", w_out.zc, w_cpu.zc, 0),
                                              ("CSS", w_out.css, w_cpu.css, 1)):
                det = got_s.detected.cpu().numpy()
                hit = det & (got_s.frame_type.cpu().numpy() == batch_w.frame_types[:, col])
                corr_err = float((got_s.correlation.cpu() - want_s.correlation).abs().max())
                log(f"{tag}: {label} detected {int(det.sum())}/{W.BATCH}, frame type sent "
                    f"{int(hit.sum())}/{W.BATCH}; card vs CPU: max |corr err| {corr_err:.3g}")
                for field in ("detected", "frame_type", "start_sample"):
                    if not torch.equal(getattr(got_s, field).cpu(), getattr(want_s, field)):
                        raise AssertionError(f"{label} {field} differs between the card and "
                                             "the CPU")
                if hit.mean() < 0.95 or corr_err > 1e-3:
                    raise AssertionError(f"{label} sync: {hit.mean():.4f} < 0.95 or corr differs")
            cfo_err = float((w_out.zc.cfo_hz.cpu() - w_cpu.zc.cfo_hz).abs().max())
            snr_err = float((w_out.zc.snr_estimate.cpu() - w_cpu.zc.snr_estimate).abs().max())
            log(f"{tag}: ZC card vs CPU max |cfo err| {cfo_err:.3g} Hz, |snr err| "
                f"{snr_err:.3g} dB, K1 launches {w_launches[0]}, K2 launches {w_launches[1]}")
            if cfo_err > 1e-3 or snr_err > 1e-3 or w_launches != (0, 0):
                raise AssertionError("ZC cfo/snr differ between the card and the CPU, or a "
                                     "decode ran")
        else:
            det = w_out.detected.cpu().numpy()
            ok = w_out.cw_success.cpu().numpy()
            log(f"{tag}: detected {int(det.sum())}/{W.BATCH}, cw_decode_rate {ok.mean():.4f}, "
                f"mean iterations {w_out.iterations.float().mean():.2f}, K1 launches "
                f"{w_launches[0]}, K2 launches {w_launches[1]}")
            if name.startswith("otfs") and not (w_out.frame_type.cpu().numpy()[det] == 2).all():
                raise AssertionError("the ZC sync found another frame type than DATA")
            if not torch.isfinite(w_out.snr_db).all() or not torch.isfinite(w_out.cfo_hz).all():
                raise AssertionError("non-finite snr_db or cfo_hz")
            if det.mean() < 0.95 or ok.mean() < 0.95:
                raise AssertionError(f"detected {det.mean():.4f} or cw_decode_rate {ok.mean():.4f} "
                                     "< 0.95")
            if not (w_out.info_bits.cpu().numpy() == batch_w.info)[ok].all():
                raise AssertionError("decoded info bits differ from the transmitted bits")
            if w_launches != (1, 0):
                raise AssertionError(f"the path launched K1 {w_launches[0]} and K2 "
                                     f"{w_launches[1]} times; 1 and 0 expected")
            moved = (w_out.start.cpu() != w_cpu.start).nonzero().flatten().tolist()
            for b in moved:
                log(f"{tag}: channel {b}: start {int(w_out.start[b])} (card, score "
                    f"{float(w_out.sync_score[b]):.9g}) vs {int(w_cpu.start[b])} (CPU, score "
                    f"{float(w_cpu.sync_score[b]):.9g})")
            for field in ("detected", "start", "frame_type", "cw_success"):
                if not torch.equal(getattr(w_out, field).cpu(), getattr(w_cpu, field)):
                    raise AssertionError(f"{field} differs between the card and the CPU ({name})")
            errs = {field: float((getattr(w_out, field).cpu() - getattr(w_cpu, field)).abs().max())
                    for field in ("cfo_hz", "snr_db", "soft_bits")}
            log(f"{tag}: card vs CPU: detected/start/frame_type/cw_success equal, max |cfo err| "
                f"{errs['cfo_hz']:.3g} Hz, |snr err| {errs['snr_db']:.3g} dB, |soft-bit err| "
                f"{errs['soft_bits']:.3g}")
            if errs["cfo_hz"] > 1e-3 or errs["snr_db"] > 1e-3 or errs["soft_bits"] > 2e-3:
                raise AssertionError(f"cfo, snr or soft bits differ between the card and the CPU "
                                     f"({name})")
        wpaths[name] = (path, x, w_launches)

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
    n_bad, err = compare(L.decode_with_retries(llr, "R1_2", device="cpu"), got)
    log(f"[6 serving] decode_with_retries R1/2 B=4: success {int(got.success.sum())}/4, "
        f"K1 launches {retry_launches}, rows differing from the CPU port {n_bad}, "
        f"max |llr err| {err:.3g}")
    if not 1 <= retry_launches <= 2 or n_bad:
        raise AssertionError("decode_with_retries on the card")
    llr = bpsk_llrs("R1_4", 6, 4, 10 ** (-1.0 / 20))
    got = L.decode_candidates(llr, "R1_4", device=dev)
    want = L.decode_candidates(llr, "R1_4", device="cpu")
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
    chain_ms = {"mc_dpsk": rx_ms}
    for path, (geom, orx, o_audio, _) in ofdm.items():
        for _ in range(3):
            orx(o_audio)
        o_ms, o_lo, o_hi = cuda_ms(lambda: orx(o_audio), 10)
        chain_ms[path] = o_ms
        log(f"[7 timing] OFDM {path} B={geom.batch} window={geom.window}: median {o_ms:.3f} "
            f"ms/call (min {o_lo:.3f}, max {o_hi:.3f}, 7 windows of 10 calls), "
            f"{geom.batch * geom.window / o_ms * 1e3:.4g} samples/s ({card})")
    # Where each chain's time goes: its sync stage alone and sync to soft
    # bits (slice, demodulation, deinterleave), timed like the whole call and,
    # like it, before any profiler run (a profiled process launches slower).
    chains = {"mc_dpsk": (rx, audio)}
    chains.update({path: (run[1], run[2]) for path, run in ofdm.items()})
    stages = {path: {"sync": lambda c=chain, x=x: c.sync(x),
                     "sync..soft bits": lambda c=chain, x=x: c.soft_bits(x),
                     "whole call": lambda c=chain, x=x: c(x)}
              for path, (chain, x) in chains.items()}
    for path in chains:
        stage_ms = {stage: cuda_ms(stages[path][stage], 10)[0]
                    for stage in ("sync", "sync..soft bits")}
        stage_ms["whole call"] = chain_ms[path]
        chain_ms[path] = stage_ms
        log(f"[7 timing] {path} by stage (CUDA events, median of 7 x 10 calls): "
            + ", ".join(f"{stage} {ms:.3f} ms" for stage, ms in stage_ms.items()) + f" ({card})")
    # Each waveform path by stage: CUDA events between sync, demodulation
    # and decode inside the same calls, so the stages add up to the call
    # (before any profiler run, like the chains).
    path_stages = {}
    for name, (path, x, _) in wpaths.items():
        if name == "css_zc_sync":
            fns = {"whole call": lambda p=path, x=x: p(*x)}
            for _ in range(3):
                fns["whole call"]()
            whole, lo, hi = cuda_ms(fns["whole call"], 10)
            split, stage_ms = "", {"whole call": whole}
        else:
            fns = {"sync": lambda p=path, x=x: p.sync(*x),
                   "sync..soft bits": lambda p=path, x=x: p.soft_bits(*x),
                   "whole call": lambda p=path, x=x: p(*x)}
            for _ in range(3):
                fns["whole call"]()
            split_ms = staged_ms(path, x[0], 10)
            stage_ms = {"sync": split_ms["sync"][0],
                        "sync..soft bits": split_ms["sync"][0] + split_ms["demod"][0],
                        "whole call": split_ms["call"][0]}
            whole, lo, hi = split_ms["call"]
            split = "; " + ", ".join(f"{stage} {split_ms[stage][0]:.3f} ms"
                                     for stage in ("sync", "demod", "decode"))
        path_stages[name] = (fns, stage_ms)
        samples = sum(t.shape[0] * t.shape[1] for t in x)
        log(f"[7 timing] path {name} B={W.BATCH}: median {whole:.3f} ms/call (min {lo:.3f}, max "
            f"{hi:.3f}, 7 windows of 10 calls), {samples / whole * 1e3:.4g} samples/s{split} "
            f"({card})")
    _, _, soft = rx.soft_bits(audio)
    dec = ldpc_decoder(RATE, None, dev)
    k2_dec = make_cuda_decoder_v1(RATE, device=dev)
    # K1's host cost per call: wall clock over 1,000 calls with no synchronise
    # (before any profiler run, which slows launches).
    f = torch.full((soft.shape[0],), MIN_SUM_FACTOR, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(1000):
        dec(soft, f)
    host_us = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    log(f"[7 timing] K1 host time per call at B={soft.shape[0]}: {host_us:.2f} us "
        "(wall clock over 1,000 calls, no synchronise)")
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
        iterations = dec(x, f).iterations
        bounds = {name: bound_us(dec, name, x.shape[0], int(iterations.sum())) for name in us}
        times[label] = {"K1": ((k1a + k1b) / 2, (p1 + p2) / 2, us["K1"], bounds["K1"]),
                        "K2": ((k2a + k2b) / 2, (q1 + q2) / 2, us["K2"], bounds["K2"])}
        log(f"[7 timing] LDPC {RATE} {label}: mean iterations "
            f"{iterations.float().mean():.2f}; K1 {k1a:.4f} / {k1b:.4f} / {k1c:.4f} ms, "
            f"plain {p1:.4f} / {p2:.4f} ms; K2 {k2a:.4f} / {k2b:.4f} ms, plain_v1 {q1:.4f} / "
            f"{q2:.4f} ms")
        log(f"[7 timing] LDPC {RATE} {label}: device time per launch (torch.profiler, 20 "
            "launches): " + ", ".join(
                f"{name} " + ("not measured" if t is None else f"{t:.2f} us")
                for name, t in us.items()))
        if None in us.values():
            raise AssertionError("the profiler showed no device time for K1 or K2")
        log(f"[7 timing] LDPC {RATE} {label}: K1/K2 device time {us['K1'] / us['K2']:.4f}; "
            + ", ".join(f"{name} bound {bounds[name][0]:.3f} us ({bounds[name][1]}), "
                        f"{bounds[name][0] / us[name]:.2%} of it reached"
                        for name in us) + f" ({card})")

    # K1 on each OFDM chain's own 256 codewords, at factor 0.9375.
    for path, (geom, orx, o_audio, _) in ofdm.items():
        _, _, o_soft = orx.soft_bits(o_audio)
        o_dec = orx.decoder
        o_f = torch.full((o_soft.shape[0],), orx.min_sum_factor, device=dev)
        o_us = device_us(lambda: o_dec(o_soft, o_f), "ldpc_bp_kernel")
        if o_us is None:
            raise AssertionError(f"the profiler showed no device time for K1 ({path})")
        o_iters = o_dec(o_soft, o_f).iterations
        o_bound = bound_us(o_dec, "K1", o_soft.shape[0], int(o_iters.sum()))
        log(f"[7 timing] K1 on {path} ({geom.rate}, B={o_soft.shape[0]}, mean iterations "
            f"{o_iters.float().mean():.2f}): {o_us:.2f} us per launch (torch.profiler, 20 "
            f"launches), bound {o_bound[0]:.3f} us ({o_bound[1]}), "
            f"{o_bound[0] / o_us:.2%} of it reached ({card})")

    # K1 on each waveform path's own 64 header codewords.
    path_k1 = {}
    w_dec = ldpc_decoder(W.RATE, RECOMMENDED_ITERS[W.RATE], dev)
    for name, (path, x, _) in wpaths.items():
        if name == "css_zc_sync":
            continue
        _, _, w_soft = path.soft_bits(*x)
        w_f = torch.full((w_soft.shape[0],), MIN_SUM_FACTOR, device=dev)
        w_us = device_us(lambda: w_dec(w_soft, w_f), "ldpc_bp_kernel")
        if w_us is None:
            raise AssertionError(f"the profiler showed no device time for K1 ({name})")
        w_iters = w_dec(w_soft, w_f).iterations
        w_bound = bound_us(w_dec, "K1", w_soft.shape[0], int(w_iters.sum()))
        path_k1[name] = (w_us, w_bound)
        log(f"[7 timing] K1 on path {name} ({W.RATE}, B={w_soft.shape[0]}, mean iterations "
            f"{w_iters.float().mean():.2f}): {w_us:.2f} us per launch (torch.profiler, 20 "
            f"launches), bound {w_bound[0]:.3f} us ({w_bound[1]}), "
            f"{w_bound[0] / w_us:.2%} of it reached ({card})")

    # One trace of each waveform path and of its stages.
    for name, (fns, stage_ms) in path_stages.items():
        for stage, fn in fns.items():
            n_dev, busy_us, top = trace_call(fn)
            log(f"[7 timing] trace of one path {name} {stage}: {n_dev} device kernels, copies "
                f"and memsets, {busy_us / 1e3:.3f} ms device-busy, "
                f"{busy_us / 1e3 / stage_ms[stage]:.1%} of its {stage_ms[stage]:.3f} ms ({card})"
                + top_kernels(stage, top))

    # One call of each chain and of its stages under the profiler: the device
    # kernels, copies and memsets, and the share of the stage's time the
    # device is busy.
    for path, fns in stages.items():
        for stage, fn in fns.items():
            n_dev, busy_us, top = trace_call(fn)
            log(f"[7 timing] trace of one {path} {stage}: {n_dev} device kernels, copies and "
                f"memsets, {busy_us / 1e3:.3f} ms device-busy, "
                f"{busy_us / 1e3 / chain_ms[path][stage]:.1%} of its {chain_ms[path][stage]:.3f} "
                f"ms ({card})" + top_kernels(stage, top))

    # The serial floor: one codeword alone for all 50 iterations.
    ab_k1 = dec(ab_llr, ab_fac)
    row = int(torch.nonzero((ab_k1.iterations == 50) & ~ab_k1.success)[0])
    x1, f1 = ab_llr[row : row + 1], ab_fac[:1]
    floor = {"K1": device_us(lambda: dec(x1, f1), "ldpc_bp_kernel"),
             "K2": device_us(lambda: k2_dec(x1, f1), "ldpc_bp_v1_kernel")}
    log("[7 timing] serial floor, B=1 on A/B row {} (50 iterations): ".format(row) + ", ".join(
        f"{name} {t:.2f} us per launch, {t / 50:.4f} us per iteration"
        for name, t in floor.items()) + f" ({card})")

    # -- 8. result ------------------------------------------------------------
    # Times at the main path's 256 codewords.  ``launches`` counts the path
    # that runs each kernel (K1: the RX call; K2: the A/B entry point),
    # ``launches_per_call`` the launches per RX call of the main path, and
    # ``launches_per_call_by_path`` those of each chain's and waveform path's
    # call.  No PyTorch call computes min-sum BP, so there is no library time.
    main_times = times["B=256 main path"]
    kernels = []
    for i, (name, source, replaces, n_launch, per_call) in enumerate((
            ("K1", "ria_tpu_torch/csrc/ldpc_bp.cu", "ria_tpu/fec/ldpc_pallas.py:39",
             launches, launches),
            ("K2", "ria_tpu_torch/csrc/ldpc_bp_v1.cu", "ria_tpu/fec/ldpc_pallas.py:218",
             launches_v1, launches_v1_main))):
        ms, plain_ms, dev_us, (b_us, b_by) = main_times[name]
        by_path = {"mc_dpsk": per_call}
        by_path.update({path: run[3][i] for path, run in ofdm.items()})
        by_path.update({path: run[2][i] for path, run in wpaths.items()})
        kernels.append({
            "name": "ldpc_bp" if name == "K1" else "ldpc_bp_v1", "route": "cuda",
            "source": source, "replaces": replaces, "launches": n_launch,
            "launches_per_call": per_call, "launches_per_call_by_path": by_path,
            "max_abs_err": max_err[name], "ms": ms,
            "plain_ms": plain_ms, "device_us": dev_us, "bound_us": b_us,
            "bound_ms": b_us / 1e3, "bound_by": b_by, "library_ms": None})
    # K1's device time and bound on each waveform path's 64 codewords.
    kernels[0]["device_us_by_path"] = {path: t[0] for path, t in path_k1.items()}
    kernels[0]["bound_us_by_path"] = {path: t[1][0] for path, t in path_k1.items()}
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
