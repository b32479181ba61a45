#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``ria_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with one CUDA card visible:

    python3 chip_smoke.py

It builds the LDPC kernels K1 and K2, each in its float32 build
(``ria_tpu_torch/csrc/ldpc_bp.cu``, ``ldpc_bp_v1.cu``) and its bf16 build,
the TPU kernels' own arithmetic (``ldpc_bp_bf16.cu``, ``ldpc_bp_v1_bf16.cu``),
from the checkout's sources and runs these phases, each printing its lines
and raising on failure:

1. device: the card's name and power limit, as nvidia-smi gives them;
2. build: nvcc for sm_90a, the four libraries at once, with each build
   time and ptxas resource lines; K1's and K2's (both builds of each)
   registers, spill and shared bytes as the CUDA runtime reports them, and how many
   codewords the card holds at once (it fails on any spill, or if fewer
   than the A/B point's 512 fit); K1's at R1/2 and R3/4 too, the rates the
   OFDM chains decode (no spill);
3. kernels vs plain: each kernel build against its plain PyTorch version
   (K1 and ``plain``, K2 and ``plain_v1``, each in float32 and in
   ``precision="bf16"``): every output of every row equal; and K2 against
   K1 in each precision (they group their sums otherwise: at most 1% of
   the mixed batch's rows may part); on the card, for every rate at B = 8
   and 256 and for R1/4 at B = 512 (mixed difficulty);
3b. the chirp search's window pass (``csrc/zoom_front.cu``) against its
   plain version (``sync.chirp.zoom_front_plain``) on the card, at the
   benchmark cell's 256 channels of 207,328 samples and at B = 1: within
   the order of a 16-term sum (the kernel adds in PyTorch's order, so no
   group should differ), all-zero groups 0; its device µs beside its bound
   from the bytes and the share of it, and the plain version's ms;
3c. the Schmidl-Cox search's kernels (``csrc/sc_search.cu``) against the
   plain search (``SchmidlCoxDetector.search_plain``) on the card, at both
   OFDM cells' shapes (2,048 windows of 26,160 samples, QAM64; 1,024 of
   42,720, DQPSK): all five outputs equal bit for bit; each kernel's device
   µs beside its bound from the bytes and the share of it, the whole
   search's ms on the card beside the plain search's;
3d. the OFDM demodulator's demap stage (``csrc/ofdm_demap.cu``) against its
   plain version (``OFDMDemodulator.demap_plain``) on the card, at both OFDM
   cells' shapes (DQPSK [1,024, 22, 59] with the noise variance broadcast
   over the symbols, QAM64 [2,048, 9, 51] with a full one) and at a long
   frame (S = 200, the chains in the output's slots): equal bit for bit; its device µs
   beside its bound from the bytes and the share of it, and the plain
   version's ms;
3e. the chirp search's fine stage (``csrc/chirp_fine.cu``) against its plain
   path (``sync.chirp.refine_front_plain``, ``refine_pick_plain``,
   ``median_plain``) on the card, at both MC-DPSK cells' shapes (256
   windows of 207,328 samples; 128 of 606,688): every output equal bit for
   bit; each kernel's device µs beside its bound from the bytes and the
   share of it, and a refinement with the median on the card with the
   kernels and with the plain path;
3f. the light preamble's LTS search's kernels (``csrc/lts_search.cu``)
   against the plain search (``LTSDetector.search_plain``) on the card, at
   the light cell's shape (1,024 windows of 48,000 samples, DQPSK with 6
   pilots): all five outputs equal bit for bit; each kernel's device µs
   beside its bound from the bytes and the share of it, the whole search's
   ms on the card beside the plain search's;
4. main path: the MC-DPSK RX chain at the bench.py chain-1 geometry (64
   channels, window 207,328, R1/4, 4 codewords, 10 dB AWGN) from the port's
   own TX, checked against the transmitted bits and against the same chain
   on the CPU, with K1's launch count from that run, exactly one launch
   of the window pass, two of each refinement kernel and one median, and
   no Schmidl-Cox or LTS search on the card;
4b. OFDM chains: bench.py's chains 2 and 3 (north-star configs #3, DQPSK
   R1/2 at 15 dB, window 42,720, and #4, QAM64 R3/4 at 25 dB, window
   26,160; 64 channels each) from the port's own TX, each call one
   Schmidl-Cox search through the kernels (``launch_count("sc_coarse")``)
   and one demap (``launch_count("ofdm_demap")``): all detected,
   cw_decode_rate >= 0.95, bits equal to those sent, one K1 launch and no K2
   launch in the call, no LTS search, and the same chain on the CPU equal;
   and the light chain (``preamble="lts"``; config #3 with 6 pilots, R1/2
   at 15 dB) at the light cell's shape (1,024 channels of 48,000 samples,
   leads in [0, 16000)), whose call launches each LTS search kernel once
   (``launch_count("lts_front")``, the ``lts_search`` entry's launches):
   all detected within 16 samples of the lead, cw_decode_rate >= 0.95,
   bits equal to those sent, no Schmidl-Cox search and no K2 launch, and
   its detected, start and CFO equal to the plain search's on the card;
4c. single-frame waveform paths (``ria_tpu_torch.tools.waveform_paths``), 64
   channels each from the port's own TX: OTFS EQ and OTFS raw-DD (ZC sync,
   one R1/4 codeword, window 48,000, 18 dB), DQPSK (Barker sync, window
   194,368, 6 dB), 8-tone MFSK (sweep sync one channel at a time, window
   696,128, -2 dB), each decoded by ``decode_batch``: detection and
   cw_decode_rate >= 0.95, bits equal to those sent, one K1 launch and no
   K2 launch in the call; and ZC (four roots, 48,000) with CSS (four
   shifts, 96,000) sync at 0 dB, the frame type sent found on >= 0.95 of
   channels; every path equal to the same path on the CPU port;
4d. waveform API and CLI (``ria_tpu_torch.wave.api``, ``ria_tpu_torch.cli``),
   one frame a call with the default device: the 11 captures of the
   reference C++ modem in tests/golden/interop through
   ``create_waveform(...).rx_frame`` (full, then light) byte for byte, and
   ``ref_ping.f32`` through ``cli.main(["prx", ...])``; ``ptx`` -> ``prx``
   loopbacks through ``cli.main`` (auto-detected MC_DPSK, OFDM_CHIRP,
   OFDM_COX, OTFS_EQ; ``-w`` given for OTFS_RAW, DPSK, MFSK; ``connect`` and
   ``ping``); an OFDM 4-frame burst and an AFDM frame with 5 Hz CFO through
   the API; one clean frame per waveform class.  Every result equal to the
   same call with ``device="cpu"`` (ok, bytes, header, flags and start
   exact; CFO and SNR within 1e-3; soft bits within 2e-3), at least one K1
   launch and no K2 launch per ``rx_frame``, the counts printed per waveform;
4e. protocol sessions (``ria_tpu_torch.tools.session_paths``) with the
   default device, at the reference's geometry (48 kHz, 200 ms blocks, the
   40 s ring, ITU-R preset channels, the 10-carrier MC-DPSK handshake, the
   negotiated waveform): S1 (12 dB AWGN, seed 7: connect, a message each
   way, disconnect) in lock step with the same session on the CPU port, both
   fed one CPU generator's draws, every tick equal (states, links, counters,
   ring, pending sync, messages; measured SNR within 1e-3 dB); S2 (6 dB
   AWGN, seed 3, eight messages), S3 (Poor 15 dB, seed 42) and S4 (Good
   -8 dB, seed 42, the session floor: reported, not asserted), each fed
   CPU torch generators' draws (seeds ``seed`` and ``seed + 1``) on the card.  S1-S3 connect and deliver every message, S1 disconnects
   cleanly.  Every K1 launch of every session is held against the plain
   decoder on its own LLRs, and K2 is never launched.  Per session: ticks,
   links, wall seconds, audio seconds per wall second, ms per tick (median,
   p90), the tick split into channel, sync search, header peek, frame decode
   and the rest (host clock, card synchronised), ``decode_time_ms_avg``, K1
   launches and their batch sizes, and the phase's own seconds;
4f. host-control plane (``ria_tpu_torch.tools.host_paths``) with the default
   device: the native runtime library (``native/ria_native.cpp``, g++ at
   first use; its build time) loads through ``native.require()``; H1, two
   modems driven only over TCP (``DualModemTcp(awgn(15), seed=42)``, ports
   picked by the system: the reference's self test, then a compressed and
   AES-256 encrypted 2,048-byte message on a second connection, then
   ``RAWTX``) in lock step with the CPU port, both fed one CPU generator's
   draws (seeds 42, 43), every tick equal (stations, engine states, command
   replies, event lines, data-port bytes; SNR within 1e-3 dB), both payloads
   out of B's data port byte for byte; an attached console reading H1's
   STATUS; H2, the threaded continuous session (two station threads on the
   card, the native ring buffers and Watterson channel), connected and
   delivering within 120 s; H3, ``cli.main(["gui", "--sim", ...,
   "--frames", "10"])`` printing its frame, and a console session (connect,
   a composed message the virtual peer receives).  Every K1 launch of the
   phase is held against the plain decoder, and K2 is never launched.  Per
   run: ticks, wall s, audio s per wall s, ms per tick (median, p90; per
   thread for H2, with how often its backpressure wait ran), K1 launches and
   their batch sizes; for H1 the median ms from a command's send to its reply
   and each payload's ticks from data port in to data port out;
4g. scale-out (``ria_tpu_torch.parallel``, ``ria_tpu_torch.tools.parallel_paths``):
   K1 built here, then one launch of 4 ranks sharing the card (gloo; the
   backend, world size and each rank's device printed), each given only its
   own rows or block, running G1-G7 at the reference's production geometry:
   the batch mesh on phase 4's chain-1 batch (G1) and on phase 4b's OFDM
   batches (G2 #3, #4), 16 rows a rank; the stream RX (G3: 4 blocks of
   192,000, the chirp straddling the first boundary, +5 Hz; and top_k 2 on
   two frames, one straddling); the stream search alone (G4); the OFDM
   stream RX (G5: DQPSK with pilots, R1/2, blocks of 3 x 48,000, 8 dB,
   straddling); the sharded FIR (G6); the (ch=2, t=2) hybrid mesh (G7).
   Every rank's result equal; each case against the single-process port on
   the card (decisions exact, CFO and SNR within 1e-3, soft bits within
   2e-3, the FIR within 1e-5 of ``np.convolve``) and against what was sent
   (every codeword decoded); every K1 launch of every rank held against the
   plain decoder on its own LLRs, K1 launched on every rank of a case that
   decodes, K2 never.  Per case: K1 launches per rank and their batch
   sizes, ms per call (CUDA events, the slowest rank's median of 7) beside
   the same program in one process, and the phase's seconds;
4h. root tools (the twins of ``tools/*.py`` in ``ria_tpu_torch.tools``) with
   the default device, at the tools' own geometry: ``verify_cfo_chain`` (12 Hz
   into an MC-DPSK frame: PASS, the estimate and carrier 0's two phase slopes
   within 1e-3 Hz of the CPU port's); ``throughput_test.measure_rows()`` (the
   12 operating points, each row equal to the CPU port's field for field; the
   table, then the worst net against the reference binary and against the
   published table); ``acceptance_sweep`` at 3 seeds (its 14 cases on CPU
   torch generators' draws, keys 1000 + s: every case at its own threshold,
   seed 0 of each decoding the same bytes as the CPU port); ``otfs_mode_sweep``
   at 3 seeds (OTFS_EQ, OTFS_RAW, OFDM DQPSK R1/2 over Good, Moderate, Poor at
   20 dB, the 3 x 3 table; seed 0 of each arm equal to the CPU port's);
   ``profile_acquisition`` at B = 32 (its six ms figures, CUDA events); and
   ``goodput`` (the reference's three rows, AWGN 25 dB, Good 20 dB, Moderate
   20 dB, at seeds 100 and 101, Moderate at 100 only (a session that does not
   deliver runs 3,000 ticks), CPU generators' draws: AWGN 25 dB seed 100 in
   lock step with the CPU port, every tick equal; both AWGN sessions connect
   and deliver 100%; per session the delivered share, goodput bps, link, air
   and connect seconds, retransmits, ticks and ms per tick, and per row the
   median kbps beside the reference's).  Every K1 launch of the phase is held
   against the plain decoder, and K2 is never launched; per tool its K1
   launches and batch sizes, and the phase's seconds;
4i. the stage profile (``ria_tpu_torch.tools.bench_profile``) at its own
   geometry (the chain-1 batch with every frame at lead 4,000): the
   reference tool's four rows (sync, demod, ldpc, full: ms and Msamp/s,
   CUDA events), then one call of the chain split by its stage spans
   (``utils/trace.span``: ``rx.sync``, ``rx.demod``, ``rx.decode``; device ms and kernels
   each; it fails unless they cover >= 95% of the call's device time); and
   the bf16 path: ``make_decoder(..., precision="bf16")`` on the profile's
   256 codewords with the counts zeroed, the bf16 build launched and the
   float32 build not, every output equal to the plain bf16 decoder's and
   the converged rows' bits to those sent;
4j. bench.py's twin (``ria_tpu_torch.tools.bench``) on bench.py's batches at
   bench.py's counts, counts zeroed just before: bench.py's sanity checks
   hold; each chain call and each ``k1`` and serving call launches K1's
   float32 build once, each ``k1_bf16`` call its bf16 build once, the
   ``plain`` row and K2 nothing, and no launch falls outside those parts;
   K1 ran at B = 256 (chains), 512 (rows) and 4 (serving) only; then K1 and
   K1 bf16 each equal to its plain version on every copy of the LDPC batch,
   and each one's device time on its first copy with bound and share;
5. A/B entry point: ``ria_tpu_torch.tools.ldpc_bench`` at its default size
   (R1/4, B = 512, -1 dB), K1, K2 and the plain decoder reporting the same
   success set and bit accuracy, with K2's launch count from that run; then
   K1 and K2 against their plain versions on those LLRs, bit for bit; then
   ``ldpc_bench --precision bf16`` (the TPU kernels' arithmetic, plain
   float32), with the counts zeroed: the bf16 builds launched and the
   float32 ones not, K1 bf16 and K2 bf16 each equal bit for bit to its plain
   bf16 version on those LLRs, and to each other on all but 1% of rows;
6. serving layer on the card: ``LDPCCodec`` round trips for every rate,
   ``decode_with_retries`` in at most two K1 launches and
   ``decode_candidates``, each equal to the CPU port's result;
7. timing with CUDA events: the RX chain in samples/s; K1 against the plain
   decoder and K2 against ``plain_v1`` and K1, at B = 256 (the main path's
   codewords), B = 512 mixed and the A/B entry point's LLRs; each kernel's
   device time per launch from torch.profiler, its bound (the larger of
   bytes over 3.35 TB/s and operations over 67 TFLOP/s, the H100 SXM's
   published peaks) and the share of the bound it reaches, and the K1/K2
   device-time ratio; the serial floor (K1 and K2, each in both builds, at
   B = 1 on an A/B row that runs all 50 iterations in all four); K1's host microseconds per call; for each
   OFDM chain its ms per call and samples/s, and K1's device time on the
   chain's own 256 codewords with its bound and share; for every chain and
   for its sync and sync-to-soft-bits stages, the ms per call, the device
   kernels, copies and memsets of one call and the share of the call the
   device is busy (profiler trace), and for the whole call its three
   heaviest device kernels; for each waveform path its ms per call split
   into sync, demod and decode (CUDA events between the stages of the same
   calls), K1's device time on its 64 codewords with bound and share, and
   one profiler trace of each stage and of the call; for each waveform
   class the ms per ``rx_frame`` of its clean frame (host clock, the card
   synchronised, second and later calls of a length), the first and second
   ``prx`` of a new recording length (module build against call), and for
   MC-DPSK and OFDM_CHIRP one trace of a ``rx_frame``: device kernels, busy
   share, host-device synchronisations and copies; K1 at the sessions' batch
   sizes (device time, bound and share) and one trace of an S1 tick that
   decodes a frame; K1 at phase 4f's, 4g's and 4h's batch sizes (device
   time, bound, share); K1's and K2's bf16 builds each against its plain
   version and against its float32 build at B = 256 and the A/B point (CUDA
   events, device time, bound and share);
8. a JSON line of the sessions, one of phase 4f's runs, one of phase 4g's
   cases, one of phase 4h's tools, one of the stage profile, the twin's line
   of phase 4j with its seconds, one of the waveform
   classes' ``rx_frame`` times, a JSON line of the kernels, then the last line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Any failure ends the run with a non-zero exit code and no result line.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

RATES_SIGMA = {"R1_4": 2.4, "R1_2": 1.8, "R2_3": 1.5, "R3_4": 1.4, "R5_6": 1.4}
FACTORS = np.array([0.9375, 0.875, 0.75, 0.625, 0.5], np.float32)
LLR_ATOL = 1e-3
# K1 against K2 in their bf16 builds: a last-bit difference of their sums
# can round a gathered posterior to the other bfloat16, which moves a
# message by one bfloat16 ulp (0.03125 at |x| in [4, 8)).
BF16_LLR_ATOL = 0.0625
# Share of a B = 512 batch's rows on which K1 and K2 may part: they group
# their float32 sums otherwise, and near the BP threshold a last-bit
# difference grows.  Each kernel equals its own plain version on every row.
MIXED_MAX_FLIPS = 0.01
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
# A bf16 build (K1's or K2's) adds two roundings per edge and iteration
# (the gathered posterior and the summed c2v), each a conversion there and
# one back.
BF16_OPS_PER_EDGE = OPS_PER_EDGE + 4
# The decoder builds' C entry points, whose launches ``utils/cuda_kernels.py``
# counts: K1, K1 bf16, K2, K2 bf16.
K1, K1_BF16, K2, K2_BF16 = COUNTS = ("ldpc_bp_decode", "ldpc_bp_bf16_decode",
                                     "ldpc_bp_v1_decode", "ldpc_bp_v1_bf16_decode")


def log(msg: str) -> None:
    print(msg, flush=True)


def zero_counts() -> None:
    """Every kernel's launch count set to 0."""
    from ria_tpu_torch.utils import cuda_kernels

    cuda_kernels.reset_launches()


def launch_count(name: str) -> int:
    """Launches of the C entry point ``ria_<name>`` since the counts were last
    zeroed."""
    from ria_tpu_torch.utils import cuda_kernels

    return cuda_kernels.launches(name)


def k2_launches() -> int:
    """K2's launches, either build, since the counts were last zeroed."""
    return launch_count(K2) + launch_count(K2_BF16)


def same_bits(a, b) -> bool:
    """Every output of every row of two decode results equal."""
    return all(torch.equal(x, y) for x, y in zip(a, b))


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


def compare(ref, got, llr_atol: float = LLR_ATOL):
    """(rows that disagree, max |llr| error on rows both converged).  A row
    disagrees when success differs, or, converged in both, when its info
    bits or iteration count differ or its posterior is off by > llr_atol."""
    s_ref, s_got = ref.success.cpu(), got.success.cpu()
    both = s_ref & s_got
    err = (ref.llr_total.cpu() - got.llr_total.cpu()).abs().amax(dim=1)
    bad = s_ref != s_got
    bad |= both & (ref.iterations.cpu() != got.iterations.cpu())
    bad |= both & (ref.info_bits.cpu() != got.info_bits.cpu()).any(dim=1)
    bad |= both & (err > llr_atol)
    max_err = float(err[both].max()) if bool(both.any()) else 0.0
    return int(bad.sum()), max_err


def iteration_counts(iterations: list[int]) -> str:
    """A batch's iteration counts: the list itself up to 8 rows, else
    {count: rows}."""
    if len(iterations) <= 8:
        return str(iterations)
    return str({n: iterations.count(n) for n in sorted(set(iterations))})


def bound_us(dec, kernel: str, B: int, iterations: int) -> tuple[float, str]:
    """(least microseconds, the side that binds) for one launch of ``kernel``
    on B codewords of ``dec``'s code that need ``iterations`` codeword-
    iterations in all: each input byte read once (LLRs, factors, the
    kernel's tables) and each output byte written once (posteriors, info
    bits, success, iterations), against the operations these iterations
    need."""
    n, k = dec.n, dec.k
    io = B * (4 * n + 4) + B * (4 * n + k + 1 + 4)
    t = dec.k2 if kernel.startswith("K2") else dec.k1
    tables = sum(x.numel() * x.element_size() for x in (t.row, t.epos, t.jobs))
    edges = int(dec.row_mask.sum())
    per_edge = BF16_OPS_PER_EDGE if kernel.endswith("bf16") else OPS_PER_EDGE
    ops = iterations * (per_edge * edges + n)
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


# The window pass's tolerance against its plain version: what the order of a
# 16-term float32 sum may move, 2 * 15 * 2**-24 of the terms' magnitudes
# (tests/test_torch_chirp_cuda.py).
ZOOM_ORDER_TOL = 2 * 15 * 2.0**-24


def zoom_front_phase(card: str, dev: torch.device) -> dict:
    """Phase 3b: the chirp search's window pass against its plain version
    and timed, at the benchmark cell's shape (B = 256) and at B = 1; returns
    its ``kernels`` entry."""
    from ria_tpu_torch.sync import chirp, zoom_kernel
    from ria_tpu_torch.utils.timing import cuda_ms, kernel_us

    n = 207328
    det = chirp.ChirpDetector(chirp.ChirpConfig(), n, dev)
    D = 16
    nb, nblk = det.nfft // D, n // D
    rng = np.random.default_rng(23)
    by_batch = {}
    for B in (256, 1):
        x = torch.as_tensor(rng.normal(0, 0.35, (B, n)).astype(np.float32), device=dev)
        x[:, 16 * 300 : 16 * 340] = 0.0
        zb, blk = zoom_kernel.zoom_front(x, det.rot, nb)
        want_zb, want_blk = chirp.zoom_front_plain(x, det.rot, nb)
        torch.cuda.synchronize()
        xg = x[:, : nblk * D].double().reshape(B, nblk, D)
        rot = det.rot.reshape(nblk, D)
        differ = 0
        for got, want, scale in (
                (zb.real, want_zb.real, (xg * rot.real.double()).abs().sum(-1)),
                (zb.imag, want_zb.imag, (xg * rot.imag.double()).abs().sum(-1)),
                (blk, want_blk, (xg * xg).sum(-1))):
            gap = (got[:, :nblk].double() - want[:, :nblk].double()).abs()
            differ += int((gap > 0).sum())
            if not bool((gap <= ZOOM_ORDER_TOL * scale).all()):
                raise AssertionError(f"zoom_front differs from its plain version at B={B} "
                                     "beyond the order of a 16-term sum")
        if not (bool((zb[:, 300:340] == 0).all()) and bool((blk[:, 300:340] == 0).all())
                and bool((zb[:, nblk:] == 0).all())):
            raise AssertionError(f"zoom_front: an all-zero group or the padding is not 0 (B={B})")
        io = 4 * B * n + 8 * B * nb + 4 * B * nblk + 8 * D * nblk
        bound = io / HBM_BYTES_PER_S * 1e6
        us, how = kernel_us(lambda: zoom_kernel.zoom_front(x, det.rot, nb), "zoom_front_kernel")
        plain = cuda_ms(lambda: chirp.zoom_front_plain(x, det.rot, nb), reps=20)
        log(f"[3b zoom_front] B={B} n={n}: values differing from the plain version {differ} "
            f"of {3 * B * nblk}; {us:.2f} us per launch ({how}), bound {bound:.2f} us "
            f"({io / 1e6:.3f} MB), {bound / us:.1%} of it; plain version {plain[0]:.4f} ms "
            f"(min {plain[1]:.4f}, max {plain[2]:.4f}) ({card})")
        by_batch[str(B)] = {"device_us": us, "bound_us": bound, "plain_ms": plain[0],
                            "values_differing": differ}
    main = by_batch["256"]
    return {"name": "zoom_front", "route": "cuda", "source": "ria_tpu_torch/csrc/zoom_front.cu",
            "replaces": None, "launches_per_call": 1, "device_us": main["device_us"],
            "ms": main["device_us"] / 1e3, "plain_ms": main["plain_ms"],
            "bound_us": main["bound_us"], "bound_ms": main["bound_us"] / 1e3,
            "bound_by": "bytes", "library_ms": None, "by_batch": by_batch}


def sc_windows(cfg, B: int, n: int, dev: torch.device, seed: int) -> torch.Tensor:
    """[B, n] float32 windows on the card: a frame of the port's TX at a lead
    in each row at 20 dB, every 5th row noise alone, every 7th all zeros."""
    from ria_tpu_torch.wave import ofdm

    rng = np.random.default_rng(seed)
    frames = [ofdm.tx_frame(rng.integers(0, 2, 4 * 648), cfg, "cox",
                            tx_cfo_hz=float(rng.uniform(-20.0, 20.0))) for _ in range(4)]
    x = np.zeros((B, n), np.float32)
    for b in range(B):
        f = frames[b % 4]
        if b % 5 != 4:
            lead = int(rng.integers(0, n - len(f) + 1))
            x[b, lead : lead + len(f)] = f
    x += rng.standard_normal((B, n), dtype=np.float32) * np.float32(
        np.sqrt(np.mean(frames[0] ** 2)) / 10.0)
    x[3::7] = 0.0
    return torch.as_tensor(x, device=dev)


def sc_search_phase(card: str, dev: torch.device) -> dict:
    """Phase 3c: the Schmidl-Cox search's kernels against the plain search on
    the card and timed, at both OFDM cells' shapes; returns their ``kernels``
    entry."""
    from ria_tpu_torch.utils.timing import cuda_ms, kernel_us
    from ria_tpu_torch.wave import ofdm

    shapes = {"ofdm_qam64_r34": (ofdm.OFDMConfig(modulation="QAM64", use_pilots=True,
                                                 pilot_spacing=8), 2048, 26160),
              "ofdm_dqpsk_r14": (ofdm.OFDMConfig(modulation="DQPSK"), 1024, 42720)}
    by_cell = {}
    for cell, (cfg, B, n) in shapes.items():
        det = ofdm.SchmidlCoxDetector(cfg, n, dev)
        x = sc_windows(cfg, B, n, dev, seed=B)
        got, want = det(x), det.search_plain(x)
        torch.cuda.synchronize()
        for name, g, w in zip(ofdm.SCSyncResult._fields, got, want):
            gb, wb = (t.view(torch.int32) if t.dtype == torch.float32 else t for t in (g, w))
            if not torch.equal(gb, wb):
                raise AssertionError(f"the Schmidl-Cox kernels' {name} differs from the plain "
                                     f"search in {int((gb != wb).sum())} of {B} rows ({cell})")
        R, L, sym, nfft = det.R, det.L, cfg.symbol_samples, det.nfft
        seg_len = sym + L
        seg_nfft = 1 << (seg_len - 1).bit_length()
        # Each input byte read once, each output byte written once.
        io = {"sc_pad": B * (8 * (nfft - R) + 4 * (seg_nfft - seg_len)),
              "sc_coarse": 4 * B * n + 8 * (n // 8 * 8) + 12 * B,
              "sc_slice": B * (4 + 4 * R + 8 * R),
              "sc_pick": B * (4 + 8 * (R - L) + 4 * R + 8 * seg_len + 8),
              "sc_decide": B * (8 + 16 + 9)}
        kernels = {}
        for name, nbytes in io.items():
            us, how = kernel_us(lambda: det(x), f"{name}_kernel")
            bound = nbytes / HBM_BYTES_PER_S * 1e6
            kernels[name] = {"device_us": us, "bound_us": bound, "bytes": nbytes}
            log(f"[3c sc_search] {cell} B={B} n={n}: {name} {us:.2f} us per launch ({how}), "
                f"bound {bound:.2f} us ({nbytes / 1e6:.3f} MB), {bound / us:.1%} of it ({card})")
        search = cuda_ms(lambda: det(x), reps=20)
        plain = cuda_ms(lambda: det.search_plain(x), reps=10)
        log(f"[3c sc_search] {cell}: the search {search[0]:.4f} ms a call on the card (min "
            f"{search[1]:.4f}, max {search[2]:.4f}), the plain search {plain[0]:.4f} ms (min "
            f"{plain[1]:.4f}, max {plain[2]:.4f}); five outputs equal bit for bit, "
            f"{int(got.detected.sum())}/{B} detected ({card})")
        by_cell[cell] = {"kernels": kernels, "search_ms": search[0], "plain_ms": plain[0],
                         "B": B, "n": n}
    main = by_cell["ofdm_qam64_r34"]
    device_us = sum(k["device_us"] for k in main["kernels"].values())
    bound_us = sum(k["bound_us"] for k in main["kernels"].values())
    return {"name": "sc_search", "route": "cuda", "source": "ria_tpu_torch/csrc/sc_search.cu",
            "replaces": None, "launches_per_call": 1, "device_us": device_us,
            "ms": main["search_ms"], "plain_ms": main["plain_ms"], "bound_us": bound_us,
            "bound_ms": bound_us / 1e3, "bound_by": "bytes", "library_ms": None,
            "by_cell": by_cell}


def demap_inputs(cfg, B: int, S: int, broadcast: bool, dev: torch.device, seed: int):
    """(eq [B, S, D] complex64, carrier_nv of its shape) on the card: the
    constellation's points (DQPSK's as its differential phases) under noise
    at about 20 dB, each carrier's noise variance in [1e-3, 0.05] (every 7th
    row's at the ceiling, 100), broadcast over the symbols or drawn a
    symbol."""
    from ria_tpu_torch.wave import ofdm

    rng = np.random.default_rng(seed)
    D = cfg.num_data_carriers
    table = ofdm.constellation_table(cfg.modulation)
    pts = table[rng.integers(0, len(table), (B, S, D))]
    if cfg.modulation in ofdm.DIFFERENTIAL:
        pts = np.cumprod(pts, axis=1)
    noise = (rng.standard_normal((B, S, D)) + 1j * rng.standard_normal((B, S, D))) * 0.07
    eq = torch.as_tensor((pts + noise).astype(np.complex64), device=dev)
    nv = rng.uniform(1e-3, 0.05, (B, 1 if broadcast else S, D)).astype(np.float32)
    nv[::7] = ofdm.MAX_CARRIER_NOISE_VAR
    return eq, torch.as_tensor(nv, device=dev).expand(B, S, D)


def ofdm_demap_phase(card: str, dev: torch.device) -> dict:
    """Phase 3d: the demap stage's kernel against its plain version on the
    card and timed, at both OFDM cells' shapes and at a long frame;
    returns its ``kernels`` entry."""
    from ria_tpu_torch.utils.timing import cuda_ms, kernel_us
    from ria_tpu_torch.wave import demap_kernel, ofdm

    shapes = {"ofdm_dqpsk_r14": (ofdm.OFDMConfig(modulation="DQPSK"), 1024, 22, True),
              "ofdm_qam64_r34": (ofdm.OFDMConfig(modulation="QAM64", use_pilots=True,
                                                 pilot_spacing=8), 2048, 9, False),
              "dqpsk_s200": (ofdm.OFDMConfig(modulation="DQPSK"), 64, 200, True)}
    by_cell = {}
    for cell, (cfg, B, S, broadcast) in shapes.items():
        mod, ce = cfg.modulation, ofdm.CE_MARGIN[cfg.modulation]
        demod = ofdm.OFDMDemodulator(cfg, S, 2, dev)
        eq, nv = demap_inputs(cfg, B, S, broadcast, dev, seed=B + S)
        got = demap_kernel.demap(eq, nv, ce, mod)
        want = demod.demap_plain(eq, nv, ce)
        torch.cuda.synchronize()
        differ = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        if differ:
            raise AssertionError(f"ofdm_demap differs from its plain version in {differ} of "
                                 f"{got.numel()} LLRs ({cell})")
        D, bps = eq.shape[-1], demap_kernel.MODULATIONS[mod][1]
        io = 8 * B * S * D + 4 * B * (1 if broadcast else S) * D + 4 * B * S * D * bps
        bound = io / HBM_BYTES_PER_S * 1e6
        us, how = kernel_us(lambda: demap_kernel.demap(eq, nv, ce, mod), "ofdm_demap_kernel")
        plain = cuda_ms(lambda: demod.demap_plain(eq, nv, ce), reps=20)
        log(f"[3d ofdm_demap] {cell} [{B}, {S}, {D}] {mod}: equal bit for bit; {us:.2f} us per "
            f"launch ({how}), bound {bound:.2f} us ({io / 1e6:.3f} MB), {bound / us:.1%} of "
            f"it; plain version {plain[0]:.4f} ms (min {plain[1]:.4f}, max {plain[2]:.4f}) "
            f"({card})")
        by_cell[cell] = {"device_us": us, "bound_us": bound, "plain_ms": plain[0],
                         "shape": [B, S, D]}
    main = by_cell["ofdm_qam64_r34"]
    return {"name": "ofdm_demap", "route": "cuda", "source": "ria_tpu_torch/csrc/ofdm_demap.cu",
            "replaces": None, "launches_per_call": 1, "device_us": main["device_us"],
            "ms": main["device_us"] / 1e3, "plain_ms": main["plain_ms"],
            "bound_us": main["bound_us"], "bound_ms": main["bound_us"] / 1e3,
            "bound_by": "bytes", "library_ms": None, "by_cell": by_cell}


def chirp_fine_phase(card: str, dev: torch.device) -> dict:
    """Phase 3e: the chirp search's fine-stage kernels against their plain
    versions on the card and timed, at both MC-DPSK cells' shapes (a
    zoom-branch call's up-chirp refinement and its CFAR median); returns
    their ``kernels`` entry."""
    from ria_tpu_torch.sync import chirp, fine_kernel
    from ria_tpu_torch.utils.timing import cuda_ms, kernel_us

    shapes = {"mcdpsk_r14": (256, 207328), "mcdpsk_s4_r14": (128, 606688)}
    R = chirp._ZOOM_REFINE
    by_cell = {}
    for cell, (B, n) in shapes.items():
        det = chirp.chirp_detector(chirp.ChirpConfig(), n, dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(B)
        x = 0.35 * torch.randn((B, n), generator=gen, device=dev)
        pos = torch.randint(0, (n - det.chirp_len) // 16, (B,), generator=gen, device=dev,
                            dtype=torch.int32) * 16
        nb = det.nfft // 16
        m = -(-(n - det.chirp_len) // 16)
        norm = torch.rand((B, nb), generator=gen, device=dev) * 0.05
        front = fine_kernel.refine_front(x, pos, det.chirp_len, R)
        cr, ci = front[1] @ det.up_mr, front[1] @ det.up_mi
        got = [*front, *chirp.refine_pick(cr, ci, front[2], front[0], det.energy),
               chirp._median(norm[:, :m])]
        plain_front = chirp.refine_front_plain(x, pos, det.chirp_len, R)
        want = [*plain_front, *chirp.refine_pick_plain(cr, ci, plain_front[2], plain_front[0],
                                                        det.energy),
                chirp.median_plain(norm[:, :m])]
        torch.cuda.synchronize()
        for name, g, w in zip(("start", "y", "win", "lag", "val", "median"), got, want):
            gb, wb = (v.view(torch.int32) if v.dtype == torch.float32 else v for v in (g, w))
            if not torch.equal(gb, wb):
                raise AssertionError(f"chirp fine stage: {name} differs from the plain path "
                                     f"({cell})")
        L, nwin = det.chirp_len + 2 * R, 2 * R + 1
        # Each input byte read once, each output byte written once.
        runs = {"chirp_refine_front": (lambda: fine_kernel.refine_front(x, pos, det.chirp_len, R),
                                       8 * B * L + 4 * B * nwin + 8 * B),
                "chirp_refine_pick": (lambda: chirp.refine_pick(cr, ci, front[2], front[0],
                                                                det.energy),
                                      12 * B * nwin + 12 * B),
                "median_select": (lambda: chirp._median(norm[:, :m]), 4 * B * m + 4 * B)}
        kernels = {}
        for name, (fn, nbytes) in runs.items():
            us, how = kernel_us(fn, f"{name}_kernel")
            bound = nbytes / HBM_BYTES_PER_S * 1e6
            kernels[name] = {"device_us": us, "bound_us": bound, "bytes": nbytes}
            log(f"[3e chirp_fine] {cell} B={B}: {name} {us:.2f} us per launch ({how}), bound "
                f"{bound:.2f} us ({nbytes / 1e6:.3f} MB), {bound / us:.1%} of it ({card})")

        def plain_stage():
            p = chirp.refine_front_plain(x, pos, det.chirp_len, R)
            chirp.refine_pick_plain(p[1] @ det.up_mr, p[1] @ det.up_mi, p[2], p[0], det.energy)
            chirp.median_plain(norm[:, :m])

        def kernel_stage():
            k = fine_kernel.refine_front(x, pos, det.chirp_len, R)
            chirp.refine_pick(k[1] @ det.up_mr, k[1] @ det.up_mi, k[2], k[0], det.energy)
            chirp._median(norm[:, :m])

        stage = cuda_ms(kernel_stage, reps=20)
        plain = cuda_ms(plain_stage, reps=10)
        log(f"[3e chirp_fine] {cell} B={B} n={n}: a refinement and the median {stage[0]:.4f} ms "
            f"on the card with the kernels (min {stage[1]:.4f}, max {stage[2]:.4f}), "
            f"{plain[0]:.4f} ms with the plain path (min {plain[1]:.4f}, max {plain[2]:.4f}); "
            f"every output equal bit for bit ({card})")
        by_cell[cell] = {"kernels": kernels, "stage_ms": stage[0], "plain_ms": plain[0],
                         "B": B, "n": n}
    main = by_cell["mcdpsk_r14"]
    device_us = sum(k["device_us"] for k in main["kernels"].values())
    bound_us = sum(k["bound_us"] for k in main["kernels"].values())
    return {"name": "chirp_fine", "route": "cuda", "source": "ria_tpu_torch/csrc/chirp_fine.cu",
            "replaces": None, "launches_per_call": 5, "device_us": device_us,
            "ms": main["stage_ms"], "plain_ms": main["plain_ms"], "bound_us": bound_us,
            "bound_ms": bound_us / 1e3, "bound_by": "bytes", "library_ms": None,
            "by_cell": by_cell}


def lts_windows(cfg, B: int, n: int, dev: torch.device, seed: int) -> torch.Tensor:
    """[B, n] float32 windows on the card: a light-preamble frame of the
    port's TX at a lead in each row at 15 dB, every 5th row noise alone,
    every 7th all zeros."""
    from ria_tpu_torch.wave import ofdm

    rng = np.random.default_rng(seed)
    frames = [ofdm.tx_frame(rng.integers(0, 2, 4 * 648), cfg, "lts",
                            tx_cfo_hz=float(rng.uniform(-20.0, 20.0))) for _ in range(4)]
    x = np.zeros((B, n), np.float32)
    for b in range(B):
        f = frames[b % 4]
        if b % 5 != 4:
            lead = int(rng.integers(0, n - len(f) + 1))
            x[b, lead : lead + len(f)] = f
    x += rng.standard_normal((B, n), dtype=np.float32) * np.float32(
        np.sqrt(np.mean(frames[0] ** 2)) / np.sqrt(10.0 ** 1.5))
    x[3::7] = 0.0
    return torch.as_tensor(x, device=dev)


def lts_search_phase(card: str, dev: torch.device) -> dict:
    """Phase 3f: the LTS search's kernels against the plain search on the
    card and timed, at the light cell's shape; returns their ``kernels``
    entry."""
    from ria_tpu_torch.utils.timing import cuda_ms, kernel_us
    from ria_tpu_torch.wave import ofdm

    cfg = ofdm.OFDMConfig(modulation="DQPSK", use_pilots=True, pilot_spacing=10)
    B, n = 1024, 48000
    det = ofdm.LTSDetector(cfg, n, 0.5, dev)
    x = lts_windows(cfg, B, n, dev, seed=B)
    got, want = det(x), det.search_plain(x)
    torch.cuda.synchronize()
    for name, g, w in zip(ofdm.LTSSyncResult._fields, got, want):
        gb, wb = (t.view(torch.int32) if t.dtype == torch.float32 else t for t in (g, w))
        if not torch.equal(gb, wb):
            raise AssertionError(f"the LTS search kernels' {name} differs from the plain "
                                 f"search in {int((gb != wb).sum())} of {B} rows")
    nfft, lags = det.nfft, n - det.L
    # Each input byte read once, each output byte written once.
    io = {"lts_pad": 8 * B * (nfft - n),
          "lts_front": B * (4 * n + 8 * n + 4 * lags + 4),
          "lts_pick": B * (8 * lags + 4 * lags + 4 + 20),
          "lts_decide": B * (8 + 5)}
    kernels = {}
    for name, nbytes in io.items():
        us, how = kernel_us(lambda: det(x), f"{name}_kernel")
        bound = nbytes / HBM_BYTES_PER_S * 1e6
        kernels[name] = {"device_us": us, "bound_us": bound, "bytes": nbytes}
        log(f"[3f lts_search] B={B} n={n}: {name} {us:.2f} us per launch ({how}), "
            f"bound {bound:.2f} us ({nbytes / 1e6:.3f} MB), {bound / us:.1%} of it ({card})")
    search = cuda_ms(lambda: det(x), reps=20)
    plain = cuda_ms(lambda: det.search_plain(x), reps=10)
    log(f"[3f lts_search] B={B} n={n}: the search {search[0]:.4f} ms a call on the card (min "
        f"{search[1]:.4f}, max {search[2]:.4f}), the plain search {plain[0]:.4f} ms (min "
        f"{plain[1]:.4f}, max {plain[2]:.4f}); five outputs equal bit for bit, "
        f"{int(got.detected.sum())}/{B} detected ({card})")
    device_us = sum(k["device_us"] for k in kernels.values())
    bound_us = sum(k["bound_us"] for k in kernels.values())
    # ``launches`` and ``launches_per_call`` come from the light chain (4b).
    return {"name": "lts_search", "route": "cuda", "source": "ria_tpu_torch/csrc/lts_search.cu",
            "replaces": None, "launches_per_call": None, "device_us": device_us,
            "ms": search[0], "plain_ms": plain[0], "bound_us": bound_us,
            "bound_ms": bound_us / 1e3, "bound_by": "bytes", "library_ms": None,
            "kernels": kernels, "B": B, "n": n}


LTS_ENTRIES = ("lts_pad", "lts_front", "lts_pick", "lts_decide")


def lts_launches() -> list[int]:
    """The LTS search's kernels' launches since the counts were last zeroed."""
    return [launch_count(name) for name in LTS_ENTRIES]


def light_chain_phase(dev: torch.device, lts_entry: dict) -> None:
    """Phase 4b's light chain: ``make_ofdm_rx_pipeline(..., preamble="lts")``
    at the light cell's shape, one call from the port's own TX, its LTS
    search through the kernels once; sets ``lts_entry``'s launches from that
    call."""
    from ria_tpu_torch.entry import FRAME_CODEWORDS
    from ria_tpu_torch.fec.ldpc_matrix import get_code
    from ria_tpu_torch.phy.frame_v2 import encode_fixed_frame
    from ria_tpu_torch.phy.pipeline import make_ofdm_rx_pipeline
    from ria_tpu_torch.utils.bits import bytes_to_bits
    from ria_tpu_torch.wave import ofdm

    # Config #3 with 6 pilots behind the light preamble, R1/2, 15 dB; 1,024
    # channels of 48,000 samples, leads in [0, 16000), 8 distinct frames.
    cfg = ofdm.OFDMConfig(modulation="DQPSK", use_pilots=True, pilot_spacing=10)
    rate, ci_bits, B, n, max_lead, snr_db = "R1_2", 106, 1024, 48000, 16000, 15.0
    k = get_code(rate).k
    bpc = k // 8
    rng = np.random.default_rng(B)
    pool = []
    for _ in range(8):
        payload = rng.integers(0, 256, FRAME_CODEWORDS * bpc).astype(np.uint8)
        info = np.zeros((FRAME_CODEWORDS, k), np.uint8)
        info[:, : 8 * bpc] = bytes_to_bits(payload).reshape(FRAME_CODEWORDS, 8 * bpc)
        pool.append((ofdm.tx_frame(encode_fixed_frame(payload.tobytes(), rate, ci_bits), cfg,
                                   preamble="lts"), info))
    leads = rng.integers(0, max_lead, B)
    audio = np.zeros((B, n), np.float32)
    sent = np.zeros((B, FRAME_CODEWORDS, k), np.uint8)
    for b in range(B):
        tx, sent[b] = pool[b % len(pool)]
        audio[b, leads[b] : leads[b] + len(tx)] = tx
    rms = float(np.sqrt(np.mean(pool[0][0] ** 2)))
    audio += rng.standard_normal(audio.shape, dtype=np.float32) * np.float32(
        rms * 10 ** (-snr_db / 20))
    audio = torch.as_tensor(audio, device=dev)

    lrx = make_ofdm_rx_pipeline(cfg, rate, n, ci_bits, device=dev, preamble="lts")
    torch.cuda.synchronize()
    zero_counts()
    out = lrx(audio)
    torch.cuda.synchronize()
    launched = dict(zip(LTS_ENTRIES, lts_launches()))
    decodes = (launch_count(K1), k2_launches())
    tag = f"[4b light] config #3 DQPSK R1_2 with 6 pilots at {snr_db:g} dB, B={B} window={n}"
    det = out.detected.cpu().numpy()
    ok = out.cw_success.cpu().numpy()
    gap = np.abs(out.lts_start.cpu().numpy().astype(np.int64) - leads)
    log(f"{tag}: detected {int(det.sum())}/{B}, max |start - lead| {int(gap.max())}, "
        f"cw_decode_rate {ok.mean():.4f}, LTS kernel launches {launched}, "
        f"Schmidl-Cox searches {launch_count('sc_coarse')}, K1 launches {decodes[0]}, "
        f"K2 launches {decodes[1]}")
    if list(launched.values()) != [1] * len(LTS_ENTRIES):
        raise AssertionError(f"the light chain launched the LTS search's kernels {launched}; "
                             "each once expected")
    if launch_count("sc_coarse"):
        raise AssertionError("the light chain ran a Schmidl-Cox search")
    if decodes[0] < 1 or decodes[1]:
        raise AssertionError(f"the light chain launched K1 {decodes[0]} and K2 {decodes[1]} "
                             "times; at least 1 and 0 expected")
    if not det.all() or gap.max() > 16:
        raise AssertionError(f"{int(det.sum())}/{B} channels detected, max |start - lead| "
                             f"{int(gap.max())}; all, and at most 16, expected")
    if ok.mean() < 0.95:
        raise AssertionError(f"cw_decode_rate {ok.mean():.4f} < 0.95")
    if not (out.info_bits.cpu().numpy() == sent)[ok].all():
        raise AssertionError("decoded info bits differ from the transmitted bits")
    # The chain's search is the plain search's, bit for bit, on the card.
    plain = lrx.sync.search_plain(audio)
    for name in ("detected", "lts_start", "cfo_hz"):
        got, want = getattr(out, name), getattr(plain, name)
        if want.dtype == torch.float32:
            got, want = got.view(torch.int32), want.view(torch.int32)
        if not torch.equal(got, want):
            raise AssertionError(f"the light chain's {name} differs from the plain search's on "
                                 "the card")
    log(f"{tag}: detected/lts_start/cfo_hz equal to the plain search's on the card bit for bit")
    lts_entry["launches"] = launched["lts_front"]
    lts_entry["launches_per_call"] = launched["lts_front"]


def run_cli(argv: list[str]) -> tuple[int, str, str]:
    """(return code, stdout, stderr) of ``ria_tpu_torch.cli.main(argv)``."""
    from ria_tpu_torch import cli

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    return rc, out.getvalue(), err.getvalue()


def waveform_api_phase(dev: torch.device) -> dict:
    """Phase 4d.  Returns {"frames": {class: (its rx_frame call, waveform,
    audio)}, "launches": {label: (K1, K2) of one rx_frame or prx},
    "codewords": the MC-DPSK clean frame's LLRs [4, 648], "noisy_codewords":
    those of the MC-DPSK frame near its decode floor, "k1_err": the largest
    |llr| error of a K1 call of this phase against the plain decoder} for
    the timing phase and the kernels line.

    Every K1 call of every rx_frame, rx_burst and prx here is held against
    the plain decoder on the call's own LLRs and factors: the header peek
    and the control frames at B = 1, the bodies at B = total_cw and B = 4."""
    from ria_tpu_torch.phy.frame_v2 import WaveformMode, make_fixed_data_frame
    from ria_tpu_torch.tools import waveform_frames as F
    from ria_tpu_torch.wave.api import create_waveform

    launches: dict[str, tuple[int, int]] = {}
    k1_held: list[dict] = []

    def hold_k1(tag: str, calls, k1: int) -> str:
        """The call's K1 launches against the plain decoder; a summary."""
        if len(calls) != k1:
            raise AssertionError(f"{tag}: {k1} K1 launches, {len(calls)} of them recorded")
        rows = F.hold_k1_calls(calls, tag)
        k1_held.extend(rows)
        if not rows:
            return "K1 vs plain: no launch"
        return "K1 vs plain: " + ", ".join(
            f"B={r['B']} k={r['k']} iterations {iteration_counts(r['iterations'])} max |llr err| "
            f"{r['max_abs_err']:.3g}" for r in rows) + ", every row equal bit for bit"

    def held(tag: str, card_call, cpu_call, check, key: str | None = None):
        """One rx_frame on the card, counted, checked, and held against the
        CPU's; its launches are kept under ``key`` (default the tag)."""
        got, k1, k2, calls = F.counted_k1(card_call)
        check(got)
        errs = F.same_rx(got, cpu_call(), tag)
        launches[key or tag] = (k1, k2)
        k1_vs_plain = hold_k1(tag, calls, k1)
        log(f"[4d api] {tag}: ok, start {got.start_sample}, cfo {got.cfo_hz:.3f} Hz, snr "
            f"{got.snr_db:.2f} dB, K1 launches {k1}, K2 launches {k2}; card vs CPU: bytes/header/"
            f"flags/start equal, |cfo err| {errs['cfo_hz']:.3g} Hz, |snr err| "
            f"{errs['snr_db']:.3g} dB, |soft-bit err| {errs['soft_bits']:.3g}; {k1_vs_plain}")
        if k1 < 1 or k2:
            raise AssertionError(f"{tag}: K1 launches {k1}, K2 launches {k2}")
        return got

    # The reference modem's captures, with the default device.
    for fixture, mode, mod, rate in F.CAPTURES:
        audio = F.capture(fixture)
        wf = create_waveform(WaveformMode[mode], mod, rate)
        if wf.device.type != "cuda":
            raise AssertionError("create_waveform's default device is not the card")
        cpu_wf = create_waveform(WaveformMode[mode], mod, rate, device="cpu")
        held(f"capture {fixture} ({len(audio)} samples)",
             lambda: F.rx_full_then_light(wf, audio), lambda: F.rx_full_then_light(cpu_wf, audio),
             lambda rx: F.check_capture_frame(rx, fixture), key=f"capture {fixture}")
    ping = str(F.CAPTURE_DIR / F.PING_CAPTURE)
    (rc, out, _), k1, k2, calls = F.counted_k1(lambda: run_cli(["prx", ping, "-w", "MC_DPSK"]))
    log(f"[4d api] prx {F.PING_CAPTURE} -w MC_DPSK: rc {rc}, {out.strip()!r}, K1 launches {k1}, "
        f"K2 launches {k2}; {hold_k1('prx of the PING capture', calls, k1)}")
    if rc != 0 or "type=PING" not in out or k2:
        raise AssertionError("the reference's PING capture was not read as a PING")
    if run_cli(["--device", "cpu", "prx", ping, "-w", "MC_DPSK"])[:2] != (rc, out):
        raise AssertionError("prx of the PING capture differs between the card and the CPU")

    # ptx -> prx through the command line, with the default device.
    with tempfile.TemporaryDirectory() as tmp:
        loops = [(w, f"loopback {w}", []) for w in ("MC_DPSK", "OFDM_CHIRP", "OFDM_COX", "OTFS_EQ")]
        loops += [(w, f"loopback {w}", ["-w", w]) for w in ("OTFS_RAW", "DPSK", "MFSK")]
        loops += [("MC_DPSK", "connect", []), ("MC_DPSK", "ping", [])]
        for wfn, text, given in loops:
            path = os.path.join(tmp, f"{wfn}_{text.split()[0]}.f32")
            rc, _, err = run_cli(["ptx", text, "-s", "W1AW", "-d", "VE3ABC", "-w", wfn,
                                  "-o", path])
            if rc != 0:
                raise AssertionError(f"ptx {text!r} -w {wfn}: rc {rc}: {err}")
            (rc, out, err), k1, k2, calls = F.counted_k1(
                lambda: run_cli(["prx", path] + given))
            tag = f"prx of ptx {text!r} -w {wfn}" + ("" if given else " (auto-detect)")
            launches[tag] = (k1, k2)
            k1_vs_plain = hold_k1(tag, calls, k1)
            want = {"connect": "type=CONNECT src=W1AW dst=VE3ABC", "ping": "type=PING"}.get(
                text, text)
            log(f"[4d api] {tag}: rc {rc}, {out.strip().splitlines()[:2]}, "
                f"{err.strip().splitlines()[-1]!r}, K1 launches {k1}, K2 launches {k2}; "
                f"{k1_vs_plain}")
            if rc != 0 or want not in out or k2 or (text != "ping" and k1 < 1):
                raise AssertionError(f"{tag} failed: {out!r}")
            if not given and text.startswith("loopback") and f"waveform={wfn}" not in err:
                raise AssertionError(f"{tag}: auto-detect announced {err!r}")
            rc_c, out_c, _ = run_cli(["--device", "cpu", "prx", path] + given)
            # The last line's snr/cfo are printed to one decimal: the frames
            # themselves are held to the CPU's below, the other lines here.
            if rc_c != rc or out_c.splitlines()[:-1] != out.splitlines()[:-1]:
                raise AssertionError(f"{tag} differs between the card and the CPU")

    # The OFDM burst and AFDM through the API.
    wf = create_waveform(WaveformMode.OFDM_CHIRP, "DQPSK", "R1_2")
    cpu_wf = create_waveform(WaveformMode.OFDM_CHIRP, "DQPSK", "R1_2", device="cpu")
    frames = [make_fixed_data_frame("W1AW", "VE3ABC", i, f"burst frame {i}".encode(),
                                    "R1_2").serialize() for i in range(4)]
    audio = F.awgn(wf.tx_burst(frames), 15.0, seed=8)
    (got, snr, fading), k1, k2, calls = F.counted_k1(lambda: wf.rx_burst(audio, group=4))
    want, snr_c, fading_c = cpu_wf.rx_burst(audio, group=4)
    launches["rx_burst OFDM_CHIRP group 4"] = (k1, k2)
    log(f"[4d api] rx_burst OFDM_CHIRP DQPSK R1/2, 4 frames: {sum(ok for ok, _ in got)}/4 frames, "
        f"snr {snr:.2f} dB, K1 launches {k1}, K2 launches {k2}; card vs CPU: frames equal, "
        f"|snr err| {abs(snr - snr_c):.3g} dB, |fading err| {abs(fading - fading_c):.3g}; "
        f"{hold_k1('rx_burst', calls, k1)}")
    if got != want or [fb for _, fb in got] != frames or k1 < 1 or k2:
        raise AssertionError("the OFDM burst on the card")
    if abs(snr - snr_c) > F.RX_TOL or abs(fading - fading_c) > F.RX_TOL:
        raise AssertionError("the OFDM burst's snr or fading differs between the card and the CPU")
    afdm = create_waveform(WaveformMode.AFDM)
    cpu_afdm = create_waveform(WaveformMode.AFDM, device="cpu")
    fb = F.control_frame_bytes()
    audio = F.awgn(afdm.tx_frame(fb, tx_cfo_hz=5.0), 10.0, seed=9)
    (ok, got_fb, info), k1, k2, calls = F.counted_k1(lambda: afdm.rx_frame(audio))
    ok_c, fb_c, info_c = cpu_afdm.rx_frame(audio)
    launches["AFDMWaveform"] = (k1, k2)
    log(f"[4d api] AFDM frame with 5 Hz CFO: ok {ok}, start {info.get('start')}, cfo "
        f"{info.get('cfo_hz', 0.0):.3f} Hz, K1 launches {k1}, K2 launches {k2}; card vs CPU: "
        f"bytes and start equal, |cfo err| {abs(info['cfo_hz'] - info_c['cfo_hz']):.3g} Hz; "
        f"{hold_k1('AFDM', calls, k1)}")
    if not ok or got_fb[:20] != fb or (ok_c, fb_c, info_c["start"]) != (ok, got_fb, info["start"]):
        raise AssertionError("the AFDM frame on the card")
    if abs(info["cfo_hz"] - info_c["cfo_hz"]) > F.RX_TOL or k1 < 1 or k2:
        raise AssertionError("the AFDM frame's cfo or launches on the card")
    api_frames = {"AFDMWaveform": (lambda a=afdm, x=audio: a.rx_frame(x), afdm, audio)}

    # One clean frame per waveform class: K1 launches a rx_frame.
    for spec in F.CLEAN_FRAMES:
        wf, audio, _ = F.make_clean_frame(spec, seed=0)
        cpu_wf = F.make_clean_frame(spec, seed=0, device="cpu")[0]
        rx = held(f"{spec.name} {spec.modulation or spec.mode} {spec.rate} at {spec.snr_db:g} dB "
                  f"({len(audio)} samples)",
                  lambda: wf.rx_frame(audio, light=spec.light),
                  lambda: cpu_wf.rx_frame(audio, light=spec.light),
                  lambda rx: F.check_clean_frame(rx, spec), key=spec.name)
        api_frames[spec.name] = (lambda w=wf, x=audio, s=spec: w.rx_frame(x, light=s.light),
                                 wf, audio)
        if spec.mode == "MC_DPSK":
            codewords = rx.soft_bits.reshape(-1, 648)

    # Near the decode floor, so that K1 is held to the plain decoder over
    # several iterations at the API's batch sizes, not only over the first.
    for spec in F.NOISY_FRAMES:
        wf, audio, _ = F.make_clean_frame(spec, seed=0)
        cpu_wf = F.make_clean_frame(spec, seed=0, device="cpu")[0]
        seen = len(k1_held)
        rx = held(f"noisy {spec.name} {spec.modulation} {spec.rate} at {spec.snr_db:g} dB "
                  f"({len(audio)} samples)",
                  lambda: wf.rx_frame(audio), lambda: cpu_wf.rx_frame(audio),
                  lambda rx: F.check_clean_frame(rx, spec), key=f"noisy {spec.name}")
        deep = [r for r in k1_held[seen:] if r["B"] == 4 and r["converged"] == 4
                and np.mean(r["iterations"]) >= 2]
        if not deep:
            raise AssertionError(f"noisy {spec.name}: no B = 4 K1 call of two or more iterations")
        if spec.mode == "MC_DPSK":
            noisy_codewords = rx.soft_bits.reshape(-1, 648)
            if not any(r["B"] == 1 and r["converged"] and r["iterations"][0] >= 2
                       for r in k1_held[seen:]):
                raise AssertionError("noisy MC-DPSK: the B = 1 header decode took one iteration")
    sizes = sorted({r["B"] for r in k1_held})
    k1_err = max(r["max_abs_err"] for r in k1_held)
    log(f"[4d api] K1 vs plain over phase 4d: {len(k1_held)} launches held at B in {sizes}, "
        f"{sum(r['converged'] for r in k1_held)} converged rows, most iterations of one "
        f"{max(max(r['iterations']) for r in k1_held)}, max |llr err| {k1_err:.3g}, every row "
        "equal bit for bit")
    if not {1, 4} <= set(sizes):
        raise AssertionError(f"phase 4d held K1 at B in {sizes}; 1 and 4 expected")
    return {"frames": api_frames, "launches": launches, "codewords": codewords,
            "noisy_codewords": noisy_codewords, "k1_err": k1_err}


@contextlib.contextmanager
def tracked_snr_timed(spent: list):
    """While open, every ``_tracked_snr`` call of the waveform API adds its
    milliseconds on the host's clock to ``spent``: the spectral SNR as
    ``rx_frame`` really calls it, on the frame's own window with its noise
    reference and tracked floor.  The API reaches it after it has read the
    decode's result, so the card is idle and the bracket holds host work
    only."""
    from ria_tpu_torch.wave import api as wave_api

    inner = wave_api._tracked_snr

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = inner(*args, **kwargs)
        spent.append((time.perf_counter() - t0) * 1e3)
        return out

    wave_api._tracked_snr = timed
    try:
        yield
    finally:
        wave_api._tracked_snr = inner


def time_waveform_api(api: dict, card: str) -> dict:
    """Phase 7, the waveform API: ms per rx_frame by class (before any
    profiler run), and the first against the second prx of a new length.
    Returns {class: (median, min, max, median ms of the spectral SNR inside
    those calls or None)}."""
    from ria_tpu_torch.utils.timing import wall_ms

    ms = {}
    for name, (call, wf, audio) in api["frames"].items():
        call()
        spent: list[float] = []
        per_call: list[float] = []

        def call_and_split(call=call, spent=spent, per_call=per_call):
            seen = len(spent)
            call()
            per_call.append(sum(spent[seen:]))

        with tracked_snr_timed(spent):
            whole = wall_ms(call_and_split, 9)
        # Two of its parts: the spectral SNR (host numpy), bracketed inside
        # these same nine calls, and the sync search alone (device work the
        # host dispatches and waits for), timed in calls of its own.
        if name == "AFDMWaveform":
            ms[name], parts = whole + (None,), ""
        else:
            if not all(per_call):
                raise AssertionError(f"{name}: a rx_frame call measured no spectral SNR")
            snr_ms = float(np.median(per_call))
            sync_ms = wall_ms(lambda: wf.detect_sync(audio), 9)[0]
            ms[name] = whole + (snr_ms,)
            parts = (f"; inside these calls the spectral SNR on the host takes {snr_ms:.3f} ms "
                     f"({snr_ms / whole[0]:.1%} of the call); detect_sync alone {sync_ms:.3f} ms")
        log(f"[7 timing] rx_frame {name} ({len(audio)} samples): median {ms[name][0]:.3f} ms/call "
            f"(min {ms[name][1]:.3f}, max {ms[name][2]:.3f}; host clock, card synchronised, 9 "
            f"calls after the first of this length){parts} ({card})")
    with tempfile.TemporaryDirectory() as tmp:
        for wfn in ("MC_DPSK", "OFDM_CHIRP"):
            path = os.path.join(tmp, f"{wfn}.f32")
            run_cli(["ptx", "new length", "-s", "W1AW", "-d", "VE3ABC",
                     "-w", wfn, "-o", path])
            # A tail of silence of an odd length: a recording length that no
            # earlier phase has met, so the first call builds its detector.
            with open(path, "ab") as f:
                f.write(np.zeros(12345, np.float32).tobytes())
            took = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rc, out, _ = run_cli(["prx", path, "-w", wfn])
                torch.cuda.synchronize()
                took.append((time.perf_counter() - t0) * 1e3)
                if rc != 0 or "new length" not in out:
                    raise AssertionError(f"prx -w {wfn} of a new length failed")
            log(f"[7 timing] prx -w {wfn} of a new length ({os.path.getsize(path) // 4} samples): "
                f"first call {took[0]:.3f} ms, second {took[1]:.3f} ms, third {took[2]:.3f} ms; "
                f"module build of the first call {took[0] - took[1]:.3f} ms ({card})")
    return ms


def trace_waveform_api(api: dict, ms: dict, card: str, dev: torch.device) -> dict:
    """Phase 7: one profiler trace of a rx_frame of MC-DPSK and OFDM_CHIRP,
    and K1 at the API's batch sizes (the header codeword alone, B = 1, and
    the MC-DPSK clean frame's codewords): the host's time per
    ``decode_codewords`` call, K1's device time per launch, its bound and
    the share reached.  Returns {B: (host us, device us, bound us)}."""
    from ria_tpu_torch.fec.ldpc import ldpc_decoder
    from ria_tpu_torch.fec.ldpc_matrix import MIN_SUM_FACTOR, RECOMMENDED_ITERS
    from ria_tpu_torch.phy.frame_v2 import decode_codewords
    from ria_tpu_torch.utils.timing import kernel_us, trace_syncs, wall_ms

    k1_small = {}
    dec = ldpc_decoder("R1_4", RECOMMENDED_ITERS["R1_4"], dev)
    for kind, codewords in (("clean", api["codewords"]), ("noisy", api["noisy_codewords"])):
        for rows in (codewords[:1], codewords):
            B = rows.shape[0]
            host_ms = wall_ms(lambda: decode_codewords(rows, "R1_4", None), 20)[0]
            x = torch.as_tensor(rows, device=dev)
            f = torch.full((B,), MIN_SUM_FACTOR, device=dev)
            us, how = kernel_us(lambda: dec(x, f), "ldpc_bp_kernel")
            got = dec(x, f)
            n_bad, err = compare(dec.plain(x, f), got)
            iters = got.iterations
            b_us, b_by = bound_us(dec, "K1", B, int(iters.sum()))
            if kind == "clean":
                k1_small[B] = (host_ms * 1e3, us, b_us)
            log(f"[7 timing] K1 at the waveform API's size B={B}, {kind} MC-DPSK frame (R1_4, "
                f"mean iterations {iters.float().mean():.2f}): decode_codewords "
                f"{host_ms * 1e3:.1f} us per call on the host's clock (upload, launch, two copies "
                f"back), K1 {us:.2f} us per launch on the device ({how}), bound {b_us:.3f} us ({b_by}), "
                f"{b_us / us:.2%} of it reached; vs plain: rows differing {n_bad}, max |llr err| "
                f"{err:.3g} ({card})")
            if n_bad:
                raise AssertionError(f"K1 disagrees with plain at the API's size B={B} ({kind})")

    for name in ("MCDPSKWaveform", "OFDMChirpWaveform"):
        t = trace_syncs(api["frames"][name][0])
        log(f"[7 timing] trace of one rx_frame {name}: {t['device']} device kernels, copies and "
            f"memsets, {t['busy_us'] / 1e3:.3f} ms device-busy, "
            f"{t['busy_us'] / 1e3 / ms[name][0]:.1%} of its {ms[name][0]:.3f} ms; "
            f"{t['syncs']} host-device synchronisations, {t['d2h']} copies to the host, "
            f"{t['h2d']} from it ({card}); most device time: "
            + ", ".join(f"{n[:60]} {us / 1e3:.3f} ms" for n, us in t["top"]))
        if t["device"] < 1:
            raise AssertionError(f"the trace of {name}.rx_frame shows no device activity")
    return k1_small


def session_phase(card: str) -> dict:
    """Phase 4e.  Returns {"runs": {session: its summary}, "launches":
    {session: (K1, K2)}, "calls": {(B, k): (decoder, LLRs, factors)} one
    recorded K1 call per batch size, "decode_tick": an S1 tick that decodes
    a frame, "decode_tick_ms": its milliseconds in the lock-step run} for
    the timing phase and the result lines."""
    from ria_tpu_torch.protocol.connection import ConnectionState
    from ria_tpu_torch.tools import session_paths as S
    from ria_tpu_torch.tools import waveform_frames as F

    t_phase = time.perf_counter()
    runs, launches, rep_calls = {}, {}, {}
    decode_tick = decode_tick_ms = None
    for name, s in S.SESSIONS.items():
        with S.StageTimer(torch.cuda.synchronize) as timer:
            if name == "S1":
                # The card's run and the CPU port's, in lock step, both fed
                # one CPU generator's draws.
                card_sim = S.make_sim(s, draws=S.generator_draws(s, "cuda", "cpu"))
                cpu_sim = S.make_sim(s, "cpu", S.generator_draws(s, "cpu", "cpu"))
                if card_sim.device.type != "cuda":
                    raise AssertionError("DualStationSim's default device is not the card")
                t0 = time.perf_counter()
                lock, k1, k2, calls = F.counted_k1(lambda: S.lock_step(
                    [card_sim, cpu_sim], s, [ConnectionState, ConnectionState],
                    synchronize=torch.cuda.synchronize))
                out = dict(lock["outs"][0], ticks=lock["ticks"], tick_ms=lock["tick_ms"][0],
                           wall_s=sum(lock["tick_ms"][0]) / 1e3,
                           stats={side: getattr(card_sim, side).stats for side in ("alpha", "bravo")})
                decode_tick = S.decode_ticks(lock["snapshots"])[0]
                decode_tick_ms = lock["tick_ms"][0][decode_tick - 1]
                cpu_s = sum(lock["tick_ms"][1]) / 1e3
                log(f"[4e sessions] S1 card vs CPU port: {lock['ticks']} ticks equal (states, "
                    f"links, counters, ring, pending sync, messages), max |snr err| "
                    f"{lock['max_snr_err']:.3g} dB (limit {S.SNR_TOL_DB:g}); the CPU port's "
                    f"run {cpu_s:.2f} s of {time.perf_counter() - t0:.2f} s")
            else:
                out, k1, k2, calls = F.counted_k1(lambda: S.run(
                    s, draws=S.generator_draws(s, "cuda", "cpu"),
                    synchronize=torch.cuda.synchronize))
        outcome = S.check_outcome(s, out)
        launches[name] = (k1, k2)
        if len(calls) != k1 or k2:
            raise AssertionError(f"{name}: K1 launches {k1} ({len(calls)} recorded), K2 {k2}")
        rows = F.hold_k1_calls(calls, name)
        for dec, llrs, factors, _ in calls:
            rep_calls.setdefault((llrs.shape[0], dec.k), (dec, llrs, factors))
        sizes = sorted({r["B"] for r in rows})
        iters = [i for r in rows for i in r["iterations"]]
        ticks = out["ticks"]
        tick_ms = out["tick_ms"]
        audio_s = ticks * 0.2
        stage = {k: v / ticks for k, v in timer.totals.items()}
        rest = float(np.mean(tick_ms)) - sum(stage.values())
        dec_ms = [out["stats"][side].decode_time_ms_avg for side in ("alpha", "bravo")]
        runs[name] = {
            "ticks": ticks, "connect_ticks": out.get("connect_ticks"), "link": out.get("link"),
            "final_link": out.get("final_link"), "messages": out.get("messages"),
            "disconnected": out.get("disconnected"), "wall_s": out["wall_s"],
            "audio_s_per_wall_s": audio_s / out["wall_s"],
            "tick_ms_median": float(np.median(tick_ms)),
            "tick_ms_p90": float(np.percentile(tick_ms, 90)), "tick_ms_mean": float(np.mean(tick_ms)),
            "stage_ms_per_tick": dict(stage, rest=rest), "stage_calls": dict(timer.calls),
            "decode_time_ms_avg": dec_ms, "k1_launches": k1, "k1_batch_sizes": sizes,
            "k1_max_iterations": max(iters) if iters else 0,
            "k1_max_abs_err": max((r["max_abs_err"] for r in rows), default=0.0)}
        r = runs[name]
        log(f"[4e sessions] {name} {s.channel}({s.snr_db:g}) seed {s.seed}: {outcome}; {ticks} "
            f"ticks ({audio_s:.1f} s of audio) in {out['wall_s']:.2f} s, "
            f"{r['audio_s_per_wall_s']:.2f} audio s per wall s; ms per tick median "
            f"{r['tick_ms_median']:.2f}, p90 {r['tick_ms_p90']:.2f}, mean {r['tick_ms_mean']:.2f} "
            f"({card})")
        log(f"[4e sessions] {name} a tick, mean ms (host clock, card synchronised): "
            + ", ".join(f"{k} {v:.2f}" for k, v in r["stage_ms_per_tick"].items())
            + "; calls " + ", ".join(f"{k} {v}" for k, v in timer.calls.items())
            + f"; decode_time_ms_avg ALPHA {dec_ms[0]:.2f}, BRAVO {dec_ms[1]:.2f}")
        log(f"[4e sessions] {name}: K1 launches {k1} at B in {sizes}, iterations up to "
            f"{r['k1_max_iterations']}, K2 launches {k2}; K1 vs plain: every row equal bit for "
            f"bit, max |llr err| {r['k1_max_abs_err']:.3g}")
        if k1 < 1:
            raise AssertionError(f"{name} launched no K1")
    log(f"[4e sessions] phase 4e took {time.perf_counter() - t_phase:.1f} s")
    return {"runs": runs, "launches": launches, "calls": rep_calls, "decode_tick": decode_tick,
            "decode_tick_ms": decode_tick_ms}


def tick_stats(tick_ms: list) -> str:
    return (f"ms per tick median {float(np.median(tick_ms)):.2f}, p90 "
            f"{float(np.percentile(tick_ms, 90)):.2f}")


def host_phase(card: str) -> dict:
    """Phase 4f, the host-control plane with the default device: the native
    runtime library, H1 (two modems driven only over TCP) in lock step with
    the CPU port, an attached console reading H1's STATUS, H2 (the threaded
    continuous session) and H3 (``gui --sim --frames`` headless, and a
    console session).  Every K1 launch of the phase is held against the plain
    decoder; K2 is never launched.  Returns {"runs": {run: its summary},
    "launches": {run: (K1, K2)}, "calls": {(B, k): (decoder, LLRs, factors)}
    one recorded K1 call per batch size, "k1_err"}."""
    from ria_tpu_torch import cli
    from ria_tpu_torch.protocol.connection import ConnectionState
    from ria_tpu_torch.runtime import native
    from ria_tpu_torch.runtime.tui import AttachedConsole, TuiApp
    from ria_tpu_torch.sim.channel import GeneratorDraws, awgn
    from ria_tpu_torch.tools import host_paths as H
    from ria_tpu_torch.tools import waveform_frames as F
    from ria_tpu_torch.tools.dual_modem_tcp import DualModemTcp

    t_phase = time.perf_counter()
    built = native.build()
    native.require()
    log(f"[4f host] native runtime library {built.path.name}: g++ "
        f"{built.seconds:.2f} s ({'built now' if built.seconds else 'already built'}); "
        "native.require() loaded it")
    runs, launches, rep_calls, k1_err = {}, {}, {}, 0.0

    def held(name: str, k1: int, k2: int, calls: list) -> dict:
        nonlocal k1_err
        launches[name] = (k1, k2)
        if len(calls) != k1 or k2:
            raise AssertionError(f"{name}: K1 launches {k1} ({len(calls)} recorded), K2 {k2}")
        rows = F.hold_k1_calls(calls, name)
        for dec, llrs, factors, _ in calls:
            rep_calls.setdefault((llrs.shape[0], dec.k), (dec, llrs, factors))
        iters = [i for r in rows for i in r["iterations"]]
        err = max((r["max_abs_err"] for r in rows), default=0.0)
        k1_err = max(k1_err, err)
        sizes = sorted({r["B"] for r in rows})
        log(f"[4f host] {name}: K1 launches {k1} at B in {sizes}, iterations up to "
            f"{max(iters) if iters else 0}, K2 launches {k2}; K1 vs plain: every row equal bit "
            f"for bit, max |llr err| {err:.3g}")
        return {"k1_launches": k1, "k1_batch_sizes": sizes, "k1_max_abs_err": err,
                "k1_max_iterations": max(iters) if iters else 0}

    # H1: the card's stacks and the CPU port's, in lock step, both fed one
    # CPU generator's draws; the card's run is the default device's.
    def dual_modem(device=None):
        kw = {} if device is None else {"device": device}
        draws = tuple(GeneratorDraws(seed, "cuda" if device is None else device, "cpu")
                      for seed in (H.H1_SEED, H.H1_SEED + 1))
        return DualModemTcp(awgn(H.H1_SNR_DB), seed=H.H1_SEED, base_port_a=0, base_port_b=0,
                            draws=draws, **kw)

    card_dm, cpu_dm = dual_modem(), dual_modem("cpu")
    try:
        if card_dm.sim.device.type != "cuda":
            raise AssertionError("DualModemTcp's default device is not the card")
        t0 = time.perf_counter()
        lock, k1, k2, calls = F.counted_k1(lambda: H.lock_step(
            [card_dm, cpu_dm], [ConnectionState, ConnectionState],
            synchronize=torch.cuda.synchronize))
        out = lock["outs"][0]
        outcome = H.check_outcome(out)
        data_b = lock["clients"][0].data_rx[1]
        if data_b != H.SELF_TEST_PAYLOAD + H.MESSAGE + H.RAWTX_TEXT.encode():
            raise AssertionError(f"H1: B's data port gave {len(data_b)} bytes that differ")
        tick_ms = lock["tick_ms"][0]
        wall = sum(tick_ms) / 1e3
        reply_ms = lock["reply_ms"][0]
        log(f"[4f host] H1 awgn({H.H1_SNR_DB:g}) seed {H.H1_SEED}, card vs CPU port: "
            f"{lock['ticks']} ticks equal (states, links, counters, ring, pending sync, engine "
            f"states, replies, events, data-port bytes), max |snr err| "
            f"{lock['max_snr_err']:.3g} dB (limit 1e-3); the CPU port's run "
            f"{sum(lock['tick_ms'][1]) / 1e3:.2f} s of {time.perf_counter() - t0:.2f} s")
        log(f"[4f host] H1: {outcome}; {len(data_b)} bytes out of B's data port byte for byte")
        log(f"[4f host] H1 on the card: {lock['ticks']} ticks ({lock['ticks'] * 0.2:.1f} s of "
            f"audio) in {wall:.2f} s, {lock['ticks'] * 0.2 / wall:.2f} audio s per wall s; "
            f"{tick_stats(tick_ms)}; command send -> reply median {np.median(reply_ms):.3f} ms "
            f"over {len(reply_ms)} commands; payload ticks data port in -> out "
            f"{out['payload_ticks']} ({card})")
        runs["H1"] = {
            "ticks": lock["ticks"], "links": out["link"], "wall_s": wall,
            "audio_s_per_wall_s": lock["ticks"] * 0.2 / wall,
            "tick_ms_median": float(np.median(tick_ms)),
            "tick_ms_p90": float(np.percentile(tick_ms, 90)),
            "reply_ms_median": float(np.median(reply_ms)), "commands": len(reply_ms),
            "payload_ticks": out["payload_ticks"], "max_snr_err": lock["max_snr_err"],
            **held("H1", k1, k2, calls)}
        # An attached console on H1's command port reads STATUS.
        hi = card_dm.ifaces[0]
        con = AttachedConsole(command_port=hi.cmd_srv.port, data_port=hi.data_srv.port)
        try:
            for _ in range(200):
                hi.poll(0.005)
                con.step()
                if con.status:
                    break
            frame = "\n".join(con.build_frame())
        finally:
            con.close()
        if con.status.get("state") != "DISCONNECTED" or "attached console" not in frame:
            raise AssertionError(f"H3 attached console: status {con.status}")
        log(f"[4f host] H3 attached console on H1's command port: STATUS {con.status}")
    finally:
        card_dm.close()
        cpu_dm.close()

    # H2: two station threads on the card against the native air.
    h2, k1, k2, calls = F.counted_k1(H.threaded_session)
    if h2["sim"].device.type != "cuda":
        raise AssertionError("ContinuousAudioSimulator's default device is not the card")
    if not h2["ok"]:
        raise AssertionError(f"H2: not delivered within 120 s: {h2['got']}, ticks {h2['ticks']}")
    per = {d: {"ticks": h2["ticks"][d], "audio_s_per_wall_s": h2["ticks"][d] * 0.1 / h2["wall_s"],
               "tick_ms_median": float(np.median(h2["tick_ms"][d])),
               "tick_ms_p90": float(np.percentile(h2["tick_ms"][d], 90)),
               "backpressure_waits": h2["backpressure_waits"][d]} for d in ("ab", "ba")}
    runs["H2"] = {"wall_s": h2["wall_s"], "connected_at_s": h2["connected_at_s"],
                  "threads": per, **held("H2", k1, k2, calls)}
    log(f"[4f host] H2 awgn(12) seed 5, two station threads on the card: connected after "
        f"{h2['connected_at_s']:.2f} s, {h2['got']} delivered in {h2['wall_s']:.2f} s (bound "
        "120 s); " + "; ".join(
            f"{'ALPHA' if d == 'ab' else 'BRAVO'} thread {p['ticks']} ticks, "
            f"{p['audio_s_per_wall_s']:.2f} audio s per wall s, {tick_stats(h2['tick_ms'][d])}, "
            f"backpressure wait ran {p['backpressure_waits']} times" for d, p in per.items())
        + f" ({card})")

    # H3: the operator console headless, with the default device.
    frames = 10
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        (rc, k1, k2, calls) = F.counted_k1(lambda: cli.main(
            ["gui", "--sim", "--channel", "awgn", "--snr", "15", "--frames", str(frames)]))
    gui_s = time.perf_counter() - t0
    text = buf.getvalue()
    if rc != 0 or "operator console" not in text:
        raise AssertionError(f"H3: gui returned {rc}: {text[:400]}")
    runs["H3 gui"] = {"frames": frames, "wall_s": gui_s, **held("H3 gui", k1, k2, calls)}
    log(f"[4f host] H3 gui --sim --frames {frames}: {gui_s:.2f} s; its frame:")
    for line in text.rstrip().splitlines():
        log("  | " + line)
    app = TuiApp(mycall="W1AW", sim_channel=awgn(18.0), seed=7)
    if app.station.device.type != "cuda":
        raise AssertionError("TuiApp's default device is not the card")

    def console_session():
        ticks = []
        app.handle_key("c")
        for _ in range(80):
            t = time.perf_counter()
            app.step()
            torch.cuda.synchronize()
            ticks.append((time.perf_counter() - t) * 1e3)
            if app.station.conn.state.name == "CONNECTED":
                break
        for ch in ":hello tui\n":
            app.handle_key(ch)
        for _ in range(60):
            t = time.perf_counter()
            app.step()
            torch.cuda.synchronize()
            ticks.append((time.perf_counter() - t) * 1e3)
            if ("peer", "hello tui") in app.state.messages:
                break
        return ticks

    ticks, k1, k2, calls = F.counted_k1(console_session)
    if ("peer", "hello tui") not in app.state.messages:
        raise AssertionError(f"H3 console session: {app.state.messages}")
    runs["H3 console"] = {"ticks": len(ticks), "wall_s": sum(ticks) / 1e3,
                          "tick_ms_median": float(np.median(ticks)),
                          "tick_ms_p90": float(np.percentile(ticks, 90)),
                          **held("H3 console", k1, k2, calls)}
    log(f"[4f host] H3 console session (c, ':hello tui'): the peer got it after {len(ticks)} "
        f"ticks, {sum(ticks) / 1e3:.2f} s, {tick_stats(ticks)}, SNR "
        f"{app.monitor.status().snr_db:.1f} dB, {len(app.monitor.constellation.snapshot())} "
        f"constellation points ({card})")
    log(f"[4f host] phase 4f took {time.perf_counter() - t_phase:.1f} s")
    return {"runs": runs, "launches": launches, "calls": rep_calls, "k1_err": k1_err,
            "gpp_s": built.seconds}


SCALE_REPS = 7  # timed calls a case and rank in phase 4g (their median)


def scale_out_phase(card: str, dev: torch.device) -> dict:
    """Phase 4g, scale-out: cases G1-G7 of ``tools/parallel_paths.py`` at
    the production geometry, on 4 ranks sharing the card.  Each rank holds
    every K1 launch of its first call against the plain decoder; here every
    case is held against the single-process port on the card, against what
    was sent, and across ranks.  Returns {"cases": {case: its summary},
    "launches": {case: ([K1 per rank], [K2 per rank])}, "calls": {(B, k):
    (decoder, LLRs, factors)} one K1 call per batch size, "k1_err"}."""
    from ria_tpu_torch.fec.ldpc import ldpc_decoder
    from ria_tpu_torch.parallel import distributed
    from ria_tpu_torch.parallel.launch import launch
    from ria_tpu_torch.tools import parallel_paths as P
    from ria_tpu_torch.utils.timing import cuda_ms

    t_phase = time.perf_counter()
    n = P.RANKS
    backend = distributed.choose_backend(dev, n)
    cases, data, sent = P.production_cases(n, device=dev)
    log(f"[4g scale-out] {n} ranks, backend {backend}, world size {n}, rank devices "
        f"{[str(distributed.rank_device(dev, r)) for r in range(n)]}; cases "
        f"{[c.name for c in cases]} built in {time.perf_counter() - t_phase:.1f} s")
    t0 = time.perf_counter()
    outs = launch(P.run_rank, n, args=(cases, SCALE_REPS), device=dev, backend=backend,
                  timeout_s=600.0, rank_args=[(d,) for d in P.rank_data(cases, data, n)])
    log(f"[4g scale-out] the ranks ran in {time.perf_counter() - t0:.1f} s (start-up, first "
        f"calls, {SCALE_REPS} timed calls a case)")
    summary, launches, rep_calls, k1_err = {}, {}, {}, 0.0
    for case in cases:
        per = [o[case.name] for o in outs]
        P.same_on_every_rank(case.name, [P.replicated(case, p["result"]) for p in per])
        got = per[0]["result"]
        if case.kind == "fir":
            got = np.concatenate([p["result"] for p in per], axis=-1)
        if case.kind == "hybrid":
            coords = [tuple(int(c) for c in p["result"]["coords"]) for p in per]
            if coords != [divmod(r, case.params[1]) for r in range(n)]:
                raise AssertionError(f"{case.name}: rank coordinates {coords}")
        errs = P.hold_single(case, got, P.single_process(case, data[case.name], got, n, dev))
        P.check_sent(case, got, sent[case.name])
        k1 = [p["k1_launches"] for p in per]
        k2 = [p["k2_launches"] for p in per]
        held = [c for p in per for c in p["k1_calls"]]
        launches[case.name] = (k1, k2)
        if any(k2) or len(held) != sum(k1) or (
                case.kind not in ("stream_search", "fir") and min(k1) < 1):
            raise AssertionError(f"{case.name}: K1 launches per rank {k1} ({len(held)} held), "
                                 f"K2 {k2}")
        for (B, k), (rate, iters, llrs, factors) in per[0]["k1_inputs"].items():
            rep_calls.setdefault((B, k), (ldpc_decoder(rate, iters, dev),
                                          torch.as_tensor(llrs, device=dev),
                                          torch.as_tensor(factors, device=dev)))
        err = max((c["max_abs_err"] for c in held), default=0.0)
        k1_err = max(k1_err, err)
        sizes = sorted({c["B"] for c in held})
        iters = max((i for c in held for i in c["iterations"]), default=0)
        ms = max(p["ms"] for p in per) if per[0]["ms"] is not None else None
        one, why = P.one_rank_case(case, n)
        single_ms = None
        if one is not None:
            fn, x = P.program(one, dev), data[case.name]
            for _ in range(2):
                fn(x)
            single_ms = cuda_ms(lambda: fn(x), 1)[0]
        summary[case.name] = {"k1_launches_per_rank": k1, "k1_batch_sizes": sizes,
                              "k1_max_iterations": iters, "k1_max_abs_err": err,
                              "ms_per_call": ms, "single_process_ms": single_ms,
                              "vs_single_process": errs}
        log(f"[4g scale-out] {case.name} ({case.kind}): as sent, equal on every rank; vs the "
            "single-process port: decisions equal, " + ", ".join(
                f"|{k} err| {v:.3g}" for k, v in errs.items())
            + f"; K1 launches per rank {k1} at B in {sizes}, iterations up to {iters}, K2 "
            f"launches {k2}; K1 vs plain: no row's outcome differing, max |llr err| {err:.3g}")
        if ms is not None:
            log(f"[4g scale-out] {case.name}: {ms:.3f} ms per call (4 ranks sharing one card, "
                f"CUDA events, the slowest rank's median of {SCALE_REPS}); "
                + (f"one process: {single_ms:.3f} ms (median of 7)" if single_ms is not None
                   else f"no one-process form ({why})")
                + f" ({card})")
    seconds = time.perf_counter() - t_phase
    log(f"[4g scale-out] phase 4g took {seconds:.1f} s")
    return {"cases": summary, "launches": launches, "calls": rep_calls, "k1_err": k1_err,
            "backend": backend, "seconds": seconds}


TOOL_SEEDS = 3  # seeds a case of the acceptance and OTFS sweeps in phase 4h
# Seeds of each goodput row in phase 4h.  A session that does not deliver
# runs all its 3,000 ticks (65-70 s on the card): Moderate runs one seed.
GOODPUT_SEEDS = {"awgn": (100, 101), "good": (100, 101), "moderate": (100,)}
CFO_TOL_HZ = 1e-3  # the CFO chain's estimate and slopes, card against CPU


def tools_phase(card: str) -> dict:
    """Phase 4h, the twins of the root tools with the default device, at the
    tools' own geometry.  Every K1 launch of the phase is held against the
    plain decoder; K2 is never launched.  Returns {"summary": for the JSON
    line, "launches": {tool: (K1, K2)}, "calls": {(B, k): (decoder, LLRs,
    factors)} one recorded K1 call per batch size, "k1_err", "seconds"}."""
    from ria_tpu_torch.protocol.connection import ConnectionState
    from ria_tpu_torch.tools import acceptance_sweep as A
    from ria_tpu_torch.tools import goodput as G
    from ria_tpu_torch.tools import otfs_mode_sweep as O
    from ria_tpu_torch.tools import profile_acquisition as P
    from ria_tpu_torch.tools import session_paths as S
    from ria_tpu_torch.tools import throughput_test as TT
    from ria_tpu_torch.tools import verify_cfo_chain as V
    from ria_tpu_torch.tools import waveform_frames as F

    t_phase = time.perf_counter()
    summary, launches, rep_calls = {}, {}, {}
    k1_err = 0.0

    def tool_log(msg: str) -> None:
        log(f"[4h tools]   {msg}")

    def quiet(msg: str) -> None:
        pass

    def held(name: str, fn):
        """(fn(), its summary): fn's K1 launches held against plain, 0 K2."""
        nonlocal k1_err
        t0 = time.perf_counter()
        out, k1, k2, calls = F.counted_k1(fn)
        seconds = time.perf_counter() - t0
        launches[name] = (k1, k2)
        if len(calls) != k1 or k2:
            raise AssertionError(f"{name}: K1 launches {k1} ({len(calls)} recorded), K2 {k2}")
        t0 = time.perf_counter()
        rows = F.hold_k1_calls(calls, name)
        hold_s = time.perf_counter() - t0
        for dec, llrs, factors, _ in calls:
            rep_calls.setdefault((llrs.shape[0], dec.k), (dec, llrs, factors))
        iters = [i for r in rows for i in r["iterations"]]
        err = max((r["max_abs_err"] for r in rows), default=0.0)
        k1_err = max(k1_err, err)
        sizes = sorted({r["B"] for r in rows})
        log(f"[4h tools] {name}: {seconds:.1f} s (its K1 launches held in {hold_s:.1f} s); "
            f"K1 launches {k1} at B in {sizes}, iterations up to {max(iters) if iters else 0}, "
            f"K2 launches {k2}; K1 vs plain: every row equal bit for bit, max |llr err| "
            f"{err:.3g}")
        return out, {"seconds": seconds, "k1_launches": k1, "k1_batch_sizes": sizes,
                     "k1_max_iterations": max(iters) if iters else 0, "k1_max_abs_err": err}

    # The CFO chain: 12 Hz injected, the dual-chirp estimate and carrier 0's
    # phase slopes before and after the correction, card against CPU.
    cfo, info = held("verify_cfo_chain", lambda: V.measure(12.0))
    cpu = V.measure(12.0, "cpu")
    errs = {k: abs(cfo[k] - cpu[k]) for k in ("estimate", "slope_pre", "slope_post")}
    log(f"[4h tools] verify_cfo_chain: applied {cfo['applied']:+.2f} Hz, estimate "
        f"{cfo['estimate']:+.4f} Hz, slopes {cfo['slope_pre']:+.4f} -> {cfo['slope_post']:+.4f} "
        f"Hz, correction {cfo['correction']:+.4f} Hz: {'PASS' if cfo['ok'] else 'FAIL'}; "
        "against the CPU port " + ", ".join(f"|{k} err| {v:.3g} Hz" for k, v in errs.items()))
    if not cfo["ok"] or max(errs.values()) > CFO_TOL_HZ:
        raise AssertionError(f"verify_cfo_chain: {cfo} against the CPU port's {cpu}")
    summary["verify_cfo_chain"] = dict(info, **{k: cfo[k] for k in ("estimate", "slope_pre",
                                                                    "slope_post", "correction")},
                                       vs_cpu_hz=errs)

    # The throughput table: the TX chain and the protocol's tables only.
    rows, info = held("throughput_test", TT.measure_rows)
    cpu_rows = TT.measure_rows("cpu")
    for got, want in zip(rows, cpu_rows):
        if got != want:
            raise AssertionError(f"throughput row {got['name']}: card {got}, CPU port {want}")
    if len(rows) != 12 or len(cpu_rows) != 12:
        raise AssertionError(f"throughput_test: {len(rows)} rows on the card, "
                             f"{len(cpu_rows)} on the CPU")
    log("[4h tools] throughput_test.measure_rows(): 12 rows equal to the CPU port's, field "
        "for field")
    worst, worst_bin = TT.report(rows, log=tool_log)
    summary["throughput_test"] = dict(info, worst_vs_published=worst,
                                      worst_vs_reference_binary=worst_bin,
                                      steady_bps={r["name"]: r["steady"] for r in rows})

    # The acceptance sweep: its fourteen cases on CPU generators' draws
    # (keys 1000 + s), so the card's run can be held to the CPU port's.
    card_draws = A.generator_draws("cuda", "cpu")
    results, info = held("acceptance_sweep", lambda: A.sweep(TOOL_SEEDS, draws=card_draws,
                                                             log=tool_log))
    for case, r in zip(A.CASES, results):
        c = A.run_case(case, 1, "cpu", A.generator_draws("cpu", "cpu"), log=quiet)
        if (c["outcomes"][0], c["frames"][0]) != (r["outcomes"][0], r["frames"][0]):
            raise AssertionError(f"{case.name} seed 0: card {r['outcomes'][0]} "
                                 f"{r['frames'][0]!r}, CPU port {c['outcomes'][0]} "
                                 f"{c['frames'][0]!r}")
    log(f"[4h tools] acceptance_sweep: seed 0 of each of the {len(results)} cases equal to "
        "the CPU port's (outcome and frame bytes)")
    failed = [r["name"] for r in results if not r["passed"]]
    if failed:
        raise AssertionError(f"acceptance_sweep: below their thresholds: {failed}")
    summary["acceptance_sweep"] = dict(info, seeds=TOOL_SEEDS, cases={
        r["name"]: f"{r['passes']}/{r['seeds']} (need {r['need']})" for r in results})

    # The OTFS mode sweep: 3 x 3 arms, the same draws (keys s).
    table, info = held("otfs_mode_sweep", lambda: O.sweep(TOOL_SEEDS, 20.0, draws=card_draws,
                                                          log=tool_log))
    cpu_table = O.sweep(1, 20.0, "cpu", A.generator_draws("cpu", "cpu"), log=quiet)
    for ch in O.CHANNELS:
        for m in O.MODES:
            if table[ch][m][0] != cpu_table[ch][m][0]:
                raise AssertionError(f"otfs_mode_sweep {ch} {m} seed 0: card "
                                     f"{table[ch][m][0]}, CPU port {cpu_table[ch][m][0]}")
    log("[4h tools] otfs_mode_sweep: seed 0 of each arm equal to the CPU port's")
    summary["otfs_mode_sweep"] = dict(info, seeds=TOOL_SEEDS, table={
        ch: {m: sum(w) for m, w in arms.items()} for ch, arms in table.items()})

    # Acquisition and decode latency at B = 32 (CUDA events).
    ms, info = held("profile_acquisition", lambda: P.profile(32, log=tool_log))
    summary["profile_acquisition"] = dict(info, batch=32, ms=ms)

    # Goodput: each row at two seeds, CPU generators' draws (s, s + 1); the
    # first AWGN session in lock step with the CPU port.
    sessions, kbps = {}, {}
    for channel, snr, ref_kbps, ref_rate in G.ROWS:
        full, seeds = [], GOODPUT_SEEDS[channel]
        for seed in seeds:
            s = G.session(channel, snr, seed)
            if (channel, seed) == ("awgn", seeds[0]):
                card_sim = G.make_sim(channel, snr, seed,
                                      draws=S.generator_draws(s, "cuda", "cpu"))
                cpu_sim = G.make_sim(channel, snr, seed, "cpu",
                                     S.generator_draws(s, "cpu", "cpu"))
                if card_sim.device.type != "cuda":
                    raise AssertionError("goodput.make_sim's default device is not the card")
                lock, info = held(s.name, lambda: S.lock_step(
                    [card_sim, cpu_sim], s, [ConnectionState, ConnectionState],
                    synchronize=torch.cuda.synchronize))
                out = dict(lock["outs"][0], ticks=lock["ticks"], tick_ms=lock["tick_ms"][0])
                log(f"[4h tools] {s.name} card vs CPU port: {lock['ticks']} ticks equal "
                    f"(states, links, counters, ring, pending sync, messages), max |snr err| "
                    f"{lock['max_snr_err']:.3g} dB (limit {S.SNR_TOL_DB:g})")
            else:
                out, info = held(s.name, lambda: S.run(
                    s, draws=S.generator_draws(s, "cuda", "cpu"),
                    synchronize=torch.cuda.synchronize))
            r = dict(info, **{k: out.get(k) for k in ("connected", "delivered", "goodput_bps",
                                                      "link", "air_s", "connect_s",
                                                      "retransmits")},
                     ticks=out["ticks"], tick_ms_median=float(np.median(out["tick_ms"])),
                     tick_ms_p90=float(np.percentile(out["tick_ms"], 90)))
            sessions[s.name] = r
            if r["delivered"] and r["delivered"] >= 1.0:
                full.append(r["goodput_bps"])
            log(f"[4h tools] {s.name}: delivered {r['delivered']:.0%}, "
                f"{r['goodput_bps']:.1f} bps, link {r['link']}, air {r['air_s']} s, connect "
                f"{r['connect_s']} s, retransmits {r['retransmits']}, {r['ticks']} ticks, ms per "
                f"tick median {r['tick_ms_median']:.2f}, p90 {r['tick_ms_p90']:.2f} ({card})")
            if channel == "awgn" and not (r["connected"] and r["delivered"] == 1.0):
                raise AssertionError(f"{s.name} did not deliver everything: {r}")
        med = sorted(full)[len(full) // 2] if full else 0.0
        kbps[f"{channel}({snr:g})"] = {"delivered": f"{len(full)}/{len(seeds)}",
                                       "median_kbps": med / 1e3, "reference_kbps": ref_kbps,
                                       "reference_delivery": ref_rate}
        log(f"[4h tools] goodput {channel} @ {snr:g} dB: {len(full)}/{len(seeds)} "
            f"delivered, median {med / 1e3:.3f} kbps (reference {ref_kbps} kbps at "
            f"{ref_rate:.0%} of runs)")
    summary["goodput"] = {"rows": kbps, "sessions": sessions}
    if sum(k1 for k1, _ in launches.values()) < 1:
        raise AssertionError("phase 4h launched no K1")
    seconds = time.perf_counter() - t_phase
    log(f"[4h tools] phase 4h took {seconds:.1f} s")
    return {"summary": summary, "launches": launches, "calls": rep_calls, "k1_err": k1_err,
            "seconds": seconds}


COVERAGE_MIN = 0.95  # share of the chain call's device time the stage spans must cover


def profile_phase(card: str, dev: torch.device) -> dict:
    """Phase 4i, the stage profile and the bf16 path.  Returns {"rows": the
    four rows' ms, "split": the span split, "launches": the bf16 path's
    (K1 f32, K1 bf16, K2 of either build) launches, "k1_bf16_err", "seconds"}."""
    from ria_tpu_torch.fec.ldpc import ldpc_decoder, make_decoder
    from ria_tpu_torch.fec.ldpc_matrix import RECOMMENDED_ITERS
    from ria_tpu_torch.tools import bench_profile as BP

    t_phase = time.perf_counter()
    cfg, ncw, batch, window, lead = BP.geometry()
    prof = BP.build(cfg, ncw, batch, window, lead, dev)
    rows = {name: t * 1e3 for name, t in BP.stage_times(prof).items()}
    log(f"[4i profile] python -m ria_tpu_torch.tools.bench_profile: geometry: batch={batch} "
        f"window={window} ncw={ncw}, lead {lead}")
    for name, ms in rows.items():
        log(f"[4i profile] {name:6s} {ms:8.3f} ms  {batch * window / ms / 1e3:9.1f} Msamp/s "
            f"(CUDA events, {BP.ITERS} calls over {BP.NBUF} buffers; {card})")
    out = prof.rx(prof.auds[0])
    torch.cuda.synchronize()
    if not (out.detected.all() and out.cw_success.float().mean() >= 0.95):
        raise AssertionError("phase 4i: the profile's chain did not detect and decode")
    split = BP.span_split(lambda: prof.rx(prof.auds[0]), dev)
    for name, sp in split["spans"].items():
        log(f"[4i profile] span {name}: {sp['ms']:.3f} ms device, {sp['kernels']} kernels")
    log(f"[4i profile] the three spans cover {split['covered']:.2%} of the call's "
        f"{split['total_ms']:.3f} ms of device time (outside them "
        f"{split['outside']['kernels']} pieces of work, {split['outside']['ms']:.3f} ms; {card})")
    if split["covered"] < COVERAGE_MIN:
        raise AssertionError(f"phase 4i: the stage spans cover {split['covered']:.2%} of the "
                             f"call's device time, under {COVERAGE_MIN:.0%}")

    # The bf16 path: the decoder entry point asked for the TPU kernel's
    # rounding, on the profile's 256 codewords.
    soft = prof.soft(prof.auds[0])
    iters = RECOMMENDED_ITERS[BP.RATE]
    decode16 = make_decoder(BP.RATE, iters, 0.75, "bf16", device=dev)
    torch.cuda.synchronize()
    zero_counts()
    got = decode16(soft)
    torch.cuda.synchronize()
    launches = (launch_count(K1), launch_count(K1_BF16), k2_launches())
    dec16 = ldpc_decoder(BP.RATE, iters, dev, "bf16")
    want = dec16.plain(soft, torch.full((soft.shape[0],), 0.75, device=dev))
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    err = float((got.llr_total - want.llr_total).abs().max())
    ok = got.success.cpu().numpy()
    f32 = ldpc_decoder(BP.RATE, iters, dev)(soft, torch.full((soft.shape[0],), 0.75, device=dev))
    log(f"[4i bf16] make_decoder({BP.RATE!r}, {iters}, 0.75, 'bf16') on B={soft.shape[0]}: "
        f"launches K1 f32 {launches[0]}, K1 bf16 {launches[1]}, K2 {launches[2]}; success "
        f"{int(ok.sum())}/{len(ok)} (f32 {int(f32.success.sum())}), iterations "
        f"{iteration_counts(got.iterations.cpu().tolist())}, equal to plain bf16: {same}, max "
        f"|llr err| {err:.3g}")
    if launches != (0, 1, 0):
        raise AssertionError(f"phase 4i: the bf16 path launched {launches} (f32, bf16, K2)")
    if not same:
        raise AssertionError("phase 4i: K1's bf16 build differs from the plain bf16 decoder")
    if ok.mean() < 0.95 or not (got.info_bits.cpu().numpy() == prof.info)[ok].all():
        raise AssertionError("phase 4i: the bf16 path decoded under 95% of the codewords, or "
                             "bits other than those sent")
    seconds = time.perf_counter() - t_phase
    log(f"[4i profile] phase 4i took {seconds:.1f} s")
    return {"rows": rows, "split": split, "launches": launches, "k1_bf16_err": err,
            "seconds": seconds}


# The part of bench.py's twin each decoder row is, and the count each part
# must move once a call (chains and serving: K1; the rows: their own build).
BENCH_PARTS = {"mc_dpsk": "k1", "ofdm": "k1", "coherent": "k1", "plain": None, "k1": "k1",
               "k1_bf16": "k1_bf16", "serving": "k1"}


def bench_phase(card: str, dev: torch.device) -> dict:
    """Phase 4j, bench.py's twin (``ria_tpu_torch.tools.bench``) at
    bench.py's counts on bench.py's batches.  Returns {"line", "launches"
    (its parts'), "seconds", "k1_err", "k1_bf16_err", "us": {kernel: (device
    us, bound us, bound by, iterations)} on the LDPC batch's first copy}."""
    from ria_tpu_torch.entry import RATE, bench_batches
    from ria_tpu_torch.fec.ldpc import LDPCDecoder, ldpc_decoder
    from ria_tpu_torch.fec.ldpc_matrix import MIN_SUM_FACTOR
    from ria_tpu_torch.tools import bench as BT
    from ria_tpu_torch.utils.timing import kernel_us

    t_phase = time.perf_counter()
    batches = bench_batches(dev)
    chains = BT.build_chains(batches, dev)
    variants = batches.ldpc.variants
    k1_batches = []

    def record(module, args, output):
        if isinstance(module, LDPCDecoder) and args[0].is_cuda:
            k1_batches.append((module.precision, args[0].shape[0]))

    torch.cuda.synchronize()
    zero_counts()
    handle = torch.nn.modules.module.register_module_forward_hook(record)
    t0 = time.perf_counter()
    try:
        line, launches = BT.run(chains, variants, batches.ldpc.clean.cpu().numpy(), dev)
    finally:
        handle.remove()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    totals = {"k1": launch_count(K1), "k1_bf16": launch_count(K1_BF16),
              "k2": k2_launches()}
    d = line["detail"]
    log(f"[4j bench] python -m ria_tpu_torch.tools.bench: {line['value']:.6g} samples/s "
        f"(x{line['vs_baseline']:.6g} real time), cw_decode_rate {d['cw_decode_rate']}; ofdm "
        f"{d['ofdm']['samples_per_s']:.6g}, coherent {d['coherent']['samples_per_s']:.6g} "
        f"samples/s; {run_s:.1f} s ({card})")
    for part, n in launches.items():
        log(f"[4j bench] {part}: {n['calls']} calls, launches K1 {n['k1']}, K1 bf16 "
            f"{n['k1_bf16']}, K2 {n['k2']}")
        want = {k: (n["calls"] if k == BENCH_PARTS[part] else 0) for k in totals}
        if {k: n[k] for k in totals} != want:
            raise AssertionError(f"phase 4j: {part} launched {n}, {want} expected")
    if {k: sum(n[k] for n in launches.values()) for k in totals} != totals:
        raise AssertionError(f"phase 4j: launches outside the twin's parts: {totals}")
    sizes = {key: k1_batches.count(key) for key in sorted(set(k1_batches))}
    log(f"[4j bench] decoder forward calls on the card by (precision, batch): {sizes}")
    chain_calls = sum(launches[p]["calls"] for p in ("mc_dpsk", "ofdm", "coherent"))
    if sizes != {("bf16", 512): launches["k1_bf16"]["calls"], ("f32", 4): launches["serving"]
                 ["calls"], ("f32", 256): chain_calls, ("f32", 512): launches["k1"]["calls"]}:
        raise AssertionError("phase 4j: K1 ran at other batch sizes than B = 256 (chains), "
                             "512 (rows) and 4 (serving)")
    for key, value in (("value", line["value"]), ("ofdm", d["ofdm"]["samples_per_s"]),
                       ("coherent", d["coherent"]["samples_per_s"]),
                       *((k, v) for k, v in d["ldpc"].items() if k.endswith("_cw_per_s"))):
        if not (np.isfinite(value) and value > 0):
            raise AssertionError(f"phase 4j: {key} = {value}")
    # Each kernel row against its plain version on every copy of the batch.
    errs, us = {}, {}
    factors = torch.full((variants[0].shape[0],), MIN_SUM_FACTOR, device=dev)
    for kernel, precision, symbol in (("K1", "f32", "ldpc_bp_kernel"),
                                      ("K1 bf16", "bf16", "ldpc_bp_bf16_kernel")):
        dec = ldpc_decoder(RATE, None, dev, precision)
        errs[kernel] = 0.0
        for i, x in enumerate(variants):
            got, want = dec(x, factors), dec.plain(x, factors)
            errs[kernel] = max(errs[kernel],
                               float((got.llr_total - want.llr_total).abs().max()))
            if not same_bits(got, want):
                raise AssertionError(f"phase 4j: {kernel} differs from its plain version on "
                                     f"copy {i} of the LDPC batch")
        iters = int(dec(variants[0], factors).iterations.sum())
        t_us, how = kernel_us(lambda: dec(variants[0], factors), symbol)
        b_us, b_by = bound_us(dec, kernel, variants[0].shape[0], iters)
        us[kernel] = (t_us, b_us, b_by, iters)
        log(f"[4j bench] {kernel} on bench.py's LDPC batch (copy 0, B={variants[0].shape[0]}, "
            f"{iters} codeword-iterations): {t_us:.2f} us per launch ({how}), bound "
            f"{b_us:.3f} us ({b_by}), {b_us / t_us:.2%} of it reached; equal to its plain "
            f"version on all {len(variants)} copies ({card})")
    seconds = time.perf_counter() - t_phase
    log(f"[4j bench] phase 4j took {seconds:.1f} s")
    return {"line": line, "launches": launches, "seconds": run_s, "k1_err": errs["K1"],
            "k1_bf16_err": errs["K1 bf16"], "us": us}


def k1_at_sizes(rep_calls: dict, where: str, card: str) -> dict:
    """Phase 7: K1 at each batch size a phase launched it with (device time,
    bound, share).  Returns {"B=.. k=..": (device us, bound us)}."""
    from ria_tpu_torch.utils.timing import kernel_us

    k1_by_b = {}
    for (B, k), (dec, x, f) in sorted(rep_calls.items()):
        us, how = kernel_us(lambda: dec(x, f), "ldpc_bp_kernel")
        iters = dec(x, f).iterations
        b_us, b_by = bound_us(dec, "K1", B, int(iters.sum()))
        k1_by_b[f"B={B} k={k}"] = (us, b_us)
        log(f"[7 timing] K1 at a {where} size B={B}, k={k} (iterations "
            f"{iteration_counts(iters.tolist())}): {us:.2f} us per launch ({how}), bound "
            f"{b_us:.3f} us ({b_by}), {b_us / us:.2%} of it reached ({card})")
    return k1_by_b


def time_sessions(sessions: dict, card: str) -> dict:
    """Phase 7, the sessions: K1 at each batch size the sessions launched it
    with (device time, bound, share), and one profiler trace of the S1 tick
    that first decodes a frame, replayed on a fresh simulator.  Returns
    {B: (device us, bound us)} of the R1/4 and other codes' calls."""
    from ria_tpu_torch.tools import session_paths as S
    from ria_tpu_torch.utils.timing import trace_syncs

    k1_by_b = k1_at_sizes(sessions["calls"], "session's", card)
    s = S.SESSIONS["S1"]
    tick = sessions["decode_tick"]
    sim, gen = S.replay_to(s, tick, draws=S.generator_draws(s, "cuda", "cpu"))
    before = (sim.alpha.stats.frames_rx, sim.bravo.stats.frames_rx)
    spent = []

    def one_tick():
        t0 = time.perf_counter()
        next(gen)
        torch.cuda.synchronize()
        spent.append((time.perf_counter() - t0) * 1e3)

    tr = trace_syncs(one_tick)
    after = (sim.alpha.stats.frames_rx, sim.bravo.stats.frames_rx)
    log(f"[7 timing] trace of S1 tick {sim.ticks} (frames decoded in it: "
        f"{sum(after) - sum(before)}; {len(spent)} traced block(s)): {tr['device']} device "
        f"kernels, copies and memsets, {tr['busy_us'] / 1e3:.3f} ms device-busy, "
        f"{tr['busy_us'] / 1e3 / spent[-1]:.1%} of its {spent[-1]:.3f} ms under the profiler, "
        f"{tr['busy_us'] / 1e3 / sessions['decode_tick_ms']:.1%} of the "
        f"{sessions['decode_tick_ms']:.3f} ms the same tick took in phase 4e; {tr['syncs']} "
        f"host-device synchronisations, {tr['d2h']} copies to the host, {tr['h2d']} from it "
        f"({card}); most device time: "
        + ", ".join(f"{n[:60]} {us / 1e3:.3f} ms" for n, us in tr["top"]))
    if tr["device"] < 1:
        raise AssertionError("the trace of an S1 tick shows no device activity")
    return k1_by_b


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
    from ria_tpu_torch.utils import cuda_kernels
    from ria_tpu_torch.utils.timing import cuda_ms, kernel_us, queued_us, trace_call

    # -- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    builds = cuda_kernels.build()
    log(f"[2 build] {len(builds)} libraries in {time.perf_counter() - t0:.2f} s")
    for b in builds.values():
        log(f"[2 build] {b.path.name}: nvcc {b.seconds:.2f} s")
        for line in b.log.splitlines():
            if "registers" in line or "bytes stack" in line:
                log(f"  ptxas: {line.strip()}")
    rate_dec = ldpc_decoder(RATE, None, dev)
    rate_dec16 = ldpc_decoder(RATE, None, dev, "bf16")  # the bf16 builds' own tables
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    resources_by_build = {
        "K1": ldpc_kernel.k1_resources(rate_dec.n, rate_dec.k1.slots),
        "K1 bf16": ldpc_kernel.k1_resources(rate_dec16.n, rate_dec16.k1.slots, "bf16"),
        "K2": ldpc_kernel.k2_resources(rate_dec.n, rate_dec.k2.slots),
        "K2 bf16": ldpc_kernel.k2_resources(rate_dec16.n, rate_dec16.k2.slots, "bf16")}
    for name, res in resources_by_build.items():
        resident = res["blocks_per_sm"] * sms
        log(f"[2 build] {name} at {RATE}: {res['registers']} registers and "
            f"{res['local_bytes']} bytes of local (spill) memory per thread, "
            f"{res['shared_bytes']} shared bytes per block; {res['blocks_per_sm']} blocks per "
            f"SM x {sms} SMs = {resident} codewords resident at once")
        if res["local_bytes"] or resident < 512:
            raise AssertionError(f"{name} spills, or fewer than 512 codewords are resident")
    for rate in ("R1_2", "R3_4"):
        for precision in ("f32", "bf16"):
            dec_r = ldpc_decoder(rate, None, dev, precision)
            res = ldpc_kernel.k1_resources(dec_r.n, dec_r.k1.slots, precision)
            log(f"[2 build] K1 ({precision}) at {rate}: {res['registers']} registers and "
                f"{res['local_bytes']} bytes of local (spill) memory per thread, "
                f"{res['shared_bytes']} shared bytes per block; {res['blocks_per_sm']} blocks "
                f"per SM x {sms} SMs = {res['blocks_per_sm'] * sms} codewords resident at once")
            if res["local_bytes"]:
                raise AssertionError(f"K1 ({precision}) spills at {rate}")

    # -- 3. kernels vs plain, on the card -------------------------------------
    rng = np.random.default_rng(1234)
    max_err = {"K1": 0.0, "K1 bf16": 0.0, "K2": 0.0, "K2 bf16": 0.0}
    plain_name = {"K1": "plain", "K1 bf16": "plain bf16", "K2": "plain_v1",
                  "K2 bf16": "plain_v1 bf16"}
    cases = [(rate, B, False) for rate in CODE_PARAMS for B in (8, 256)] + [(RATE, 512, True)]
    for rate, B, mixed in cases:
        llr, fac = llr_batch(rate, B, rng, mixed)
        dec = ldpc_decoder(rate, None, dev)
        dec16 = ldpc_decoder(rate, None, dev, "bf16")
        x, f = torch.as_tensor(llr, device=dev), torch.as_tensor(fac, device=dev)
        got = {"K1": dec(x, f), "K1 bf16": dec16(x, f),
               "K2": make_cuda_decoder_v1(rate, device=dev)(x, f),
               "K2 bf16": make_cuda_decoder_v1(rate, device=dev, precision="bf16")(x, f)}
        plain = {"K1": dec.plain(x, f), "K1 bf16": dec16.plain(x, f),
                 "K2": dec.plain_v1(x, f), "K2 bf16": dec16.plain_v1(x, f)}
        torch.cuda.synchronize()
        tag = f"{rate} B={B}{' mixed' if mixed else ''}"
        # Each kernel build against its plain version: every output of every row.
        for name, res in got.items():
            ref = plain[name]
            same = same_bits(res, ref)
            err = float((res.llr_total - ref.llr_total).abs().max())
            max_err[name] = max(max_err[name], err)
            log(f"[3 kernels] {tag}: {name} vs {plain_name[name]}: success "
                f"{int(res.success.sum())}/{B}, mean iterations "
                f"{res.iterations.float().mean():.2f}, every output equal: {same}, "
                f"max |llr err| {err:.3g}")
            if not same:
                raise AssertionError(f"{name} differs from {plain_name[name]} ({tag})")
        # K2 against K1 in each precision, within the tolerances of ``compare``.
        allowed = int(MIXED_MAX_FLIPS * B) if mixed else 0
        for a, b, atol in (("K2", "K1", LLR_ATOL), ("K2 bf16", "K1 bf16", BF16_LLR_ATOL)):
            n_bad, err = compare(got[b], got[a], atol)
            log(f"[3 kernels] {tag}: {a} vs {b}: rows differing {n_bad} (allowed {allowed}), "
                f"max |llr err| {err:.3g}")
            if n_bad > allowed:
                raise AssertionError(f"{a} disagrees with {b} on {n_bad} rows ({tag})")
        log(f"[3 kernels] {tag}: max |bf16 - f32 posterior| K1 "
            f"{float((got['K1 bf16'].llr_total - got['K1'].llr_total).abs().max()):.3g}, K2 "
            f"{float((got['K2 bf16'].llr_total - got['K2'].llr_total).abs().max()):.3g}")

    # -- 3b. the chirp search's window pass -----------------------------------
    zoom_entry = zoom_front_phase(card, dev)

    # -- 3c. the Schmidl-Cox search's kernels ------------------------------------
    sc_entry = sc_search_phase(card, dev)

    # -- 3d. the OFDM demodulator's demap stage ---------------------------------
    demap_entry = ofdm_demap_phase(card, dev)

    # -- 3e. the chirp search's fine stage -----------------------------------------
    fine_entry = chirp_fine_phase(card, dev)

    # -- 3f. the light preamble's LTS search's kernels ----------------------------
    lts_entry = lts_search_phase(card, dev)

    # -- 4. main path ---------------------------------------------------------
    cfg, ncw, batch, window = geometry(production=True)
    audio, info = _make_batch(cfg, ncw, batch, window, seed=0, production=True, device=dev)
    rx = make_rx_pipeline(cfg, RATE, ncw, window, device=dev)
    torch.cuda.synchronize()
    zero_counts()
    out = rx(audio)
    torch.cuda.synchronize()
    if launch_count("zoom_front") != 1:
        raise AssertionError(f"the main path launched the window pass "
                             f"{launch_count('zoom_front')} times; 1 expected")
    if launch_count("sc_coarse"):
        raise AssertionError("the MC-DPSK main path ran a Schmidl-Cox search")
    if any(lts_launches()):
        raise AssertionError("the MC-DPSK main path ran an LTS search")
    fine = [launch_count(e) for e in ("chirp_refine_front", "chirp_refine_pick", "median_select")]
    if fine != [2, 2, 1]:
        raise AssertionError(f"the main path launched the fine stage's kernels {fine} times; "
                             "[2, 2, 1] expected")
    zoom_entry["launches"] = launch_count("zoom_front")
    fine_entry["launches"] = sum(fine)
    launches = launch_count(K1)
    launches_v1_main = (launch_count(K2), launch_count(K2_BF16))
    det = out.detected.cpu().numpy()
    ok = out.cw_success.cpu().numpy()
    bits = out.info_bits.cpu().numpy()
    log(f"[4 main path] B={batch} window={window}: detected {int(det.sum())}/{batch}, "
        f"cw_decode_rate {ok.mean():.4f}, K1 launches {launches}, K2 launches f32 "
        f"{launches_v1_main[0]}, bf16 {launches_v1_main[1]}")
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
    if any(launches_v1_main):
        raise AssertionError(f"the main path launched K2 (f32, bf16) {launches_v1_main}")
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
        zero_counts()
        o_out = orx(o_audio)
        torch.cuda.synchronize()
        o_launches = (launch_count(K1), k2_launches())
        if launch_count("sc_coarse") != 1:
            raise AssertionError(f"the OFDM chain ran {launch_count('sc_coarse')} "
                                 "Schmidl-Cox searches through the kernels; 1 expected")
        if launch_count("ofdm_demap") != 1:
            raise AssertionError(f"the OFDM chain launched the demap kernel "
                                 f"{launch_count('ofdm_demap')} times; 1 expected")
        if any(lts_launches()):
            raise AssertionError("the Schmidl-Cox chain ran an LTS search")
        sc_entry["launches"] = launch_count("sc_coarse")
        demap_entry["launches"] = launch_count("ofdm_demap")
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
    light_chain_phase(dev, lts_entry)

    # -- 4c. single-frame waveform paths --------------------------------------
    wpaths = {}
    for name in W.PATHS:
        batch_w = W.make_path_batch(name, W.BATCH, seed=0, device="cpu")
        x = tuple(t.to(dev) for t in batch_w.inputs)
        path = W.make_path(name)
        torch.cuda.synchronize()
        zero_counts()
        w_out = path(*x)
        torch.cuda.synchronize()
        w_launches = (launch_count(K1), k2_launches())
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

    # -- 4d. waveform API and CLI ---------------------------------------------
    api = waveform_api_phase(dev)
    max_err["K1"] = max(max_err["K1"], api["k1_err"])

    # -- 4e. protocol sessions ------------------------------------------------
    sessions = session_phase(card)
    max_err["K1"] = max([max_err["K1"]] + [r["k1_max_abs_err"] for r in sessions["runs"].values()])

    # -- 4f. host-control plane ----------------------------------------------
    host = host_phase(card)
    max_err["K1"] = max(max_err["K1"], host["k1_err"])

    # -- 4g. scale-out --------------------------------------------------------
    scale = scale_out_phase(card, dev)
    max_err["K1"] = max(max_err["K1"], scale["k1_err"])

    # -- 4h. root tools -------------------------------------------------------
    tools = tools_phase(card)
    max_err["K1"] = max(max_err["K1"], tools["k1_err"])

    # -- 4i. stage profile and the bf16 path ------------------------------------
    profile = profile_phase(card, dev)
    max_err["K1 bf16"] = max(max_err["K1 bf16"], profile["k1_bf16_err"])

    # -- 4j. bench.py's twin --------------------------------------------------
    bench_run = bench_phase(card, dev)
    max_err["K1"] = max(max_err["K1"], bench_run["k1_err"])
    max_err["K1 bf16"] = max(max_err["K1 bf16"], bench_run["k1_bf16_err"])

    # -- 5. A/B entry point ---------------------------------------------------
    log(f"[5 A/B] python -m ria_tpu_torch.tools.ldpc_bench {' '.join(BENCH_ARGS)}")
    zero_counts()
    rows = ldpc_bench.run(BENCH_ARGS)
    torch.cuda.synchronize()
    launches_v1, launches_ab = launch_count(K2), launch_count(K1)
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
    # Each kernel against its plain version on the entry point's own LLRs:
    # every output of every row.
    ab_llr = torch.as_tensor(ldpc_bench.make_llrs("R1_4", 512, -1.0)[1], device=dev)
    ab_fac = torch.full((512,), MIN_SUM_FACTOR, device=dev)
    ab_dec, ab_dec16 = ldpc_decoder("R1_4", None, dev), ldpc_decoder("R1_4", None, dev, "bf16")

    def hold_ab(bench_rows, held):
        for name, kernel, ref in held:
            res = bench_rows[name].result
            same = same_bits(res, ref)
            err = float((res.llr_total - ref.llr_total).abs().max())
            max_err[kernel] = max(max_err[kernel], err)
            log(f"[5 A/B] {name} ({kernel}) vs {plain_name[kernel]}: every output equal: {same}, "
                f"max |llr err| {err:.3g}")
            if not same:
                raise AssertionError(f"ldpc_bench: {kernel} differs from {plain_name[kernel]}")

    hold_ab(rows, (("k1", "K1", rows["plain"].result),
                   ("k2", "K2", ab_dec.plain_v1(ab_llr, ab_fac))))
    # The same entry point with the TPU kernels' arithmetic: both kernels in
    # their bf16 builds, the plain decoder float32, as tools/pallas_bench.py.
    bench16 = [*BENCH_ARGS, "--precision", "bf16"]
    log(f"[5 A/B] python -m ria_tpu_torch.tools.ldpc_bench {' '.join(bench16)}")
    zero_counts()
    rows16 = ldpc_bench.run(bench16)
    torch.cuda.synchronize()
    launches_ab16 = {name: launch_count(name) for name in COUNTS}
    log(f"[5 A/B] launches in the bf16 run: K1 {launches_ab16[K1]}, K1 bf16 "
        f"{launches_ab16[K1_BF16]}, K2 {launches_ab16[K2]}, K2 bf16 "
        f"{launches_ab16[K2_BF16]}")
    if list(rows16) != ["k1", "k2", "plain"]:
        raise AssertionError(f"ldpc_bench --precision bf16 ran {list(rows16)}")
    if (launches_ab16[K1] or launches_ab16[K2]
            or launches_ab16[K1_BF16] < 1 or launches_ab16[K2_BF16] < 1):
        raise AssertionError("ldpc_bench --precision bf16 did not launch the two bf16 builds "
                             "alone")
    for name in ("k1", "k2"):
        if not (rows16[name].ok > 0.5 and rows16[name].bitacc > 0.99):
            raise AssertionError(f"ldpc_bench --precision bf16: {name} ok={rows16[name].ok}, "
                                 f"bitacc={rows16[name].bitacc}")
    hold_ab(rows16, (("k1", "K1 bf16", ab_dec16.plain(ab_llr, ab_fac)),
                     ("k2", "K2 bf16", ab_dec16.plain_v1(ab_llr, ab_fac))))
    allowed = int(MIXED_MAX_FLIPS * 512)
    n_bad, err = compare(rows16["k1"].result, rows16["k2"].result, BF16_LLR_ATOL)
    s16 = rows16["k1"].result.success.cpu()
    log(f"[5 A/B] bf16: k2 vs k1 rows differing {n_bad} (allowed {allowed}), max |llr err| "
        f"{err:.3g}; success differs from plain f32 on "
        f"{int((s16 != rows16['plain'].result.success.cpu()).sum())} rows")
    if n_bad > allowed:
        raise AssertionError(f"ldpc_bench --precision bf16: k2 disagrees with k1 on {n_bad} rows")

    # -- 6. serving layer on the card -----------------------------------------
    zero_counts()
    data = bytes(range(40))
    for rate in CODE_PARAMS:
        codec = L.LDPCCodec(rate, device=dev)
        ok_rt, decoded = codec.decode_hard(codec.encode(data))
        if not ok_rt or decoded[: len(data)] != data:
            raise AssertionError(f"LDPCCodec({rate}) on the card: round trip failed")
    log(f"[6 serving] LDPCCodec round trip on the card for {len(CODE_PARAMS)} rates, "
        f"K1 launches {launch_count(K1)}")
    llr = bpsk_llrs("R1_2", 5, 4, 10 ** (1.2 / 20))
    before = launch_count(K1)
    got = L.decode_with_retries(llr, "R1_2", device=dev)
    torch.cuda.synchronize()
    retry_launches = launch_count(K1) - before
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
    if k2_launches():
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
    api_ms = time_waveform_api(api, card)
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
        read = {name: kernel_us(fns[name], kernel)
                for name, kernel in (("K1", "ldpc_bp_kernel"), ("K2", "ldpc_bp_v1_kernel"))}
        us = {name: t for name, (t, _) in read.items()}
        # The same launches by the other clock: CUDA events around launches
        # queued behind a spinning kernel (what kernel_us falls back to).
        queued = {name: queued_us(fns[name]) for name in us}
        iterations = dec(x, f).iterations
        bounds = {name: bound_us(dec, name, x.shape[0], int(iterations.sum())) for name in us}
        times[label] = {"K1": ((k1a + k1b) / 2, (p1 + p2) / 2, us["K1"], bounds["K1"]),
                        "K2": ((k2a + k2b) / 2, (q1 + q2) / 2, us["K2"], bounds["K2"])}
        log(f"[7 timing] LDPC {RATE} {label}: mean iterations "
            f"{iterations.float().mean():.2f}; K1 {k1a:.4f} / {k1b:.4f} / {k1c:.4f} ms, "
            f"plain {p1:.4f} / {p2:.4f} ms; K2 {k2a:.4f} / {k2b:.4f} ms, plain_v1 {q1:.4f} / "
            f"{q2:.4f} ms")
        log(f"[7 timing] LDPC {RATE} {label}: device time per launch: " + ", ".join(
            f"{name} {t:.2f} us ({how}; {queued[name]:.2f} us by CUDA events around 20 queued "
            "launches)" for name, (t, how) in read.items()))
        log(f"[7 timing] LDPC {RATE} {label}: K1/K2 device time {us['K1'] / us['K2']:.4f}; "
            + ", ".join(f"{name} bound {bounds[name][0]:.3f} us ({bounds[name][1]}), "
                        f"{bounds[name][0] / us[name]:.2%} of it reached"
                        for name in us) + f" ({card})")

    # Each bf16 build at the main path's 256 codewords and the A/B point, in
    # turns with its plain version and its float32 build (plain bf16, bf16,
    # f32, bf16, plain bf16).
    dec16 = ldpc_decoder(RATE, None, dev, "bf16")
    k2_dec16 = make_cuda_decoder_v1(RATE, device=dev, precision="bf16")

    def time_bf16(name: str, kernel, plain, f32, symbol32: str, symbol: str) -> dict:
        """{point: (ms, plain ms, device us, bound, f32 device us)} of the
        bf16 build ``name``; ``kernel``, ``plain`` and ``f32`` decode (x, f),
        the builds' kernels are named ``symbol`` and ``symbol32``."""
        out = {}
        f32_name = name.split()[0]
        for label, x in (("B=256 main path", soft), ("B=512 A/B -1 dB", ab_llr)):
            f = torch.full((x.shape[0],), MIN_SUM_FACTOR, device=dev)
            fns = {"bf16": lambda: kernel(x, f), "plain": lambda: plain(x, f),
                   "f32": lambda: f32(x, f)}
            for fn in fns.values():
                for _ in range(3):
                    fn()
            p1 = cuda_ms(fns["plain"], 5)[0]
            b1 = cuda_ms(fns["bf16"], 20)[0]
            k32 = cuda_ms(fns["f32"], 20)[0]
            b2 = cuda_ms(fns["bf16"], 20)[0]
            p2 = cuda_ms(fns["plain"], 5)[0]
            us16, how = kernel_us(fns["bf16"], symbol)
            us32 = kernel_us(fns["f32"], symbol32)[0]
            it16 = kernel(x, f).iterations
            bnd = bound_us(dec16, name, x.shape[0], int(it16.sum()))
            out[label] = ((b1 + b2) / 2, (p1 + p2) / 2, us16, bnd, us32)
            log(f"[7 timing] LDPC {RATE} {label}, {name}: mean iterations "
                f"{it16.float().mean():.2f} (f32 {f32(x, f).iterations.float().mean():.2f}); "
                f"{name} {b1:.4f} / {b2:.4f} ms, {f32_name} {k32:.4f} ms, {plain_name[name]} "
                f"{p1:.4f} / {p2:.4f} ms; device time per launch {name} {us16:.2f} us ({how}), "
                f"{f32_name} {us32:.2f} us, ratio {us16 / us32:.4f}; bound {bnd[0]:.3f} us "
                f"({bnd[1]}), {bnd[0] / us16:.2%} of it reached ({card})")
        log(f"[7 timing] {name} resources at {RATE}: {resources_by_build[name]}, "
            f"{f32_name} {resources_by_build[f32_name]} (registers, local bytes, shared bytes, "
            f"blocks per SM; {card})")
        return out

    bf16_times = {"K1 bf16": time_bf16("K1 bf16", dec16, dec16.plain, dec, "ldpc_bp_kernel",
                                       "ldpc_bp_bf16_kernel"),
                  "K2 bf16": time_bf16("K2 bf16", k2_dec16, dec16.plain_v1, k2_dec,
                                       "ldpc_bp_v1_kernel", "ldpc_bp_v1_bf16_kernel")}

    # K1 on each OFDM chain's own 256 codewords, at factor 0.9375.
    for path, (geom, orx, o_audio, _) in ofdm.items():
        _, _, o_soft = orx.soft_bits(o_audio)
        o_dec = orx.decoder
        o_f = torch.full((o_soft.shape[0],), orx.min_sum_factor, device=dev)
        o_us, how = kernel_us(lambda: o_dec(o_soft, o_f), "ldpc_bp_kernel")
        o_iters = o_dec(o_soft, o_f).iterations
        o_bound = bound_us(o_dec, "K1", o_soft.shape[0], int(o_iters.sum()))
        log(f"[7 timing] K1 on {path} ({geom.rate}, B={o_soft.shape[0]}, mean iterations "
            f"{o_iters.float().mean():.2f}): {o_us:.2f} us per launch ({how}), bound {o_bound[0]:.3f} us ({o_bound[1]}), "
            f"{o_bound[0] / o_us:.2%} of it reached ({card})")

    # K1 on each waveform path's own 64 header codewords.
    path_k1 = {}
    w_dec = ldpc_decoder(W.RATE, RECOMMENDED_ITERS[W.RATE], dev)
    for name, (path, x, _) in wpaths.items():
        if name == "css_zc_sync":
            continue
        _, _, w_soft = path.soft_bits(*x)
        w_f = torch.full((w_soft.shape[0],), MIN_SUM_FACTOR, device=dev)
        w_us, how = kernel_us(lambda: w_dec(w_soft, w_f), "ldpc_bp_kernel")
        w_iters = w_dec(w_soft, w_f).iterations
        w_bound = bound_us(w_dec, "K1", w_soft.shape[0], int(w_iters.sum()))
        path_k1[name] = (w_us, w_bound)
        log(f"[7 timing] K1 on path {name} ({W.RATE}, B={w_soft.shape[0]}, mean iterations "
            f"{w_iters.float().mean():.2f}): {w_us:.2f} us per launch ({how}), bound {w_bound[0]:.3f} us ({w_bound[1]}), "
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

    k1_small = trace_waveform_api(api, api_ms, card, dev)
    k1_sessions = time_sessions(sessions, card)
    k1_host = k1_at_sizes(host["calls"], "phase-4f", card)
    k1_scale = k1_at_sizes(scale["calls"], "phase-4g", card)
    k1_tools = k1_at_sizes(tools["calls"], "phase-4h", card)

    # The serial floor: one codeword alone for all 50 iterations, on a row
    # that no build decodes, each bf16 build in turns with its float32 one
    # (K1, K1 bf16, K1 bf16, K1; then K2 likewise).
    ab_runs = (dec(ab_llr, ab_fac), dec16(ab_llr, ab_fac), k2_dec(ab_llr, ab_fac),
               k2_dec16(ab_llr, ab_fac))
    stuck = torch.stack([(r.iterations == 50) & ~r.success for r in ab_runs]).all(dim=0)
    row = int(torch.nonzero(stuck)[0])
    x1, f1 = ab_llr[row : row + 1], ab_fac[:1]
    floor_fns = {"K1": (lambda: dec(x1, f1), "ldpc_bp_kernel"),
                 "K1 bf16": (lambda: dec16(x1, f1), "ldpc_bp_bf16_kernel"),
                 "K2": (lambda: k2_dec(x1, f1), "ldpc_bp_v1_kernel"),
                 "K2 bf16": (lambda: k2_dec16(x1, f1), "ldpc_bp_v1_bf16_kernel")}
    floor_reads = {name: [] for name in floor_fns}
    for order in (("K1", "K1 bf16", "K1 bf16", "K1"), ("K2", "K2 bf16", "K2 bf16", "K2")):
        for name in order:
            floor_reads[name].append(kernel_us(*floor_fns[name]))
    floor = {name: (sum(t for t, _ in reads) / len(reads), reads[0][1])
             for name, reads in floor_reads.items()}
    log("[7 timing] serial floor, B=1 on A/B row {} (50 iterations, mean of two reads in "
        "turns): ".format(row) + ", ".join(
            f"{name} {t:.2f} us per launch ({' / '.join(f'{r:.2f}' for r, _ in floor_reads[name])}), "
            f"{t / 50:.4f} us per iteration ({how})" for name, (t, how) in floor.items())
        + f"; bf16 / f32: K1 {floor['K1 bf16'][0] / floor['K1'][0]:.4f}, K2 "
        f"{floor['K2 bf16'][0] / floor['K2'][0]:.4f} ({card})")

    # -- 8. result ------------------------------------------------------------
    # Times at the main path's 256 codewords.  ``launches`` counts the path
    # that runs each kernel (K1: the RX call; K2: the A/B entry point; the
    # bf16 builds: the bf16 path of phase 4i and ``ldpc_bench --precision
    # bf16``),
    # ``launches_per_call`` the launches per RX call of the main path, and
    # ``launches_per_call_by_path`` those of each chain's and waveform path's
    # call.  No PyTorch call computes min-sum BP, so there is no library time.
    main_times = times["B=256 main path"]
    kernels = []
    for i, (name, source, replaces, n_launch, per_call) in enumerate((
            ("K1", "ria_tpu_torch/csrc/ldpc_bp.cu", "ria_tpu/fec/ldpc_pallas.py:39",
             launches, launches),
            ("K2", "ria_tpu_torch/csrc/ldpc_bp_v1.cu", "ria_tpu/fec/ldpc_pallas.py:218",
             launches_v1, launches_v1_main[0]))):
        ms, plain_ms, dev_us, (b_us, b_by) = main_times[name]
        by_path = {"mc_dpsk": per_call}
        by_path.update({path: run[3][i] for path, run in ofdm.items()})
        by_path.update({path: run[2][i] for path, run in wpaths.items()})
        by_path.update({f"api {tag}": n[i] for tag, n in api["launches"].items()})
        by_path.update({f"session {name}": n[i] for name, n in sessions["launches"].items()})
        by_path.update({f"host {name}": n[i] for name, n in host["launches"].items()})
        by_path.update({f"scale-out {name} (sum over ranks)": sum(n[i])
                        for name, n in scale["launches"].items()})
        by_path.update({f"tools {name}": n[i] for name, n in tools["launches"].items()})
        by_path["bf16 path"] = profile["launches"][2 * i]
        by_path["bench chains"] = (bench_run["launches"]["mc_dpsk"]["k1" if i == 0 else "k2"]
                                   / bench_run["launches"]["mc_dpsk"]["calls"])
        kernels.append({
            "name": "ldpc_bp" if name == "K1" else "ldpc_bp_v1", "route": "cuda",
            "source": source, "replaces": replaces, "launches": n_launch,
            "launches_per_call": per_call, "launches_per_call_by_path": by_path,
            "max_abs_err": max_err[name], "ms": ms,
            "plain_ms": plain_ms, "device_us": dev_us, "bound_us": b_us,
            "bound_ms": b_us / 1e3, "bound_by": b_by, "library_ms": None})

    def bf16_entry(name: str, symbol: str, source: str, replaces: str, launched: int,
                   by_path: dict) -> dict:
        """The ``kernels`` entry of the bf16 build ``name``: its launches on
        the path that runs it, its times at the main path's 256 codewords and
        at the A/B point beside them."""
        ms, plain_ms, dev_us, (b_us, b_by), _ = bf16_times[name]["B=256 main path"]
        ab16 = bf16_times[name]["B=512 A/B -1 dB"]
        return {
            "name": symbol, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launched, "launches_per_call": launched,
            "launches_per_call_by_path": by_path, "max_abs_err": max_err[name], "ms": ms,
            "plain_ms": plain_ms, "device_us": dev_us, "bound_us": b_us, "bound_ms": b_us / 1e3,
            "bound_by": b_by, "library_ms": None,
            "ab_point": {"ms": ab16[0], "plain_ms": ab16[1], "device_us": ab16[2],
                         "bound_us": ab16[3][0], "bound_by": ab16[3][1],
                         "f32_device_us": ab16[4]}}

    # K1's bf16 build: launched by the bf16 path of phase 4i (the decoder
    # entry point with precision="bf16") and by ``ldpc_bench --precision
    # bf16``, per call of its decoder there (the calls the tool counted).
    kernels.append(bf16_entry(
        "K1 bf16", "ldpc_bp_bf16", "ria_tpu_torch/csrc/ldpc_bp_bf16.cu",
        "ria_tpu/fec/ldpc_pallas.py:39", profile["launches"][1],
        {"bf16 path": profile["launches"][1],
         "ldpc_bench --precision bf16": launches_ab16[K1_BF16] / rows16["k1"].calls,
         "bench k1_bf16 row": (bench_run["launches"]["k1_bf16"]["k1_bf16"]
                               / bench_run["launches"]["k1_bf16"]["calls"])}))
    # K2's bf16 build: launched by ``ldpc_bench --precision bf16`` (phase 5)
    # alone.  On every other path K2's count above is of either build and
    # every phase requires it to be 0, so it is this build's count too; the
    # main path's is this build's own.
    by_path = dict(kernels[1]["launches_per_call_by_path"])
    by_path["mc_dpsk"] = launches_v1_main[1]
    by_path["ldpc_bench --precision bf16"] = (launches_ab16[K2_BF16]
                                              / rows16["k2"].calls)
    if any(n for path, n in by_path.items() if path != "ldpc_bench --precision bf16"):
        raise AssertionError(f"K2's bf16 build launched off the A/B entry point: {by_path}")
    kernels.append(bf16_entry(
        "K2 bf16", "ldpc_bp_v1_bf16", "ria_tpu_torch/csrc/ldpc_bp_v1_bf16.cu",
        "ria_tpu/fec/ldpc_pallas.py:218", launches_ab16[K2_BF16], by_path))
    kernels[-1]["launches_per_call"] = by_path["ldpc_bench --precision bf16"]
    for kernel, name in zip(kernels, ("K1", "K2", "K1 bf16", "K2 bf16")):
        kernel["serial_floor_us_per_iteration"] = floor[name][0] / 50
    # K1's device time and bound on each waveform path's 64 codewords.
    kernels[0]["device_us_by_path"] = {path: t[0] for path, t in path_k1.items()}
    kernels[0]["bound_us_by_path"] = {path: t[1][0] for path, t in path_k1.items()}
    kernels[0]["api_us_by_batch"] = {
        str(B): {"decode_codewords_host_us": t[0], "device_us": t[1], "bound_us": t[2]}
        for B, t in k1_small.items()}
    kernels[0]["session_us_by_batch"] = {
        b: {"device_us": t[0], "bound_us": t[1]} for b, t in k1_sessions.items()}
    kernels[0]["host_us_by_batch"] = {
        b: {"device_us": t[0], "bound_us": t[1]} for b, t in k1_host.items()}
    kernels[0]["scaleout_us_by_batch"] = {
        b: {"device_us": t[0], "bound_us": t[1]} for b, t in k1_scale.items()}
    kernels[0]["tools_us_by_batch"] = {
        b: {"device_us": t[0], "bound_us": t[1]} for b, t in k1_tools.items()}
    # K1's two builds on bench.py's LDPC batch (phase 4j).
    for kernel, name in ((kernels[0], "K1"), (kernels[2], "K1 bf16")):
        t_us, b_us, b_by, iters = bench_run["us"][name]
        kernel["bench_ldpc_batch"] = {"device_us": t_us, "bound_us": b_us, "bound_by": b_by,
                                      "codeword_iterations": iters}
    for i, kernel in enumerate(kernels[:2]):
        kernel["scaleout_launches_per_rank"] = {name: n[i]
                                                for name, n in scale["launches"].items()}
    log(json.dumps({"sessions": sessions["runs"], "card": card}))
    log(json.dumps({"host_control": host["runs"], "native_gpp_s": host["gpp_s"],
                    "card": card}))
    log(json.dumps({"scale_out": scale["cases"], "ranks": 4, "backend": scale["backend"],
                    "phase_s": scale["seconds"], "card": card}))
    log(json.dumps({"tools": tools["summary"], "phase_s": tools["seconds"], "card": card}))
    log(json.dumps({"bench_profile": {"ms": profile["rows"], "split": profile["split"]},
                    "phase_s": profile["seconds"], "card": card}))
    log(json.dumps({"bench": bench_run["line"], "seconds": bench_run["seconds"], "card": card}))
    # The whole call on the host's clock: the API's number, not a kernel's.
    log(json.dumps({"rx_frame_ms_by_class": {name: t[0] for name, t in api_ms.items()},
                    "spectral_snr_ms_in_call_by_class": {name: t[3] for name, t in api_ms.items()},
                    "card": card}))
    kernels.append(zoom_entry)
    kernels.append(sc_entry)
    kernels.append(demap_entry)
    kernels.append(fine_entry)
    kernels.append(lts_entry)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
