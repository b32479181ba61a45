"""The scale-out runs: cases G1-G7 of ``chip_smoke.py`` phase 4g, their data
and the program every rank runs.

Test and bench harness, like ``tools/session_paths.py``.  The parent builds
each case's data from numpy seeds and hands each rank only its own rows or
block (:func:`rank_data`); :func:`run_rank` is the program of one rank,
started by :func:`ria_tpu_torch.parallel.launch.launch`.  For each case a
rank builds its mesh, calls the case's function once with the K1 counters
set to 0 just before and read just after, holds every K1 launch of that
call against the plain decoder on the same LLRs and factors
(``waveform_frames.hold_k1_calls``), and, when asked, times further calls.

=====  ================================================================
G1     batch mesh MC-DPSK (``make_sharded_rx``) on a (ch x cw) mesh
G2     batch mesh OFDM (``make_sharded_ofdm_rx``), one case per config
G3     stream RX MC-DPSK (``make_stream_rx``), top_k 1, and top_k 2 on
       two frames, one of them straddling a block boundary
G4     ``make_stream_search`` alone, on G3's stream
G5     OFDM stream RX (``make_ofdm_stream_rx``), straddling a boundary
G6     sharded FIR (``make_sharded_fir``), 101-tap bandpass
G7     hybrid (ch, t) mesh: ``put_stream_rows``, the cross-rank row sums,
       and one frame through the stream RX on the t lines
=====  ================================================================

:func:`production_cases` gives them at the reference's production geometry
(what ``chip_smoke.py`` runs with 4 ranks), :func:`tiny_cases` at the small
geometry of ``__graft_entry__.dryrun_multichip``.
"""

from __future__ import annotations

import functools
import os
import statistics
import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ria_tpu_torch.dsp.fir import design_bandpass
from ria_tpu_torch.entry import _make_batch, _make_ofdm_batch, _tiny_cfg, geometry, ofdm_geometry
from ria_tpu_torch.fec.interleave import channel_perm, frame_perm
from ria_tpu_torch.fec.ldpc import ldpc_decoder
from ria_tpu_torch.fec.ldpc_matrix import CODE_PARAMS, RECOMMENDED_ITERS, encode_np, get_code
from ria_tpu_torch.parallel._collectives import (all_gather, from_left, from_right,
                                                 gather_fields, psum)
from ria_tpu_torch.parallel.distributed import (local_device, make_hybrid_mesh, put_stream_rows,
                                                rank)
from ria_tpu_torch.parallel.mesh import make_mesh, make_sharded_ofdm_rx, make_sharded_rx
from ria_tpu_torch.parallel.stream import (LADDER_FACTORS, MC_FACTORS, _first_passing,
                                           _stream_geometry, make_ofdm_stream_rx,
                                           make_sharded_fir, make_stream_mesh, make_stream_rx,
                                           make_stream_search)
from ria_tpu_torch.phy.frame_v2 import encode_fixed_frame
from ria_tpu_torch.phy.pipeline import make_ofdm_rx_pipeline, make_rx_pipeline
from ria_tpu_torch.sync.chirp import detect_dual_chirp
from ria_tpu_torch.tools import waveform_frames as F
from ria_tpu_torch.utils.bits import bytes_to_bits
from ria_tpu_torch.wave.mc_dpsk import MCDPSKConfig, demodulate, modulate, preamble
from ria_tpu_torch.wave.ofdm import (OFDMConfig, demodulate_presynced, schmidl_cox_search,
                                     tx_frame)

RATE = "R1_4"
NCW = 4
RANKS = 4
# G3/G4: a 16 s production stream in 4 blocks; the frame's chirp straddles
# the first boundary.
STREAM_BLOCK = 192_000
FRAME_POS = 150_000
CFO_HZ = 5.0
# G5: DQPSK with pilots, R1/2, blocks of 3 x 48,000, 8 dB.
OFDM_BLOCK = 3 * 48_000
# G6: 3 rows of 4 x 12,000 samples.
FIR_BLOCK = 12_000
# G7: rows of 4,096 samples, host h's row holding h + 1.
HYBRID_T = 4096
# The 128-point OFDM of dryrun_multichip: 375 Hz bins, the band at 12 kHz.
TINY_OFDM = OFDMConfig(fft_size=128, cp_len=12, num_carriers=29, center_freq=12000.0,
                       modulation="DQPSK", use_pilots=False, output_scale=8.0)
TINY_OFDM_RATE = "R1_2"


@dataclass(frozen=True)
class Case:
    """One case: its name, kind (the ``make_*`` it runs) and that
    function's arguments after the mesh."""

    name: str
    kind: str
    params: tuple


# ------------------------------------------------------------------ data
def _frame_tx(cfg: MCDPSKConfig, info: np.ndarray, cfo_hz: float) -> np.ndarray:
    coded = encode_np(info, RATE).reshape(-1)
    return np.concatenate([preamble(cfg, tx_cfo_hz=cfo_hz), modulate(coded, cfg)])


def mc_stream(cfg: MCDPSKConfig, ncw: int, total: int, positions: tuple[int, ...],
              cfo_hz: float, noise: float, seed: int):
    """A stream of ``total`` samples with one frame at each position
    (random R1/4 codewords, ``cfo_hz`` on the preamble) under AWGN.
    Returns (stream f32, [info [ncw, k] per frame]).  A positive ``noise``
    is an SNR in dB against the first frame's RMS; 0 or less is minus the
    noise's standard deviation."""
    rng = np.random.default_rng(seed)
    k = get_code(RATE).k
    stream = np.zeros(total, np.float32)
    infos, rms = [], None
    for pos in positions:
        info = rng.integers(0, 2, (ncw, k)).astype(np.uint8)
        tx = _frame_tx(cfg, info, cfo_hz)
        stream[pos : pos + len(tx)] = tx[: total - pos]
        rms = float(np.sqrt(np.mean(tx**2))) if rms is None else rms
        infos.append(info)
    sigma = rms * 10 ** (-noise / 20) if noise > 0 else -noise
    stream += rng.normal(0, sigma, total).astype(np.float32)
    return stream, infos


def _ofdm_frame(cfg: OFDMConfig, rate: str, rng: np.random.Generator):
    """(audio, info bits [4, k]) of one fixed 4-codeword Schmidl-Cox frame of
    random payload bytes drawn from ``rng``."""
    k = get_code(rate).k
    bpc = k // 8
    payload = rng.integers(0, 256, 4 * bpc).astype(np.uint8)
    tx = tx_frame(encode_fixed_frame(payload.tobytes(), rate, cfg.bits_per_ofdm_symbol()), cfg,
                  preamble="cox").astype(np.float32)
    info = np.zeros((4, k), np.uint8)
    info[:, : 8 * bpc] = bytes_to_bits(payload).reshape(4, 8 * bpc)
    return tx, info


def ofdm_stream(cfg: OFDMConfig, rate: str, total: int, pos: int, snr_db: float, seed: int):
    """A stream with one fixed 4-codeword Schmidl-Cox frame at ``pos`` and
    AWGN at ``snr_db`` against its RMS.  Returns (stream, info [4, k])."""
    rng = np.random.default_rng(seed)
    tx, info = _ofdm_frame(cfg, rate, rng)
    stream = np.zeros(total, np.float32)
    stream[pos : pos + len(tx)] = tx
    rms = float(np.sqrt(np.mean(tx**2)))
    stream += rng.normal(0, rms * 10 ** (-snr_db / 20), total).astype(np.float32)
    return stream, info


def ofdm_frame_samples(cfg: OFDMConfig) -> int:
    """The length of a fixed 4-codeword frame with its Schmidl-Cox preamble."""
    return cfg.preamble_samples + (2 + cfg.num_symbols_for_bits(4 * 648)) * cfg.symbol_samples


def fir_taps() -> np.ndarray:
    return design_bandpass(101, 300.0, 2700.0, 48000.0)


def fir_rows(n: int, seed: int = 3) -> np.ndarray:
    return np.random.default_rng(seed).normal(0, 1, (3, n * FIR_BLOCK)).astype(np.float32)


def tiny_stream_geometry(cfg: MCDPSKConfig, ncw: int, n: int) -> tuple[int, int]:
    """dryrun_multichip's stream: (block, frame position).  One frame and
    4,096 samples over n blocks of at least 8,192; the frame at the middle
    of the first block, or as late as the stream allows."""
    tx_len = cfg.chirp.total_samples + (cfg.training_symbols + 1 + cfg.num_data_symbols(
        ncw * 648) * cfg.spreading) * cfg.samples_per_symbol
    block = max(8192, -(-(tx_len + 4096) // n))
    return block, min(block // 2, n * block - tx_len)


# ----------------------------------------------------------------- cases
def production_cases(n: int = RANKS, device: str | torch.device = "cpu"):
    """(cases, data, sent): G1-G7 at the reference's production geometry for
    ``n`` ranks.  ``data[name]`` is the case's whole input, ``sent[name]``
    what was transmitted (info bits, or the expected values)."""
    cases, data, sent = [], {}, {}
    cfg, ncw, batch, window = geometry(production=True)
    audio, info = _make_batch(cfg, ncw, batch, window, seed=0, production=True, device=device)
    cases.append(Case("G1", "mesh_rx", (cfg, RATE, ncw, window)))
    data["G1"], sent["G1"] = audio.cpu().numpy(), info
    for config in (3, 4):
        g = ofdm_geometry(config)
        o_audio, o_info = _make_ofdm_batch(g, seed=0, device=device)
        name = f"G2 #{config}"
        cases.append(Case(name, "mesh_ofdm_rx", (g.cfg, g.rate, g.window, g.ci_bits)))
        data[name], sent[name] = o_audio.cpu().numpy(), o_info
    scfg = MCDPSKConfig(num_carriers=10, bits_per_symbol=1)
    total = n * STREAM_BLOCK
    stream, infos = mc_stream(scfg, NCW, total, (FRAME_POS,), CFO_HZ, 10.0, seed=7)
    cases.append(Case("G3", "stream_rx", (scfg, RATE, NCW, STREAM_BLOCK, 1)))
    data["G3"], sent["G3"] = stream, {"positions": (FRAME_POS,), "infos": infos}
    two = (5000, 2 * STREAM_BLOCK - 2000)
    stream2, infos2 = mc_stream(scfg, NCW, total, two, 0.0, 10.0, seed=13)
    cases.append(Case("G3 top_k=2", "stream_rx", (scfg, RATE, NCW, STREAM_BLOCK, 2)))
    data["G3 top_k=2"], sent["G3 top_k=2"] = stream2, {"positions": two, "infos": infos2}
    cases.append(Case("G4", "stream_search", (scfg.chirp, STREAM_BLOCK)))
    data["G4"], sent["G4"] = stream, {"positions": (FRAME_POS,)}
    ocfg = OFDMConfig(modulation="DQPSK", use_pilots=True, pilot_spacing=10)
    flen = ofdm_frame_samples(ocfg)
    opos = 2 * OFDM_BLOCK - flen // 3
    ostream, oinfo = ofdm_stream(ocfg, "R1_2", n * OFDM_BLOCK, opos, 8.0, seed=11)
    cases.append(Case("G5", "ofdm_stream_rx", (ocfg, "R1_2", OFDM_BLOCK,
                                               ocfg.bits_per_ofdm_symbol())))
    data["G5"], sent["G5"] = ostream, {"positions": (opos,), "infos": [oinfo]}
    cases.append(Case("G6", "fir", (tuple(fir_taps()), FIR_BLOCK)))
    data["G6"], sent["G6"] = fir_rows(n), None
    cases.append(hybrid_case(n))
    data["G7"], sent["G7"] = hybrid_data(n)
    return cases, data, sent


def dryrun_cases(n: int, device: str | torch.device = "cpu"):
    """(cases, data, sent) of ``__graft_entry__.dryrun_multichip(n)``: its
    batch mesh (G1), stream (G3), OFDM batch mesh (G2) and OFDM stream (G5),
    in its order, with its geometry and seeds."""
    cfg, ncw = _tiny_cfg(), 2
    cases, data, sent = [], {}, {}
    batch = max(2 * n, 8)
    window = cfg.frame_samples(ncw * 648) + 2048
    audio, info = _make_batch(cfg, ncw, batch, window, seed=1, device=device)
    cases.append(Case("G1", "mesh_rx", (cfg, RATE, ncw, window)))
    data["G1"], sent["G1"] = audio.cpu().numpy(), info
    block, pos = tiny_stream_geometry(cfg, ncw, n)
    stream, infos = mc_stream(cfg, ncw, n * block, (pos,), 0.0, -0.02, seed=2)
    cases.append(Case("G3", "stream_rx", (cfg, RATE, ncw, block, 1)))
    data["G3"], sent["G3"] = stream, {"positions": (pos,), "infos": infos}
    oaudio, oinfo, owindow, ostream, osent = tiny_ofdm(n)
    ci = TINY_OFDM.bits_per_ofdm_symbol()
    cases.append(Case("G2", "mesh_ofdm_rx", (TINY_OFDM, TINY_OFDM_RATE, owindow, ci)))
    data["G2"], sent["G2"] = oaudio, oinfo
    cases.append(tiny_ofdm_stream_case(n))
    data["G5"], sent["G5"] = ostream, osent
    return cases, data, sent


def tiny_cases(n: int = RANKS, device: str | torch.device = "cpu"):
    """(cases, data, sent) of the small geometry for ``n`` ranks:
    :func:`dryrun_cases`, two frames for top_k 2 (block 16,384: one inside
    block 0, one straddling blocks 1 and 2), the search on G3's stream, the
    FIR and the hybrid mesh."""
    cases, data, sent = dryrun_cases(n, device)
    cfg, ncw = _tiny_cfg(), 2
    block2 = 16384
    two = (1000, 2 * block2 - 500)
    stream2, infos2 = mc_stream(cfg, ncw, n * block2, two, 0.0, -0.02, seed=13)
    cases.append(Case("G3 top_k=2", "stream_rx", (cfg, RATE, ncw, block2, 2)))
    data["G3 top_k=2"], sent["G3 top_k=2"] = stream2, {"positions": two, "infos": infos2}
    g3 = next(c for c in cases if c.name == "G3")
    cases.append(Case("G4", "stream_search", (cfg.chirp, g3.params[3])))
    data["G4"], sent["G4"] = data["G3"], {"positions": sent["G3"]["positions"]}
    cases.append(Case("G6", "fir", (tuple(fir_taps()), FIR_BLOCK)))
    data["G6"], sent["G6"] = fir_rows(n), None
    cases.append(hybrid_case(n))
    data["G7"], sent["G7"] = hybrid_data(n)
    return cases, data, sent


def tiny_ofdm(n: int, seed: int = 3):
    """dryrun_multichip's OFDM data for n ranks, drawn from one generator in
    its order: the batch (max(2n, 8) frames, leads in [0, 512), 15 dB
    against the last frame's RMS), then the stream, which holds the batch's
    last frame straddling the first block boundary under that noise.
    Returns (audio [batch, window], info [batch, 4, k], window, stream,
    {"positions", "infos"} of the stream)."""
    batch = max(2 * n, 8)
    window = ofdm_frame_samples(TINY_OFDM) + 1024
    rng = np.random.default_rng(seed)
    audio = np.zeros((batch, window), np.float32)
    info = np.zeros((batch, 4, get_code(TINY_OFDM_RATE).k), np.uint8)
    for b in range(batch):
        tx, info[b] = _ofdm_frame(TINY_OFDM, TINY_OFDM_RATE, rng)
        lead = int(rng.integers(0, 512))
        audio[b, lead : lead + len(tx)] = tx
        sigma = float(np.sqrt(np.mean(tx**2))) * 10 ** (-15 / 20)
    audio += rng.normal(0, sigma, audio.shape).astype(np.float32)
    block = tiny_ofdm_block()
    total = n * block
    pos = min(block - TINY_OFDM.symbol_samples, total - len(tx) - 64)
    stream = np.zeros(total, np.float32)
    stream[pos : pos + len(tx)] = tx
    stream += rng.normal(0, sigma, total).astype(np.float32)
    return audio, info, window, stream, {"positions": (pos,), "infos": [info[-1]]}


def tiny_ofdm_block() -> int:
    sym = TINY_OFDM.symbol_samples
    return max(TINY_OFDM.preamble_samples + 6 * sym + 2048, 4096)


def tiny_ofdm_stream_case(n: int) -> Case:
    return Case("G5", "ofdm_stream_rx", (TINY_OFDM, TINY_OFDM_RATE, tiny_ofdm_block(),
                                         TINY_OFDM.bits_per_ofdm_symbol()))


def hybrid_case(n: int) -> Case:
    cfg, ncw = _tiny_cfg(), 2
    t = n // 2
    return Case("G7", "hybrid", (2, t, cfg, RATE, ncw, tiny_stream_geometry(cfg, ncw, t)[0]))


def hybrid_data(n: int):
    """G7's rows (host h's row full of h + 1) and its tiny stream over the
    t lines (one frame, placed as :func:`tiny_stream_geometry` places it)."""
    cfg, ncw = _tiny_cfg(), 2
    t = n // 2
    block, pos = tiny_stream_geometry(cfg, ncw, t)
    rows = np.stack([np.full(HYBRID_T, h + 1.0, np.float32) for h in range(2)])
    stream, infos = mc_stream(cfg, ncw, t * block, (pos,), 0.0, -0.02, seed=2)
    return ({"rows": rows, "stream": stream},
            {"positions": (pos,), "infos": infos,
             "sums": [float(HYBRID_T * (h + 1)) for h in range(2)]})


def rank_data(cases, data: dict, n: int) -> list[dict]:
    """Each rank's own part of every case's data: rows of a batch, a block
    of a stream, a column block of the FIR's rows, and for G7 its host's
    row and its block of the t line's stream."""
    out = [dict() for _ in range(n)]
    for case in cases:
        x = data[case.name]
        for r in range(n):
            if case.kind in ("mesh_rx", "mesh_ofdm_rx"):
                b = x.shape[0] // n
                out[r][case.name] = x[r * b : (r + 1) * b]
            elif case.kind == "hybrid":
                t = case.params[1]
                h, j = divmod(r, t)
                block = case.params[5]
                out[r][case.name] = (x["rows"][h : h + 1],
                                     x["stream"][j * block : (j + 1) * block])
            else:
                block = x.shape[-1] // n
                out[r][case.name] = x[..., r * block : (r + 1) * block]
    return out


# ------------------------------------------------- the single-process port
RX_TOL = 1e-3     # cfo_hz, snr_db
SOFT_TOL = 2e-3   # soft bits
FIR_TOL = 1e-5    # the FIR against np.convolve


def one_rank_case(case: Case, n: int) -> tuple[Case | None, str]:
    """(``case`` on one rank over the whole input of n blocks, the same
    program in a single process; or None and why there is none)."""
    p = case.params
    if case.kind in ("mesh_rx", "mesh_ofdm_rx"):
        return case, ""
    if case.kind == "stream_rx" and p[4] == 1:
        return Case(case.name, case.kind, p[:3] + (n * p[3], p[4])), ""
    if case.kind in ("stream_search", "fir"):
        return Case(case.name, case.kind, (p[0], n * p[1])), ""
    return None, {"stream_rx": "top_k takes one candidate a block",
                  "ofdm_stream_rx": "the OFDM stream RX needs 4 ranks",
                  "hybrid": "a mesh of 2 x 2"}[case.kind]


def _owner_window(stream: np.ndarray, start: int, block: int, halo: int):
    """(the block holding ``start`` extended by ``halo`` samples, zeros past
    the stream's end; its first sample)."""
    lo = (start // block) * block
    window = np.zeros(block + halo, np.float32)
    seg = stream[lo : lo + block + halo]
    window[: len(seg)] = seg
    return window, lo


def _mc_single(cfg, rate: str, ncw: int, block: int, stream: np.ndarray, start: int,
               device) -> dict:
    """One frame of the MC-DPSK stream in a single process: the chirp search
    on the window of the block that owns ``start``, the whole frame through
    ``demodulate``, and the decode at both factors of ``MC_FACTORS`` (the
    first passing kept)."""
    num_bits, D, S_all, frame_need, _ = _stream_geometry(cfg, ncw, block)
    halo = max(cfg.chirp.total_samples + 4800, cfg.samples_per_symbol)
    window, lo = _owner_window(stream, start, block, halo)
    res = detect_dual_chirp(torch.as_tensor(window, device=device), cfg.chirp)
    g = int(res.start) + lo
    at = min(max(g, 0), len(stream) - frame_need) + cfg.chirp.total_samples
    frame = torch.as_tensor(stream[at : at + S_all * cfg.samples_per_symbol], device=device)
    demod = demodulate(frame, res.cfo_hz, cfg, D)
    soft = demod.soft_bits[:num_bits].reshape(ncw, 648)
    factors = torch.tensor(MC_FACTORS, device=device).repeat_interleave(ncw)
    dec = ldpc_decoder(rate, RECOMMENDED_ITERS[rate], device)(
        torch.cat([soft] * len(MC_FACTORS)).contiguous(), factors)
    ok, info = _first_passing(dec.success.reshape(len(MC_FACTORS), ncw),
                              dec.info_bits.reshape(len(MC_FACTORS), ncw, -1))
    return {"detected": bool(res.detected), "start": g, "cfo_hz": float(res.cfo_hz),
            "cw_success": (ok & res.detected).cpu().numpy(),
            "info_bits": info.cpu().numpy(), "soft_bits": soft.cpu().numpy(),
            "snr_db": float(demod.snr_estimate_db)}


def _ofdm_single(cfg, rate: str, block: int, ci: int, stream: np.ndarray, lts_start: int,
                 n: int, device) -> dict:
    """The OFDM stream's frame in a single process: the Schmidl-Cox search on
    the window of the block that owns the preamble, ``demodulate_presynced``
    on the whole frame, and each codeword decoded at the ladder factors the
    n ranks use, the lowest passing kept."""
    sym = cfg.symbol_samples
    S = cfg.num_symbols_for_bits(4 * 648)
    halo = cfg.preamble_samples + 5 * sym + 2048
    window, lo = _owner_window(stream, lts_start - 5 * sym, block, halo)
    res = schmidl_cox_search(torch.as_tensor(window, device=device), cfg)
    lts = int(res.lts_start) + lo
    at = min(max(lts, 0), len(stream) - (2 + S) * sym)
    frame = torch.as_tensor(stream[at : at + (2 + S) * sym], device=device)
    demod = demodulate_presynced(frame, res.cfo_hz, cfg, S, 2)
    soft = demod.soft_bits[: 4 * 648][torch.as_tensor(frame_perm(), device=device)]
    cw = soft.reshape(4, 648)[:, torch.as_tensor(channel_perm(ci), device=device)]
    n_var = max(1, min(n // 4, len(LADDER_FACTORS)))
    factors = torch.tensor(LADDER_FACTORS[:n_var], device=device).repeat_interleave(4)
    dec = ldpc_decoder(rate, None, device)(torch.cat([cw] * n_var).contiguous(), factors)
    ok, info = _first_passing(dec.success.reshape(n_var, 4),
                              dec.info_bits.reshape(n_var, 4, -1))
    return {"detected": bool(res.detected), "lts_start": lts, "cfo_hz": float(res.cfo_hz),
            "cw_success": (ok & res.detected).cpu().numpy(),
            "info_bits": info.cpu().numpy(), "snr_db": float(demod.snr_db)}


def single_process(case: Case, x, got, n: int, device) -> dict:
    """The single-process port's answer to ``case`` on the whole input
    ``x``, for the frames the sharded run ``got`` found: the batch chains
    (``make_rx_pipeline``, ``make_ofdm_rx_pipeline``) on every row; for a
    stream, the sync on the owning block's window and the demodulator on
    the whole frame; the FIR by ``np.convolve``."""
    p = case.params
    if case.kind == "mesh_rx":
        out = make_rx_pipeline(*p, device=device)(torch.as_tensor(x, device=device))
        return {k: v.cpu().numpy() for k, v in out._asdict().items()}
    if case.kind == "mesh_ofdm_rx":
        out = make_ofdm_rx_pipeline(*p, device=device)(torch.as_tensor(x, device=device))
        return {k: v.cpu().numpy() for k, v in out._asdict().items()}
    if case.kind == "stream_rx":
        cfg, rate, ncw, block, top_k = p
        rows = [_mc_single(cfg, rate, ncw, block, x, int(s), device)
                for s in np.atleast_1d(got["start"])]
        if top_k == 1:
            return rows[0]
        return {k: np.stack([np.asarray(r[k]) for r in rows]) for k in rows[0]}
    if case.kind == "stream_search":
        chirp, block = p
        window, lo = _owner_window(x, int(got[1]), block, chirp.total_samples + 4800)
        res = detect_dual_chirp(torch.as_tensor(window, device=device), chirp)
        return {"detected": bool(res.detected), "start": int(res.start) + lo,
                "cfo_hz": float(res.cfo_hz)}
    if case.kind == "ofdm_stream_rx":
        return _ofdm_single(*p, x, int(got["lts_start"]), n, device)
    if case.kind == "fir":
        taps = np.asarray(p[0], np.float32)
        return {"y": np.stack([np.convolve(r, taps)[: x.shape[1]] for r in x])}
    if case.kind == "hybrid":
        cfg, rate, ncw, block = p[2:]
        return {"sums": np.array([float(x["rows"][h].sum()) for h in range(p[0])]),
                "stream": _mc_single(cfg, rate, ncw, block, x["stream"],
                                     int(got["stream"]["start"]), device)}
    raise ValueError(f"unknown case kind {case.kind!r}")


# Fields held exactly, within RX_TOL and within SOFT_TOL, by case kind.  The
# OFDM batch mesh reports no iterations (zeros, as the reference does).
_FIELDS = {
    "mesh_rx": (("detected", "start", "cw_success", "info_bits", "iterations"),
                ("cfo_hz", "snr_db"), ()),
    "mesh_ofdm_rx": (("detected", "lts_start", "cw_success", "info_bits"),
                     ("cfo_hz", "snr_db"), ()),
    "stream_rx": (("detected", "start", "cw_success", "info_bits"), ("cfo_hz", "snr_db"),
                  ("soft_bits",)),
    "ofdm_stream_rx": (("detected", "lts_start", "cw_success", "info_bits"),
                       ("cfo_hz", "snr_db"), ()),
}


def hold_single(case: Case, got, want: dict) -> dict:
    """Hold the sharded result against the single-process one: decisions
    exact (info bits where the codeword decoded), CFO and SNR within
    ``RX_TOL``, soft bits within ``SOFT_TOL``, the FIR within ``FIR_TOL``.
    Returns the largest errors by field; raises on a difference."""
    if case.kind == "stream_search":
        got = dict(zip(("detected", "start", "cfo_hz"), got))
        exact, close, soft = ("detected", "start"), ("cfo_hz",), ()
    elif case.kind == "fir":
        err = float(np.abs(np.asarray(got) - want["y"]).max())
        if not err < FIR_TOL:
            raise AssertionError(f"{case.name}: FIR {err:.3g} from np.convolve")
        return {"y": err}
    elif case.kind == "hybrid":
        if not np.array_equal(np.asarray(got["sums"]), want["sums"]):
            raise AssertionError(f"{case.name}: row sums {got['sums']} != {want['sums']}")
        return hold_single(Case(case.name, "stream_rx", ()), got["stream"], want["stream"])
    else:
        got = got if isinstance(got, dict) else got._asdict()
        exact, close, soft = _FIELDS[case.kind]
    errs = {}
    for key in exact:
        a, b = np.asarray(got[key]), np.asarray(want[key])
        if key == "info_bits":
            ok = np.asarray(want["cw_success"]).astype(bool)
            a, b = a[ok], b[ok]
        if a.shape != b.shape or not np.array_equal(a, b):
            raise AssertionError(f"{case.name}: {key} differs from the single-process port")
    for key, tol in [(k, RX_TOL) for k in close] + [(k, SOFT_TOL) for k in soft]:
        errs[key] = float(np.max(np.abs(np.asarray(got[key], np.float64)
                                        - np.asarray(want[key], np.float64))))
        if not errs[key] <= tol:
            raise AssertionError(f"{case.name}: {key} {errs[key]:.3g} from the single-process "
                                 f"port (limit {tol:g})")
    return errs


def check_sent(case: Case, got, sent) -> None:
    """Hold a case's result to what was sent: every frame found where it was
    put, every codeword decoded to the bits sent, the row sums of G7."""
    if case.kind in ("mesh_rx", "mesh_ofdm_rx"):
        if not (np.asarray(got.detected).all() and np.asarray(got.cw_success).all()):
            raise AssertionError(f"{case.name}: {int(np.sum(got.detected))} detected, "
                                 f"{int(np.sum(got.cw_success))} codewords decoded")
        if not np.array_equal(got.info_bits, sent):
            raise AssertionError(f"{case.name}: info bits differ from those sent")
        return
    if case.kind == "stream_search":
        if not (bool(got[0]) and int(got[1]) == sent["positions"][0]):
            raise AssertionError(f"{case.name}: found {bool(got[0])} at {int(got[1])}, sent at "
                                 f"{sent['positions'][0]}")
        return
    if case.kind == "fir":
        return
    if case.kind == "hybrid":
        if np.asarray(got["sums"]).tolist() != sent["sums"]:
            raise AssertionError(f"{case.name}: row sums {got['sums']} != {sent['sums']}")
        got = got["stream"]
    key = "lts_start" if case.kind == "ofdm_stream_rx" else "start"
    shift = 5 * case.params[0].symbol_samples if case.kind == "ofdm_stream_rx" else 0
    starts = np.atleast_1d(got[key]) - shift
    if sorted(starts.tolist()) != sorted(sent["positions"]):
        raise AssertionError(f"{case.name}: frames at {starts.tolist()}, sent at "
                             f"{list(sent['positions'])}")
    if not np.asarray(got["cw_success"]).all():
        raise AssertionError(f"{case.name}: codewords decoded {got['cw_success']}")
    bits = np.asarray(got["info_bits"]).reshape((len(starts),) + sent["infos"][0].shape[:1]
                                                 + (-1,))
    for s, b in zip(starts, bits):
        info = sent["infos"][list(sent["positions"]).index(int(s))]
        if not np.array_equal(b[:, : info.shape[1]], info):
            raise AssertionError(f"{case.name}: the frame at {s} decoded to other bits")


def replicated(case: Case, result):
    """The part of a rank's result that every rank shares: all of it but
    the FIR's own block and G7's mesh coordinates."""
    if case.kind == "fir":
        return None
    if case.kind == "hybrid":
        return {"sums": result["sums"], "stream": result["stream"]}
    return result


def same_on_every_rank(name: str, results: list) -> None:
    """Raise unless every rank's result equals rank 0's: the outputs are
    replicated, as the reference's ``P()`` outputs are."""
    want = to_leaves(results[0])
    for r, res in enumerate(results[1:], 1):
        for (key, a), (_, b) in zip(to_leaves(res), want):
            if not np.array_equal(np.asarray(a), np.asarray(b)):
                raise AssertionError(f"{name}: rank {r}'s {key} differs from rank 0's")


def to_leaves(x, key: str = "") -> list:
    """[(path, array)] of a nested result of dicts, tuples and arrays."""
    if isinstance(x, dict):
        return [leaf for k, v in x.items() for leaf in to_leaves(v, f"{key}.{k}")]
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return [leaf for k, v in zip(x._fields, x) for leaf in to_leaves(v, f"{key}.{k}")]
    if isinstance(x, (list, tuple)):
        return [leaf for i, v in enumerate(x) for leaf in to_leaves(v, f"{key}[{i}]")]
    return [(key, x)]


# ------------------------------------------------------------ rank side
def _hybrid(ch: int, t: int, cfg, rate: str, ncw: int, block: int, x) -> dict:
    rows_local, stream_block = x
    mesh = make_hybrid_mesh(ch, t)
    local = put_stream_rows(mesh, rows_local)                  # [1, T / t]
    part = local.sum(dim=-1)
    (row,) = gather_fields([part], mesh, "t")
    (sums,) = gather_fields([row.sum(dim=0)], mesh, "ch")
    rx = make_stream_rx(mesh, cfg, rate, ncw, block)
    return {"coords": (mesh.coords["ch"], mesh.coords["t"]), "sums": sums.reshape(-1),
            "stream": rx(stream_block)}


def program(case: Case, device: str | torch.device | None = None):
    """The function of this rank's data that ``case`` runs (built once:
    meshes and modules), on ``device`` (default: the rank's)."""
    p = case.params
    if case.kind == "mesh_rx":
        return make_sharded_rx(make_mesh(device=device), *p)
    if case.kind == "mesh_ofdm_rx":
        return make_sharded_ofdm_rx(make_mesh(device=device), *p)
    if case.kind == "stream_rx":
        return make_stream_rx(make_stream_mesh(device=device), *p[:4], top_k=p[4])
    if case.kind == "stream_search":
        return make_stream_search(make_stream_mesh(device=device), *p)
    if case.kind == "ofdm_stream_rx":
        return make_ofdm_stream_rx(make_stream_mesh(device=device), *p)
    if case.kind == "fir":
        return make_sharded_fir(make_stream_mesh(device=device), np.asarray(p[0], np.float32),
                                p[1])
    if case.kind == "hybrid":
        return functools.partial(_hybrid, *p)
    raise ValueError(f"unknown case kind {case.kind!r}")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def median_ms(fn, x, reps: int, device: torch.device) -> float:
    """Median milliseconds of ``reps`` calls, each started together on every
    rank (a barrier first) and timed by CUDA events on the card, by the
    host clock on the CPU."""
    times = []
    for _ in range(reps):
        if dist.is_initialized():
            dist.barrier()
        if device.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn(x)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn(x)
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


_RATE_BY_K = {get_code(r).k: r for r in CODE_PARAMS}


def run_rank(cases, reps: int, data: dict) -> dict:
    """One rank's run of ``cases`` on its ``data`` (:func:`rank_data`).

    Per case: {"result": the first call's result, "k1_launches",
    "k2_launches" (counted around that call alone), "k1_calls": one
    {"B", "k", "iterations", "converged", "max_abs_err"} per K1
    launch held against the plain decoder, "k1_inputs": {(B, k): (rate,
    max_iters, LLRs, factors)} of one launch per batch size (rank 0), "ms":
    the median of ``reps`` timed calls (None for ``reps`` 0 and for G7,
    which builds its meshes inside)}."""
    out = {}
    for case in cases:
        fn = program(case)
        x = data[case.name]
        device = local_device()
        _sync(device)
        res, k1, k2, calls = F.counted_k1(lambda: fn(x))
        _sync(device)
        held = F.hold_k1_calls(calls, f"{case.name} rank {rank()}")
        inputs = {}
        if rank() == 0:
            for dec, llrs, factors, _ in calls:
                inputs.setdefault((llrs.shape[0], dec.k),
                                  (_RATE_BY_K[dec.k], dec.max_iters, llrs, factors))
        ms = median_ms(fn, x, reps, device) if reps and case.kind != "hybrid" else None
        out[case.name] = {"result": res, "k1_launches": k1, "k2_launches": k2,
                          "k1_calls": held, "k1_inputs": inputs, "ms": ms}
    return out


def mesh_selftest() -> dict:
    """A program for 4 ranks: the (2 x 2) hybrid mesh, each collective and
    ``put_stream_rows``, with what each gave."""
    hybrid = make_hybrid_mesh(2, 2)
    line = make_stream_mesh()
    r = line.rank
    v = torch.full((3,), float(r + 1))
    fields = gather_fields([torch.tensor(1.5 * r), torch.tensor(r, dtype=torch.int32),
                              torch.tensor(r > 1)], line, "t")
    rows = put_stream_rows(hybrid, np.full((1, 4096), hybrid.coords["ch"] + 1.0, np.float32))
    (row,) = gather_fields([rows.sum(dim=-1)], hybrid, "t")
    (sums,) = gather_fields([row.sum(dim=0)], hybrid, "ch")
    slab = torch.zeros(4, dtype=torch.complex64)
    slab[r] = complex(r + 0.25, -r)
    return {"coords": (hybrid.coords["ch"], hybrid.coords["t"]),
            "peers": (hybrid.peer("t", 0), hybrid.peer("t", 1), hybrid.peer("ch", 0)),
            "rows": rows, "sums": sums.reshape(-1),
            "right": from_right(v, line, "t"), "left": from_left(v, line, "t"),
            "t_line": all_gather(torch.tensor([r]), hybrid, "t").reshape(-1),
            "bools": all_gather(torch.tensor([r % 2 == 0]), line, "t").reshape(-1),
            "fields": fields, "psum": psum(slab, line, "t")}


def where() -> torch.device:
    """This rank's device."""
    return local_device()


def die_on(bad_rank: int) -> int:
    """A program whose rank ``bad_rank`` exits at once with code 3, with no
    result and no exception."""
    mesh = make_stream_mesh()
    if mesh.rank == bad_rank:
        os._exit(3)
    gather_fields([torch.zeros(1)], mesh, "t")
    return mesh.rank


def fail_on(bad_rank: int) -> int:
    """A program whose rank ``bad_rank`` raises before the collective the
    others wait in."""
    mesh = make_stream_mesh()
    if mesh.rank == bad_rank:
        raise ValueError(f"rank {bad_rank} fails on purpose")
    gather_fields([torch.zeros(1)], mesh, "t")
    return mesh.rank


def stall_on(slow_rank: int, seconds: float) -> int:
    """A program whose rank ``slow_rank`` sleeps before the collective the
    others wait in."""
    mesh = make_stream_mesh()
    if mesh.rank == slow_rank:
        time.sleep(seconds)
    gather_fields([torch.zeros(1)], mesh, "t")
    return mesh.rank


# ------------------------------------------------------- gloo and CUDA tensors
GLOO_OPS = ("all_gather", "all_reduce", "send_recv")


def gloo_cuda_op(op: str):
    """A program for 2 gloo ranks on the card: one ``op`` handed the rank's
    CUDA tensor itself, with no host copy.  Returns what it gave, on the
    host."""
    mesh = make_stream_mesh()
    r = mesh.rank
    x = torch.full((4,), float(r + 1), device=mesh.device)
    if op == "all_gather":
        parts = [torch.empty_like(x) for _ in range(2)]
        dist.all_gather(parts, x)
        return torch.stack(parts).cpu()
    if op == "all_reduce":
        dist.all_reduce(x)
        return x.cpu()
    got = torch.zeros_like(x)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, x, 1 - r),
                                   dist.P2POp(dist.irecv, got, 1 - r)])
    for req in reqs:
        req.wait()
    return got.cpu()


def probe_gloo_cuda(timeout_s: float = 30.0) -> dict:
    """Which collectives gloo takes CUDA tensors for: each op in a launch of
    its own (a rank that crashes or hangs fails only that op).  Returns
    {op: "takes CUDA tensors" or what went wrong}."""
    from ria_tpu_torch.parallel.launch import launch

    want = {"all_gather": [[1.0] * 4, [2.0] * 4], "all_reduce": [[3.0] * 4] * 2,
            "send_recv": [[2.0] * 4, [1.0] * 4]}
    out = {}
    for op in GLOO_OPS:
        try:
            got = launch(gloo_cuda_op, 2, args=(op,), device="cuda", backend="gloo",
                         timeout_s=timeout_s)
        except Exception as exc:  # noqa: BLE001 - the probe reports any failure
            out[op] = f"refused: {type(exc).__name__}: {str(exc).splitlines()[0][:200]}"
            continue
        if op == "all_gather":
            got = [g.tolist() for g in got[0]]
        else:
            got = [g.tolist() for g in got]
        out[op] = "takes CUDA tensors" if got == want[op] else f"wrong values: {got}"
    return out


if __name__ == "__main__":
    import json
    import sys

    if sys.argv[1:] != ["--probe-gloo"]:
        raise SystemExit("usage: python -m ria_tpu_torch.tools.parallel_paths --probe-gloo")
    print(json.dumps({"gloo_cuda": probe_gloo_cuda(),
                      "card": torch.cuda.get_device_name(0)}))
