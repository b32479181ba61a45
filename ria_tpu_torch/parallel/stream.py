"""Time-block sharding of long sample streams with halo exchange.

Port of ``ria_tpu/parallel/stream.py``.  A long window [T] is split into
contiguous time blocks, one per rank of a mesh's ``t`` axis (rank order =
time order), and each rank is given only its own block (:func:`put_stream`).
The three stream-crossing computations each exchange exactly the halo they
need (:mod:`._collectives`):

1. **Sync search**: each rank correlates its block extended by a right halo
   of one full preamble from its right neighbour (zeros on the last rank),
   so a preamble straddling a boundary is found by the rank that owns its
   first sample; the ranks' best peaks are combined by one small all-gather.
2. **Mix-integrate demod**: once the (replicated) frame start is known, each
   rank demodulates exactly the symbols whose first sample lies in its
   block, into a slab of the global symbol matrix that is zero elsewhere;
   one all-reduce assembles the matrix.  Only the owner writes a slot, so
   the sum is exact in any order.  The differential/LLR stage and the LDPC
   decode then run replicated on every rank.
3. **FIR filtering**: overlap-save; each rank prepends the (taps - 1)
   samples its left neighbour sends it (zeros on the first rank).

Every decode goes through :func:`ria_tpu_torch.fec.ldpc.ldpc_decoder` with
per-row factors: kernel K1 on the card, the plain decoder on the CPU.  (The
reference decodes the stream with XLA's ``make_decoder_vf``, the function
K1 computes.)  Results are replicated on every rank, as the reference's
``P()`` outputs are.  Each ``make_*`` returns a function of this rank's
block; every rank of the mesh calls it together.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ria_tpu_torch.fec.interleave import channel_perm, frame_perm
from ria_tpu_torch.fec.ldpc import ldpc_decoder
from ria_tpu_torch.fec.ldpc_matrix import RECOMMENDED_ITERS
from ria_tpu_torch.parallel._collectives import from_left, from_right, gather_fields, psum
from ria_tpu_torch.parallel.distributed import Mesh, put_stream, world_size
from ria_tpu_torch.sync.chirp import ChirpConfig, detect_dual_chirp
from ria_tpu_torch.utils.device import full_fp32_matmul
from ria_tpu_torch.wave.mc_dpsk import MCDPSKConfig, _synth_matrix, soft_from_zsym
from ria_tpu_torch.wave.ofdm import (OFDMConfig, carrier_layout, demodulate_from_bins,
                                     schmidl_cox_search)

LDPC_BITS = 648
# Min-sum factor ladder of the sharded OFDM decode (the retry ladder's
# phase-0 factor diversity; variant 0 is the fixed-frame base factor).
LADDER_FACTORS = (0.9375, 0.75, 0.625, 0.5)
# The MC-DPSK stream decodes each codeword at both factors in one batch.
MC_FACTORS = (0.75, 0.9375)


def make_stream_mesh(n_devices: int | None = None,
                     device: str | torch.device | None = None) -> Mesh:
    """1D time-block mesh over the ranks: rank order = time order, so the
    halo exchange goes to the nearest neighbours.  ``n_devices`` must be
    the world size (None: the world size)."""
    n = world_size() if n_devices is None else n_devices
    return Mesh(("t",), (n,), device)


def _floor_div(a: torch.Tensor, b: int) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def _block(mesh: Mesh, local, block_samples: int) -> torch.Tensor:
    x = put_stream(mesh, local)
    if x.shape[-1] != block_samples:
        raise ValueError(f"this rank's block has {x.shape[-1]} samples, "
                         f"block_samples is {block_samples}")
    return x


# --------------------------------------------------------------------- FIR
def make_sharded_fir(mesh: Mesh, taps, block_samples: int):
    """Overlap-save FIR over [ch, T] with T sharded on the ``t`` axis:
    ``fir(x_local [ch, block]) -> y_local [ch, block]``.

    Equal to the unsharded causal FIR y[i] = sum_k h[k] x[i-k] (zero
    history before sample 0): each rank gets the last (K-1) samples of its
    left neighbour, convolves the extended block and keeps its own span.
    One (K-1)-sample exchange per call is the only traffic.
    """
    K = int(len(taps))
    h = torch.as_tensor(np.asarray(taps, np.float32), device=mesh.device)

    def fir(x_local) -> torch.Tensor:
        x = _block(mesh, x_local, block_samples)
        left = from_left(x[..., block_samples - (K - 1):], mesh, "t")
        ext = torch.cat([left, x], dim=-1)
        nfft = 1 << (ext.shape[-1] + K - 2).bit_length()
        y = torch.fft.irfft(torch.fft.rfft(ext, nfft) * torch.fft.rfft(h, nfft), nfft)
        return y[..., K - 1 : K - 1 + block_samples].to(x.dtype)

    return fir


# ------------------------------------------------------------ stream search
def _candidates(mesh: Mesh, detected, start, corr, cfo, block_samples: int):
    """Every rank's in-block detection, gathered: (score [n], global start
    [n], cfo [n]); the score is -1 where a rank found nothing in its block."""
    i = mesh.index("t")
    ok = detected & (start >= 0) & (start < block_samples)
    score = torch.where(ok, corr, torch.full_like(corr, -1.0))
    return gather_fields([score, start + i * block_samples, cfo], mesh, "t")


def _gather_best(mesh: Mesh, detected, start, corr, cfo, block_samples: int):
    """Combine the ranks' detections: the first highest peak."""
    allc, alls, allf = _candidates(mesh, detected, start, corr, cfo, block_samples)
    best = torch.argmax(allc)
    return allc[best] > 0.0, alls[best], allf[best]


def _gather_topk(mesh: Mesh, detected, start, corr, cfo, block_samples: int, k: int):
    """The k best in-block detections, score-ordered (ties in rank order):
    a window holding up to one frame per block yields every frame; two
    frames inside ONE block take the stronger, like the reference's
    per-window sliding search."""
    allc, alls, allf = _candidates(mesh, detected, start, corr, cfo, block_samples)
    order = torch.argsort(-allc, stable=True)[:k]
    return allc[order] > 0.0, alls[order], allf[order]


def _extended(mesh: Mesh, x: torch.Tensor, halo: int) -> torch.Tensor:
    """The block followed by the first ``halo`` samples of the next one."""
    return torch.cat([x, from_right(x[:halo], mesh, "t")])


def make_stream_search(mesh: Mesh, chirp_cfg: ChirpConfig, block_samples: int,
                       halo: int | None = None):
    """Sharded dual-chirp search over a stream of n blocks:
    ``search(local [block]) -> (detected, start, cfo_hz)``, replicated.

    ``halo`` defaults to one full preamble + timing margin, so a
    boundary-straddling preamble is wholly visible to the rank owning its
    start.
    """
    if halo is None:
        halo = chirp_cfg.total_samples + 4800
    if halo > block_samples:
        raise ValueError(f"halo {halo} must fit in one block of {block_samples}")

    def search(local):
        ext = _extended(mesh, _block(mesh, local, block_samples), halo)
        res = detect_dual_chirp(ext, chirp_cfg)
        corr = torch.maximum(res.up_corr, res.down_corr)
        return _gather_best(mesh, res.detected, res.start, corr, res.cfo_hz, block_samples)

    return search


# ---------------------------------------------------------------- stream RX
@functools.lru_cache(maxsize=None)
def _stream_geometry(cfg: MCDPSKConfig, num_codewords: int, block_samples: int):
    num_bits = num_codewords * LDPC_BITS
    D = cfg.num_data_symbols(num_bits)
    S_all = cfg.training_symbols + 1 + D * cfg.spreading
    frame_need = cfg.chirp.total_samples + S_all * cfg.samples_per_symbol
    sym_cap = block_samples // cfg.samples_per_symbol + 2
    return num_bits, D, S_all, frame_need, sym_cap


def _owned_slots(origin: torch.Tensor, lo: int, block_samples: int, step: int, count: int,
                 cap: int, ext_len: int):
    """This rank's symbols of a frame whose symbol k starts at global sample
    ``origin + k * step`` (k < ``count``): the ones whose first sample lies
    in [lo, lo + block).  Returns (k_slots [cap], the local offsets of
    their samples [cap], valid [cap]).  Offsets are clamped into the
    extended block as ``jax.lax.dynamic_slice`` clamps a start."""
    first = torch.clamp(-_floor_div(origin - lo, step), 0, count)
    nxt = torch.clamp(-_floor_div(origin - lo - block_samples, step), 0, count)
    k_slots = first + torch.arange(cap, dtype=torch.int32, device=origin.device)
    offs = torch.clamp(origin + k_slots * step - lo, 0, ext_len - step)
    return k_slots, offs, k_slots < nxt


def _rows(ext: torch.Tensor, offs: torch.Tensor, length: int) -> torch.Tensor:
    """[cap, length]: ``ext[o : o + length]`` for each offset."""
    return ext[offs[:, None].long() + torch.arange(length, device=ext.device)]


def _slab(z: torch.Tensor, k_slots: torch.Tensor, count: int) -> torch.Tensor:
    """[count, bins]: ``z``'s rows at slots ``k_slots``, zeros elsewhere
    (``dynamic_update_slice`` of a zero buffer in the reference)."""
    buf = torch.zeros((count + z.shape[0], z.shape[1]), dtype=z.dtype, device=z.device)
    return buf.index_copy(0, k_slots.long(), z)[:count]


def _ramp(w: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """exp(-j w t) in float32, as the reference's ``exp(-1j * w * t)``."""
    return torch.polar(torch.ones((), device=t.device), -(w * t))


def _first_passing(ok: torch.Tensor, info: torch.Tensor):
    """(any row passes [m], the info bits of the first passing row [m, k])
    of per-variant outcomes ok [v, m] and info [v, m, k]."""
    pref = ok.to(torch.uint8).argmax(dim=0)
    pick = pref[None, :, None].expand(1, info.shape[1], info.shape[2])
    return ok.any(dim=0), torch.gather(info, 0, pick)[0]


def make_stream_rx(mesh: Mesh, cfg: MCDPSKConfig, rate: str, num_codewords: int,
                   block_samples: int, top_k: int = 1):
    """Full sharded MC-DPSK stream RX: ``rx(local [block]) -> dict`` of
    replicated results (detected, start, cfo_hz, cw_success, info_bits,
    soft_bits, snr_db).

    Halo'd chirp search, sequence-parallel mix-integrate, one all-reduce of
    the symbol matrix, then the differential/LLR stage and the decode on
    every rank: each codeword at both factors of :data:`MC_FACTORS` in one
    K1 launch, the first that passes parity kept.  The frame may straddle
    any number of block boundaries.  ``top_k`` > 1 decodes up to that many
    frames per window (one candidate per block, see :func:`_gather_topk`);
    results then carry a leading [top_k] axis, score-ordered.
    """
    n = mesh.size("t")
    sps = cfg.samples_per_symbol
    num_bits, D, S_all, frame_need, sym_cap = _stream_geometry(cfg, num_codewords,
                                                               block_samples)
    total = n * block_samples
    halo = max(cfg.chirp.total_samples + 4800, sps)
    if halo > block_samples:
        raise ValueError(f"block_samples {block_samples} must cover one preamble halo {halo}")
    if frame_need > total:
        raise ValueError(f"a stream of {total} samples is shorter than one frame")
    if not 1 <= top_k <= n:
        raise ValueError(f"top_k {top_k}: one candidate a block, {n} blocks")
    full_fp32_matmul()
    dev = mesh.device
    decoder = ldpc_decoder(rate, RECOMMENDED_ITERS[rate], dev)
    mixer = torch.as_tensor(np.conj(_synth_matrix(cfg)) / sps, device=dev)
    rows_n = top_k * num_codewords
    factors = torch.tensor(MC_FACTORS, dtype=torch.float32,
                           device=dev).repeat_interleave(rows_n)
    t_in = torch.arange(sps, dtype=torch.float32, device=dev)
    lo = mesh.index("t") * block_samples

    def assemble(ext: torch.Tensor, g_start: torch.Tensor, cfo: torch.Tensor) -> torch.Tensor:
        data_start = g_start + cfg.chirp.total_samples
        k_slots, offs, valid = _owned_slots(data_start, lo, block_samples, sps, S_all,
                                            sym_cap, ext.shape[0])
        # CFO rotation with its phase origin at the frame start (k*sps + i),
        # as wave.mc_dpsk's demodulator factors its ramp.
        w = (2.0 * np.pi / cfg.sample_rate) * cfo
        z = (_rows(ext, offs, sps).to(torch.complex64) * _ramp(w, t_in)) @ mixer
        z = z * _ramp(w, k_slots.float() * sps)[:, None]
        z = torch.where(valid[:, None], z, torch.zeros((), dtype=z.dtype, device=dev))
        return _slab(z, k_slots, S_all)

    def rx(local) -> dict:
        ext = _extended(mesh, _block(mesh, local, block_samples), halo)
        res = detect_dual_chirp(ext, cfg.chirp)
        corr = torch.maximum(res.up_corr, res.down_corr)
        dets, starts, cfos = _gather_topk(mesh, res.detected, res.start, corr, res.cfo_hz,
                                          block_samples, top_k)
        starts = torch.clamp(torch.where(dets, starts, torch.zeros_like(starts)), 0,
                             total - frame_need)
        zsyms = psum(torch.stack([assemble(ext, s, f) for s, f in zip(starts, cfos)]),
                     mesh, "t")                                   # [top_k, S_all, C]
        demod = soft_from_zsym(zsyms, cfg, D)
        soft = demod.soft_bits[..., :num_bits].reshape(rows_n, LDPC_BITS)
        dec = decoder(torch.cat([soft] * len(MC_FACTORS)).contiguous(), factors)
        ok, info = _first_passing(dec.success.reshape(len(MC_FACTORS), rows_n),
                                  dec.info_bits.reshape(len(MC_FACTORS), rows_n, -1))
        out = {
            "detected": dets,
            "start": starts,
            "cfo_hz": cfos,
            "cw_success": ok.reshape(top_k, num_codewords) & dets[:, None],
            "info_bits": info.reshape(top_k, num_codewords, -1),
            "soft_bits": soft.reshape(top_k, num_codewords, LDPC_BITS),
            "snr_db": demod.snr_estimate_db,
        }
        if top_k == 1:
            out = {k: v[0] for k, v in out.items()}
        return out

    return rx


def make_ofdm_stream_rx(mesh: Mesh, ofdm_cfg: OFDMConfig, rate: str, block_samples: int,
                        ci_bits: int | None = None):
    """Sequence-parallel OFDM RX over a stream of n blocks:
    ``rx(local [block]) -> dict`` of replicated results (detected,
    lts_start, cfo_hz, cw_success, info_bits, snr_db).

    1. Each rank runs the Schmidl-Cox + LTS search on its block plus a
       right halo of one preamble and the LTS refinement span; the rank
       whose block holds the PREAMBLE START claims the frame.
    2. Each rank CP-strips and FFTs the symbols whose first sample lies in
       its block, with the continuous global-time downmix, into a slab of
       the [T+S, bins] matrix; one all-reduce assembles it.
    3. Equalize, demap and deinterleave run on every rank
       (``demodulate_from_bins``); the decode is split: rank i decodes
       codeword i % 4 at ladder variant i // 4 (one K1 launch of one row),
       one all-gather combines, and the lowest passing variant wins.

    Needs at least 4 ranks (one per codeword); 8 run the second variant.
    """
    n = mesh.size("t")
    if n < 4:
        raise ValueError(f"the OFDM stream RX decodes one codeword per rank: it needs at "
                         f"least 4 ranks on 't', the mesh has {n}")
    sym = ofdm_cfg.symbol_samples
    T = 2
    num_bits = 4 * LDPC_BITS
    S = ofdm_cfg.num_symbols_for_bits(num_bits)
    total = n * block_samples
    frame_need = (T + S) * sym
    # Search halo: the SC metric window + LTS refinement span around a
    # preamble starting at the block's last sample.
    halo = ofdm_cfg.preamble_samples + 5 * sym + 2048
    if halo > block_samples:
        raise ValueError(f"block_samples {block_samples} must cover the search halo {halo}")
    if frame_need + ofdm_cfg.preamble_samples > total:
        raise ValueError(f"a stream of {total} samples is shorter than one frame")
    sym_cap = block_samples // sym + 2
    _, data_bins, pilot_bins = carrier_layout(ofdm_cfg)
    nD = len(data_bins)
    dev = mesh.device
    bins = torch.as_tensor(np.concatenate([data_bins, pilot_bins]).astype(np.int64), device=dev)
    frame_idx = torch.as_tensor(frame_perm(), device=dev)
    ci_idx = torch.as_tensor(channel_perm(ci_bits), device=dev) if ci_bits else None
    decoder = ldpc_decoder(rate, None, dev)
    i = mesh.index("t")
    cw_i = i % 4
    factor = torch.tensor([LADDER_FACTORS[min(i // 4, len(LADDER_FACTORS) - 1)]],
                          dtype=torch.float32, device=dev)
    n_var = max(1, min(n // 4, len(LADDER_FACTORS)))
    t_in = torch.arange(sym, dtype=torch.float32, device=dev)
    lo = i * block_samples
    cp, fft = ofdm_cfg.cp_len, ofdm_cfg.fft_size

    def rx(local) -> dict:
        ext = _extended(mesh, _block(mesh, local, block_samples), halo)
        res = schmidl_cox_search(ext, ofdm_cfg)
        # The LTS sits 5 symbols in (guard + 4 STS) and may fall in the halo.
        detected, pre_start, cfo = _gather_best(mesh, res.detected, res.lts_start - 5 * sym,
                                                res.lts_corr, res.cfo_hz, block_samples)
        lts_start = pre_start + 5 * sym
        lts_start = torch.clamp(torch.where(detected, lts_start, torch.zeros_like(lts_start)),
                                0, total - frame_need)
        k_slots, offs, valid = _owned_slots(lts_start, lo, block_samples, sym, T + S,
                                            sym_cap, ext.shape[0])
        # Continuous downmix with its time origin at lts_start, as
        # demodulate_presynced's ramp: t = k*sym + j.
        w = (2.0 * np.pi / ofdm_cfg.sample_rate) * (ofdm_cfg.center_freq + cfo)
        bb = (_rows(ext, offs, sym).to(torch.complex64) * _ramp(w, t_in)
              * _ramp(w, k_slots.float() * sym)[:, None])
        z = torch.fft.fft(bb[:, cp : cp + fft], dim=-1)[:, bins]
        z = torch.where(valid[:, None], z, torch.zeros((), dtype=z.dtype, device=dev))
        Y = psum(_slab(z, k_slots, T + S), mesh, "t")
        demod = demodulate_from_bins(Y[:, :nD], Y[:, nD:] if len(pilot_bins) else None,
                                     ofdm_cfg, S, T)
        cw_soft = demod.soft_bits[:num_bits][frame_idx].reshape(4, LDPC_BITS)
        if ci_idx is not None:
            cw_soft = cw_soft[:, ci_idx]
        dec = decoder(cw_soft[cw_i : cw_i + 1].contiguous(), factor)
        ok_all, info_all = gather_fields([dec.success[0], dec.info_bits[0]], mesh, "t")
        # Rank = variant * 4 + codeword for variant < n_var; later ranks
        # repeat the last variant.  The lowest passing variant wins.
        ok, info = _first_passing(ok_all[: 4 * n_var].reshape(n_var, 4),
                                  info_all[: 4 * n_var].reshape(n_var, 4, -1))
        return {
            "detected": detected,
            "lts_start": lts_start,
            "cfo_hz": cfo,
            "cw_success": ok & detected,
            "info_bits": info,
            "snr_db": demod.snr_db,
        }

    return rx
