"""The port's main path in one call: the MC-DPSK RX chain over a batch.

Twin of ``__graft_entry__.entry()``, ``_make_batch`` and
``dryrun_multichip``.  ``entry()`` returns ``(rx, (audio,))``: the batched
RX pipeline and a batch of noisy frames for it.
The default is the small ``_tiny_cfg`` geometry of the CPU tests;
``production=True`` gives the geometry bench.py times as chain 1: 64 channels
of 10-carrier DBPSK, R1/4, 4 codewords per frame, a window of
``frame_samples(2592) + 12000`` = 207,328 samples, leads in [0, 8000) and
10 dB AWGN.

``ofdm_geometry`` and ``_make_ofdm_batch`` are the twins of bench.py's
``_ofdm_case`` and ``_coherent_case``, its chains 2 and 3: the north-star
configurations #3 (OFDM DQPSK R1/2 at 15 dB) and #4 (OFDM-COX QAM64 R3/4 at
25 dB), fixed 4-codeword frames built by the port's own TX.

``bench_batches`` draws every batch bench.py times, from one generator in
the order of bench.py's ``main()``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ria_tpu_torch.fec.ldpc import make_encoder
from ria_tpu_torch.fec.interleave import FRAME_CODEWORDS
from ria_tpu_torch.fec.ldpc_matrix import encode_np, get_code
from ria_tpu_torch.phy.frame_v2 import encode_fixed_frame
from ria_tpu_torch.phy.pipeline import LDPC_BITS, make_rx_pipeline, make_tx_pipeline
from ria_tpu_torch.sync.chirp import ChirpConfig
from ria_tpu_torch.utils.bits import bytes_to_bits
from ria_tpu_torch.utils.device import resolve_device
from ria_tpu_torch.wave.mc_dpsk import MCDPSKConfig
from ria_tpu_torch.wave.ofdm import OFDMConfig, tx_frame

RATE = "R1_4"


def _tiny_cfg() -> MCDPSKConfig:
    """Small-geometry config so CPU runs are fast."""
    chirp = ChirpConfig(duration_ms=10.0, gap_ms=2.0)
    return MCDPSKConfig(num_carriers=4, samples_per_symbol=128,
                        bits_per_symbol=2, training_symbols=4, chirp=chirp)


def geometry(production: bool = False) -> tuple[MCDPSKConfig, int, int, int]:
    """(cfg, num_codewords, batch, window) of the tiny or production batch."""
    if production:
        cfg = MCDPSKConfig(num_carriers=10, bits_per_symbol=1)
        ncw, batch = 4, 64
        return cfg, ncw, batch, cfg.frame_samples(ncw * LDPC_BITS) + 12000
    cfg = _tiny_cfg()
    return cfg, 1, 4, cfg.frame_samples(LDPC_BITS) + 2048


def _make_batch(cfg: MCDPSKConfig, num_codewords: int, batch: int, window: int,
                seed: int = 0, production: bool = False,
                device: str | torch.device = "cuda",
                rng: np.random.Generator | None = None) -> tuple[torch.Tensor, np.ndarray]:
    """TX a batch of frames (encoded random R1/4 codewords) into audio windows.

    Returns (audio [batch, window] f32 on ``device``, info bits
    [batch, num_codewords, k] uint8).  All randomness comes from ``rng``
    (default ``np.random.default_rng(seed)``), drawn in the order of the
    reference's batch functions: info bits, then (production) one lead per
    channel, then the noise.  Tiny batches sit at lead 256 under N(0, 0.02)
    noise; production batches at leads in [0, 8000) under 10 dB AWGN.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed) if rng is None else rng
    k = get_code(RATE).k
    info = rng.integers(0, 2, size=(batch * num_codewords, k)).astype(np.uint8)
    coded = make_encoder(RATE, dev)(torch.as_tensor(info, device=dev))
    tx = make_tx_pipeline(cfg, num_codewords, dev)(
        coded.reshape(batch, num_codewords * LDPC_BITS))
    audio = torch.zeros((batch, window), dtype=torch.float32, device=dev)
    for b in range(batch):
        lead = int(rng.integers(0, 8000)) if production else 256
        n = min(tx.shape[1], window - lead)
        audio[b, lead : lead + n] = tx[b, :n]
    if production:
        sigma = float(torch.sqrt(torch.mean(tx * tx))) * 10 ** (-10 / 20)
    else:
        sigma = 0.02
    audio += torch.as_tensor(rng.normal(0, sigma, audio.shape).astype(np.float32), device=dev)
    return audio, info.reshape(batch, num_codewords, k)


def entry(production: bool = False, device: str | torch.device = "cuda"):
    """(rx, (audio,)): the RX chain and a batch for it, on ``device`` (the
    card by default; ``device="cpu"`` for the host)."""
    cfg, ncw, batch, window = geometry(production)
    rx = make_rx_pipeline(cfg, RATE, ncw, window, device=device)
    audio, _ = _make_batch(cfg, ncw, batch, window, production=production, device=device)
    return rx, (audio,)


@dataclass(frozen=True)
class OFDMGeometry:
    """One of bench.py's OFDM chains: the waveform, code rate, channel
    interleave width, batch, window, lead range and SNR."""

    cfg: OFDMConfig
    rate: str
    ci_bits: int
    batch: int
    window: int
    max_lead: int
    snr_db: float


def ofdm_geometry(config: int) -> OFDMGeometry:
    """bench.py chain 2 (``config=3``, ``_ofdm_case``) or chain 3
    (``config=4``, ``_coherent_case``).

    #3: DQPSK without pilots, R1/2; ci = 59 carriers x 2 = 118 bits, 22 data
    symbols, window 7,840 + 24 x 1,120 + 8,000 = 42,720 samples, leads in
    [0, 4000), 15 dB.  #4: QAM64 with pilots every 8th carrier (51 data + 8
    pilots; the config ``create_waveform(OFDM_COX, "QAM64", "R3_4")`` builds),
    R3/4; ci = 306 bits, 9 data symbols, window 7,840 + 11 x 1,120 + 6,000 =
    26,160 samples, leads in [0, 3000), 25 dB.  Both at B = 64.
    """
    if config == 3:
        cfg, rate, slack, max_lead, snr = (OFDMConfig(modulation="DQPSK", use_pilots=False),
                                           "R1_2", 8000, 4000, 15.0)
    elif config == 4:
        cfg, rate, slack, max_lead, snr = (OFDMConfig(modulation="QAM64", use_pilots=True,
                                                      pilot_spacing=8),
                                           "R3_4", 6000, 3000, 25.0)
    else:
        raise ValueError(f"no OFDM chain for config {config}; 3 or 4")
    S = cfg.num_symbols_for_bits(FRAME_CODEWORDS * LDPC_BITS)
    window = cfg.preamble_samples + (2 + S) * cfg.symbol_samples + slack
    return OFDMGeometry(cfg, rate, cfg.bits_per_ofdm_symbol(), 64, window, max_lead, snr)


def _make_ofdm_batch(geom: OFDMGeometry, batch: int | None = None, seed: int = 0,
                     device: str | torch.device = "cuda",
                     rng: np.random.Generator | None = None) -> tuple[torch.Tensor, np.ndarray]:
    """TX a batch of fixed 4-codeword OFDM frames into audio windows.

    Returns (audio [batch, window] f32 on ``device``, the sent info bits
    [batch, 4, k] uint8).  All randomness comes from ``rng`` (default
    ``np.random.default_rng(seed)``) in bench.py's order: per channel the
    payload bytes, then its lead; then the noise over the whole batch, whose
    sigma follows the LAST channel's TX rms, as bench.py's does.  The TX is
    host numpy; ``batch`` defaults to the geometry's.
    """
    dev = resolve_device(device)
    batch = geom.batch if batch is None else batch
    rng = np.random.default_rng(seed) if rng is None else rng
    k = get_code(geom.rate).k
    bpc = k // 8
    audio = np.zeros((batch, geom.window), np.float32)
    info = np.zeros((batch, FRAME_CODEWORDS, k), np.uint8)
    rms = 0.0
    for b in range(batch):
        payload = rng.integers(0, 256, FRAME_CODEWORDS * bpc).astype(np.uint8)
        tx = tx_frame(encode_fixed_frame(payload.tobytes(), geom.rate, geom.ci_bits),
                      geom.cfg, preamble="cox")
        lead = int(rng.integers(0, geom.max_lead))
        audio[b, lead : lead + len(tx)] = tx
        rms = float(np.sqrt(np.mean(tx**2)))
        info[b, :, : 8 * bpc] = bytes_to_bits(payload).reshape(FRAME_CODEWORDS, 8 * bpc)
    audio += rng.normal(0, rms * 10 ** (-geom.snr_db / 20), audio.shape).astype(np.float32)
    return torch.as_tensor(audio, device=dev), info


# bench.py's noisy copies of each batch: six of each chain's audio under
# N(0, 1e-4) (bench.py:77, 110, 147) and four of the LDPC batch's LLRs under
# N(0, 0.05) (bench.py:183-185).
BENCH_VARIANTS = 6
BENCH_VARIANT_SIGMA = 1e-4
LDPC_BENCH_BATCH = 512
LDPC_BENCH_VARIANTS = 4
LDPC_BENCH_VARIANT_SIGMA = 0.05


class BenchChain(NamedTuple):
    """One of bench.py's batches: its noisy copies (the tensors bench.py
    times, on the device), the info bits sent and the batch the copies were
    made from (bench.py's serving decode takes the LDPC batch's first rows
    from it, ``bench.py:251``)."""

    variants: list[torch.Tensor]
    info: np.ndarray
    clean: torch.Tensor


class BenchBatches(NamedTuple):
    mc_dpsk: BenchChain          # chain 1: audio [64, 207328], info [64, 4, 162]
    ofdm_dqpsk_r12: BenchChain   # chain 2: audio [64, 42720], info [64, 4, 324]
    ofdm_qam64_r34: BenchChain   # chain 3: audio [64, 26160], info [64, 4, 486]
    ldpc: BenchChain             # R1/4 LLRs [512, 648], info [512, 162]


def _noisy_copies(x: torch.Tensor, rng: np.random.Generator, count: int,
                  sigma: float) -> list[torch.Tensor]:
    return [x + torch.as_tensor(rng.normal(0, sigma, tuple(x.shape)).astype(np.float32),
                                device=x.device) for _ in range(count)]


def bench_batches(device: str | torch.device = "cuda") -> BenchBatches:
    """bench.py's batches, drawn as its ``main()`` draws them: ONE
    ``np.random.default_rng(0)`` runs through chain 1 (``_mc_dpsk_case``:
    info bits, 64 leads, noise) and its six variants, chain 2
    (``_ofdm_case``) and its six, chain 3 (``_coherent_case``) and its six,
    then the LDPC batch of ``_ldpc_metrics`` (info bits, noise at sigma 1.0
    with the second half of the rows at 2.6, four variants).  The port's TX
    builds every frame."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    cfg, ncw, batch, window = geometry(production=True)
    audio, info = _make_batch(cfg, ncw, batch, window, production=True, device=dev, rng=rng)
    chains = [BenchChain(_noisy_copies(audio, rng, BENCH_VARIANTS, BENCH_VARIANT_SIGMA), info,
                         audio)]
    for config in (3, 4):
        audio, info = _make_ofdm_batch(ofdm_geometry(config), device=dev, rng=rng)
        chains.append(BenchChain(_noisy_copies(audio, rng, BENCH_VARIANTS, BENCH_VARIANT_SIGMA),
                                 info, audio))
    B = LDPC_BENCH_BATCH
    info = rng.integers(0, 2, (B, get_code(RATE).k)).astype(np.uint8)
    llr = (1.0 - 2.0 * encode_np(info, RATE).astype(np.float32)) * 4.0
    noise = rng.normal(0, 1.0, llr.shape).astype(np.float32)
    noise[B // 2 :] = rng.normal(0, 2.6, (B // 2, LDPC_BITS)).astype(np.float32)
    llr = torch.as_tensor(llr + noise, device=dev)
    chains.append(BenchChain(_noisy_copies(llr, rng, LDPC_BENCH_VARIANTS,
                                           LDPC_BENCH_VARIANT_SIGMA), info, llr))
    return BenchBatches(*chains)


def dryrun_multichip(n_devices: int, device: str | torch.device = "cuda") -> dict:
    """Twin of ``__graft_entry__.dryrun_multichip``: run both sharded RX
    programs, for MC-DPSK and for OFDM, on ``n_devices`` ranks (one process
    each, :func:`ria_tpu_torch.parallel.launch.launch`):

    1. the (ch x cw) batch mesh: channels data-parallel, each rank decoding
       its own rows through K1 (``parallel/mesh.py``);
    2. the 1D time-block stream mesh: one long stream sharded over the
       ranks, with the halo exchange for the sync search and the
       sequence-parallel mix-integrate (``parallel/stream.py``).

    The same small geometry and seeds as the reference; the OFDM stream RX
    needs ``n_devices`` >= 4.  Prints the backend, then the reference's
    four lines.  Returns rank 0's results by program (G1 batch mesh, G3
    stream, G2 OFDM batch mesh, G5 OFDM stream, as in
    ``tools/parallel_paths.py``)."""
    from ria_tpu_torch.parallel import distributed
    from ria_tpu_torch.parallel.launch import launch
    from ria_tpu_torch.tools import parallel_paths as P

    dev = resolve_device(device)
    backend = distributed.choose_backend(dev, n_devices)
    cases, data, sent = P.dryrun_cases(n_devices)
    ranks = [str(distributed.rank_device(dev, r)) for r in range(n_devices)]
    print(f"dryrun_multichip({n_devices}): {n_devices} ranks, backend {backend}, "
          f"devices {ranks}")
    outs = launch(P.run_rank, n_devices, args=(cases, 0), device=dev, backend=backend,
                  rank_args=[(d,) for d in P.rank_data(cases, data, n_devices)])
    res = {name: r["result"] for name, r in outs[0].items()}
    mc, st, of, ost = res["G1"], res["G3"], res["G2"], res["G5"]
    print(f"dryrun_multichip({n_devices}): batch mesh detected "
          f"{mc.detected.sum()}/{len(mc.detected)}, cw decode {mc.cw_success.mean():.2f}")
    print(f"dryrun_multichip({n_devices}): stream mesh detected "
          f"{bool(st['detected'])} at {int(st['start'])} (true {sent['G3']['positions'][0]}), "
          f"cw decode {st['cw_success'].mean():.2f}")
    print(f"dryrun_multichip({n_devices}): OFDM batch mesh detected "
          f"{of.detected.sum()}/{len(of.detected)}, cw decode {of.cw_success.mean():.2f}")
    true_lts = sent["G5"]["positions"][0] + 5 * P.TINY_OFDM.symbol_samples
    print(f"dryrun_multichip({n_devices}): OFDM stream mesh detected "
          f"{bool(ost['detected'])} at {int(ost['lts_start'])} (true {true_lts}), "
          f"cw decode {ost['cw_success'].mean():.2f}")
    return res
