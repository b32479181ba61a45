"""Rank-mesh scale-out of the batched modem pipelines.

Port of ``ria_tpu/parallel/mesh.py``.  Independent channels (audio windows)
are data-parallel over the ranks of a (ch x cw) mesh: each rank is given its
own rows of the batch, runs the whole chain on them (sync, frame slice,
demodulation, and the LDPC decode through K1 on the card, by
``make_tile_decoder``) and one all-gather hands every rank the global
result, in rank order.  The reference's tile padding has no counterpart: K1
exits per codeword and needs none.
"""

from __future__ import annotations

import torch

from ria_tpu_torch.fec.interleave import FRAME_CODEWORDS
from ria_tpu_torch.fec.ldpc import make_tile_decoder
from ria_tpu_torch.fec.ldpc_matrix import RECOMMENDED_ITERS
from ria_tpu_torch.parallel._collectives import gather_fields
from ria_tpu_torch.parallel.distributed import Mesh, _to_device, world_size
from ria_tpu_torch.phy.pipeline import (OFDMRxBatchResult, RxBatchResult,
                                        make_ofdm_rx_pipeline, make_rx_pipeline)
from ria_tpu_torch.wave.mc_dpsk import MCDPSKConfig
from ria_tpu_torch.wave.ofdm import OFDMConfig


def make_mesh(n_devices: int | None = None, device: str | torch.device | None = None) -> Mesh:
    """2D (ch x cw) mesh over the ranks; cw = 2 when the count is even.
    ``n_devices`` must be the world size (None: the world size)."""
    n = world_size() if n_devices is None else n_devices
    cw = 2 if n % 2 == 0 and n >= 2 else 1
    return Mesh(("ch", "cw"), (n // cw, cw), device)


def _rows(mesh: Mesh, audio_local, window_samples: int) -> torch.Tensor:
    x = _to_device(audio_local, mesh.device)
    if x.ndim != 2 or x.shape[1] != window_samples:
        raise ValueError(f"this rank's rows are [b, {window_samples}], got {tuple(x.shape)}")
    return x


def _gathered(mesh: Mesh, local):
    """The NamedTuple of every rank's ``local`` result, concatenated along
    the batch in rank order, on every rank (one collective)."""
    fields = gather_fields(list(local), mesh)
    return type(local)(*(f.reshape((-1,) + tuple(f.shape[2:])) for f in fields))


def make_sharded_rx(mesh: Mesh, cfg: MCDPSKConfig, rate: str, num_codewords: int,
                    window_samples: int):
    """Multi-rank MC-DPSK RX: ``rx(audio_local [b, window]) ->
    RxBatchResult`` of the global batch [n * b], on every rank.  Each rank
    passes its own b rows (every rank the same b) and runs sync + demod +
    LDPC on them."""
    pipe = make_rx_pipeline(cfg, rate, num_codewords, window_samples, device=mesh.device)
    decode, _ = make_tile_decoder(rate, RECOMMENDED_ITERS[rate], device=mesh.device)

    def rx(audio_local) -> RxBatchResult:
        audio = _rows(mesh, audio_local, window_samples)
        b = audio.shape[0]
        sync, demod, soft = pipe.soft_bits(audio)
        dec = decode(soft)
        return _gathered(mesh, RxBatchResult(
            detected=sync.detected, start=sync.start, cfo_hz=sync.cfo_hz,
            cw_success=dec.success.reshape(b, num_codewords) & sync.detected[:, None],
            info_bits=dec.info_bits.reshape(b, num_codewords, -1),
            iterations=dec.iterations.reshape(b, num_codewords),
            snr_db=demod.snr_estimate_db))

    return rx


def make_sharded_ofdm_rx(mesh: Mesh, ofdm_cfg: OFDMConfig, rate: str, window_samples: int,
                         ci_bits: int | None = None):
    """Multi-rank OFDM RX: ``rx(audio_local [b, window]) ->
    OFDMRxBatchResult`` of the global batch, on every rank.  Each rank runs
    the whole chain (Schmidl-Cox + LTS search, CP/FFT + equalize + demap,
    deinterleave) on its rows and decodes its codewords through K1 at the
    fixed-frame factor 0.9375.  ``iterations`` is zeros, as in the
    reference."""
    pipe = make_ofdm_rx_pipeline(ofdm_cfg, rate, window_samples, ci_bits, device=mesh.device)
    decode, _ = make_tile_decoder(rate, min_sum_factor=0.9375, device=mesh.device)

    def rx(audio_local) -> OFDMRxBatchResult:
        audio = _rows(mesh, audio_local, window_samples)
        b = audio.shape[0]
        sync, demod, soft = pipe.soft_bits(audio)
        dec = decode(soft)
        ok = dec.success.reshape(b, FRAME_CODEWORDS) & sync.detected[:, None]
        return _gathered(mesh, OFDMRxBatchResult(
            detected=sync.detected, lts_start=sync.lts_start, cfo_hz=sync.cfo_hz,
            cw_success=ok, info_bits=dec.info_bits.reshape(b, FRAME_CODEWORDS, -1),
            iterations=torch.zeros_like(ok, dtype=torch.int32), snr_db=demod.snr_db))

    return rx
