"""Batched sync -> demod -> K1 paths of the single-frame waveforms.

Test and bench harness, like ``entry.ofdm_geometry``: the card paths that
``chip_smoke.py`` drives for the slice's sync methods and waveform cores,
and that ``tests/test_torch_waveform_paths.py`` holds against the same
composition of ``ria_tpu`` functions.  Each decoding path follows the first
pass of its waveform class's ``rx_frame`` in ``ria_tpu/wave/api.py``: sync
on the class's search window, demodulation of the header codeword from the
sync's start (the chunk zero-padded to the class's fixed length), then the
decode through ``decode_batch`` with ``MIN_SUM_FACTOR`` and
``RECOMMENDED_ITERS["R1_4"]``, which is what ``frame_v2.decode_codewords``
does, here on the device tensors (one K1 launch a call on the card).

- ``otfs_eq``: OTFS QPSK with TF equalization and phase tracking
  (``api.py:893-896``); a ZC DATA preamble and one OTFS frame carrying one
  R1/4 codeword; window 48,000; 18 dB.
- ``otfs_raw``: OTFS raw-DD differential (``raw_dd=True``); as above.
- ``dpsk``: DQPSK at 512 samples a symbol (``api.py:1116-1124``);
  Barker-13x3, the reference symbol and 324 data symbols (186,368
  samples); window 194,368; 6 dB.
- ``mfsk``: 8 tones, repetition 2 (``api.py:1012-1017``); the sweep and
  216 symbols x 2 (688,128 samples); window 696,128; -2 dB.
- ``css_zc_sync``: ZC (all four roots) and CSS (all four shifts), the
  preambles only, frame types drawn uniformly; windows 48,000 and 96,000;
  0 dB; no decode.

Every batch comes from ``np.random.default_rng(seed)``: per channel its
info bits (or frame types) and lead in [0, 8000), then the noise
N(0, rms 10^(-snr/20)) over the whole window of every channel at once,
with rms that of the last channel's TX, as bench.py adds it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ria_tpu_torch.fec.ldpc import decode_batch
from ria_tpu_torch.fec.ldpc_matrix import MIN_SUM_FACTOR, RECOMMENDED_ITERS, encode_np, get_code
from ria_tpu_torch.sync import css, zc
from ria_tpu_torch.utils.device import resolve_device
from ria_tpu_torch.wave import dpsk, mfsk, otfs

PATHS = ("otfs_eq", "otfs_raw", "dpsk", "mfsk", "css_zc_sync")
DECODE_PATHS = PATHS[:4]
RATE = "R1_4"
LDPC_BITS = 648
BATCH = 64
MAX_LEAD = 8000
# Search windows of the waveform classes (api.py:931, :1032, :1145).
OTFS_WINDOW = 48000
SEARCH_WINDOW = 96000
CSS_WINDOW = 96000
ZC_CFG = zc.ZCConfig()
CSS_CFG = css.CSSConfig()


@dataclass(frozen=True)
class PathGeometry:
    """One path: its waveform config, frame length, window and SNR."""

    name: str
    cfg: object
    frame_samples: int
    window: int
    snr_db: float


def _otfs_cfg(raw: bool) -> otfs.OTFSConfig:
    # OTFSWaveform's config (api.py:893-896).
    return otfs.OTFSConfig(modulation="QPSK", dd_differential=raw, tf_equalization=not raw,
                           phase_tracking=not raw)


def path_geometry(name: str) -> PathGeometry:
    if name in ("otfs_eq", "otfs_raw"):
        cfg = _otfs_cfg(name == "otfs_raw")
        frame = ZC_CFG.preamble_samples + cfg.preamble_samples + cfg.frame_samples
        return PathGeometry(name, cfg, frame, OTFS_WINDOW, 18.0)
    if name == "dpsk":
        cfg = dpsk.DPSKConfig(bits_per_symbol=2, samples_per_symbol=512)
        frame = cfg.frame_samples(LDPC_BITS)
        return PathGeometry(name, cfg, frame, frame + MAX_LEAD, 6.0)
    if name == "mfsk":
        cfg = mfsk.MFSKConfig(num_tones=8)
        frame = cfg.frame_samples(LDPC_BITS)
        return PathGeometry(name, cfg, frame, frame + MAX_LEAD, -2.0)
    if name == "css_zc_sync":
        return PathGeometry(name, None, CSS_CFG.preamble_samples, CSS_WINDOW, 0.0)
    raise ValueError(f"no path {name!r}; one of {PATHS}")


class PathBatch(NamedTuple):
    """A path's input windows (one tensor; two for ``css_zc_sync``: the ZC
    and the CSS windows) and what was sent: the info bits [B, k] of the
    codeword, or the frame types [B, 2] (ZC, CSS) of the sync path."""

    inputs: tuple[torch.Tensor, ...]
    info: np.ndarray | None
    frame_types: np.ndarray


def _tx(geom: PathGeometry, coded: np.ndarray) -> np.ndarray:
    if geom.name in ("otfs_eq", "otfs_raw"):
        bits = np.zeros(geom.cfg.bits_per_frame(), np.int64)
        bits[:LDPC_BITS] = coded
        return np.concatenate([zc.generate_preamble(ZC_CFG, zc.ZC_DATA),
                               otfs.tx_frame(bits, geom.cfg)]).astype(np.float32)
    module = dpsk if geom.name == "dpsk" else mfsk
    return module.tx_frame(coded, geom.cfg)


def _place(frames: list[np.ndarray], leads: list[int], window: int, snr_db: float,
           rng: np.random.Generator) -> np.ndarray:
    audio = np.zeros((len(frames), window), np.float32)
    for b, (tx, lead) in enumerate(zip(frames, leads)):
        n = min(len(tx), window - lead)
        audio[b, lead : lead + n] = tx[:n]
    rms = float(np.sqrt(np.mean(frames[-1] ** 2)))
    audio += rng.normal(0, rms * 10 ** (-snr_db / 20), audio.shape).astype(np.float32)
    return audio


def make_path_batch(name: str, batch: int = BATCH, seed: int = 0,
                    device: str | torch.device = "cuda") -> PathBatch:
    """A batch of ``batch`` channels for path ``name`` on ``device``."""
    dev = resolve_device(device)
    geom = path_geometry(name)
    rng = np.random.default_rng(seed)
    if name == "css_zc_sync":
        types = np.zeros((batch, 2), np.int64)
        zc_frames, zc_leads, css_frames, css_leads = [], [], [], []
        for b in range(batch):
            types[b, 0] = rng.integers(0, 4)
            zc_frames.append(zc.generate_preamble(ZC_CFG, int(types[b, 0])))
            zc_leads.append(int(rng.integers(0, MAX_LEAD)))
            types[b, 1] = rng.integers(0, 4)
            css_frames.append(css.generate_preamble(CSS_CFG, int(types[b, 1])))
            css_leads.append(int(rng.integers(0, MAX_LEAD)))
        zc_audio = _place(zc_frames, zc_leads, OTFS_WINDOW, geom.snr_db, rng)
        css_audio = _place(css_frames, css_leads, CSS_WINDOW, geom.snr_db, rng)
        return PathBatch((torch.as_tensor(zc_audio, device=dev),
                          torch.as_tensor(css_audio, device=dev)), None, types)
    k = get_code(RATE).k
    info = np.zeros((batch, k), np.uint8)
    frames, leads = [], []
    for b in range(batch):
        info[b] = rng.integers(0, 2, k)
        frames.append(_tx(geom, encode_np(info[b : b + 1], RATE)[0]))
        leads.append(int(rng.integers(0, MAX_LEAD)))
    audio = _place(frames, leads, geom.window, geom.snr_db, rng)
    types = np.full((batch, 2), zc.ZC_DATA if name.startswith("otfs") else -1, np.int64)
    return PathBatch((torch.as_tensor(audio, device=dev),), info, types)


def zero_padded_slice(x: torch.Tensor, start: torch.Tensor, length: int) -> torch.Tensor:
    """x[b, start[b] : start[b] + length] per row, zero-padded past the end
    of the window (the waveform classes' fixed-size chunk).  x: [B, n];
    start: [B] in [0, n]."""
    padded = nn.functional.pad(x, (0, length))
    rows = torch.arange(x.shape[0], device=x.device)
    return padded.unfold(-1, length, 1)[rows, torch.clamp(start.long(), 0, x.shape[-1])]


class PathSync(NamedTuple):
    detected: torch.Tensor     # [B] bool
    start: torch.Tensor        # [B] int32: the first demodulated sample, -1 if none
    cfo_hz: torch.Tensor       # [B]
    frame_type: torch.Tensor   # [B] int32 (ZC frame type; -1 where none is sent)
    score: torch.Tensor        # [B] the detector's statistic (ZC correlation,
                               # Barker correlation, MFSK sweep score)


class PathResult(NamedTuple):
    detected: torch.Tensor     # [B] bool
    start: torch.Tensor        # [B] int32
    cfo_hz: torch.Tensor       # [B]
    frame_type: torch.Tensor   # [B] int32
    snr_db: torch.Tensor       # [B]
    soft_bits: torch.Tensor    # [B, 648] the header codeword's LLRs
    cw_success: torch.Tensor   # [B] bool
    info_bits: torch.Tensor    # [B, k] uint8
    iterations: torch.Tensor   # [B]
    sync_score: torch.Tensor   # [B]


class WaveformPath:
    """A decoding path: audio [B, window] -> PathResult, on the device of
    the audio, in three stages: ``sync``, ``demodulate`` and ``decode``."""

    def __init__(self, name: str):
        if name not in DECODE_PATHS:
            raise ValueError(f"no decoding path {name!r}; one of {DECODE_PATHS}")
        self.name = name
        self.geom = path_geometry(name)
        cfg = self.geom.cfg
        if name == "dpsk":
            self.chunk = (cfg.num_symbols_for_bits(LDPC_BITS) + 1) * cfg.samples_per_symbol
        elif name == "mfsk":
            self.chunk = (cfg.num_symbols_for_bits(LDPC_BITS) * cfg.repetition
                          * cfg.samples_per_symbol)
        else:
            self.chunk = cfg.preamble_samples + cfg.frame_samples

    def sync(self, audio: torch.Tensor) -> PathSync:
        cfg, dev = self.geom.cfg, audio.device
        if self.name in ("otfs_eq", "otfs_raw"):
            res = zc.detect(audio, ZC_CFG, root_mask=zc.ROOT_MASK_DATA | zc.ROOT_MASK_CONTROL)
            return PathSync(res.detected, res.start_sample, res.cfo_hz, res.frame_type,
                            res.correlation)
        window = audio[:, :SEARCH_WINDOW]
        if self.name == "dpsk":
            res = dpsk.find_preamble(window, cfg)
        else:
            # find_preamble takes one channel at a time (a batched input
            # reads as not detected, as in the reference).
            per = [mfsk.find_preamble(row, cfg) for row in window]
            res = mfsk.MFSKSyncResult(*(torch.stack(v) for v in zip(*per)))
        score = res.corr if self.name == "dpsk" else res.score
        return PathSync(res.detected, res.data_start, torch.zeros(res.detected.shape, device=dev),
                        torch.full_like(res.data_start, -1), score)

    def demodulate(self, audio: torch.Tensor, sync: PathSync):
        """(demod result, header-codeword LLRs [B, 648]) from the sync's
        start (channels not detected start at 0)."""
        start = torch.where(sync.detected, sync.start, 0)
        chunk = zero_padded_slice(audio.float(), start, self.chunk)
        cfg = self.geom.cfg
        if self.name == "dpsk":
            demod = dpsk.demodulate(chunk, cfg, LDPC_BITS)
        elif self.name == "mfsk":
            demod = mfsk.demodulate(chunk, cfg, LDPC_BITS)
        else:
            demod = otfs.demodulate_presynced(chunk, sync.cfo_hz, cfg)
        return demod, demod.soft_bits[:, :LDPC_BITS].contiguous()

    def soft_bits(self, audio: torch.Tensor):
        """(sync, demod result, header-codeword LLRs [B, 648])."""
        sync = self.sync(audio)
        return (sync, *self.demodulate(audio, sync))

    def decode(self, sync: PathSync, demod, soft: torch.Tensor) -> PathResult:
        factors = torch.full((soft.shape[0],), MIN_SUM_FACTOR, dtype=torch.float32,
                             device=soft.device)
        dec = decode_batch(soft, factors, RATE, RECOMMENDED_ITERS[RATE])
        snr = demod.snr_db if self.name.startswith("otfs") else demod.snr_estimate_db
        return PathResult(sync.detected, sync.start, sync.cfo_hz, sync.frame_type, snr, soft,
                          dec.success & sync.detected, dec.info_bits, dec.iterations, sync.score)

    def __call__(self, audio: torch.Tensor) -> PathResult:
        return self.decode(*self.soft_bits(audio))


class SyncPathResult(NamedTuple):
    zc: zc.ZCSyncResult
    css: css.CSSResult


class SyncPath:
    """The sync-only path: (ZC windows [B, 48000], CSS windows [B, 96000])
    -> SyncPathResult, all four ZC roots and CSS shifts enabled."""

    name = "css_zc_sync"

    def __init__(self):
        self.geom = path_geometry(self.name)

    def __call__(self, zc_audio: torch.Tensor, css_audio: torch.Tensor) -> SyncPathResult:
        return SyncPathResult(zc.detect(zc_audio, ZC_CFG, root_mask=zc.ROOT_MASK_ALL),
                              css.detect(css_audio, CSS_CFG))


def make_path(name: str) -> WaveformPath | SyncPath:
    """The path ``name``; it runs on the device of the tensors it is given."""
    return SyncPath() if name == "css_zc_sync" else WaveformPath(name)
