"""MC-DPSK PHY pipeline: frame bytes <-> audio samples, in PyTorch.

Port of ``ria_tpu/phy/modem.py``, the equivalent of the reference's
StreamingEncoder/StreamingDecoder MC-DPSK path
(src/gui/modem/streaming_encoder.cpp:210-251, streaming_decoder.cpp:2595):

TX: serialized frame -> per-CW LDPC encode (+ optional channel interleave) ->
    chirp/training/reference preamble + mixer-bank modulation (host numpy).
RX: dual-chirp sync + CFO -> demod CW0 worth of symbols ("CW0 peek",
    streaming_decoder.cpp:1060-1100) -> parse header for total_cw -> demod the
    full frame -> batched LDPC decode -> reassemble + CRC check.

Host Python orchestrates (variable frame sizes, retries); the signal math
runs in the cached ``nn.Module``s of ``sync/chirp.py`` and ``wave/mc_dpsk.py``
on ``device``, and every decode goes through ``decode_batch`` (K1 on the
card).  The receive buffer is uploaded once a call.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ria_tpu_torch.fec.ldpc import LDPCCodec
from ria_tpu_torch.phy import frame_v2
from ria_tpu_torch.phy.frame_v2 import (
    DataFrame, decode_codewords, encode_frame_ldpc, parse_header, reassemble_codewords,
)
from ria_tpu_torch.sync.chirp import detect_dual_chirp
from ria_tpu_torch.utils.device import resolve_device
from ria_tpu_torch.wave.mc_dpsk import MCDPSKConfig, demodulate, modulate, preamble

LDPC_BITS = 648


@dataclass
class RxFrame:
    """One receive attempt; every field is a host value."""

    ok: bool
    frame_bytes: bytes | None
    header: dict | None
    cw_ok: np.ndarray | None
    soft_bits: np.ndarray | None   # raw frame soft bits (for HARQ chase)
    snr_db: float = 0.0
    fading_index: float = 0.0
    cfo_hz: float = 0.0
    start_sample: int = -1
    # Handshake channel probe (MC-DPSK frames only; -1 = not measured).
    delay_spread_ms: float = -1.0
    doppler_spread_hz: float = -1.0


class AudioBuffer:
    """One receive buffer for every stage of a call: the samples on the
    device (a numpy array is uploaded once, a tensor is used where it lies)
    and host slices of them for the host-side measurements."""

    def __init__(self, audio, device: str | torch.device = "cuda"):
        dev = resolve_device(device)
        if isinstance(audio, torch.Tensor):
            if audio.device.type != dev.type or dev.index not in (None, audio.device.index):
                raise ValueError(f"audio on {audio.device}, but device={dev} was asked for")
            self.samples = audio.float()
            self._host = None
        else:
            host = np.ascontiguousarray(audio, np.float32)
            if not host.flags.writeable:
                host = host.copy()
            self._host = host
            self.samples = torch.as_tensor(host, device=dev)

    def __len__(self) -> int:
        return self.samples.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.samples.device

    def host(self, begin: int, end: int) -> np.ndarray:
        """samples[begin:end] as a host float32 array."""
        if self._host is not None:
            return self._host[begin:end]
        return self.samples[begin:end].cpu().numpy()

    def chunk(self, start: int, need: int) -> torch.Tensor:
        """samples[start : start + need] on the device, zero-padded to
        ``need`` past the end of the buffer (the fixed-size demod slice)."""
        avail = self.samples[start : start + need]
        if avail.shape[-1] < need:
            avail = torch.nn.functional.pad(avail, (0, need - avail.shape[-1]))
        return avail


def as_audio(audio, device: str | torch.device) -> AudioBuffer:
    """``audio`` (numpy array, tensor or :class:`AudioBuffer`) as an
    :class:`AudioBuffer` on ``device``; a buffer passes through as it is."""
    if isinstance(audio, AudioBuffer):
        if audio.device.type != resolve_device(device).type:
            raise ValueError(f"audio on {audio.device}, but device={device} was asked for")
        return audio
    return AudioBuffer(audio, device)


def host_scalars(*tensors: torch.Tensor) -> list[float]:
    """The values of 0-d device tensors, brought to the host in one copy
    (one device synchronisation instead of one per ``bool()``/``float()``)."""
    return torch.stack([t.reshape(()).double() for t in tensors]).tolist()


def cfo_tensor(cfo_hz: float, device: torch.device) -> torch.Tensor:
    """A CFO as the float32 scalar the demodulators take: rounded to
    float32 before any arithmetic, as the reference passes it."""
    return torch.full((), float(cfo_hz), dtype=torch.float32, device=device)


class MCDPSKModem:
    """Host-facing MC-DPSK TX/RX for single frames (simulation/test tier)."""

    def __init__(self, cfg: MCDPSKConfig | None = None, rate: str = "R1_4",
                 channel_interleave: bool = False, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg or MCDPSKConfig()
        self.rate = rate
        self.codec = LDPCCodec(rate, device=self.device)
        self.channel_interleave = channel_interleave

    @property
    def _ci_bits(self) -> int | None:
        return self.cfg.bits_per_mc_symbol if self.channel_interleave else None

    # ------------------------------------------------------------------ TX
    def tx_frame(self, frame_bytes: bytes, tx_cfo_hz: float = 0.0) -> np.ndarray:
        """Serialized frame -> audio samples (preamble + modulated CWs)."""
        is_ctrl = len(frame_bytes) == 20 and (
            0x10 <= frame_bytes[2] <= 0x21 or frame_bytes[2] == 0x40)
        cw_bits = encode_frame_ldpc(
            frame_bytes, self.rate,
            None if is_ctrl else self._ci_bits)
        # Patch total_cw for data frames if the serializer guessed wrong
        if not is_ctrl and len(frame_bytes) >= 17 and frame_bytes[12] != len(cw_bits):
            patched = bytearray(frame_bytes)
            patched[12] = len(cw_bits)
            hcrc = frame_v2.crc16(bytes(patched[:15]))
            patched[15:17] = hcrc.to_bytes(2, "big")
            fcrc = frame_v2.crc16(bytes(patched[:-2]))
            patched[-2:] = fcrc.to_bytes(2, "big")
            frame_bytes = bytes(patched)
            cw_bits = encode_frame_ldpc(frame_bytes, self.rate,
                                        None if is_ctrl else self._ci_bits)
        bits = cw_bits.reshape(-1)
        return np.concatenate([preamble(self.cfg, tx_cfo_hz), modulate(bits, self.cfg)])

    def frame_duration_samples(self, frame_bytes_len: int) -> int:
        ncw = len(frame_v2.split_into_codewords(b"\x00" * frame_bytes_len, self.rate))
        return self.cfg.frame_samples(ncw * LDPC_BITS)

    # ------------------------------------------------------------------ RX
    def _demod_bits(self, audio: AudioBuffer, start: int, cfo: float,
                    num_bits: int) -> tuple[np.ndarray, object]:
        n_sym = self.cfg.num_data_symbols(num_bits)
        need = (self.cfg.training_symbols + 1 + n_sym * self.cfg.spreading) \
            * self.cfg.samples_per_symbol
        res = demodulate(audio.chunk(start, need), cfo_tensor(cfo, audio.device),
                         self.cfg, n_sym)
        return res.soft_bits[:num_bits].cpu().numpy(), res

    def rx_frame(self, audio) -> RxFrame:
        """Search audio for one frame: sync, CW0 peek, full decode."""
        audio = as_audio(audio, self.device)
        sync = detect_dual_chirp(audio.samples, self.cfg.chirp)
        detected, sync_start, cfo = host_scalars(sync.detected, sync.start, sync.cfo_hz)
        if not detected:
            return RxFrame(False, None, None, None, None)
        sync_start = int(sync_start)
        start = sync_start + self.cfg.chirp.total_samples

        # CW0 peek: control frames never use channel interleave.
        soft0, _ = self._demod_bits(audio, start, cfo, LDPC_BITS)
        ok0, chunk0 = decode_codewords(soft0[None, :], self.rate, None, device=self.device)
        header = parse_header(chunk0[0]) if ok0[0] else None
        if header is None and self._ci_bits:
            ok0i, chunk0i = decode_codewords(soft0[None, :], self.rate, self._ci_bits,
                                             device=self.device)
            h = parse_header(chunk0i[0]) if ok0i[0] else None
            if h is not None:
                ok0, chunk0, header = ok0i, chunk0i, h
        if header is None:
            return RxFrame(False, None, None, np.asarray(ok0), soft0,
                           cfo_hz=cfo, start_sample=sync_start)

        total_cw = max(1, int(header["total_cw"]))
        if header["is_control"]:
            total_cw = 1

        num_bits = total_cw * LDPC_BITS
        soft, res = self._demod_bits(audio, start, cfo, num_bits)
        ci = None if header["is_control"] else self._ci_bits
        oks, chunks = decode_codewords(soft.reshape(total_cw, LDPC_BITS), self.rate, ci,
                                       device=self.device)
        frame_bytes = reassemble_codewords(list(chunks), self.rate) if oks.all() else None

        ok = bool(oks.all())
        if ok and frame_bytes is not None and not header["is_control"]:
            # Validate frame CRC via deserialization
            ok = DataFrame.deserialize(frame_bytes) is not None
        snr_db, fading = host_scalars(res.snr_estimate_db,
                                      res.freq_fading_index + res.temporal_fading_index)
        return RxFrame(ok, frame_bytes, header, oks, soft,
                       snr_db=snr_db, fading_index=fading,
                       cfo_hz=cfo, start_sample=sync_start)
