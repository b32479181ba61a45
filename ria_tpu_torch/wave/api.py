"""Waveform abstraction: unified TX/RX interface over MC-DPSK and OFDM.

Port of ``ria_tpu/wave/api.py``, the counterpart of the reference's IWaveform plugin interface
(src/waveform/waveform_interface.hpp:47-220) and WaveformFactory
(src/waveform/waveform_factory.hpp:18-60).  Each waveform provides:

- configure(modulation, rate) (+ spreading for MC-DPSK)
- tx_frame(frame_bytes, light=False): full preamble (chirp / Schmidl-Cox)
  or the compact connected-mode preamble (ZC / LTS-only)
- rx_frame(audio, light=False): sync search + demod + LDPC decode with the
  reference's control-frame fast path and try-both decode strategies
- frame_samples(n_codewords): RX buffering hints (getMinSamplesFor*)

Host Python orchestrates, as in ``ria_tpu``; the signal math runs in the
cached ``nn.Module``s of the sync and waveform modules on the waveform's
``device`` (default the card; without one construction raises), and every
decode goes through ``decode_batch``, K1 on the card.  ``rx_frame``,
``detect_sync``, ``peek_header`` and ``rx_burst`` take a numpy array, a
tensor or an :class:`AudioBuffer`: a numpy array is uploaded once a call, a
tensor on the device is used where it lies, and a caller that tries several
waveforms on one recording builds one ``AudioBuffer`` and hands it to each.
A sync result's scalars come to the host in one copy.  ``RxFrame``, the
chase cache, the tracked noise floor, frame parsing and the CRC gates are
host values and host code.
"""

from __future__ import annotations

import itertools
from dataclasses import replace

import numpy as np
import torch

from ria_tpu_torch.dsp.snr import spectral_snr_db
from ria_tpu_torch.fec.chase import ChaseKey
from ria_tpu_torch.fec.interleave import (
    apply_perm, channel_perm, stripe_deinterleave, stripe_interleave,
)
from ria_tpu_torch.fec.ldpc import decode_candidates, decode_with_retries
from ria_tpu_torch.phy import frame_v2
from ria_tpu_torch.phy.channel_probe import estimate_mc_dpsk
from ria_tpu_torch.phy.frame_v2 import (
    FRAME_CODEWORDS, ControlFrame, DataFrame, WaveformMode, _encode_chunks,
    _validate_fixed_chunks, bits_to_bytes, build_burst_stream, burst_stream_codewords,
    bytes_per_codeword, decode_codewords, decode_fixed_frame, encode_fixed_frame,
    encode_frame_ldpc, parse_burst_stream, parse_header, reassemble_codewords,
)
from ria_tpu_torch.phy.modem import AudioBuffer, RxFrame, as_audio, cfo_tensor, host_scalars
from ria_tpu_torch.sync import chirp as chirp_sync
from ria_tpu_torch.sync import css
from ria_tpu_torch.sync import zc as zc_sync
from ria_tpu_torch.utils.device import full_fp32_matmul, resolve_device
from ria_tpu_torch.wave import dpsk, mc_dpsk, mfsk, ofdm, otfs
from ria_tpu_torch.wave.selection import recommended_pilot_spacing

LDPC_BITS = 648


def _is_control_bytes(frame_bytes: bytes) -> bool:
    return len(frame_bytes) == 20 and (
        0x10 <= frame_bytes[2] <= 0x21 or frame_bytes[2] == 0x40)


def _noise_ref(audio: AudioBuffer, preamble_begin: int) -> np.ndarray | None:
    """Noise-only window from the inter-frame gap just before a frame's
    preamble, for the spectral SNR floor.  Without it the floor falls back
    to out-of-band bins (8-22 kHz), which are empty whenever the channel is
    bandlimited — a receiver SSB filter, or the simulator's SSB-shift CFO
    path — and the SNR estimate inflates by 10+ dB, negotiating absurd
    rates (QAM64 at a true 10 dB)."""
    end = max(0, int(preamble_begin) - 480)  # timing-error guard
    beg = max(0, end - 24000)
    if end - beg >= 4096:
        return audio.host(beg, end)
    return None


def _tracked_snr(obj, audio: AudioBuffer, start: int, length: int,
                 pre: int) -> float:
    """Spectral SNR with a per-waveform tracked noise floor: measure the
    floor from the inter-frame gap when one exists, else reuse the last
    measured floor (a receiver-tracked quantity, like the reference's OFDM
    energy-gate noise tracker, ofdm_sync.cpp:20-47).  Without the memory, a
    frame whose gap was already consumed falls back to the out-of-band
    floor, which reads near-zero on any bandlimited channel and clips the
    estimate at +50 dB.

    The signal window spans the WHOLE on-air frame [pre, start+length) —
    acquisition preamble included — because the selection tables' SNR
    convention (inherited from the reference's simulator feed,
    hf_channel.hpp:125-128: noise sized from whole-frame rms) counts the
    preamble's power.  Measuring the body alone read a constant ~1.7 dB
    low on MC-DPSK chirp frames (the chirp is louder than the body) and
    under-negotiated modes one rung down the ladder — e.g. MC-DPSK DQPSK
    at a true 12 dB where the reference engages OFDM.

    Host numpy on host slices of the buffer, as in ``ria_tpu``."""
    begin = int(np.clip(pre, 0, start))
    ref = _noise_ref(audio, pre)
    prior = getattr(obj, "_noise_floor", None)
    window = audio.host(begin, start + length)
    snr, floor = spectral_snr_db(window,
                                 noise_ref=ref,
                                 noise_bin_prior=prior,
                                 return_floor=True)
    if ref is not None and floor > 0.0:
        # Contamination guard: with pipelined bursts the "inter-frame gap"
        # directly precedes a frame that QUEUED BEHIND another burst — the
        # window holds the previous burst's signal, not noise, and one
        # poisoned floor sent session SNR reads to -24 dB (measured:
        # ladder thrash QAM16->DQPSK R1/4 mid-transfer at Good 20 dB).  A
        # real noise floor moves slowly; accept at most a 4x (+6 dB) step
        # up per measurement, else keep the tracked prior.
        if prior is not None and floor > 4.0 * prior:
            snr = spectral_snr_db(window, noise_bin_prior=prior)
        else:
            obj._noise_floor = floor
    return snr


def _control_crc_gate(frame_bytes: bytes | None, cw_soft: np.ndarray, rate: str,
                      device: str | torch.device = "cuda") -> tuple[bool, bytes | None]:
    """Full-frame CRC16 gate for single-CW control frames.

    LDPC parity alone is not sufficient acceptance: BP (especially the
    perturbation retry ladder) can converge to a parity-valid NEIGHBOUR
    codeword a few bits from the truth, whose header still parses — the
    reference catches this with the frame CRC at the protocol layer and
    drops the frame silently (streaming_decoder.cpp:2955-2960 false-positive
    check).  Gating here instead (a) keeps wrong bytes out of frames_rx
    accounting and (b) lets the caller's fallback paths (e.g. the 4x-spread
    beacon re-decode) run.  When the primary decode fails the gate, rescue
    with CRC-aided list decoding over distinct parity-valid candidates.
    """
    if frame_bytes is not None and ControlFrame.deserialize(frame_bytes) is not None:
        return True, frame_bytes
    cands = decode_candidates(np.asarray(cw_soft, np.float32).reshape(1, -1), rate,
                              device=device)
    for _metric, info in cands[0]:
        fb = bits_to_bytes(np.asarray(info))[:20]
        if ControlFrame.deserialize(fb) is not None:
            return True, bytes(fb)
    return False, frame_bytes


def _encode_with_cw_patch(frame_bytes: bytes, rate: str, ci_bits: int | None):
    """Variable-CW LDPC encode, patching total_cw + CRCs in the header when
    the serializer's guess differs (streaming_encoder.cpp total_cw patch)."""
    is_ctrl = _is_control_bytes(frame_bytes)
    ci = None if is_ctrl else ci_bits
    cw_bits = encode_frame_ldpc(frame_bytes, rate, ci)
    if not is_ctrl and len(frame_bytes) >= 17 and frame_bytes[12] != len(cw_bits):
        patched = bytearray(frame_bytes)
        patched[12] = len(cw_bits)
        patched[15:17] = frame_v2.crc16(bytes(patched[:15])).to_bytes(2, "big")
        patched[-2:] = frame_v2.crc16(bytes(patched[:-2])).to_bytes(2, "big")
        cw_bits = encode_frame_ldpc(bytes(patched), rate, ci)
    return cw_bits, is_ctrl


def _chase_combine(chase, header, cw_soft: np.ndarray, oks: np.ndarray,
                   chunks: list, rate: str, ci_bits: int | None,
                   device: str | torch.device = "cuda"):
    """Store failed-CW LLRs, retry decode on the accumulated sums."""
    key = ChaseKey(header["seq"], header["src_hash"], header["dst_hash"])
    total_cw = len(oks)
    raw = cw_soft
    if ci_bits:
        raw = apply_perm(cw_soft, channel_perm(ci_bits), inverse=True)
    combined_rows, combined_idx = [], []
    for i in range(total_cw):
        if oks[i]:
            chase.mark_decoded(key, i)
            continue
        chase.store(key, i, raw[i], total_cw, int(header["type"]))
        acc = chase.get_combined(key, i)
        if acc is not None and chase.get_combine_count(key, i) > 1:
            combined_rows.append(acc)
            combined_idx.append(i)
    if combined_rows:
        retry = decode_codewords(np.stack(combined_rows), rate, None, device=device)
        r_oks, r_chunks = retry
        for j, i in enumerate(combined_idx):
            if r_oks[j]:
                oks[i] = True
                chunks[i] = r_chunks[j]
                chase.mark_decoded(key, i)
                chase.stats.recoveries += 1
    return oks, chunks


def _chase_combine_fixed(chase, header, cw_raw: np.ndarray, rate: str,
                         device: str | torch.device = "cuda"):
    """Fixed-frame HARQ combine: accumulate ALL 4 CWs' raw LLRs.

    Unlike the variable-CW path (which stores only parity-FAILED CWs), the
    fixed path cannot trust per-CW parity as acceptance — at low SNR the
    retry ladder regularly converges every CW to a parity-valid NEIGHBOUR
    while the frame CRC rejects the result (measured at Moderate 9 dB:
    most failures are all-CW-"ok"/frame-invalid).  Storing all rows is
    safe: adding an extra independent copy of a correct CW only raises its
    margin.  Acceptance stays with the frame header/CRC validators.
    Returns the validated frame bytes or None."""
    key = ChaseKey(header["seq"], header["src_hash"], header["dst_hash"])
    for i in range(FRAME_CODEWORDS):
        chase.store(key, i, cw_raw[i], FRAME_CODEWORDS, int(header["type"]))
    rows = []
    for i in range(FRAME_CODEWORDS):
        acc = chase.get_combined(key, i)
        if acc is None or chase.get_combine_count(key, i) < 2:
            return None  # first transmission: accumulated only
        rows.append(acc)
    combined = np.stack(rows)
    info_bits = decode_with_retries(combined, rate, device=device).info_bits.cpu().numpy()
    chunks = [bits_to_bytes(info_bits[i]) for i in range(FRAME_CODEWORDS)]
    fb = _validate_fixed_chunks(chunks, rate)
    if fb is None:
        # CRC-aided list decode over the combined LLRs (same rescue the
        # single-shot fixed decode gets, frame_v2.decode_fixed_frame).
        cands = decode_candidates(combined, rate, device=device)
        if all(len(c) > 0 for c in cands):
            combos = sorted(itertools.product(*cands),
                            key=lambda t: -sum(m for m, _ in t))[:64]
            for combo in combos:
                chunks_c = [bits_to_bytes(np.asarray(info)) for _, info in combo]
                fb = _validate_fixed_chunks(chunks_c, rate)
                if fb is not None:
                    break
    if fb is not None:
        chase.stats.recoveries += 1
        chase.remove(key)
    return fb


def _chirp_sync_dict(x: torch.Tensor, cfg: chirp_sync.ChirpConfig) -> dict | None:
    """Dual-chirp sync of a buffer as the waveforms' sync dict."""
    res = chirp_sync.detect_dual_chirp(x, cfg)
    detected, start, cfo, up, down = host_scalars(res.detected, res.start, res.cfo_hz,
                                                  res.up_corr, res.down_corr)
    if not detected:
        return None
    return {"start": int(start) + cfg.total_samples, "cfo_hz": cfo,
            "corr": max(up, down), "kind": "chirp"}


def _zc_sync_dict(x: torch.Tensor, cfg: zc_sync.ZCConfig, with_type: bool = False) -> dict | None:
    """ZC sync (DATA and CONTROL roots) of a buffer as the sync dict."""
    res = zc_sync.detect(x, cfg, root_mask=zc_sync.ROOT_MASK_DATA | zc_sync.ROOT_MASK_CONTROL)
    detected, start, cfo, corr, ftype = host_scalars(
        res.detected, res.start_sample, res.cfo_hz, res.correlation, res.frame_type)
    if not detected:
        return None
    out = {"start": int(start), "cfo_hz": cfo, "corr": corr, "kind": "zc"}
    if with_type:
        out["zc_type"] = int(ftype)
    return out


def _lts_scalars(res: ofdm.LTSSyncResult) -> tuple:
    """(detected, lts_start, corr, cfo_hz, repeats) on the host, one copy."""
    return tuple(host_scalars(res.detected, res.lts_start, res.corr, res.cfo_hz, res.repeats))


class MCDPSKWaveform:
    """MC-DPSK: chirp handshake preamble, ZC connected-mode preamble."""

    mode = WaveformMode.MC_DPSK
    fallback_cw = 1   # header-less skip span (CW0 carries the length)
    header_required = True  # variable-CW: no decodable CW0 => frame lost

    def __init__(self, num_carriers: int = 10, modulation: str = "DBPSK",
                 rate: str = "R1_4", spreading: int = 1,
                 channel_interleave: bool = False, use_css: bool = False,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        full_fp32_matmul()
        self.cfg = mc_dpsk.MCDPSKConfig(
            num_carriers=num_carriers,
            bits_per_symbol=2 if modulation == "DQPSK" else 1,
            spreading=spreading)
        self.modulation = modulation
        self.rate = rate
        self.channel_interleave = channel_interleave
        self.zc_cfg = zc_sync.ZCConfig()
        # Optional CSS acquisition preamble (reference --css,
        # src/sync/css_sync.hpp:1-40): frame type rides the chirp's cyclic
        # shift, so the receiver knows PING/DATA/CONTROL from sync itself
        # instead of the post-chirp energy-ratio discrimination.  Tradeoff
        # vs the dual chirp: no CFO estimate (an up-chirp pair is needed to
        # separate CFO from timing), so CSS suits near-zero-CFO links.
        self.use_css = use_css
        self.css_cfg = None
        if use_css:
            self.css_cfg = css.CSSConfig()

    def configure(self, modulation: str, rate: str, spreading: int = 1,
                  num_carriers: int | None = None):
        self.modulation = modulation
        self.rate = rate
        self.cfg = replace(self.cfg,
                           bits_per_symbol=2 if modulation == "DQPSK" else 1,
                           spreading=spreading,
                           num_carriers=num_carriers or self.cfg.num_carriers)

    @property
    def _ci_bits(self) -> int | None:
        return self.cfg.bits_per_mc_symbol if self.channel_interleave else None

    # ------------------------------------------------------------------ TX
    def _encode_bits(self, frame_bytes: bytes):
        return _encode_with_cw_patch(frame_bytes, self.rate, self._ci_bits)

    def _train_ref(self) -> np.ndarray:
        train = mc_dpsk._synthesize(mc_dpsk._training_matrix(self.cfg), self.cfg)
        ref = mc_dpsk._synthesize(
            np.ones((1, self.cfg.num_carriers), np.complex64), self.cfg)
        return np.concatenate([train, ref])

    def acq_preamble(self, css_type: int, tx_cfo_hz: float = 0.0) -> np.ndarray:
        """Acquisition preamble + training + reference symbol.  css_type
        selects the CSS cyclic shift when use_css (ignored for chirp)."""
        if self.use_css:
            head = css.generate_preamble(self.css_cfg, css_type)
            return np.concatenate([head, self._train_ref()]).astype(np.float32)
        return mc_dpsk.preamble(self.cfg, tx_cfo_hz)

    def tx_frame(self, frame_bytes: bytes, light: bool = False,
                 tx_cfo_hz: float = 0.0) -> np.ndarray:
        cw_bits, is_ctrl = self._encode_bits(frame_bytes)
        bits = cw_bits.reshape(-1)
        body = mc_dpsk.modulate(bits, self.cfg)
        if light:
            ftype = zc_sync.ZC_CONTROL if is_ctrl else zc_sync.ZC_DATA
            zc = zc_sync.generate_preamble(self.zc_cfg, ftype)
            return np.concatenate([zc, self._train_ref(), body]).astype(np.float32)
        head = self.acq_preamble(css.CSS_CONTROL if is_ctrl else css.CSS_DATA,
                                 tx_cfo_hz)
        return np.concatenate([head, body])

    def frame_samples(self, num_codewords: int, light: bool = False) -> int:
        n_bits = num_codewords * LDPC_BITS
        body = self.cfg.num_rx_symbols(n_bits) * self.cfg.samples_per_symbol
        train_ref = (self.cfg.training_symbols + 1) * self.cfg.samples_per_symbol
        if light:
            head = self.zc_cfg.preamble_samples
        elif self.use_css:
            head = self.css_cfg.preamble_samples
        else:
            head = self.cfg.chirp.total_samples
        return head + train_ref + body

    # ------------------------------------------------------------------ RX
    def search_window(self, light: bool = False) -> int:
        """Sliding sync-search window (reference getMinSamplesForSearch +
        streaming_decoder window caps: chirp <=120k, connected ZC <=48k).
        Fixed sizes keep the detectors at one cached module."""
        return 48000 if light else 120000

    def search_overlap(self, light: bool = False) -> int:
        """Overlap re-searched between consecutive windows: one full
        preamble plus margin, so a boundary-straddling preamble is found."""
        if light:
            return self.zc_cfg.preamble_samples + 2048
        if self.use_css:
            return self.css_cfg.preamble_samples + 4800
        return self.cfg.chirp.total_samples + 4800

    def peek_header(self, audio, start: int, cfo: float, light: bool = False):
        """Decode CW0 only and parse the frame header (reference CW0 "peek",
        streaming_decoder.cpp:1060-1100) — lets the caller wait for the
        exact frame length before attempting the full decode."""
        audio = as_audio(audio, self.device)
        soft0, _ = self._demod_bits(audio, start, cfo, LDPC_BITS)
        for ci in ([None, self._ci_bits] if self._ci_bits else [None]):
            ok0, chunk0 = decode_codewords(soft0[None, :], self.rate, ci, device=self.device)
            if ok0[0]:
                h = parse_header(chunk0[0])
                if h is not None:
                    return h
        return None

    def detect_sync(self, audio, light: bool = False):
        x = as_audio(audio, self.device).samples
        if light:
            return _zc_sync_dict(x, self.zc_cfg, with_type=True)
        if self.use_css:
            cres = css.detect(x, self.css_cfg)
            detected, start, corr, ftype = host_scalars(
                cres.detected, cres.start_sample, cres.correlation, cres.frame_type)
            if not detected:
                return None
            return {"start": int(start), "cfo_hz": 0.0, "corr": corr, "kind": "css",
                    "css_type": int(ftype)}
        return _chirp_sync_dict(x, self.cfg.chirp)

    def _demod_bits(self, audio: AudioBuffer, start, cfo, num_bits):
        n_sym = self.cfg.num_data_symbols(num_bits)
        need = (self.cfg.training_symbols + 1 + n_sym * self.cfg.spreading) \
            * self.cfg.samples_per_symbol
        res = mc_dpsk.demodulate(audio.chunk(start, need), cfo_tensor(cfo, audio.device),
                                 self.cfg, n_sym)
        return res.soft_bits[:num_bits].cpu().numpy(), res

    def rx_frame(self, audio, light: bool = False,
                 chase=None, sync: dict | None = None) -> RxFrame:
        audio = as_audio(audio, self.device)
        if sync is None:
            sync = self.detect_sync(audio, light)
        if sync is None:
            return RxFrame(False, None, None, None, None)
        start, cfo = sync["start"], sync["cfo_hz"]

        soft0, _ = self._demod_bits(audio, start, cfo, LDPC_BITS)
        header = None
        for ci in ([None, self._ci_bits] if self._ci_bits else [None]):
            ok0, chunk0 = decode_codewords(soft0[None, :], self.rate, ci, device=self.device)
            if ok0[0]:
                h = parse_header(chunk0[0])
                if h is not None:
                    header = h
                    break
        if header is None:
            return RxFrame(False, None, None, None, soft0, cfo_hz=cfo,
                           start_sample=start)

        total_cw = 1 if header["is_control"] else max(1, int(header["total_cw"]))
        soft, res = self._demod_bits(audio, start, cfo, total_cw * LDPC_BITS)
        ci = None if header["is_control"] else self._ci_bits
        cw_soft = soft.reshape(total_cw, LDPC_BITS)
        oks, chunks = decode_codewords(cw_soft, self.rate, ci, device=self.device)
        oks = np.array(oks)
        chunks = list(chunks)

        # HARQ chase combining (streaming_decoder.cpp:2729-2767): accumulate
        # failed-CW LLRs across retransmissions and retry on the combined sum.
        if chase is not None and not header["is_control"] and not oks.all():
            oks, chunks = _chase_combine(chase, header, cw_soft, oks, chunks,
                                         self.rate, ci, self.device)

        frame_bytes = reassemble_codewords(chunks, self.rate) if oks.all() else None
        ok = bool(oks.all())
        if header["is_control"]:
            ok, frame_bytes = _control_crc_gate(frame_bytes if ok else None,
                                                cw_soft[0], self.rate, self.device)
        elif ok:
            ok = DataFrame.deserialize(frame_bytes) is not None
        if ok and chase is not None and not header["is_control"]:
            chase.remove(ChaseKey(header["seq"], header["src_hash"], header["dst_hash"]))
        # SNR for mode negotiation: spectral excess-over-noise-floor, which
        # tracks -14..30+ dB; the differential-phase-variance estimate
        # floors at ~13 dB from inter-carrier leakage, and the reference
        # never measures DPSK SNR at all (it feeds sim truth into the
        # protocol, src/gui/app.cpp:309-316).
        n_sym = self.cfg.num_data_symbols(total_cw * LDPC_BITS)
        body_len = (self.cfg.training_symbols + 1 + n_sym * self.cfg.spreading) \
            * self.cfg.samples_per_symbol
        if sync.get("kind") == "zc":
            pre = start - self.zc_cfg.preamble_samples
        elif sync.get("kind") == "css":
            pre = start - self.css_cfg.preamble_samples
        else:
            pre = start - self.cfg.chirp.total_samples
        snr_db = _tracked_snr(self, audio, start, body_len, pre)
        # Handshake channel probe for OFDM<->OTFS routing (the reference's
        # AdaptiveModem preamble characterization, adaptive_modem.hpp:25-230).
        zsym = res.zsym.cpu().numpy()
        (fading,) = host_scalars(res.freq_fading_index + res.temporal_fading_index)
        probe = estimate_mc_dpsk(zsym, self.cfg, snr_db)
        z = zsym[self.cfg.training_symbols:]
        d = z[1:] * np.conj(z[:-1])
        m = np.abs(d)
        self.last_symbols = (d / np.maximum(m, 1e-9) * 0.9).reshape(-1)
        return RxFrame(ok, frame_bytes, header, oks, soft,
                       snr_db=snr_db,
                       fading_index=fading,
                       cfo_hz=cfo, start_sample=start,
                       delay_spread_ms=probe.delay_spread_ms,
                       doppler_spread_hz=probe.doppler_spread_hz)


class _OFDMWaveformBase:
    """Shared OFDM TX/RX: control frames hardened to DQPSK R1/4 variable-CW,
    data frames fixed 4-CW with frame interleave (streaming_encoder.cpp)."""

    fallback_cw = 4  # data frames are always fixed 4-CW
    header_required = False  # fixed-length decode can rescue a failed CW0

    def peek_header(self, audio, lts_start: int, cfo: float, light: bool = False):
        """Control fast-path peek: decode the DQPSK R1/4 control codeword and
        parse its header.  Returns None for data frames — their length is
        fixed (4 CW), so no peek is needed to size the wait."""
        audio = as_audio(audio, self.device)
        soft0, _ = self._demod(audio, lts_start, cfo, self.ctrl_cfg, LDPC_BITS)
        ok0, chunk0 = decode_codewords(soft0[None, :], "R1_4", None, device=self.device)
        if ok0[0]:
            h = parse_header(chunk0[0])
            if h is not None and h["is_control"]:
                return h
        return None

    def __init__(self, modulation: str = "DQPSK", rate: str = "R1_2",
                 channel_interleave: bool = True, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        full_fp32_matmul()
        # Channel interleaving defaults ON for OFDM data frames
        # (streaming_encoder.hpp:197 use_channel_interleave_ = true).
        self.modulation = modulation
        self.rate = rate
        self.channel_interleave = channel_interleave
        self._pre_start: int | None = None  # current frame's signal begin
        self._rebuild()

    def _rebuild(self):
        # Pilots are ALWAYS on for the OFDM waveforms — the reference's
        # deterministic pilot profile (ofdm_chirp_waveform.cpp:75-79,
        # ofdm_link_adaptation.hpp:26-64) is part of the wire format;
        # differential modes carry pilots too (53 data + 6 pilots at DQPSK).
        spacing = recommended_pilot_spacing(self.modulation, self.rate)
        self.cfg = ofdm.OFDMConfig(modulation=self.modulation,
                                   use_pilots=True, pilot_spacing=spacing)
        # Control profile = configure(DQPSK, R1_4): pilots spacing 10.
        self.ctrl_cfg = ofdm.OFDMConfig(modulation="DQPSK", use_pilots=True,
                                        pilot_spacing=10)

    def configure(self, modulation: str, rate: str):
        self.modulation = modulation
        self.rate = rate
        self._rebuild()

    @property
    def _ci_bits(self) -> int | None:
        if not self.channel_interleave:
            return None
        return self.cfg.bits_per_ofdm_symbol()

    def _light_lts_search(self, x):
        """LTS search against the DATA-mode layout, then the CONTROL
        profile's (DQPSK R1/4, pilot spacing 10) when the two differ.

        Control frames are transmitted with the hardened control profile
        (streaming_encoder.cpp:218-226), whose pilot layout — and hence LTS
        waveform — differs from a coherent data mode's (e.g. QAM16 spacing
        5).  The reference correlates only against the data-mode template
        and its own in-session control frames fail sync at coherent modes
        (measured: corr 0.57 < 0.62 gate on its own `ria ptx disconnect`
        at QAM16 R1/2); searching both templates fixes the asymmetry here
        and still decodes reference peers' control frames.

        Returns the winning search's scalars on the host:
        (detected, lts_start, corr, cfo_hz, repeats)."""
        res = _lts_scalars(ofdm.lts_search(x, self.cfg))
        if res[0]:
            return res
        _, data_bins, _ = ofdm.carrier_layout(self.cfg)
        _, ctrl_bins, _ = ofdm.carrier_layout(self.ctrl_cfg)
        if np.array_equal(data_bins, ctrl_bins):
            return res
        res2 = _lts_scalars(ofdm.lts_search(x, self.ctrl_cfg))
        return res2 if res2[0] else res

    def _light_sync(self, x):
        """The light-preamble sync dict of both OFDM waveforms."""
        detected, start, corr, cfo, repeats = self._light_lts_search(x)
        if not detected:
            return None
        return {"start": int(start), "cfo_hz": cfo, "corr": corr, "kind": "lts",
                "lts_repeats": int(repeats)}

    def _encode(self, frame_bytes: bytes):
        """-> (bits, cfg_used, is_ctrl)."""
        if _is_control_bytes(frame_bytes):
            cw_bits = encode_frame_ldpc(frame_bytes, "R1_4", None)
            return cw_bits.reshape(-1), self.ctrl_cfg, True
        bits = encode_fixed_frame(frame_bytes, self.rate, self._ci_bits)
        return bits, self.cfg, False

    def frame_samples(self, num_codewords: int = 4, control: bool = False) -> int:
        cfg = self.ctrl_cfg if control else self.cfg
        S = cfg.num_symbols_for_bits(num_codewords * LDPC_BITS)
        return self.preamble_samples() + (2 + S) * cfg.symbol_samples

    # ------------------------------------------------------------- bursts
    # Stream-packed burst groups under one light preamble (3 LTS = burst
    # marker): frame 0 full + compressed continuation records, striped
    # across ceil(stream/bpc) codewords (see frame_v2 burst section).
    # Shared by the chirp and Schmidl-Cox OFDM waveforms.

    BURST_TRAINING = 3  # LTS repeats marking a burst (see LTSSyncResult.repeats)

    def burst_codewords(self, group: int) -> int:
        return burst_stream_codewords(group, self.rate)

    def burst_samples(self, group: int) -> int:
        """Samples from the sync point (first LTS) to burst end."""
        S = self.cfg.num_symbols_for_bits(self.burst_codewords(group) * LDPC_BITS)
        return (self.BURST_TRAINING + S) * self.cfg.symbol_samples

    def tx_burst(self, frames: list[bytes], tx_cfo_hz: float = 0.0) -> np.ndarray | None:
        """One light preamble carrying len(frames) stream-packed frames
        (reference encodeBurstLight, streaming_encoder.cpp:302, with header
        compression — strictly less air than the reference's per-frame
        layout).  None when the group is not compressible (caller sends the
        frames standalone).

        Bursts skip the per-CW channel interleave on purpose: the stripe
        interleave already spreads every codeword across the full group's
        symbols, and the channel perm's arithmetic-progression comb sits on
        the LDPC code's stopping sets under contiguous fades (measured in
        round 2: 0-2/4 logical frames survive with the perm, 4/4 without)."""
        bits = _burst_tx_bits(frames, self.rate)
        if bits is None:
            return None
        return ofdm.tx_frame(bits, self.cfg, preamble="lts",
                             training_count=self.BURST_TRAINING,
                             tx_cfo_hz=tx_cfo_hz)

    def rx_burst(self, audio, group: int, sync: dict | None = None):
        """Returns ([(ok, frame_bytes)] per logical frame, snr_db,
        fading_index), or None when no sync."""
        audio = as_audio(audio, self.device)
        if sync is None:
            sync = self.detect_sync(audio, light=True)
        if sync is None:
            return None
        num_bits = self.burst_codewords(group) * LDPC_BITS
        soft, res = self._demod(audio, sync["start"], sync["cfo_hz"], self.cfg,
                                num_bits, training=self.BURST_TRAINING)
        out = _burst_rx_decode(soft, group, self.rate, self.device)
        self._pre_start = sync["start"]
        snr = _tracked_snr(self, audio, sync["start"], self.burst_samples(group),
                           sync["start"])
        return out, snr, host_scalars(res.fading_index)[0]

    # -------------------------------------------------------------- RX core
    def _demod(self, audio: AudioBuffer, lts_start, cfo, cfg, num_bits, training: int = 2):
        S = cfg.num_symbols_for_bits(num_bits)
        need = (training + S) * cfg.symbol_samples
        res = ofdm.demodulate_presynced(audio.chunk(lts_start, need),
                                        cfo_tensor(cfo, audio.device), cfg, S, training)
        return res.soft_bits[:num_bits].cpu().numpy(), res

    def _spectral_snr(self, audio, lts_start, cfg, num_bits) -> float:
        # Mode-negotiation SNR: spectral excess-over-floor (dsp/snr.py) in
        # the simulator's full-band-noise convention; the equalizer's EVM
        # estimate stays internal (LLR scaling, diagnostics).
        S = cfg.num_symbols_for_bits(num_bits)
        need = (2 + S) * cfg.symbol_samples
        # Inter-frame-gap noise floor (see _noise_ref); pre_start = where
        # this frame's over-the-air signal begins (acquisition preamble).
        pre = self._pre_start if self._pre_start is not None \
            else lts_start - 2 * cfg.symbol_samples
        return _tracked_snr(self, audio, lts_start, need, pre)

    def _rx_at(self, audio, lts_start, cfo, chase=None) -> RxFrame:
        # Control fast path: DQPSK R1/4 single codeword.
        soft0, res0 = self._demod(audio, lts_start, cfo, self.ctrl_cfg, LDPC_BITS)
        ok0, chunk0 = decode_codewords(soft0[None, :], "R1_4", None, device=self.device)
        if ok0[0]:
            header = parse_header(chunk0[0])
            if header is not None and header["is_control"]:
                okc, fbc = _control_crc_gate(chunk0[0][:20], soft0, "R1_4", self.device)
                if okc:
                    return RxFrame(True, fbc, header, ok0, soft0,
                                   snr_db=self._spectral_snr(audio, lts_start,
                                                             self.ctrl_cfg, LDPC_BITS),
                                   fading_index=host_scalars(res0.fading_index)[0],
                                   cfo_hz=cfo, start_sample=lts_start)
                # CRC-invalid "control" decode: fall through to the data path.

        # Data path: fixed 4-CW frame at the negotiated profile.
        num_bits = 4 * LDPC_BITS
        soft, res = self._demod(audio, lts_start, cfo, self.cfg, num_bits)
        # Constellation feed (reference GUI snapshots): equalized symbols.
        self.last_symbols = res.symbols.cpu().numpy().reshape(-1)
        oks, frame_bytes, cw_raw, chunks = decode_fixed_frame(
            soft, self.rate, self._ci_bits, return_detail=True, device=self.device)
        if frame_bytes is None and self._ci_bits:
            # "Try both" raw vs channel-interleaved (reference
            # streaming_decoder.cpp:2821-2960) — but keep the primary
            # decode's per-CW flags when the fallback also fails, so chase
            # keying and stats reflect the real (interleaved) attempt.
            oks2, frame_bytes = decode_fixed_frame(soft, self.rate, None, device=self.device)
            if frame_bytes is not None:
                oks = oks2
        # HARQ chase combining for OFDM fixed frames (reference gets its
        # ~3 dB/doubling on EVERY waveform, chase_cache.hpp:27-168; before
        # round 4 only the MC-DPSK path combined): accumulate failed CWs'
        # raw LLRs across selective-repeat retransmissions and retry on
        # the sums.  cw_raw is fully deinterleaved, so ci=None here.  The
        # chase key needs the header; when CW0 itself faded, recover it
        # from CW0's parity-valid decode CANDIDATES — the 16-bit header
        # CRC arbitrates, so a wrong candidate cannot mint a key (fixed
        # frames fade across ALL 4 CWs thanks to the frame interleave, so
        # the CW0-decoded-only policy would skip most chase opportunities).
        if frame_bytes is None and chase is not None:
            h = parse_header(chunks[0])  # 16-bit header CRC arbitrates
            if h is None:
                for _m, info in decode_candidates(
                        cw_raw[:1], self.rate, device=self.device)[0]:
                    hc = parse_header(bits_to_bytes(np.asarray(info))[:20])
                    if hc is not None:
                        h = hc
                        break
            if h is not None and not h["is_control"]:
                fb_c = _chase_combine_fixed(chase, h, cw_raw, self.rate, self.device)
                if fb_c is not None:
                    oks = np.ones_like(oks)
                    frame_bytes = fb_c
        ok = frame_bytes is not None
        if ok and chase is not None:
            h_ok = parse_header(frame_bytes[:20])
            if h_ok is not None and not h_ok["is_control"]:
                chase.remove(ChaseKey(h_ok["seq"], h_ok["src_hash"],
                                      h_ok["dst_hash"]))
        header = parse_header(frame_bytes[:20]) if ok else None
        if ok and header is not None and not header["is_control"]:
            ok = DataFrame.deserialize(frame_bytes) is not None
        return RxFrame(ok and header is not None, frame_bytes, header, oks, soft,
                       snr_db=self._spectral_snr(audio, lts_start, self.cfg, num_bits),
                       fading_index=host_scalars(res.fading_index)[0],
                       cfo_hz=cfo, start_sample=lts_start)


def _burst_tx_bits(frames: list[bytes], rate: str) -> np.ndarray | None:
    """Encode N frames as ONE stream-packed burst (frame 0 full + compressed
    continuation records, frame_v2.build_burst_stream) -> striped coded
    bits [ncw*648].  None when the group is not compressible (caller falls
    back to standalone frames).  Encoded on the host, each chunk zero-padded
    to k bits as ``LDPCCodec.encode`` pads a one-block input."""
    stream = build_burst_stream(frames, rate)
    if stream is None:
        return None
    bpc = bytes_per_codeword(rate)
    ncw = burst_stream_codewords(len(frames), rate)
    padded = stream.ljust(ncw * bpc, b"\x00")
    cw_bits = _encode_chunks([padded[i * bpc : (i + 1) * bpc] for i in range(ncw)], rate)
    return stripe_interleave(cw_bits)


def _burst_rx_decode(soft: np.ndarray, group: int, rate: str,
                     device: str | torch.device = "cuda"):
    """[ncw*648] striped soft bits -> list of (ok, frame_bytes|None)."""
    ncw = burst_stream_codewords(group, rate)
    cw_soft = stripe_deinterleave(np.asarray(soft[: ncw * LDPC_BITS], np.float32), ncw)
    result = decode_with_retries(cw_soft, rate, device=device)
    oks = result.success.cpu().numpy()
    bpc = bytes_per_codeword(rate)
    infos = result.info_bits.cpu().numpy()
    stream = b"".join(bits_to_bytes(infos[i])[:bpc] for i in range(ncw))
    return parse_burst_stream(stream, oks, group, rate)


class OFDMCoxWaveform(_OFDMWaveformBase):
    """OFDM with Schmidl-Cox sync ("OFDM-COX", stable/NVIS channels).

    Connected-mode data frames use the same LTS-only light preamble as the
    chirp waveform (the CFO is already tracked once connected, so the STS
    autocorrelation stage buys nothing), which also enables stream-packed
    bursts on the coherent QAM modes — the reference always resends the
    full Schmidl-Cox preamble per frame (ofdm_cox_waveform.cpp)."""

    mode = WaveformMode.OFDM_COX

    def preamble_samples(self) -> int:
        return self.cfg.preamble_samples

    def tx_frame(self, frame_bytes: bytes, light: bool = False,
                 tx_cfo_hz: float = 0.0) -> np.ndarray:
        bits, cfg, _ = self._encode(frame_bytes)
        if light:
            return ofdm.tx_frame(bits, cfg, preamble="lts", training_count=2,
                                 tx_cfo_hz=tx_cfo_hz)
        return ofdm.tx_frame(bits, cfg, preamble="cox", tx_cfo_hz=tx_cfo_hz)

    def search_window(self, light: bool = False) -> int:
        return 48000

    def search_overlap(self, light: bool = False) -> int:
        # STS + LTS region plus margin.
        return 4 * self.cfg.symbol_samples + 2048

    def detect_sync(self, audio, light: bool = False):
        x = as_audio(audio, self.device).samples
        if light:
            return self._light_sync(x)
        res = ofdm.schmidl_cox_search(x, self.cfg)
        detected, start, cfo, metric = host_scalars(res.detected, res.lts_start, res.cfo_hz,
                                                    res.metric)
        if not detected:
            return None
        return {"start": int(start), "cfo_hz": cfo, "corr": metric, "kind": "sc"}

    def rx_frame(self, audio, light: bool = False, chase=None,
                 sync: dict | None = None) -> RxFrame:
        audio = as_audio(audio, self.device)
        if sync is None:
            sync = self.detect_sync(audio, light)
        if sync is None:
            return RxFrame(False, None, None, None, None)
        self._pre_start = (sync["start"] if sync.get("kind") == "lts"
                           else sync["start"] - 2 * self.cfg.symbol_samples)  # STS
        return self._rx_at(audio, sync["start"], sync["cfo_hz"], chase=chase)


class OFDMChirpWaveform(_OFDMWaveformBase):
    """OFDM with dual-chirp acquisition + LTS; LTS-only light preamble.

    Burst mode (tx_burst/rx_burst, shared via _OFDMWaveformBase): one
    light preamble carries a stream-packed group (see frame_v2 burst
    section).  Burst mode is negotiated by the protocol (explicit group
    size) rather than signalled by a negated LTS as in the reference —
    magnitude-based LTS correlation cannot carry the sign, and the
    negotiated path avoids the ambiguity.
    """

    mode = WaveformMode.OFDM_CHIRP

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.chirp_cfg = chirp_sync.ChirpConfig()

    def preamble_samples(self) -> int:
        return self.chirp_cfg.total_samples

    def tx_frame(self, frame_bytes: bytes, light: bool = False,
                 tx_cfo_hz: float = 0.0) -> np.ndarray:
        bits, cfg, _ = self._encode(frame_bytes)
        body = ofdm.tx_frame(bits, cfg, preamble="lts", training_count=2,
                             tx_cfo_hz=tx_cfo_hz)
        if light:
            return body
        chirp = chirp_sync.generate(self.chirp_cfg, tx_cfo_hz)
        return np.concatenate([chirp, body]).astype(np.float32)

    def search_window(self, light: bool = False) -> int:
        return 48000 if light else 120000

    def search_overlap(self, light: bool = False) -> int:
        return (4 * self.cfg.symbol_samples + 2048 if light
                else self.chirp_cfg.total_samples + 4800)

    def detect_sync(self, audio, light: bool = False):
        x = as_audio(audio, self.device).samples
        if light:
            return self._light_sync(x)
        return _chirp_sync_dict(x, self.chirp_cfg)

    def rx_frame(self, audio, light: bool = False, chase=None,
                 sync: dict | None = None) -> RxFrame:
        audio = as_audio(audio, self.device)
        if sync is None:
            sync = self.detect_sync(audio, light)
        if sync is None:
            return RxFrame(False, None, None, None, None)
        # Signal begin: the chirp for acquisition frames; the LTS itself
        # (== sync start) for light frames, whose gap sits directly before.
        self._pre_start = (sync["start"] - self.chirp_cfg.total_samples
                           if sync.get("kind") == "chirp" else sync["start"])
        return self._rx_at(audio, sync["start"], sync["cfo_hz"], chase=chase)


class OTFSWaveform:
    """OTFS with ZC sync (experimental Good/Poor channels, reference
    otfs_waveform.{hpp,cpp}).  Each protocol codeword group rides one or
    more OTFS frames, each with its own 4-symbol channel-estimation
    preamble, after a single ZC acquisition preamble."""

    mode = WaveformMode.OTFS_EQ
    fallback_cw = 1
    header_required = True

    def __init__(self, modulation: str = "QPSK", rate: str = "R1_4",
                 raw_dd: bool = False, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        full_fp32_matmul()
        self.rate = rate
        self.modulation = modulation
        self.raw = raw_dd
        self.cfg = otfs.OTFSConfig(modulation=modulation,
                                   dd_differential=raw_dd,
                                   tf_equalization=not raw_dd,
                                   phase_tracking=not raw_dd)
        if raw_dd:
            self.mode = WaveformMode.OTFS_RAW
        self.zc_cfg = zc_sync.ZCConfig()

    def configure(self, modulation: str, rate: str):
        self.modulation = modulation
        self.rate = rate
        self.cfg = otfs.OTFSConfig(modulation=modulation,
                                   dd_differential=self.raw,
                                   tf_equalization=not self.raw,
                                   phase_tracking=not self.raw)

    def _frames_for_bits(self, num_bits: int) -> int:
        return -(-num_bits // self.cfg.bits_per_frame())

    def tx_frame(self, frame_bytes: bytes, light: bool = False,
                 tx_cfo_hz: float = 0.0) -> np.ndarray:
        cw_bits, is_ctrl = _encode_with_cw_patch(frame_bytes, self.rate, None)
        bits = cw_bits.reshape(-1)
        per = self.cfg.bits_per_frame()
        K = self._frames_for_bits(len(bits))
        padded = np.zeros(K * per, np.int64)
        padded[: len(bits)] = bits
        ftype = zc_sync.ZC_CONTROL if is_ctrl else zc_sync.ZC_DATA
        parts = [zc_sync.generate_preamble(self.zc_cfg, ftype)]
        for k in range(K):
            parts.append(otfs.tx_frame(padded[k * per : (k + 1) * per], self.cfg))
        return np.concatenate(parts).astype(np.float32)

    def search_window(self, light: bool = False) -> int:
        return 48000

    def search_overlap(self, light: bool = False) -> int:
        return self.zc_cfg.preamble_samples + 2048

    def peek_header(self, audio, start: int, cfo: float, light: bool = False):
        audio = as_audio(audio, self.device)
        soft0, _ = self._demod_bits(audio, start, cfo, LDPC_BITS)
        ok0, chunk0 = decode_codewords(soft0[None, :], self.rate, None, device=self.device)
        return parse_header(chunk0[0]) if ok0[0] else None

    def detect_sync(self, audio, light: bool = False):
        return _zc_sync_dict(as_audio(audio, self.device).samples, self.zc_cfg)

    def _demod_bits(self, audio: AudioBuffer, start, cfo, num_bits):
        """(soft bits [num_bits] on the host, the demodulator's mean SNR as
        a device scalar).  The K OTFS frames of the span are consecutive, so
        they go through the demodulator as one [K, frame] batch."""
        per = self.cfg.bits_per_frame()
        K = self._frames_for_bits(num_bits)
        frame_len = self.cfg.preamble_samples + self.cfg.frame_samples
        chunks = audio.chunk(start, K * frame_len).reshape(K, frame_len)
        res = otfs.demodulate_presynced(chunks, cfo_tensor(cfo, audio.device).expand(K),
                                        self.cfg)
        soft = res.soft_bits[:, :per].reshape(-1)[:num_bits]
        return soft.cpu().numpy(), res.snr_db.mean()

    def frame_samples(self, num_codewords: int, light: bool = False) -> int:
        K = self._frames_for_bits(num_codewords * LDPC_BITS)
        return self.zc_cfg.preamble_samples + K * (self.cfg.preamble_samples
                                                   + self.cfg.frame_samples)

    def rx_frame(self, audio, light: bool = False, chase=None,
                 sync: dict | None = None) -> RxFrame:
        audio = as_audio(audio, self.device)
        if sync is None:
            sync = self.detect_sync(audio)
        if sync is None:
            return RxFrame(False, None, None, None, None)
        start, cfo = sync["start"], sync["cfo_hz"]
        soft0, _ = self._demod_bits(audio, start, cfo, LDPC_BITS)
        ok0, chunk0 = decode_codewords(soft0[None, :], self.rate, None, device=self.device)
        header = parse_header(chunk0[0]) if ok0[0] else None
        if header is None:
            return RxFrame(False, None, None, None, soft0, cfo_hz=cfo, start_sample=start)
        total_cw = 1 if header["is_control"] else max(1, int(header["total_cw"]))
        soft, _ = self._demod_bits(audio, start, cfo, total_cw * LDPC_BITS)
        oks, chunks = decode_codewords(soft.reshape(total_cw, LDPC_BITS), self.rate, None,
                                       device=self.device)
        oks = np.array(oks)
        frame_bytes = reassemble_codewords(list(chunks), self.rate) if oks.all() else None
        ok = bool(oks.all())
        if header["is_control"]:
            ok, frame_bytes = _control_crc_gate(frame_bytes if ok else None,
                                                soft[:LDPC_BITS], self.rate, self.device)
        elif ok:
            ok = DataFrame.deserialize(frame_bytes) is not None
        K = self._frames_for_bits(total_cw * LDPC_BITS)
        ext = K * (self.cfg.preamble_samples + self.cfg.frame_samples)
        snr = _tracked_snr(self, audio, start, ext,
                           start - self.zc_cfg.preamble_samples)
        return RxFrame(ok, frame_bytes, header, oks, soft, snr_db=snr,
                       cfo_hz=cfo, start_sample=start)


class MFSKWaveform:
    """MFSK last-resort CONNECT waveform (-17..+3 dB; reference
    mfsk_waveform.{hpp,cpp})."""

    mode = WaveformMode.MFSK
    fallback_cw = 1
    header_required = True

    def __init__(self, num_tones: int = 8, rate: str = "R1_4", modulation: str = "MFSK",
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.rate = rate
        self.modulation = modulation
        self.cfg = mfsk.MFSKConfig(num_tones=num_tones)

    def configure(self, modulation: str, rate: str):
        self.rate = rate

    def tx_frame(self, frame_bytes: bytes, light: bool = False,
                 tx_cfo_hz: float = 0.0) -> np.ndarray:
        cw_bits, _ = _encode_with_cw_patch(frame_bytes, self.rate, None)
        return mfsk.tx_frame(cw_bits.reshape(-1), self.cfg)

    def frame_samples(self, num_codewords: int, light: bool = False) -> int:
        return self.cfg.frame_samples(num_codewords * LDPC_BITS)

    def search_window(self, light: bool = False) -> int:
        return 96000

    def search_overlap(self, light: bool = False) -> int:
        return self.cfg.preamble_samples + 3072

    def _demod_fixed(self, audio: AudioBuffer, start: int, num_bits: int):
        """Zero-padded fixed-size demod slice (one cached module per
        num_bits, independent of the caller's buffer length)."""
        need = (self.cfg.num_symbols_for_bits(num_bits)
                * self.cfg.repetition * self.cfg.samples_per_symbol)
        res = mfsk.demodulate(audio.chunk(start, need), self.cfg, num_bits)
        return res.soft_bits.cpu().numpy(), res

    def peek_header(self, audio, start: int, cfo: float, light: bool = False):
        soft0, _ = self._demod_fixed(as_audio(audio, self.device), start, LDPC_BITS)
        ok0, chunk0 = decode_codewords(soft0[None, :], self.rate, None, device=self.device)
        return parse_header(chunk0[0]) if ok0[0] else None

    def detect_sync(self, audio, light: bool = False):
        res = mfsk.find_preamble(as_audio(audio, self.device).samples, self.cfg)
        detected, start, score = host_scalars(res.detected, res.data_start, res.score)
        if not detected:
            return None
        return {"start": int(start), "cfo_hz": 0.0, "corr": score, "kind": "mfsk"}

    def rx_frame(self, audio, light: bool = False, chase=None,
                 sync: dict | None = None) -> RxFrame:
        audio = as_audio(audio, self.device)
        if sync is None:
            sync = self.detect_sync(audio)
        if sync is None:
            return RxFrame(False, None, None, None, None)
        start = sync["start"]

        def demod(nbits):
            return self._demod_fixed(audio, start, nbits)

        soft0, _ = demod(LDPC_BITS)
        ok0, chunk0 = decode_codewords(soft0[None, :], self.rate, None, device=self.device)
        header = parse_header(chunk0[0]) if ok0[0] else None
        if header is None:
            return RxFrame(False, None, None, None, soft0, start_sample=start)
        total_cw = 1 if header["is_control"] else max(1, int(header["total_cw"]))
        soft, res = demod(total_cw * LDPC_BITS)
        oks, chunks = decode_codewords(soft.reshape(total_cw, LDPC_BITS), self.rate, None,
                                       device=self.device)
        oks = np.array(oks)
        frame_bytes = reassemble_codewords(list(chunks), self.rate) if oks.all() else None
        ok = bool(oks.all())
        if header["is_control"]:
            ok, frame_bytes = _control_crc_gate(frame_bytes if ok else None,
                                                soft[:LDPC_BITS], self.rate, self.device)
        elif ok:
            ok = DataFrame.deserialize(frame_bytes) is not None
        ext = (self.cfg.frame_samples(total_cw * LDPC_BITS)
               - self.cfg.preamble_samples)
        snr = _tracked_snr(self, audio, start, ext,
                           start - self.cfg.preamble_samples)
        return RxFrame(ok, frame_bytes, header, oks, soft,
                       snr_db=snr, start_sample=start)


class DPSKWaveform:
    """Single-carrier DPSK with Barker-13x3 sync (reference src/psk/dpsk.hpp:
    Barker preamble :108-140, presets :1118).  The reference's lowest-rate
    robust waveform: one carrier at 1500 Hz concentrates all TX power in
    ~60 Hz of bandwidth — ~16 dB/Hz denser than 10-carrier MC-DPSK — at
    31.25-93.75 baud.  Niche: very-low-SNR point-to-point links and raw-PING
    parity workflows; never auto-negotiated (the selection ladder prefers
    MC-DPSK's diversity + throughput on fading HF channels)."""

    mode = WaveformMode.DPSK
    fallback_cw = 1
    header_required = True

    def __init__(self, modulation: str = "DQPSK", rate: str = "R1_4",
                 samples_per_symbol: int = 512, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.modulation = modulation
        self.rate = rate
        self.cfg = dpsk.DPSKConfig(
            bits_per_symbol={"DBPSK": 1, "DQPSK": 2, "D8PSK": 3}.get(modulation, 2),
            samples_per_symbol=samples_per_symbol)

    def configure(self, modulation: str, rate: str):
        self.modulation = modulation
        self.rate = rate
        self.cfg = replace(
            self.cfg,
            bits_per_symbol={"DBPSK": 1, "DQPSK": 2, "D8PSK": 3}.get(modulation, 2))

    def tx_frame(self, frame_bytes: bytes, light: bool = False,
                 tx_cfo_hz: float = 0.0) -> np.ndarray:
        cw_bits, _ = _encode_with_cw_patch(frame_bytes, self.rate, None)
        return dpsk.tx_frame(cw_bits.reshape(-1), self.cfg)

    def frame_samples(self, num_codewords: int, light: bool = False) -> int:
        return self.cfg.frame_samples(num_codewords * LDPC_BITS)

    def search_window(self, light: bool = False) -> int:
        return 96000

    def search_overlap(self, light: bool = False) -> int:
        return self.cfg.preamble_samples + self.cfg.samples_per_symbol

    def _demod_fixed(self, audio: AudioBuffer, start: int, num_bits: int):
        S = self.cfg.num_symbols_for_bits(num_bits)
        need = (S + 1) * self.cfg.samples_per_symbol
        res = dpsk.demodulate(audio.chunk(start, need), self.cfg, num_bits)
        return res.soft_bits.cpu().numpy(), res

    def peek_header(self, audio, start: int, cfo: float, light: bool = False):
        soft0, _ = self._demod_fixed(as_audio(audio, self.device), start, LDPC_BITS)
        ok0, chunk0 = decode_codewords(soft0[None, :], self.rate, None, device=self.device)
        return parse_header(chunk0[0]) if ok0[0] else None

    def detect_sync(self, audio, light: bool = False):
        res = dpsk.find_preamble(as_audio(audio, self.device).samples, self.cfg)
        detected, start, corr = host_scalars(res.detected, res.data_start, res.corr)
        if not detected:
            return None
        return {"start": int(start), "cfo_hz": 0.0, "corr": corr, "kind": "barker"}

    def rx_frame(self, audio, light: bool = False, chase=None,
                 sync: dict | None = None) -> RxFrame:
        audio = as_audio(audio, self.device)
        if sync is None:
            sync = self.detect_sync(audio)
        if sync is None:
            return RxFrame(False, None, None, None, None)
        start = sync["start"]
        soft0, _ = self._demod_fixed(audio, start, LDPC_BITS)
        ok0, chunk0 = decode_codewords(soft0[None, :], self.rate, None, device=self.device)
        header = parse_header(chunk0[0]) if ok0[0] else None
        if header is None:
            return RxFrame(False, None, None, None, soft0, start_sample=start)
        total_cw = 1 if header["is_control"] else max(1, int(header["total_cw"]))
        soft, res = self._demod_fixed(audio, start, total_cw * LDPC_BITS)
        oks, chunks = decode_codewords(soft.reshape(total_cw, LDPC_BITS),
                                       self.rate, None, device=self.device)
        oks = np.array(oks)
        frame_bytes = reassemble_codewords(list(chunks), self.rate) if oks.all() else None
        ok = bool(oks.all())
        if header["is_control"]:
            ok, frame_bytes = _control_crc_gate(frame_bytes if ok else None,
                                                soft[:LDPC_BITS], self.rate, self.device)
        elif ok:
            ok = DataFrame.deserialize(frame_bytes) is not None
        ext = self.frame_samples(total_cw) - self.cfg.preamble_samples
        snr = _tracked_snr(self, audio, start, ext,
                           start - self.cfg.preamble_samples)
        return RxFrame(ok, frame_bytes, header, oks, soft, snr_db=snr,
                       cfo_hz=0.0, start_sample=start)


def create_waveform(mode: WaveformMode, modulation: str | None = None,
                    rate: str | None = None, **kw):
    """WaveformFactory equivalent (waveform_factory.hpp:18-60).  ``device``
    (a keyword, default the card) passes on to the waveform."""
    if mode == WaveformMode.MC_DPSK:
        return MCDPSKWaveform(modulation=modulation or "DBPSK",
                              rate=rate or "R1_4", **kw)
    if mode == WaveformMode.OFDM_CHIRP:
        return OFDMChirpWaveform(modulation=modulation or "DQPSK",
                                 rate=rate or "R1_2", **kw)
    if mode == WaveformMode.OFDM_COX:
        return OFDMCoxWaveform(modulation=modulation or "QPSK",
                               rate=rate or "R1_2", **kw)
    if mode == WaveformMode.OTFS_EQ:
        return OTFSWaveform(modulation=modulation or "QPSK", rate=rate or "R1_4",
                            raw_dd=False, **kw)
    if mode == WaveformMode.OTFS_RAW:
        return OTFSWaveform(modulation=modulation or "QPSK", rate=rate or "R1_4",
                            raw_dd=True, **kw)
    if mode == WaveformMode.MFSK:
        return MFSKWaveform(rate=rate or "R1_4", **kw)
    if mode == WaveformMode.DPSK:
        return DPSKWaveform(modulation=modulation or "DQPSK",
                            rate=rate or "R1_4", **kw)
    if mode == WaveformMode.AFDM:
        from ria_tpu_torch.wave.afdm import AFDMWaveform

        return AFDMWaveform(rate=rate or "R1_4", **kw)
    raise NotImplementedError(f"waveform mode {mode}")
