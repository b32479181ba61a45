"""Single frames for the waveform API: the reference modem's captures, one
clean frame per waveform class, and the card-against-CPU comparison.

Test and bench harness, like ``tools/waveform_paths.py``: what
``chip_smoke.py`` (phase 4d) and ``tests/test_torch_waveform_api_cuda.py``
drive through ``create_waveform(...).rx_frame`` on the card and hold against
the same call with ``device="cpu"``.

- :data:`CAPTURES`: the 11 data captures of ``tests/golden/interop`` (audio
  of the reference C++ modem's ``ria ptx``), each with the waveform that
  decodes it; payload ``b"HELLO INTEROP"`` from ``ALPHA`` to ``BRAVO``.
- :data:`CLEAN_FRAMES`: one frame per waveform class from the port's own
  TX, with seeded numpy AWGN at an SNR the class decodes with margin.
- :data:`NOISY_FRAMES`: two frames near their decode floor, where K1 runs
  several iterations at B = 1 and B = 4.
- :func:`counted_k1` and :func:`hold_k1_calls`: every K1 call one
  ``rx_frame`` makes, held against the plain decoder on the same inputs,
  bit for bit.
- :func:`same_rx`: ok, frame bytes, header, per-CW flags and start equal;
  CFO, SNR, fading index and the channel probe within 1e-3; soft bits
  within 2e-3.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from ria_tpu_torch.fec.ldpc import LDPCDecoder
from ria_tpu_torch.phy.frame_v2 import (
    ControlFrame, DataFrame, WaveformMode, hash_callsign, make_fixed_data_frame,
)
from ria_tpu_torch.phy.modem import RxFrame
from ria_tpu_torch.utils.cuda_kernels import launches, reset_launches
from ria_tpu_torch.wave.api import create_waveform

CAPTURE_DIR = Path(__file__).resolve().parents[2] / "tests" / "golden" / "interop"
CAPTURE_PAYLOAD = b"HELLO INTEROP"
PING_CAPTURE = "ref_ping.f32"
# (fixture, waveform, modulation, rate): REF_TO_US of tests/test_interop.py.
CAPTURES = (
    ("ref_ofdm_dqpsk_r1_4.f32", "OFDM_CHIRP", "DQPSK", "R1_4"),
    ("ref_ofdm_dqpsk_r1_2.f32", "OFDM_CHIRP", "DQPSK", "R1_2"),
    ("ref_ofdm_dqpsk_r2_3.f32", "OFDM_CHIRP", "DQPSK", "R2_3"),
    ("ref_ofdm_dqpsk_r3_4.f32", "OFDM_CHIRP", "DQPSK", "R3_4"),
    ("ref_ofdm_d8psk_r1_2.f32", "OFDM_CHIRP", "D8PSK", "R1_2"),
    ("ref_ofdm_qam16_r1_2.f32", "OFDM_CHIRP", "QAM16", "R1_2"),
    ("ref_ofdm_qam32_r3_4.f32", "OFDM_CHIRP", "QAM32", "R3_4"),
    ("ref_cox_qpsk_r1_2.f32", "OFDM_COX", "QPSK", "R1_2"),
    ("ref_cox_qam16_r3_4.f32", "OFDM_COX", "QAM16", "R3_4"),
    ("ref_cox_qam64_r3_4.f32", "OFDM_COX", "QAM64", "R3_4"),
    ("ref_mcdpsk_dqpsk_r1_4.f32", "MC_DPSK", "DQPSK", "R1_4"),
)

PAYLOAD = b"The quick brown fox jumps over the lazy dog"
SRC, DST, SEQ = "W1AW", "VE3ABC", 3
RX_TOL = 1e-3     # cfo_hz, snr_db, fading index, channel probe
SOFT_TOL = 2e-3   # soft bits


@dataclass(frozen=True)
class CleanFrame:
    """One waveform class's clean frame: what is sent and at which SNR."""

    name: str            # the waveform class
    mode: str
    modulation: str | None
    rate: str
    light: bool
    payload: bytes
    snr_db: float
    lead: int = 3000


CLEAN_FRAMES = (
    CleanFrame("MCDPSKWaveform", "MC_DPSK", "DBPSK", "R1_4", False, PAYLOAD, 5.0),
    CleanFrame("OFDMChirpWaveform", "OFDM_CHIRP", "DQPSK", "R1_2", False, PAYLOAD, 15.0),
    CleanFrame("OFDMCoxWaveform", "OFDM_COX", "QPSK", "R1_2", False, PAYLOAD, 20.0),
    CleanFrame("OTFSWaveform", "OTFS_EQ", "QPSK", "R1_4", False, PAYLOAD, 18.0),
    CleanFrame("OTFSWaveform[raw]", "OTFS_RAW", "QPSK", "R1_4", False, PAYLOAD, 18.0),
    CleanFrame("DPSKWaveform", "DPSK", "DQPSK", "R1_4", False, PAYLOAD, 6.0, 5000),
    CleanFrame("MFSKWaveform", "MFSK", None, "R1_4", False, b"hi", 3.0, 6000),
)
# Near the decode floor: the header codeword (B = 1) and the body's four
# (B = 4) each take two or three BP iterations, and the frame still decodes.
NOISY_FRAMES = (
    CleanFrame("MCDPSKWaveform", "MC_DPSK", "DBPSK", "R1_4", False, PAYLOAD, -10.0),
    CleanFrame("OFDMChirpWaveform", "OFDM_CHIRP", "DQPSK", "R1_2", False, PAYLOAD, 2.0),
)
VARIABLE_CW = ("MC_DPSK", "DPSK", "MFSK", "OTFS_EQ", "OTFS_RAW")


def capture(fixture: str) -> np.ndarray:
    """A capture's samples (float32, 48 kHz)."""
    return np.fromfile(CAPTURE_DIR / fixture, np.float32)


def awgn(tx: np.ndarray, snr_db: float, seed: int, lead: int = 3000,
         tail: int = 4000) -> np.ndarray:
    """``tx`` behind ``lead`` and before ``tail`` samples of silence, plus
    seeded Gaussian noise at ``snr_db`` below the frame's rms."""
    rng = np.random.default_rng(seed)
    audio = np.concatenate([np.zeros(lead, np.float32), np.asarray(tx, np.float32),
                            np.zeros(tail, np.float32)])
    rms = float(np.sqrt(np.mean(np.square(tx))))
    return audio + rng.normal(0, rms * 10 ** (-snr_db / 20), audio.shape).astype(np.float32)


def data_frame_bytes(mode: str, rate: str, payload: bytes = PAYLOAD) -> bytes:
    """The serialized data frame a waveform of ``mode`` carries: variable-CW
    for the serial waveforms, the fixed 4-CW frame for OFDM."""
    if mode in VARIABLE_CW:
        return DataFrame.make_data(SRC, DST, SEQ, payload).serialize()
    return make_fixed_data_frame(SRC, DST, SEQ, payload, rate).serialize()


def make_clean_frame(spec: CleanFrame, seed: int = 0,
                     device: str | torch.device = "cuda"):
    """(waveform on ``device``, audio as a host array, the frame bytes sent)."""
    wf = create_waveform(WaveformMode[spec.mode], spec.modulation, spec.rate, device=device)
    fb = data_frame_bytes(spec.mode, spec.rate, spec.payload)
    audio = awgn(wf.tx_frame(fb, light=spec.light), spec.snr_db, seed, lead=spec.lead)
    return wf, audio, fb


def rx_full_then_light(wf, audio) -> RxFrame:
    """The full preamble, then the light one: how the captures are read."""
    rx = wf.rx_frame(audio)
    if not rx.ok:
        rx = wf.rx_frame(audio, light=True)
    return rx


def check_capture_frame(rx: RxFrame, fixture: str) -> None:
    """The capture's frame: its payload and callsign hashes."""
    df = DataFrame.deserialize(rx.frame_bytes) if rx.ok else None
    if (df is None or df.payload != CAPTURE_PAYLOAD or df.src_hash != hash_callsign("ALPHA")
            or df.dst_hash != hash_callsign("BRAVO")):
        raise AssertionError(f"{fixture}: not decoded byte for byte (ok={rx.ok})")


def check_clean_frame(rx: RxFrame, spec: CleanFrame) -> None:
    g = DataFrame.deserialize(rx.frame_bytes) if rx.ok else None
    if g is None or g.seq != SEQ or g.payload.rstrip(b"\x00")[: len(spec.payload)] != spec.payload:
        raise AssertionError(f"{spec.name}: the clean frame did not decode (ok={rx.ok})")


def counted(fn):
    """(fn(), K1 launches, K2 launches of either build) of one call, the
    counters set to 0 just before it and read just after."""
    reset_launches()
    out = fn()
    return out, launches("ldpc_bp_decode"), (launches("ldpc_bp_v1_decode")
                                              + launches("ldpc_bp_v1_bf16_decode"))


def counted_k1(fn):
    """(fn(), K1 launches, K2 launches, K1 calls) of one call: ``counted``,
    and each K1 call on the card as (decoder, LLRs, factors, its result),
    for :func:`hold_k1_calls`."""
    calls = []

    def record(module, args, output):
        if isinstance(module, LDPCDecoder) and args[0].device.type == "cuda":
            calls.append((module, args[0].clone(), args[1].clone(), output))

    handle = torch.nn.modules.module.register_module_forward_hook(record)
    try:
        out, k1, k2 = counted(fn)
    finally:
        handle.remove()
    return out, k1, k2, calls


HOLD_ROWS = 8192  # rows of one plain decode in :func:`hold_k1_calls`


def hold_k1_calls(calls, tag: str = "") -> list[dict]:
    """Hold each recorded K1 result against the plain decoder on the same
    LLRs and factors.  The two sum every variable's messages in the same
    order, so every output of every row must be equal: success, iterations,
    info bits and posteriors, bit for bit.  A decoder's rows are
    independent, so the calls of one decoder are decoded by the plain
    decoder together, HOLD_ROWS rows at a time.  Returns one {"B", "k",
    "iterations", "converged", "max_abs_err"} per call; raises on a row that
    differs."""
    by_decoder: dict[int, list[int]] = {}
    for i, (dec, *_rest) in enumerate(calls):
        by_decoder.setdefault(id(dec), []).append(i)
    wants: list = [None] * len(calls)
    for idx in by_decoder.values():
        dec = calls[idx[0]][0]
        llrs = torch.cat([calls[i][1] for i in idx])
        factors = torch.cat([calls[i][2] for i in idx])
        parts = [dec.plain(llrs[j : j + HOLD_ROWS], factors[j : j + HOLD_ROWS])
                 for j in range(0, llrs.shape[0], HOLD_ROWS)]
        want = [torch.cat(field) for field in zip(*parts)]
        start = 0
        for i in idx:
            B = calls[i][1].shape[0]
            wants[i] = [t[start : start + B] for t in want]
            start += B
    rows = []
    for (dec, llrs, factors, got), want in zip(calls, wants):
        info_bits, success, iterations, llr_total = want
        err = (llr_total - got.llr_total).abs().amax(dim=1)
        bad = ((success != got.success) | (iterations != got.iterations)
               | (info_bits != got.info_bits).any(dim=1) | (llr_total != got.llr_total).any(dim=1))
        B = llrs.shape[0]
        if bool(bad.any()):
            detail = "; ".join(
                f"row {i}: plain success {bool(success[i])} after {int(iterations[i])}, K1 "
                f"{bool(got.success[i])} after {int(got.iterations[i])}, |llr err| "
                f"{float(err[i]):.3g}" for i in bad.nonzero().flatten().tolist())
            raise AssertionError(f"{tag}: K1 at B={B}, k={dec.k} differs from the plain decoder "
                                 f"on {detail}")
        rows.append({"B": B, "k": dec.k, "iterations": got.iterations.tolist(),
                     "converged": int(got.success.sum()), "max_abs_err": float(err.max())})
    return rows


def same_rx(got: RxFrame, want, tag: str = "") -> dict:
    """Hold one ``RxFrame`` against another device's, or against the
    reference package's on the same audio (any object with its fields);
    returns the largest errors by field, raises on a mismatch."""
    def header(h):
        return None if h is None else {k: int(v) for k, v in h.items()}

    for field in ("ok", "frame_bytes", "start_sample"):
        if getattr(got, field) != getattr(want, field):
            raise AssertionError(f"{tag}: {field} {getattr(got, field)!r} != "
                                 f"{getattr(want, field)!r}")
    if header(got.header) != header(want.header):
        raise AssertionError(f"{tag}: header {got.header} != {want.header}")
    for field in ("cw_ok", "soft_bits"):
        if (getattr(got, field) is None) != (getattr(want, field) is None):
            raise AssertionError(f"{tag}: {field} is None on one side only")
    if want.cw_ok is not None and not np.array_equal(got.cw_ok, np.asarray(want.cw_ok)):
        raise AssertionError(f"{tag}: cw_ok {got.cw_ok} != {want.cw_ok}")
    errs = {"soft_bits": 0.0}
    if want.soft_bits is not None:
        want_soft = np.asarray(want.soft_bits)
        if got.soft_bits.shape != want_soft.shape:
            raise AssertionError(f"{tag}: soft bits {got.soft_bits.shape} != {want_soft.shape}")
        errs["soft_bits"] = float(np.max(np.abs(got.soft_bits - want_soft)))
    for field in ("cfo_hz", "snr_db", "fading_index", "delay_spread_ms", "doppler_spread_hz"):
        errs[field] = abs(getattr(got, field) - getattr(want, field))
        if not errs[field] <= RX_TOL:
            raise AssertionError(f"{tag}: {field} {getattr(got, field)} vs "
                                 f"{getattr(want, field)}")
    if errs["soft_bits"] > SOFT_TOL:
        raise AssertionError(f"{tag}: soft bits differ by {errs['soft_bits']:.3g}")
    return errs


def control_frame_bytes(seq: int = 99) -> bytes:
    return ControlFrame.make_ack(SRC, hash_callsign(DST), seq=seq).serialize()
