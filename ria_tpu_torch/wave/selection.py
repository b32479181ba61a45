"""Waveform / modulation / rate selection tables.

Straight port of the reference's empirically verified decision tables
(src/protocol/waveform_selection.hpp:40-317) — these thresholds ARE the
product of the reference's seed-sweep testing and are treated as data:

- fading classes: <0.15 AWGN, <0.65 Good, <1.10 Moderate, else Heavy;
- MC-DPSK ladder: 4x spread below -7 dB (floor -14), 2x below -3 (floor -8),
  DBPSK below +5 (floor -4), DQPSK to +10 (floor +5);
- OFDM ladder: QAM64/32/16 R3/4 on AWGN at 25/22/18 dB, QAM16 R2/3 on good
  fading at 22 dB, DQPSK with selectOFDMCodeRate elsewhere;
- OFDM code rate: R3/4 AWGN>=20, R2/3 good>=20, R1/2 <1.10 fading >=15,
  else R1/4; handshake bootstrap caps R3/4->R2/3 and R2/3->R1/2 unless the
  channel is near-ideal.

Host tables only, copied from ``ria_tpu/wave/selection.py`` with every
threshold verbatim.
"""

from __future__ import annotations

from dataclasses import dataclass

from ria_tpu_torch.phy.frame_v2 import WaveformMode


@dataclass
class WaveformRecommendation:
    waveform: WaveformMode
    modulation: str
    rate: str
    spreading: int = 1
    num_carriers: int = 10
    estimated_throughput_bps: float = 0.0


def select_ofdm_code_rate(snr_db: float, fading_index: float) -> str:
    """Reference table (waveform_selection.hpp) with two measured upgrades:
    R2/3 on clean channels from 18 dB (10/10 seed bursts at 17-18 dB AWGN,
    QAM16 and DQPSK) and R1/2 on Good-class fading from 10 dB (95% burst
    decode at 10 dB Good, 10/10 at 12 — the reference needs 15 dB).  These
    rungs are what let the net steady bps beat the reference's published
    R1/4 and QAM16-R1/2 rows at their own operating points
    (docs/PARITY.md §6)."""
    if fading_index < 0.15 and snr_db >= 20.0:
        return "R3_4"
    if fading_index < 0.15 and snr_db >= 17.0:
        return "R2_3"
    if fading_index < 0.65 and snr_db >= 20.0:
        return "R2_3"
    if fading_index < 0.65 and snr_db >= 6.5:
        # Thresholds live in MEASURED-SNR units: per-frame spectral SNR on
        # a fading channel reads ~2.5-3 dB below the channel's true SNR
        # (fade-state dependent), so measured 7 == true ~10 — the
        # reference's published R1/4 row condition.  Floors: AWGN bursts
        # 10/10 at true 7 dB; Good-class G4 95% at true 10 (the ARQ covers
        # the tail, and R1/4's 1066 bps net is never the better answer
        # there).
        return "R1_2"
    if fading_index < 1.10 and snr_db >= 15.0:
        return "R1_2"
    return "R1_4"


def cap_initial_ofdm_rate(snr_db: float, fading_index: float, candidate: str) -> str:
    """Handshake-bootstrap rate caps (reference waveform_selection.hpp:65-83)
    — hold back the top rates until in-session frames confirm the channel,
    EXCEPT on a near-ideal read.  The near-ideal fading gate is the AWGN
    class boundary (0.15) used by every other table: the handshake probe's
    fading estimate floors at ~0.1 on clean channels, so the old 0.05 gate
    was unreachable and every 25 dB session burned its first burst cycles
    one rate down."""
    if candidate == "R3_4":
        if fading_index >= 0.15 or snr_db < 24.0:
            return "R2_3"
        return candidate
    if candidate == "R2_3":
        if fading_index >= 0.45 or snr_db < 24.0:
            return "R1_2"
    return candidate


def _dqpsk_bps(rate: str) -> float:
    return {"R3_4": 3900.0, "R2_3": 3200.0, "R1_2": 2300.0}.get(rate, 1150.0)


def recommend_waveform_and_rate(snr_db: float, fading_index: float) -> WaveformRecommendation:
    if snr_db < -7.0:
        return WaveformRecommendation(WaveformMode.MC_DPSK, "DBPSK", "R1_4",
                                      spreading=4, estimated_throughput_bps=117.0)
    if snr_db < -3.0:
        return WaveformRecommendation(WaveformMode.MC_DPSK, "DBPSK", "R1_4",
                                      spreading=2, estimated_throughput_bps=235.0)
    if snr_db < 5.0:
        return WaveformRecommendation(WaveformMode.MC_DPSK, "DBPSK", "R1_4",
                                      estimated_throughput_bps=469.0)
    if snr_db < 10.0:
        return WaveformRecommendation(WaveformMode.MC_DPSK, "DQPSK", "R1_4",
                                      estimated_throughput_bps=938.0)
    if fading_index < 0.15:
        if snr_db >= 24.0:
            # Rung at 24 dB measured, not the README's 25: the in-session
            # SNR estimate reads ~0.6 dB below the simulator's truth on
            # burst spans, and QAM64 R3/4 G16 bursts decode 10/10 seeds at
            # a true 24 dB AWGN (tests/test_burst.py::test_qam64_r34_rung)
            # — without this the 25 dB operating point negotiates QAM32
            # and the session goodput proof point (7.5 kbps) is
            # unreachable.
            return WaveformRecommendation(WaveformMode.OFDM_CHIRP, "QAM64", "R3_4",
                                          estimated_throughput_bps=7200.0)
        if snr_db >= 22.0:
            return WaveformRecommendation(WaveformMode.OFDM_CHIRP, "QAM32", "R3_4",
                                          estimated_throughput_bps=6000.0)
        if snr_db >= 17.0:
            rate = select_ofdm_code_rate(snr_db, fading_index)
            bps = {"R3_4": 4800.0, "R2_3": 4000.0, "R1_2": 3000.0}.get(rate, 1500.0)
            return WaveformRecommendation(WaveformMode.OFDM_CHIRP, "QAM16", rate,
                                          estimated_throughput_bps=bps)
        if snr_db >= 11.0:
            # Opportunistic D8PSK on clean channels (see recommend_data_mode);
            # handshake bootstrap starts at R1/2, the in-session adapter
            # lifts it to R2/3 once frames confirm the SNR.
            return WaveformRecommendation(WaveformMode.OFDM_CHIRP, "D8PSK", "R1_2",
                                          estimated_throughput_bps=3278.0)
        rate = select_ofdm_code_rate(snr_db, fading_index)
        return WaveformRecommendation(WaveformMode.OFDM_CHIRP, "DQPSK", rate,
                                      estimated_throughput_bps=_dqpsk_bps(rate))
    if fading_index < 0.65 and snr_db >= 10.0:
        if snr_db >= 22.0:
            return WaveformRecommendation(WaveformMode.OFDM_CHIRP, "QAM16", "R2_3",
                                          estimated_throughput_bps=4000.0)
        rate = select_ofdm_code_rate(snr_db, fading_index)
        return WaveformRecommendation(WaveformMode.OFDM_CHIRP, "DQPSK", rate,
                                      estimated_throughput_bps=_dqpsk_bps(rate))
    if fading_index < 1.10 and snr_db >= 10.0:
        rate = select_ofdm_code_rate(snr_db, fading_index)
        return WaveformRecommendation(WaveformMode.OFDM_CHIRP, "DQPSK", rate,
                                      estimated_throughput_bps=_dqpsk_bps(rate))
    if snr_db >= 10.0:
        return WaveformRecommendation(WaveformMode.OFDM_CHIRP, "DQPSK", "R1_4",
                                      estimated_throughput_bps=1150.0)
    return WaveformRecommendation(WaveformMode.MC_DPSK, "DQPSK", "R1_4",
                                  estimated_throughput_bps=938.0)


def recommend_data_mode(snr_db: float, waveform: WaveformMode,
                        fading_index: float = 0.0) -> tuple[str, str, int]:
    """(modulation, rate, spreading) for an established connection."""
    if waveform in (WaveformMode.OTFS_EQ, WaveformMode.OTFS_RAW):
        mod, rate = recommend_otfs_mode(snr_db)
        return mod, rate, 1
    if waveform == WaveformMode.MC_DPSK:
        if snr_db < -7.0:
            return "DBPSK", "R1_4", 4
        if snr_db < -3.0:
            return "DBPSK", "R1_4", 2
        if snr_db < 5.0:
            return "DBPSK", "R1_4", 1
        return "DQPSK", "R1_4", 1

    if fading_index < 0.15:
        if snr_db >= 25.0:
            return "QAM64", "R3_4", 1
        if snr_db >= 22.0:
            return "QAM32", "R3_4", 1
        if snr_db >= 17.0:
            # Rung in MEASURED-SNR units: the row's "18+ dB AWGN" reads
            # ~17.3 in-session; QAM16 R2/3 bursts measured 10/10 at 17.
            return "QAM16", select_ofdm_code_rate(snr_db, fading_index), 1
        # Opportunistic D8PSK (reference README.md D8PSK section: +50%
        # over DQPSK, "performs well in AWGN", shipped opportunistic-only).
        # Measured here (stream bursts, 10-seed sweeps): R2/3 and R1/2
        # clean at 11/9 dB AWGN, but only ~40-65% on Good-class fading
        # even at 18-20 dB (8-phase margins die in carrier fades), hence
        # the strict AWGN gate; 2 dB engagement margin.
        if snr_db >= 13.0:
            return "D8PSK", "R2_3", 1
        if snr_db >= 11.0:
            return "D8PSK", "R1_2", 1
    elif fading_index < 0.65:
        if snr_db >= 22.0:
            return "QAM16", "R2_3", 1
    return "DQPSK", select_ofdm_code_rate(snr_db, fading_index), 1


def recommend_otfs_mode(snr_db: float) -> tuple[str, str]:
    """(modulation, rate) for an OTFS_EQ link.  QPSK R1/2 is the verified
    rung (tools/otfs_mode_sweep: Good 20/20, Moderate 15/20, Poor 12/20 at
    20 dB); drop to R1/4 when the link is marginal."""
    return ("QPSK", "R1_2") if snr_db >= 14.0 else ("QPSK", "R1_4")


def recommended_pilot_spacing(modulation: str, rate: str) -> int:
    """Reference include/ultra/ofdm_link_adaptation.hpp:26-64, exactly.

    This is WIRE FORMAT: both stations derive the pilot layout from the
    signaled (mod, rate) alone, and the reference peer computes this table —
    any deviation breaks over-the-air interop (verified by the round-4
    interop harness).  The old spacing-20 trim for QAM16/QPSK R1/2 lives on
    as `sparse_pilot_spacing` for explicitly-negotiated ria-to-ria links."""
    coherent = modulation in ("BPSK", "QPSK", "QAM16", "QAM32", "QAM64", "QAM256")
    if coherent:
        if rate in ("R5_6", "R7_8"):
            return 6
        if rate == "R3_4":
            return 8
        return 5
    if modulation == "D8PSK":
        return 8 if rate in ("R3_4", "R2_3", "R1_2") else 10
    return 15 if rate == "R3_4" else 10


def sparse_pilot_spacing(modulation: str, rate: str) -> int:
    """Non-wire-compat trim: QAM16/QPSK R1/2 at spacing 20 (56 data + 3
    pilots).  The equalizer for these modes uses pilots only for common-phase
    correction, so 3 pilots suffice and the row nets ~9% more than the
    reference layout (verified decode at 18 dB AWGN / good fading in tests).
    Only for ria-to-ria links where both ends negotiate it explicitly."""
    if modulation in ("QAM16", "QPSK") and rate == "R1_2":
        return 20
    return recommended_pilot_spacing(modulation, rate)


def recommend_mc_profile(snr_db: float,
                         fading_index: float = 0.0) -> tuple[int, str, str] | None:
    """(carriers, modulation, rate) for the ACK-gated MC-DPSK profile
    upgrade, or None to keep the standard 10-carrier R1/4 profile.

    The reference pins in-session MC-DPSK at 10 carriers / R1/4
    (waveform_selection.hpp:255-257), so its published 469/938 bps rows
    (R1/2 capacity math, README.md:68-72) are unreachable on its own link.
    Measured floors here (AWGN, 10/10 seeds, ZC-light data frames):
    13c DBPSK R1/2 clean at -6 dB, 13c DQPSK R1/2 at +3, 16c DQPSK R1/2
    at +4 — so with 2 dB margin the upgrade engages at -4/+4/+6.

    STRICTLY AWGN-gated: on Rayleigh channels R1/2 MC-DPSK collapses
    (measured: 13c DQPSK R1/2 1/10 on Good fading even at +6 dB — a deep
    carrier fade over a long frame defeats the halved parity), which is
    exactly why the reference pins in-session MC-DPSK to R1/4.  The
    published MC-DPSK rows are AWGN rows (BASELINE.md "10 carriers, sim
    AWGN").  The measured fading index separates the classes cleanly even
    at low SNR: AWGN reads 0.12-0.24 (noise-driven bias at -4 dB), Good
    fading reads ~0.69 — the 0.40 gate sits between them."""
    if fading_index >= 0.40:
        return None
    if snr_db >= 6.0:
        return 16, "DQPSK", "R1_2"
    if snr_db >= 4.0:
        return 13, "DQPSK", "R1_2"
    if snr_db >= -4.0:
        return 13, "DBPSK", "R1_2"
    return None


def recommend_mc_dpsk_carriers(snr_db: float) -> int:
    """MC-DPSK carrier-count ladder (reference
    WaveformFactory::recommendMCDPSKCarriers, waveform_factory.cpp:154-171):
    more carriers buy throughput but need better SNR; fewer concentrate
    power per carrier for fading diversity at the bottom of the range."""
    if snr_db < 3.0:
        return 5
    if snr_db < 8.0:
        return 8
    if snr_db < 10.0:
        return 10
    if snr_db < 15.0:
        return 13
    return 20
