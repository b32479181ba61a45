"""Link throughput measurement, the twin of ``tools/throughput_test.py``
(reference tools/test_throughput.cpp).

Measures NET payload bits per audio second through the real TX chain (on
``--device``; no channel, no RX) at the twelve operating points of the
reference's published table (BASELINE.md), and compares them with it.

Each row is an operating point (SNR + channel class).  ``steady`` is the
configuration the protocol runs there, taken from the protocol's own
tables: the negotiated burst group (``protocol/connection.py::
burst_group_for_link``), the MC-DPSK profile upgrade (``wave/selection.py::
recommend_mc_profile``) and the code-rate ladder (``select_ofdm_code_rate``).
Two comparisons a row:

- ``net_vs_binary``: steady net against the reference binary's own net
  on-air throughput at the same (modulation, rate), from its real wire
  layout (:func:`reference_net_bps`); ``--assert`` requires >= 1.05;
- ``net_ratio``: steady net against the published table, whose pilot
  layouts the reference's current code no longer sends; ``--assert``
  requires >= 0.90.

``forced`` keeps the same-(mod, rate) net, ``gross`` the capacity math.

Usage: python -m ria_tpu_torch.tools.throughput_test [--assert] [--markdown]
           [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from ria_tpu_torch.utils.device import resolve_device


def measure_single(wf, rate: str) -> float:
    """One fixed 4-CW data frame filled to its payload capacity, light
    preamble -> net bps."""
    from ria_tpu_torch.phy.frame_v2 import fixed_frame_payload_capacity, make_fixed_data_frame

    cap = fixed_frame_payload_capacity(rate)
    frame = make_fixed_data_frame("W1AW", "VE3ABC", 0, bytes(cap), rate)
    tx = wf.tx_frame(frame.serialize(), light=True)
    return len(frame.payload) * 8 / (len(tx) / 48000.0)


def measure_burst(wf, rate: str, group: int) -> float:
    """Stream-packed burst: one light preamble, ``group`` frames -> net bps."""
    from ria_tpu_torch.phy.frame_v2 import fixed_frame_payload_capacity, make_fixed_data_frame

    cap = fixed_frame_payload_capacity(rate)
    frames = [make_fixed_data_frame("W1AW", "VE3ABC", i, bytes(cap), rate)
              for i in range(group)]
    payload = sum(len(f.payload) for f in frames)
    tx = wf.tx_burst([f.serialize() for f in frames])
    return payload * 8 / (len(tx) / 48000.0)


def measure_long_mc(wf, payload_len: int = 600) -> float:
    """MC-DPSK steady state: one long variable-CW frame, ZC light preamble."""
    from ria_tpu_torch.phy.frame_v2 import DataFrame

    frame = DataFrame.make_data("W1AW", "VE3ABC", 0, bytes(payload_len))
    tx = wf.tx_frame(frame.serialize(), light=True)
    return payload_len * 8 / (len(tx) / 48000.0)


def reference_net_bps(mode_name: str, mod: str, rate: str, mc_payload: int = 600) -> float:
    """NET bps of the reference binary's own TX chain at the same (mod,
    rate): a light preamble per frame, fixed 4-CW frames with a 19-byte
    header and CRC, no burst packing (streaming_encoder.cpp:253); OFDM
    pilots as its code lays them out (ofdm_chirp_waveform.cpp:75), not as
    its published table assumes."""
    from ria_tpu_torch.fec.ldpc_matrix import get_code
    from ria_tpu_torch.phy.frame_v2 import bytes_per_codeword
    from ria_tpu_torch.sync.zc import ZCConfig
    from ria_tpu_torch.wave.mc_dpsk import MCDPSKConfig
    from ria_tpu_torch.wave.ofdm import BITS_PER_SYMBOL
    from ria_tpu_torch.wave.selection import recommended_pilot_spacing

    if mode_name == "MC_DPSK":
        # 10-carrier profile, ZC light preamble, variable-CW frame.
        cfg = MCDPSKConfig()
        bits_per_sym = 10 * (2 if mod == "DQPSK" else 1)
        total_bits = (17 + mc_payload + 2) * 8
        ncw = -(-total_bits // get_code(rate).k)
        syms = -(-(ncw * 648) // bits_per_sym)
        air = ZCConfig().preamble_samples + syms * cfg.samples_per_symbol
        return mc_payload * 8 * 48000.0 / air
    spacing = recommended_pilot_spacing(mod, rate)
    pilots = (59 + spacing - 1) // spacing
    bps_sym = (59 - pilots) * BITS_PER_SYMBOL[mod]
    S = -(-4 * 648 // bps_sym)
    payload = 4 * bytes_per_codeword(rate) - 19
    air = 2 * 1120 + S * 1120  # LTS x2 light preamble + data symbols
    return payload * 8 * 48000.0 / air


# (name, waveform, forced modulation, forced rate, reference bps, operating
# SNR dB, operating fading index): BASELINE.md's rows with their published
# conditions; fading 0.12 is the AWGN class as the demodulators measure it
# on clean channels, 0.3 the Good class.
REF_ROWS = [
    ("MC-DPSK DBPSK R1/2", "MC_DPSK", "DBPSK", "R1_2", 469.0, -4.0, 0.2),
    ("MC-DPSK DQPSK R1/2", "MC_DPSK", "DQPSK", "R1_2", 938.0, 5.0, 0.12),
    ("OFDM DQPSK R1/4", "OFDM_CHIRP", "DQPSK", "R1_4", 1264.0, 10.0, 0.3),
    ("OFDM DQPSK R1/2", "OFDM_CHIRP", "DQPSK", "R1_2", 2271.0, 15.0, 0.3),
    ("OFDM DQPSK R2/3", "OFDM_CHIRP", "DQPSK", "R2_3", 3028.0, 20.0, 0.3),
    ("OFDM DQPSK R3/4", "OFDM_CHIRP", "DQPSK", "R3_4", 3536.0, 20.0, 0.12),
    ("OFDM QAM16 R1/2", "OFDM_CHIRP", "QAM16", "R1_2", 4800.0, 18.0, 0.12),
    ("OFDM QAM32 R3/4", "OFDM_CHIRP", "QAM32", "R3_4", 6000.0, 22.0, 0.12),
    ("OFDM QAM64 R3/4", "OFDM_COX", "QAM64", "R3_4", 7200.0, 25.0, 0.12),
    # Coherent NVIS/ground-wave rows (README.md:86-88, OFDM-COX pilots).
    ("Coherent QPSK R1/2", "OFDM_COX", "QPSK", "R1_2", 2014.0, 20.0, 0.12),
    ("Coherent QAM16 R3/4", "OFDM_COX", "QAM16", "R3_4", 5657.0, 25.0, 0.12),
    ("Coherent QAM32 R3/4", "OFDM_COX", "QAM32", "R3_4", 7071.0, 30.0, 0.12),
]


def steady_config(mode, forced_mod: str, forced_rate: str, snr_db: float, fading: float):
    """What the protocol runs at the row's operating point, from its own
    tables: ("mc", carriers, mod, rate) or ("burst", group, mod, rate)."""
    from ria_tpu_torch.phy.frame_v2 import WaveformMode
    from ria_tpu_torch.protocol.connection import burst_group_for_link
    from ria_tpu_torch.wave.selection import recommend_mc_profile, select_ofdm_code_rate

    if mode == WaveformMode.MC_DPSK:
        prof = recommend_mc_profile(snr_db, fading)
        if prof is None:
            return ("mc", 10, forced_mod, "R1_4")
        return ("mc",) + prof
    rate = forced_rate
    if forced_mod == "DQPSK" or (forced_mod, forced_rate) == ("QAM16", "R1_2"):
        # rate-ladder rows: the rate the table selects at this point
        rate = select_ofdm_code_rate(snr_db, fading)
    group = burst_group_for_link(snr_db, forced_mod, rate, fading)
    return ("burst", group, forced_mod, rate)


def measure_rows(device: str | torch.device = "cuda") -> list[dict]:
    """-> a dict a row: steady (operating-point configuration), forced
    (same mod/rate net), single, gross, and the ratios to the reference."""
    from ria_tpu_torch.fec.ldpc_matrix import get_code
    from ria_tpu_torch.phy.frame_v2 import WaveformMode
    from ria_tpu_torch.wave.api import MCDPSKWaveform, create_waveform
    from ria_tpu_torch.wave.ofdm import BITS_PER_SYMBOL

    dev = resolve_device(device)
    out = []
    for name, mode_name, mod, rate, ref, snr, fading in REF_ROWS:
        mode = WaveformMode[mode_name]
        wf = create_waveform(mode, mod, rate, device=dev)
        code_rate = get_code(rate).k / 648.0
        cfgd = steady_config(mode, mod, rate, snr, fading)
        cfg = wf.cfg
        if mode == WaveformMode.MC_DPSK:
            gross = (cfg.bits_per_mc_symbol * (48000.0 / cfg.samples_per_symbol)
                     / cfg.spreading * code_rate)
            single = measure_long_mc(wf, 120)
            forced = measure_long_mc(wf, 600)
            _, carriers, smod, srate = cfgd
            swf = MCDPSKWaveform(num_carriers=carriers, modulation=smod, rate=srate, device=dev)
            steady = measure_long_mc(swf, 600)
            steady_desc = f"{carriers}c {smod} {srate}"
        else:
            sym_rate = 48000.0 / cfg.symbol_samples
            gross = cfg.num_data_carriers * BITS_PER_SYMBOL[mod] * sym_rate * code_rate
            single = measure_single(wf, rate)
            _, group, smod, srate = cfgd
            forced = measure_burst(wf, rate, group)
            if (smod, srate) == (mod, rate):
                steady = forced
            else:
                steady = measure_burst(create_waveform(mode, smod, srate, device=dev), srate, group)
            steady_desc = f"{smod} {srate} G{group}"
        ref_net = reference_net_bps(mode_name, mod, rate)
        out.append({"name": name, "mod": mod, "rate": rate, "ref": ref, "snr": snr,
                    "single": single, "forced": forced, "steady": steady,
                    "steady_desc": steady_desc, "gross": gross, "net_ratio": steady / ref,
                    "ratio": gross / ref, "ref_net": ref_net,
                    "net_vs_binary": steady / ref_net})
    return out


def report(rows: list[dict], markdown: bool = False, log=print) -> tuple[float, float]:
    """Print the table through ``log``; -> (worst steady net against the
    published table, worst against the reference binary's net)."""
    if markdown:
        log("| operating point | steady config | net steady bps | net forced bps "
            "| gross bps | ref binary net bps | vs binary | ref published bps | vs published |")
        log("|---|---|---|---|---|---|---|---|---|")
    else:
        log(f"{'row':22s} {'steady config':18s} {'steady':>7s} {'forced':>7s} "
            f"{'gross':>7s} {'refbin':>7s} {'vs_bin':>6s} {'ref':>6s} {'vs_pub':>6s}")
    for r in rows:
        if markdown:
            log(f"| {r['name']} @ {r['snr']:+.0f} dB | {r['steady_desc']} "
                f"| {r['steady']:.0f} | {r['forced']:.0f} | {r['gross']:.0f} "
                f"| {r['ref_net']:.0f} | {r['net_vs_binary']:.2f} "
                f"| {r['ref']:.0f} | {r['net_ratio']:.2f} |")
        else:
            log(f"{r['name']:22s} {r['steady_desc']:18s} {r['steady']:7.0f} "
                f"{r['forced']:7.0f} {r['gross']:7.0f} {r['ref_net']:7.0f} "
                f"{r['net_vs_binary']:6.2f} {r['ref']:6.0f} {r['net_ratio']:6.2f}")
    worst = min(10.0, min(r["net_ratio"] for r in rows))
    worst_bin = min(r["net_vs_binary"] for r in rows)
    log(f"worst NET steady/published ratio: {worst:.2f}")
    log(f"worst NET steady vs reference-binary net: {worst_bin:.2f}")
    return worst, worst_bin


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--assert", dest="check", action="store_true",
                    help="fail unless every row beats the reference binary's net by 5%% "
                         "and none falls below 0.90 of the published table")
    ap.add_argument("--markdown", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    rows = measure_rows(args.device)
    report(rows, args.markdown)
    if args.check:
        bad = [r["name"] for r in rows if r["net_vs_binary"] < 1.05]
        if bad:
            print(f"FAIL: not beating the reference binary's net: {bad}")
            return 1
        low = [r["name"] for r in rows if r["net_ratio"] < 0.90]
        if low:
            print(f"FAIL: below 0.90x of the published table: {low}")
            return 1
        print("PASS: every operating point beats the reference binary's "
              "net on-air throughput (same wire format)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
