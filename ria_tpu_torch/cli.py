"""``ria`` command-line tool of the PyTorch port: frame TX/RX, monitor, the
operator console and info.

Port of ``ria_tpu/cli.py``, which mirrors the reference CLI (src/main.cpp):
``ptx`` renders a frame (text, ping, connect, disconnect) to float32 samples
on stdout or a file; ``prx`` decodes float32 samples from a file or stdin and
prints parsed frames; ``monitor`` streams a recording through a ``Station``
in quarter-second blocks and prints an ASCII waterfall, the decode status
and every message; ``gui`` runs the operator console (``runtime/tui.py``:
``--sim`` embeds a virtual peer behind a Watterson channel, ``--frames N``
steps N blocks headless and prints one frame, ``--attach HOST:PORT`` drives
a running modem's host interface); ``info`` prints the modem configuration.
Flags:
-s/-d callsigns, -w waveform, -m modulation, -r rate, -o output, and
``--device`` (default ``cuda``: the sync, demodulation and LDPC decode run on
the card, and without one the command raises; ``--device cpu`` runs them on
the host).  ``prx`` uploads the recording once and hands the same buffer to
every waveform it tries.

Usage:
  python -m ria_tpu_torch.cli ptx "hello world" -s W1AW -d VE3ABC -o tx.f32
  python -m ria_tpu_torch.cli prx tx.f32
  python -m ria_tpu_torch.cli monitor tx.f32
  python -m ria_tpu_torch.cli gui --sim --frames 20
  python -m ria_tpu_torch.cli --device cpu info
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ria_tpu_torch import __version__
from ria_tpu_torch.fec.ldpc_matrix import CODE_PARAMS
from ria_tpu_torch.phy.frame_v2 import (
    ConnectFrame, ControlFrame, DataFrame, FrameType, WaveformMode, make_fixed_data_frame,
)
from ria_tpu_torch.phy.modem import AudioBuffer
from ria_tpu_torch.utils.device import resolve_device
from ria_tpu_torch.wave import mc_dpsk
from ria_tpu_torch.wave.api import create_waveform
from ria_tpu_torch.wave.ofdm import OFDMConfig


def _build_waveform(args):
    mode = WaveformMode[args.waveform.upper()]
    # Defaults mirror the reference CLI (src/main.cpp:343-344): DQPSK R1/4
    # regardless of waveform — a bare `-w mcdpsk` must interoperate with a
    # bare reference `ria -w mcdpsk`.  OTFS carries coherent DD-grid
    # constellations only, so its default is QPSK.
    default_mod = ("QPSK" if mode in (WaveformMode.OTFS_EQ,
                                      WaveformMode.OTFS_RAW) else "DQPSK")
    modulation = (args.modulation or default_mod).upper()
    rate = (args.rate or "R1_4").upper()
    return create_waveform(mode, modulation, rate, device=args.device)


def cmd_ptx(args) -> int:
    wf = _build_waveform(args)
    text = args.payload

    if text == "ping":
        cfg = wf.cfg if hasattr(wf, "cfg") and hasattr(wf.cfg, "bits_per_mc_symbol") else None
        if cfg is None:
            print("ping requires MC_DPSK", file=sys.stderr)
            return 1
        # PING = bare acquisition preamble (chirp + training + ref), no
        # data — reference encodePing (streaming_encoder.cpp:393-431); the
        # peer discriminates by post-preamble silence, so carry a tail of
        # silence like the reference's postProcessTx lead/tail.
        samples = np.concatenate([np.zeros(7200, np.float32),
                                  mc_dpsk.preamble(cfg),
                                  np.zeros(4800, np.float32)])
    elif text == "connect":
        f = ConnectFrame(type=FrameType.CONNECT, src_callsign=args.src,
                         dst_callsign=args.dst, mode_capabilities=0x3F)
        samples = wf.tx_frame(f.serialize())
    elif text == "disconnect":
        f = ConnectFrame(type=FrameType.DISCONNECT, src_callsign=args.src,
                         dst_callsign=args.dst)
        samples = wf.tx_frame(f.serialize())
    else:
        # DATA frames mirror the reference `ria ptx`: connected mode, light
        # preamble (src/main.cpp:160-166 setConnected + encodeFrameLight),
        # seq=1, with a TX lead-in of silence like postProcessTx.  OFDM_COX
        # has no light preamble in the reference (encodeFrameLight falls
        # back to the full Schmidl-Cox preamble and its RX searches STS),
        # so a COX frame for a reference peer must carry the full preamble.
        # Fixed 4-CW framing (FrameInterleaver) is an OFDM/OTFS contract;
        # the serial waveforms (MC-DPSK, Barker DPSK, MFSK) carry
        # variable-CW frames (reference encodeFrame dispatch).
        if wf.mode in (WaveformMode.MC_DPSK, WaveformMode.DPSK,
                       WaveformMode.MFSK):
            frame = DataFrame.make_data(args.src, args.dst, 1, text.encode())
        else:
            frame = make_fixed_data_frame(args.src, args.dst, 1, text.encode(), wf.rate)
        body = wf.tx_frame(frame.serialize(),
                           light=(wf.mode != WaveformMode.OFDM_COX))
        lead = np.zeros(7200, np.float32)
        samples = np.concatenate([lead, body, np.zeros(2400, np.float32)])

    data = np.asarray(samples, np.float32).tobytes()
    if args.output and args.output != "-":
        with open(args.output, "wb") as f:
            f.write(data)
        print(f"wrote {len(samples)} samples ({len(samples)/48000.0:.2f}s) to {args.output}",
              file=sys.stderr)
    else:
        sys.stdout.buffer.write(data)
    return 0


def _try_waveform(wf, audio: AudioBuffer):
    """One waveform's full decode attempt: full preamble, light preamble,
    then the bare-PING probe.  Returns ("frame", rx) / ("ping", sync) /
    None."""
    rx = wf.rx_frame(audio)
    if not rx.ok and hasattr(wf, "detect_sync"):
        rx = wf.rx_frame(audio, light=True)
    if rx.ok:
        return ("frame", rx)
    if hasattr(wf, "acq_preamble"):
        # PING probe: bare acquisition preamble with silence after the
        # training+ref block (reference prx PingReceivedCallback path).
        sync = wf.detect_sync(audio)
        if sync is not None and sync.get("kind") in ("chirp", "css"):
            cfg, start = wf.cfg, sync["start"]
            sym = cfg.samples_per_symbol
            train_end = start + (cfg.training_symbols + 1) * sym
            train = audio.host(start, train_end)
            post = audio.host(train_end, train_end + 2 * sym)
            if len(train) and len(post):
                r_t = float(np.sqrt(np.mean(np.square(train))))
                r_p = float(np.sqrt(np.mean(np.square(post))))
                if r_t > 0 and r_p < 0.6 * r_t:
                    return ("ping", sync)
    return None


def _autodetect_candidates(args):
    """Waveform candidates for `prx` without -w, ordered by detector the
    way the reference's acquisition discovers a recording's contents
    (src/main.cpp:56-63: chirp acquisition, PING/DATA discrimination):
    chirp (MC-DPSK full + PING) -> ZC (MC-DPSK light) -> SC/LTS
    (OFDM chirp light, then COX) -> OTFS -> Barker DPSK -> MFSK sweep.
    The user's -m/-r (or the reference CLI defaults DQPSK R1/4) apply to
    every candidate."""
    mod = (args.modulation or "DQPSK").upper()
    rate = (args.rate or "R1_4").upper()
    out = [create_waveform(wm, m, r, device=args.device) for wm, m, r in [
        (WaveformMode.MC_DPSK, mod, rate),       # chirp + ZC + PING
        (WaveformMode.MC_DPSK, "DBPSK", rate),   # handshake frames
        (WaveformMode.OFDM_CHIRP, mod, rate),    # LTS light + dual chirp
        (WaveformMode.OFDM_CHIRP, mod, "R1_2"),
        (WaveformMode.OFDM_COX, mod, rate),      # Schmidl-Cox
        (WaveformMode.OFDM_COX, "QAM64", "R3_4"),
        (WaveformMode.OTFS_EQ, "QPSK", "R1_4"),
        (WaveformMode.OTFS_EQ, "QPSK", "R1_2"),
        (WaveformMode.DPSK, mod, rate),          # Barker-13x3
        (WaveformMode.DPSK, "DBPSK", rate),
        (WaveformMode.MFSK, "MFSK16", rate),
    ]]
    # De-dup configurations the flags collapsed together.
    seen, uniq = set(), []
    for wf in out:
        key = (wf.mode, wf.modulation, wf.rate)
        if key not in seen:
            seen.add(key)
            uniq.append(wf)
    return uniq


def cmd_prx(args) -> int:
    if args.input == "-":
        raw = sys.stdin.buffer.read()
    else:
        with open(args.input, "rb") as f:
            raw = f.read()
    samples = np.frombuffer(raw, np.float32)
    print(f"read {len(samples)} samples ({len(samples)/48000.0:.2f}s)", file=sys.stderr)

    if args.waveform:
        candidates = [_build_waveform(args)]
    else:
        candidates = _autodetect_candidates(args)
    # One upload of the recording for every candidate and every stage.
    audio = AudioBuffer(samples, args.device)
    hit, rx, wf = None, None, None
    for cand in candidates:
        hit = _try_waveform(cand, audio)
        if hit is not None:
            wf = cand
            break
    if hit is not None and hit[0] == "ping":
        sync = hit[1]
        print(f"type=PING corr={sync['corr']:.2f} "
              f"cfo={sync['cfo_hz']:.1f} Hz")
        return 0
    if hit is not None:
        rx = hit[1]
        if not args.waveform:
            print(f"waveform={wf.mode.name} {wf.modulation} {wf.rate}",
                  file=sys.stderr)
    if rx is None or not rx.ok:
        print("no frame decoded")
        return 1
    fb = rx.frame_bytes
    for cls in (ConnectFrame, ControlFrame, DataFrame):
        g = cls.deserialize(fb)
        if g is not None:
            print(f"type={g.type.name} " + (
                f"src={g.src_callsign} dst={g.dst_callsign}"
                if cls is ConnectFrame else
                f"seq={g.seq} src={g.src_hash:06x} dst={g.dst_hash:06x}"))
            if cls is DataFrame:
                print("payload:", g.payload.rstrip(b"\x00"))
            break
    print(f"snr={rx.snr_db:.1f} dB fading={rx.fading_index:.2f} cfo={rx.cfo_hz:.1f} Hz")
    return 0


def render_waterfall_ascii(db: np.ndarray, freqs: np.ndarray, width: int = 72,
                           height: int = 16) -> str:
    """Terminal waterfall: rows = time (newest last), cols = frequency."""
    if db.size == 0:
        return "(no signal)"
    ramp = " .:-=+*#%@"
    t_idx = np.linspace(0, db.shape[0] - 1, min(height, db.shape[0])).astype(int)
    f_idx = np.linspace(0, db.shape[1] - 1, min(width, db.shape[1])).astype(int)
    grid = db[np.ix_(t_idx, f_idx)]
    lo, hi = np.percentile(grid, 10), np.percentile(grid, 99)
    norm = np.clip((grid - lo) / max(hi - lo, 1e-6), 0.0, 1.0)
    chars = (norm * (len(ramp) - 1)).astype(int)
    lines = ["".join(ramp[c] for c in row) for row in chars]
    axis = (f"{freqs[f_idx[0]]:.0f}Hz" + " " * (len(f_idx) - 12)
            + f"{freqs[f_idx[-1]]:.0f}Hz")
    return "\n".join(lines + [axis])


def cmd_monitor(args) -> int:
    """Textual waterfall + per-block decode status over an f32 stream.

    Headless counterpart of the reference GUI's waterfall/status widgets:
    streams audio (file or stdin) through a Station in block steps and
    renders an ASCII waterfall plus SNR/CFO/fading/frame counters.  The
    station's waveforms run on ``args.device``.
    """
    from ria_tpu_torch.phy.station import Station
    from ria_tpu_torch.runtime.monitor import ModemMonitor, waterfall
    from ria_tpu_torch.wave.api import MCDPSKWaveform

    if args.input == "-":
        raw = sys.stdin.buffer.read()
    else:
        with open(args.input, "rb") as f:
            raw = f.read()
    audio = np.frombuffer(raw, np.float32)
    st = Station(args.src, device=args.device)
    st.promiscuous = True  # observe connected-mode (light) traffic too
    # Out-of-session data traffic defaults to DQPSK R1/4 (the reference
    # CLI's data mode); the handshake waveform keeps decoding DBPSK
    # chirp-preamble frames.
    st.data_wf = MCDPSKWaveform(modulation="DQPSK", rate="R1_4", device=args.device)
    mon = ModemMonitor(st)
    block = 48000 // 4
    decoded = []
    st.conn.on_message = lambda m: decoded.append(m)
    for off in range(0, len(audio), block):
        st.feed_audio(audio[off: off + block])
        st.poll()
        st.tick(int(1000 * block / 48000.0))
    db, freqs = waterfall(audio[-48000 * 4:])
    s = mon.status()
    print(render_waterfall_ascii(db, freqs))
    print(f"state={s.state} wf={s.waveform} snr={s.snr_db:.1f}dB "
          f"cfo={s.cfo_hz:.1f}Hz fading={s.fading_index:.2f} "
          f"rx={s.frames_rx} tx={s.frames_tx} fail={s.decode_failures}")
    for m in decoded:
        print("message:", m)
    return 0


def cmd_gui(args) -> int:
    """Live operator dashboard (reference ria_gui; curses TUI here).

    --sim embeds a virtual peer station behind a Watterson channel
    (reference `ria_gui -sim`); without it the station runs on a
    runtime.audio backend (loopback by default, sounddevice if available).
    The stations run on ``args.device``.
    """
    from ria_tpu_torch.runtime.tui import TuiApp

    if args.attach:
        from ria_tpu_torch.runtime.tui import AttachedConsole

        host, _, port = args.attach.partition(":")
        cport = int(port or 8300)
        con = AttachedConsole(host=host or "127.0.0.1",
                              command_port=cport, data_port=cport + 1)
        if args.frames:
            for _ in range(args.frames):
                con.step()
            print("\n".join(con.build_frame()))
            con.close()
            return 0
        con.run_curses()  # pragma: no cover - terminal
        return 0

    sim_channel = None
    if args.sim:
        from ria_tpu_torch.sim.channel import PRESETS

        sim_channel = PRESETS[args.channel](args.snr)
    backend = None
    if not args.sim and args.audio == "device":  # pragma: no cover - hardware
        from ria_tpu_torch.runtime.audio import SoundDeviceBackend

        backend = SoundDeviceBackend()
    app = TuiApp(mycall=args.src, peer=args.dst, sim_channel=sim_channel,
                 seed=args.seed, audio_backend=backend, device=args.device)
    if args.frames:  # headless render (tests / CI smoke)
        for _ in range(args.frames):
            app.step()
        print("\n".join(app.build_frame()))
        return 0
    app.run_curses()  # pragma: no cover - terminal
    return 0


def cmd_info(args) -> int:
    print(f"ria_tpu_torch {__version__} — HF modem framework, PyTorch/CUDA port "
          f"(device {args.device})")
    mc = mc_dpsk.MCDPSKConfig()
    print(f"MC-DPSK: {mc.num_carriers} carriers {mc.freq_low:.0f}-{mc.freq_high:.0f} Hz, "
          f"{mc.sample_rate/mc.samples_per_symbol:.2f} baud")
    of = OFDMConfig()
    print(f"OFDM: fft={of.fft_size} cp={of.cp_len} carriers={of.num_carriers} "
          f"center={of.center_freq:.0f} Hz")
    print("LDPC: 648-bit codewords, rates " + ", ".join(CODE_PARAMS))
    print("waveforms: MC_DPSK OFDM_CHIRP OFDM_COX OTFS MFSK DPSK (+AFDM transform)")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ria", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    # --device goes before or after the sub-command; the later one wins.
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--device", default=argparse.SUPPRESS, help=argparse.SUPPRESS)
    sub = p.add_subparsers(dest="cmd", required=True)

    ptx = sub.add_parser("ptx", parents=[common], help="render a frame to f32 samples")
    ptx.add_argument("payload", help='text, or "ping"/"connect"/"disconnect"')
    ptx.add_argument("-s", "--src", default="NOCALL")
    ptx.add_argument("-d", "--dst", default="CQ")
    ptx.add_argument("-w", "--waveform", default="MC_DPSK")
    ptx.add_argument("-m", "--modulation", default=None)
    ptx.add_argument("-r", "--rate", default=None)
    ptx.add_argument("-o", "--output", default="-")
    ptx.set_defaults(fn=cmd_ptx)

    prx = sub.add_parser("prx", parents=[common], help="decode f32 samples")
    prx.add_argument("input", help="file path or - for stdin")
    prx.add_argument("-w", "--waveform", default=None,
                     help="waveform (omit to auto-detect: chirp -> ZC -> "
                          "SC/LTS -> OTFS -> Barker -> MFSK)")
    prx.add_argument("-m", "--modulation", default=None)
    prx.add_argument("-r", "--rate", default=None)
    prx.set_defaults(fn=cmd_prx)

    mon = sub.add_parser("monitor", parents=[common],
                         help="ASCII waterfall + status over f32 stream")
    mon.add_argument("input", help="file path or - for stdin")
    mon.add_argument("-s", "--src", default="NOCALL")
    mon.set_defaults(fn=cmd_monitor)

    gui = sub.add_parser("gui", parents=[common], help="live operator dashboard (curses TUI)")
    gui.add_argument("-s", "--src", default="N0CALL")
    gui.add_argument("-d", "--dst", default="VIRT")
    gui.add_argument("--sim", action="store_true",
                     help="embed a virtual peer behind a Watterson channel")
    gui.add_argument("--channel", default="awgn",
                     choices=["awgn", "good", "moderate", "poor", "flutter"])
    gui.add_argument("--snr", type=float, default=15.0)
    gui.add_argument("--seed", type=int, default=42)
    gui.add_argument("--audio", default="loopback",
                     choices=["loopback", "device"])
    gui.add_argument("--frames", type=int, default=0,
                     help="headless: step N blocks, print one frame, exit")
    gui.add_argument("--attach", default=None, metavar="HOST:PORT",
                     help="attach to a running modem's host interface "
                          "(command port; data = port+1)")
    gui.set_defaults(fn=cmd_gui)

    info = sub.add_parser("info", parents=[common], help="print modem configuration")
    info.set_defaults(fn=cmd_info)

    args = p.parse_args(argv)
    # Every command runs on args.device: no card and no --device cpu raises
    # here, before anything is rendered or decoded.
    args.device = resolve_device(args.device)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
