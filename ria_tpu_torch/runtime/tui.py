"""Live operator dashboard (TUI) — the reference GUI app's surface, headless.

Port of ``ria_tpu/runtime/tui.py``: the same frames, keys and console over
the port's station, engine and monitor.  ``TuiApp``'s stations (the
embedded simulator's two, or the audio mode's one) run on ``device``
(default the card); ``draws`` goes to the simulator's channels (see
``sim/simulator.py``).  Recordings default to the temporary directory.

The reference ships an ImGui/SDL2 application (src/gui/app.cpp: waterfall,
constellation, status readouts, connect/disconnect/beacon controls, message
console, settings persistence, embedded `-sim` virtual-station mode).  This
platform has no display stack, so the same operator surface is a curses TUI
over the exact data producers the GUI widgets would use
(runtime/monitor.py) and the same Station/Connection engine:

- live ASCII waterfall of the RX audio (STFT dB ramp);
- constellation scatter of recent equalized symbols;
- status: connection state, negotiated link, SNR/CFO/fading, frame
  counters, buffer fill, chase stats;
- message console + input line (Enter sends over the session);
- keys: c=connect d=disconnect b=beacon q=quit, type to compose;
- `--sim` embeds a second full station behind a Watterson channel in-process
  (reference `ria_gui -sim`), so the dashboard runs with zero hardware;
- plain audio mode drives a runtime.audio backend (loopback/file/device).

Rendering is split from curses: `build_frame()` returns plain text lines,
so the whole dashboard is unit-testable headless; `run_curses()` is the
only terminal-bound code.
"""

from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field

import numpy as np

import torch

from ria_tpu_torch.runtime.monitor import ModemMonitor

RAMP = " .:-=+*#%@"


def render_waterfall(db: np.ndarray, width: int = 64, height: int = 10) -> list[str]:
    """STFT dB matrix [frames, bins] -> `height` text rows (newest last).

    Auto-ranged like the reference waterfall widget: the ramp spans from
    the current median level (noise floor) to the current peak, so the
    display stays readable at any input gain."""
    if db.size == 0:
        return ["(no audio)"] + [""] * (height - 1)
    floor_db = float(np.median(db)) - 3.0
    span_db = max(float(db.max()) - floor_db, 20.0)
    frames = db.shape[0]
    rows = []
    take = np.linspace(0, frames - 1, height).astype(int)
    for r in take:
        bins = db[r]
        cols = np.linspace(0, len(bins) - 1, width).astype(int)
        level = (bins[cols] - floor_db) / span_db
        idx = np.clip((level * (len(RAMP) - 1)).astype(int), 0, len(RAMP) - 1)
        rows.append("".join(RAMP[i] for i in idx))
    return rows


def render_constellation(symbols: np.ndarray, width: int = 31,
                         height: int = 15, span: float = 1.6) -> list[str]:
    """Complex symbols -> scatter plot rows with axes."""
    grid = [[" "] * width for _ in range(height)]
    cy, cx = height // 2, width // 2
    for y in range(height):
        grid[y][cx] = "|"
    for x in range(width):
        grid[cy][x] = "-"
    grid[cy][cx] = "+"
    for s in np.asarray(symbols).reshape(-1)[-400:]:
        x = int(round(cx + s.real / span * cx))
        y = int(round(cy - s.imag / span * cy))
        if 0 <= x < width and 0 <= y < height:
            grid[y][x] = "o"
    return ["".join(r) for r in grid]


def render_status(status, link, extra: dict | None = None) -> list[str]:
    lines = [
        f"state  {status.state:<14} waveform {status.waveform}",
        f"link   {link.modulation}/{link.rate}"
        + (f" spread{link.spreading}x" if getattr(link, "spreading", 1) > 1 else "")
        + (f" burst{link.burst_group}" if getattr(link, "burst_group", 0) else ""),
        f"snr    {status.snr_db:6.1f} dB   cfo {status.cfo_hz:+6.1f} Hz   "
        f"fading {status.fading_index:4.2f}",
        f"frames rx {status.frames_rx}  tx {status.frames_tx}  "
        f"fail {status.decode_failures}  buf {100 * status.buffer_fill:4.1f}%",
    ]
    for k, v in (extra or {}).items():
        lines.append(f"{k:<6} {v}")
    return lines


@dataclass
class TuiState:
    messages: list = field(default_factory=list)   # (dir, text)
    input_line: str = ""
    running: bool = True
    # Compose mode: printable keys go to the input line ONLY while
    # composing (entered with ':' or Enter) — bare c/d/b/q/s/r stay
    # single-key commands and can never eat the first letter of a message
    # ("bye", "call at 9", ...).
    composing: bool = False
    show_settings: bool = False
    recording: bool = False


class TuiApp:
    """Headless-drivable dashboard engine.

    sim mode: owns a DualStationSim; the local operator drives ALPHA, the
    embedded virtual peer (BRAVO) auto-accepts and acknowledges messages —
    the reference's `ria_gui -sim` twin-station mode.
    audio mode: owns a single Station + runtime.audio backend.
    """

    def __init__(self, mycall: str = "N0CALL", peer: str = "VIRT",
                 sim_channel=None, seed: int = 42, audio_backend=None,
                 settings=None, settings_path=None,
                 record_prefix: str | None = None,
                 device: str | torch.device = "cuda", draws=None):
        from ria_tpu_torch.config import AppSettings
        from ria_tpu_torch.protocol.engine import ProtocolEngine

        self.state = TuiState()
        self.peer = peer
        self.settings_path = settings_path
        if settings is None and settings_path is not None:
            settings = AppSettings.load(settings_path)
        self.settings = settings or AppSettings()
        self.record_prefix = (os.path.join(tempfile.gettempdir(), "ria_tui")
                              if record_prefix is None else record_prefix)
        self._rec_files = None
        self.file_progress = None
        self.sim = None
        self.audio = None
        if sim_channel is not None:
            from ria_tpu_torch.sim.simulator import DualStationSim

            self.sim = DualStationSim(sim_channel, seed=seed, device=device, draws=draws)
            self.station = self.sim.alpha
            self.station.callsign = mycall
            self.station.conn.set_local_callsign(mycall)
            self.peer = "BRAVO"
            # Full engine on the virtual peer too, so file transfers and
            # compressed messages round-trip in sim mode.
            self.peer_engine = ProtocolEngine(conn=self.sim.bravo.conn)
            self.peer_engine.on_message = self._peer_got
            self.peer_engine.on_file_received = \
                lambda name, data, ok: self._log(
                    "peer", f"file {name!r} received ({len(data)} B, ok={ok})")
        else:
            from ria_tpu_torch.phy.station import Station
            from ria_tpu_torch.runtime.audio import AudioEngine, LoopbackBackend

            self.station = Station(mycall, device=device)
            self.audio = AudioEngine(backend=audio_backend or LoopbackBackend(),
                                     rx_callback=self._rx_tee)
        # ProtocolEngine over the station's connection: message
        # compression/encryption + file transfer with progress (the
        # reference GUI's file panel, app.hpp).
        self.engine = ProtocolEngine(conn=self.station.conn)
        self.engine.files.on_progress = self._on_file_progress
        self.engine.on_file_received = self._on_file_received
        self.monitor = ModemMonitor(self.station)

        def _observe(rx):
            self.monitor.observe_rx(rx)
            syms = getattr(self.station.data_wf, "last_symbols", None)
            if syms is None:
                syms = getattr(self.station.handshake_wf, "last_symbols", None)
            if syms is not None and len(syms):
                self.monitor.constellation.push(syms)

        self.station.on_rx_frame = _observe
        self.engine.on_message = self._got_message
        self.engine.on_connected = lambda: self._log("sys", "CONNECTED")
        self.engine.on_disconnected = \
            lambda r: self._log("sys", f"DISCONNECTED ({r})")

    # ------------------------------------------------------------- events
    def _log(self, direction: str, text):
        self.state.messages.append((direction, str(text)))
        del self.state.messages[:-200]

    def _got_message(self, data: bytes):
        self._log("rx", data.decode("utf-8", "replace"))

    def _peer_got(self, data: bytes):
        # Virtual peer acknowledges traffic (reference sim-mode echo).
        self._log("peer", data.decode("utf-8", "replace"))

    # ------------------------------------------------------------- control
    def connect(self):
        self._log("sys", f"connecting {self.peer}...")
        self.station.conn.connect(self.peer)

    def disconnect(self):
        self.station.conn.disconnect()

    def beacon(self):
        self.station.conn.send_beacon(b"TUI")
        self._log("sys", "beacon queued")

    def send_message(self, text: str):
        if not text:
            return
        if text.startswith("/file "):
            self.send_file(text[6:].strip())
            return
        if text.startswith("/set "):
            parts = text[5:].split(None, 1)
            if len(parts) == 2:
                self.apply_setting(parts[0], parts[1])
            else:
                self._log("sys", "usage: /set <field> <value>")
            return
        self.engine.send_message(text.encode())
        self._log("tx", text)

    # --------------------------------------------------------- file transfer
    def send_file(self, path: str):
        import os

        if not os.path.isfile(path):
            self._log("sys", f"no such file: {path}")
            return
        with open(path, "rb") as f:
            data = f.read()
        self.engine.send_file(os.path.basename(path), data)
        self._log("sys", f"sending file {path} ({len(data)} B)")

    def _on_file_progress(self, p):
        self.file_progress = p

    def _on_file_received(self, name: str, data: bytes, ok: bool):
        self._log("sys", f"file {name!r} received ({len(data)} B, ok={ok})")

    # -------------------------------------------------------------- settings
    def apply_setting(self, field_name: str, value: str):
        """Edit an AppSettings field live and persist to the INI (the
        reference settings widget, docs/CONFIGURATION_SYSTEM.md:20-32)."""
        from dataclasses import fields as dc_fields

        valid = {f.name: f.type for f in dc_fields(type(self.settings))}
        if field_name not in valid:
            self._log("sys", f"unknown setting {field_name!r} "
                             f"(fields: {', '.join(sorted(valid))})")
            return
        cur = getattr(self.settings, field_name)
        try:
            if isinstance(cur, bool):
                new = value.strip().lower() in ("1", "true", "yes", "on")
            else:
                new = type(cur)(value.strip())
        except ValueError:
            self._log("sys", f"bad value for {field_name}: {value!r}")
            return
        setattr(self.settings, field_name, new)
        self._apply_settings_live(field_name, new)
        if self.settings_path is not None:
            self.settings.save(self.settings_path)
            self._log("sys", f"set {field_name}={new} (saved)")
        else:
            self._log("sys", f"set {field_name}={new}")

    def _apply_settings_live(self, field_name: str, value):
        conn = self.station.conn
        if field_name == "mycall":
            self.station.callsign = value
            conn.set_local_callsign(value)
        elif field_name == "auto_accept":
            conn.config.auto_accept = value
        elif field_name == "compression":
            self.engine.compression_enabled = value
        elif field_name == "encryption_key":
            self.engine.set_encryption_key(value or None)
        elif field_name == "forced_modulation":
            conn.config.forced_modulation = None if value == "AUTO" else value
        elif field_name == "forced_rate":
            conn.config.forced_rate = None if value == "AUTO" else value

    def render_settings(self) -> list[str]:
        from dataclasses import asdict

        out = ["settings (edit: :set <field> <value>)"]
        for k, v in asdict(self.settings).items():
            out.append(f"  {k:<18} = {v}")
        return out

    # ------------------------------------------------------------- recording
    def toggle_recording(self):
        """RX/TX f32 capture toggle (reference app.hpp:185 RX/TX recording)."""
        if self._rec_files is None:
            rx = open(f"{self.record_prefix}_rx.f32", "ab")
            tx = open(f"{self.record_prefix}_tx.f32", "ab")
            self._rec_files = (rx, tx)
            self._orig_feed = self.station.feed_audio
            self._orig_enqueue = self.station._enqueue_tx

            def feed(samples, _o=self._orig_feed, _f=rx):
                np.asarray(samples, np.float32).tofile(_f)
                return _o(samples)

            def enqueue(samples, _o=self._orig_enqueue, _f=tx):
                np.asarray(samples, np.float32).tofile(_f)
                return _o(samples)

            self.station.feed_audio = feed
            self.station._enqueue_tx = enqueue
            self.state.recording = True
            self._log("sys", f"recording -> {self.record_prefix}_{{rx,tx}}.f32")
        else:
            self.station.feed_audio = self._orig_feed
            self.station._enqueue_tx = self._orig_enqueue
            for f in self._rec_files:
                f.close()
            self._rec_files = None
            self.state.recording = False
            self._log("sys", "recording stopped")

    def _rx_tee(self, samples):
        self.station.feed_audio(samples)

    def handle_key(self, ch: str):
        st = self.state
        if st.composing:
            if ch == "\n":
                self.send_message(st.input_line)
                st.input_line = ""
                st.composing = False
            elif ch == "\x1b":  # Esc cancels
                st.input_line = ""
                st.composing = False
            elif ch in ("\x7f", "\b"):
                st.input_line = st.input_line[:-1]
            elif ch.isprintable():
                st.input_line += ch
            return
        if ch in (":", "\n"):
            st.composing = True
            st.input_line = ""
        elif ch == "c":
            self.connect()
        elif ch == "d":
            self.disconnect()
        elif ch == "b":
            self.beacon()
        elif ch == "s":
            st.show_settings = not st.show_settings
        elif ch == "r":
            self.toggle_recording()
        elif ch == "q":
            st.running = False

    # ------------------------------------------------------------- engine
    def step(self):
        """Advance one audio block (sim tick or audio-engine block)."""
        if self.sim is not None:
            self.sim.step()
        else:
            if self.station.tx_pending:
                self.audio.queue_tx(self.station.pull_tx(48000))
            self.audio.process_block()
            self.station.poll()
            self.station.tick(21, poll=False)

    def build_frame(self, width: int = 100, height: int = 30) -> list[str]:
        wf_w = max(40, width - 36)
        db, _ = self.monitor.waterfall_frame(48000 * 2)
        wrows = render_waterfall(db, width=wf_w, height=10)
        crows = render_constellation(self.monitor.constellation.snapshot(),
                                     width=31, height=10)
        status = self.monitor.status()
        extra = {}
        if self.station.chase is not None:
            cs = self.station.chase.stats
            extra["chase"] = f"hits {cs.cache_hits} combines {cs.combines} " \
                             f"recoveries {cs.recoveries}"
        srows = render_status(status, self.station.conn.link, extra)

        rec = " [REC]" if self.state.recording else ""
        out = [f"ria_tpu operator console — {self.station.callsign}{rec}"
               f"  (c)onnect (d)isconnect (b)eacon (s)ettings (r)ec (q)uit"
               f"  ':' compose"]
        out.append("-" * width)
        for i in range(10):
            left = wrows[i] if i < len(wrows) else ""
            right = crows[i] if i < len(crows) else ""
            out.append(f"{left:<{wf_w}}  |{right}")
        out.append("-" * width)
        out.extend(srows)
        fp = self.file_progress
        if fp is not None:
            frac = fp.percentage / 100.0
            bar = "#" * int(20 * frac) + "-" * (20 - int(20 * frac))
            what = "send" if fp.is_sending else "recv"
            out.append(f"file   {what} {fp.filename} [{bar}] "
                       f"{fp.transferred_bytes}/{fp.total_bytes} B "
                       f"({fp.percentage:.0f}%)")
        out.append("-" * width)
        if self.state.show_settings:
            out.extend(self.render_settings())
            out.append("-" * width)
        for d, m in self.state.messages[-(height - len(out) - 2):]:
            out.append(f"[{d}] {m}")
        out.append("-" * width)
        prompt = ":" if self.state.composing else ">"
        out.append(f"{prompt} " + self.state.input_line)
        return out[:height]

    def run_curses(self, fps: float = 5.0):  # pragma: no cover - terminal
        _curses_loop(self, fps=fps)


def _curses_loop(app, fps: float = 5.0):  # pragma: no cover - terminal
    """Shared curses loop: step -> render -> keys, for TuiApp and
    AttachedConsole (both expose step/build_frame/handle_key/state)."""
    import curses

    def loop(scr):
        curses.curs_set(1)
        scr.nodelay(True)
        while app.state.running:
            t0 = time.monotonic()
            app.step()
            h, w = scr.getmaxyx()
            frame = app.build_frame(width=max(60, w - 1), height=max(16, h - 1))
            scr.erase()
            for i, line in enumerate(frame[: h - 1]):
                scr.addnstr(i, 0, line, w - 1)
            scr.refresh()
            while True:
                try:
                    ch = scr.get_wch()
                except curses.error:
                    break
                app.handle_key(ch if isinstance(ch, str) else "")
            dt = 1.0 / fps - (time.monotonic() - t0)
            if dt > 0:
                time.sleep(dt)

    curses.wrapper(loop)


class AttachedConsole:
    """Dashboard attached to a RUNNING modem over the TCP host interface.

    Speaks the command port's line protocol (runtime/host_interface.py):
    polls STATUS, receives async event lines (CONNECTED/DATA-RX/...), and
    sends payload bytes through the data port — the reference's external-
    app workflow (RIACodex companion) with the GUI's console on top.  No
    waterfall/constellation: those need the sample stream, which stays in
    the modem process (same split as the reference's TCP surface).
    """

    def __init__(self, host: str = "127.0.0.1", command_port: int = 8300,
                 data_port: int = 8301):
        import socket

        self.state = TuiState()
        self.cmd = socket.create_connection((host, command_port), timeout=5.0)
        self.cmd.setblocking(False)
        self.data = socket.create_connection((host, data_port), timeout=5.0)
        self.data.setblocking(False)
        self._cmd_buf = b""
        self.status: dict = {}
        self.peer = ""

    def _log(self, direction: str, text):
        self.state.messages.append((direction, str(text)))
        del self.state.messages[:-200]

    def send_command(self, line: str):
        self.cmd.sendall(line.encode() + b"\r")

    def connect(self, callsign: str):
        self.peer = callsign
        self.send_command(f"CONNECT {callsign}")

    def disconnect(self):
        self.send_command("DISCONNECT")

    def send_message(self, text: str):
        if text:
            self.data.sendall(text.encode())
            self._log("tx", text)

    def handle_key(self, ch: str):
        st = self.state
        if st.composing:
            if ch == "\n":
                self.send_message(st.input_line)
                st.input_line = ""
                st.composing = False
            elif ch == "\x1b":
                st.input_line = ""
                st.composing = False
            elif ch in ("\x7f", "\b"):
                st.input_line = st.input_line[:-1]
            elif ch.isprintable():
                st.input_line += ch
            return
        if ch in (":", "\n"):
            st.composing = True
            st.input_line = ""
        elif ch == "d":
            self.disconnect()
        elif ch == "s":
            self.send_command("STATUS")
        elif ch == "q":
            st.running = False

    def step(self):
        """Drain sockets, request fresh status."""
        import socket

        try:
            while True:
                chunk = self.cmd.recv(4096)
                if not chunk:
                    break
                self._cmd_buf += chunk
        except (BlockingIOError, socket.timeout):
            pass
        while b"\r" in self._cmd_buf or b"\n" in self._cmd_buf:
            nl = min(i for i in (self._cmd_buf.find(b"\r"), self._cmd_buf.find(b"\n"))
                     if i >= 0)
            line, self._cmd_buf = (self._cmd_buf[:nl].decode("utf-8", "replace"),
                                   self._cmd_buf[nl + 1:])
            if not line:
                continue
            if line.startswith("STATUS "):
                self.status = dict(kv.split("=", 1) for kv in line[7:].split()
                                   if "=" in kv)
            elif line not in ("OK", "PENDING"):
                self._log("evt", line)
        try:
            rx = self.data.recv(65536)
            if rx:
                self._log("rx", rx.decode("utf-8", "replace"))
        except (BlockingIOError, socket.timeout):
            pass
        self.send_command("STATUS")

    def build_frame(self, width: int = 80, height: int = 24) -> list[str]:
        s = self.status
        out = [f"ria_tpu attached console — {s.get('state', '?')}"
               f"  (d)isconnect (s)tatus (q)uit"]
        out.append("-" * width)
        out.append(f"remote {s.get('remote', '-')}  link {s.get('wf', '?')}/"
                   f"{s.get('mod', '?')}/{s.get('rate', '?')}")
        out.append(f"snr {s.get('snr', '?')} dB  fading {s.get('fading', '?')}  "
                   f"rx {s.get('rx', '?')} tx {s.get('tx', '?')} "
                   f"fail {s.get('fail', '?')} buf {s.get('buf', '?')}%")
        out.append("-" * width)
        for d, m in self.state.messages[-(height - len(out) - 2):]:
            out.append(f"[{d}] {m}")
        out.append("-" * width)
        out.append("> " + self.state.input_line)
        return out[:height]

    def close(self):
        self.cmd.close()
        self.data.close()

    def run_curses(self, fps: float = 4.0):  # pragma: no cover - terminal
        _curses_loop(self, fps=fps)
