"""TCP host-control interface (ARDOP-style command/data/KISS servers).

Port of ``ria_tpu/runtime/host_interface.py``: the same servers, commands
and reply strings (``VERSION`` answers ``VERSION ria_tpu <version>`` with the
port's ``__version__``), over the port's engine and station.  ``RAWTX``
builds its waveform on the attached station's device, so its TX runs where
the station's waveforms do (the card by default).

Contract from the reference (src/interface/, docs/TCPCommands.md):
- command port 8300: ASCII commands terminated \\r or \\n — CONNECT/
  DISCONNECT/ABORT, BEACON/CQ/PING/RAWTX, MYCALL, WAVEFORM/MODULATION/
  CODERATE/MCDPSKCARRIERS, COMPRESSION, ENCRYPT/ENCRYPTKEY, PTT timing,
  VERSION/STATE/BUSY/BUFFER queries; replies OK/PENDING/ERROR ...;
  async events (CONNECTED/DISCONNECTED/DATA notifications) pushed to all
  command clients;
- data port 8301: raw payload bytes in/out (1 MiB RX buffer cap);
- optional KISS TNC port 8302: FEND/FESC framing (kiss_tnc.hpp).

Implementation: selectors-based single-threaded servers (the reference's
TcpServer is select-based too); poll() integrates into the station tick
loop.
"""

from __future__ import annotations

import selectors
import socket
from typing import Callable

from ria_tpu_torch import __version__
from ria_tpu_torch.phy.frame_v2 import WaveformMode, sanitize_callsign

KISS_FEND = 0xC0
KISS_FESC = 0xDB
KISS_TFEND = 0xDC
KISS_TFESC = 0xDD

RX_BUFFER_CAP = 1 << 20


def kiss_escape(data: bytes) -> bytes:
    out = bytearray([KISS_FEND, 0x00])
    for b in data:
        if b == KISS_FEND:
            out += bytes([KISS_FESC, KISS_TFEND])
        elif b == KISS_FESC:
            out += bytes([KISS_FESC, KISS_TFESC])
        else:
            out.append(b)
    out.append(KISS_FEND)
    return bytes(out)


def kiss_unescape(stream: bytearray) -> list[bytes]:
    """Extract complete KISS frames from a mutable stream buffer."""
    frames = []
    while True:
        try:
            start = stream.index(KISS_FEND)
        except ValueError:
            stream.clear()
            return frames
        try:
            end = stream.index(KISS_FEND, start + 1)
        except ValueError:
            del stream[:start]
            return frames
        raw = bytes(stream[start + 1 : end])
        del stream[: end + 1]
        if not raw:
            continue
        payload = bytearray()
        i = 1  # skip port/command byte
        while i < len(raw):
            b = raw[i]
            if b == KISS_FESC and i + 1 < len(raw):
                payload.append(KISS_FEND if raw[i + 1] == KISS_TFEND else KISS_FESC)
                i += 2
            else:
                payload.append(b)
                i += 1
        frames.append(bytes(payload))


class _TcpServer:
    def __init__(self, sel: selectors.DefaultSelector, port: int, on_data):
        self.sel = sel
        self.on_data = on_data
        self.clients: dict[socket.socket, bytearray] = {}
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind(("127.0.0.1", port))
        self.listener.listen(4)
        self.listener.setblocking(False)
        self.port = self.listener.getsockname()[1]
        sel.register(self.listener, selectors.EVENT_READ, self._accept)

    def _accept(self, sock):
        conn, _ = sock.accept()
        conn.setblocking(False)
        self.clients[conn] = bytearray()
        self.sel.register(conn, selectors.EVENT_READ, self._read)

    def _read(self, conn):
        try:
            data = conn.recv(65536)
        except ConnectionError:
            data = b""
        if not data:
            self.sel.unregister(conn)
            self.clients.pop(conn, None)
            conn.close()
            return
        buf = self.clients[conn]
        buf.extend(data)
        if len(buf) > RX_BUFFER_CAP:
            del buf[: len(buf) - RX_BUFFER_CAP]
        self.on_data(conn, buf)

    def broadcast(self, data: bytes):
        for conn in list(self.clients):
            try:
                conn.sendall(data)
            except OSError:
                pass

    def close(self):
        for conn in list(self.clients):
            try:
                self.sel.unregister(conn)
            except Exception:
                pass
            conn.close()
        self.sel.unregister(self.listener)
        self.listener.close()


class _NativeClientHandle:
    """sendall()-compatible wrapper so command handlers can reply to one
    client regardless of backend."""

    def __init__(self, srv, cid: int):
        self._srv, self._cid = srv, cid

    def sendall(self, data: bytes):
        self._srv.send(self._cid, data)


class _NativeServerAdapter:
    """C++ TcpServer (native/ria_native.cpp) behind the same surface as
    _TcpServer: per-client line buffers, on_data(conn, buf) callbacks,
    broadcast, close.  Selected automatically when the native library is
    available (the reference's TcpServer is C++; this keeps the host-control
    plane native with Python only parsing command lines)."""

    def __init__(self, port: int, on_data):
        from ria_tpu_torch.runtime.native import NativeTcpServer

        self.srv = NativeTcpServer(port)
        self.port = self.srv.port
        self.on_data = on_data
        self.buffers: dict[int, bytearray] = {}
        self.handles: dict[int, _NativeClientHandle] = {}

    def poll(self, timeout_ms: int = 0):
        self.srv.poll(timeout_ms)
        for ev, cid, payload in self.srv.drain():
            if ev == "connect":
                self.buffers[cid] = bytearray()
                self.handles[cid] = _NativeClientHandle(self.srv, cid)
            elif ev == "disconnect":
                self.buffers.pop(cid, None)
                self.handles.pop(cid, None)
            else:
                buf = self.buffers.setdefault(cid, bytearray())
                buf.extend(payload)
                if len(buf) > RX_BUFFER_CAP:
                    del buf[: len(buf) - RX_BUFFER_CAP]
                self.on_data(self.handles.setdefault(
                    cid, _NativeClientHandle(self.srv, cid)), buf)

    def broadcast(self, data: bytes):
        self.srv.broadcast(data)

    def close(self):
        self.srv.close()


def _native_tcp_available() -> bool:
    from ria_tpu_torch.runtime.native import available

    return available()


class HostInterface:
    """Binds TCP servers to a ProtocolEngine/Station pair.

    backend: "native" (C++ select server), "python" (selectors), or "auto"
    (native when the toolchain/library is available).
    """

    def __init__(self, engine, station=None, command_port: int = 8300,
                 data_port: int = 8301, kiss_port: int | None = None,
                 backend: str = "auto"):
        self.engine = engine
        self.station = station
        if backend == "auto":
            backend = "native" if _native_tcp_available() else "python"
        self.backend = backend
        if backend == "native":
            self.sel = None
            self.cmd_srv = _NativeServerAdapter(command_port, self._on_cmd_data)
            self.data_srv = _NativeServerAdapter(data_port, self._on_data_data)
            self.kiss_srv = (_NativeServerAdapter(kiss_port, self._on_kiss_data)
                             if kiss_port is not None else None)
        else:
            self.sel = selectors.DefaultSelector()
            self.cmd_srv = _TcpServer(self.sel, command_port, self._on_cmd_data)
            self.data_srv = _TcpServer(self.sel, data_port, self._on_data_data)
            self.kiss_srv = (_TcpServer(self.sel, kiss_port, self._on_kiss_data)
                             if kiss_port is not None else None)
        self.listen = True
        self.forced = {"waveform": "AUTO", "modulation": "AUTO", "coderate": "AUTO"}
        self.ptt_lead_ms = 100
        self.ptt_tail_ms = 50
        self.tx_drive = 1.0

        engine.on_connected = lambda: self._event("CONNECTED %s" % engine.conn.remote_call)
        engine.on_disconnected = lambda r: self._event("DISCONNECTED %s" % r)
        engine.on_message = self._on_engine_message

    # ------------------------------------------------------------------ events
    def _event(self, line: str):
        self.cmd_srv.broadcast((line + "\r\n").encode())

    def _on_engine_message(self, data: bytes):
        self.data_srv.broadcast(data)
        if self.kiss_srv:
            self.kiss_srv.broadcast(kiss_escape(data))

    # ------------------------------------------------------------------ RX
    def _on_cmd_data(self, conn, buf: bytearray):
        while True:
            pos = -1
            for i, b in enumerate(buf):
                if b in (0x0D, 0x0A):
                    pos = i
                    break
            if pos < 0:
                return
            line = bytes(buf[:pos]).decode(errors="replace").strip()
            del buf[: pos + 1]
            if line:
                reply = self.handle_command(line)
                if reply:
                    try:
                        conn.sendall((reply + "\r\n").encode())
                    except OSError:
                        pass

    def _on_data_data(self, conn, buf: bytearray):
        if buf:
            payload = bytes(buf)
            buf.clear()
            self.engine.send_message(payload)

    def _on_kiss_data(self, conn, buf: bytearray):
        for frame in kiss_unescape(buf):
            self.engine.send_message(frame)

    # ------------------------------------------------------------------ commands
    def handle_command(self, line: str) -> str:
        parts = line.split()
        cmd = parts[0].upper()
        args = parts[1:]

        if cmd == "CONNECT":
            if not args:
                return "ERROR Invalid callsign"
            call = sanitize_callsign(args[0])
            if not call:
                return "ERROR Invalid callsign"
            from ria_tpu_torch.protocol.connection import ConnectionState

            if self.engine.state == ConnectionState.CONNECTED:
                return "ERROR Already connected"
            return "PENDING" if self.engine.connect(call) else "ERROR Connect failed"
        if cmd == "DISCONNECT":
            self.engine.disconnect()
            return "OK"
        if cmd == "ABORT":
            self.engine.conn._enter_disconnected("abort")
            return "OK"
        if cmd == "MYCALL":
            if not args:
                return "ERROR Missing callsign"
            self.engine.set_callsign(sanitize_callsign(args[0]))
            return "OK"
        if cmd == "BEACON":
            self.engine.send_beacon()
            return "OK"
        if cmd == "CQ":
            # CQ = beacon carrying a short text payload, then stay listening
            # (reference command_parser.hpp:23).
            self.engine.send_beacon((" ".join(args)).encode() if args else b"CQ")
            self.listen = True
            return "OK"
        if cmd == "RAWTX":
            # Disconnected raw PHY TX (reference command_parser.hpp:25):
            # RAWTX [waveform] [modulation] [rate] <hex-or-text payload...>
            if self.station is None:
                return "ERROR No modem attached"
            from ria_tpu_torch.phy.frame_v2 import DataFrame
            from ria_tpu_torch.wave.api import create_waveform

            wf_name = args[0].upper() if args else "MC_DPSK"
            mod = args[1].upper() if len(args) > 1 else "DBPSK"
            rate = args[2].upper() if len(args) > 2 else "R1_4"
            text = " ".join(args[3:]) if len(args) > 3 else "RAWTX"
            try:
                wf = create_waveform(WaveformMode[wf_name], mod, rate,
                                     device=self.station.device)
            except KeyError:
                return f"ERROR Unknown waveform {wf_name}"
            frame = DataFrame.make_data(self.engine.conn.local_call or "NOCALL",
                                        "CQ", 0, text.encode())
            import numpy as _np

            self.station.tx_queue.append(
                _np.asarray(wf.tx_frame(frame.serialize()), _np.float32))
            return "OK"
        if cmd in ("PTT", "PTTSTATE"):
            on = bool(self.station and self.station.tx_pending)
            return f"PTT {'ON' if on else 'OFF'}"
        if cmd == "CATCONNECT":
            from ria_tpu_torch.runtime.cat import CatController

            self.cat = CatController()  # NullBackend unless hardware configured
            return "OK"
        if cmd == "CATDISCONNECT":
            self.cat = None
            return "OK"
        if cmd == "CATPTT":
            cat = getattr(self, "cat", None)
            if cat is None:
                return "ERROR CAT not connected"
            if args and args[0].upper() == "ON":
                cat.request_tx()
            else:
                cat.tick(10 ** 6, tx_active=False)  # force release via tail
            return "OK"
        if cmd == "PING":
            return "PENDING" if args and self.engine.connect(sanitize_callsign(args[0])) \
                else "ERROR Missing callsign"
        if cmd == "COMPRESSION":
            self.engine.compression_enabled = bool(args and args[0].upper() == "ON")
            return "OK"
        if cmd == "ENCRYPT":
            if args and args[0].upper() == "OFF":
                self.engine.set_encryption_key(None)
            elif not self.engine.encryption_enabled:
                return "ERROR Set ENCRYPTKEY first"
            return "OK"
        if cmd == "ENCRYPTKEY":
            if not args:
                return "ERROR Missing passphrase"
            self.engine.set_encryption_key(" ".join(args))
            return "OK"
        if cmd == "LISTEN":
            self.listen = bool(args and args[0].upper() == "ON")
            return "OK"
        if cmd in ("WAVEFORM", "MODULATION", "CODERATE"):
            if not args:
                return "ERROR Missing value"
            self.forced[cmd.lower()] = args[0].upper()
            cfg = self.engine.conn.config
            if cmd == "WAVEFORM":
                cfg.preferred_mode = (WaveformMode[args[0].upper()]
                                      if args[0].upper() != "AUTO" else WaveformMode.AUTO)
            elif cmd == "MODULATION":
                cfg.forced_modulation = None if args[0].upper() == "AUTO" else args[0].upper()
            else:
                cfg.forced_rate = None if args[0].upper() == "AUTO" else args[0].upper()
            return "OK"
        if cmd == "MCDPSKCARRIERS":
            return "OK"
        if cmd == "PTTLEAD":
            self.ptt_lead_ms = int(args[0]) if args else self.ptt_lead_ms
            return "OK"
        if cmd == "PTTTAIL":
            self.ptt_tail_ms = int(args[0]) if args else self.ptt_tail_ms
            return "OK"
        if cmd == "TXDRIVE":
            self.tx_drive = float(args[0]) if args else self.tx_drive
            return "OK"
        if cmd == "VERSION":
            return f"VERSION ria_tpu {__version__}"
        if cmd == "STATUS":
            # One-line modem status for dashboards (reference status queries,
            # command_parser.hpp; consumed by `ria gui --attach`).
            conn = self.engine.conn
            link = conn.link
            st = self.station
            fields = [
                f"state={self.engine.state.name}",
                f"remote={conn.remote_call or '-'}",
                f"wf={link.waveform.name}", f"mod={link.modulation}",
                f"rate={link.rate}",
                f"snr={conn.measured_snr_db:.1f}",
                f"fading={conn.measured_fading:.2f}",
            ]
            if st is not None:
                fields += [f"rx={st.stats.frames_rx}", f"tx={st.stats.frames_tx}",
                           f"fail={st.stats.decode_failures}",
                           f"buf={st.buffer_fill_percent:.1f}"]
            return "STATUS " + " ".join(fields)
        if cmd == "STATE":
            return f"STATE {self.engine.state.name}"
        if cmd in ("BUSY", "BUSYSTATE"):
            busy = bool(self.station and self.station.tx_pending)
            return f"BUSY {'TRUE' if busy else 'FALSE'}"
        if cmd == "BUFFER":
            n = len(self.station.rx_buffer) if self.station else 0
            return f"BUFFER {n}"
        if cmd == "CLOSE":
            return "OK"
        return f"ERROR Unknown command {cmd}"

    # ------------------------------------------------------------------ tick
    def poll(self, timeout: float = 0.0):
        if self.sel is None:
            # Native backend: give the full timeout to the command server
            # (the usual waiter); data/KISS are drained non-blocking.
            self.cmd_srv.poll(int(timeout * 1000))
            self.data_srv.poll(0)
            if self.kiss_srv:
                self.kiss_srv.poll(0)
            return
        for key, _ in self.sel.select(timeout):
            key.data(key.fileobj)

    def close(self):
        self.cmd_srv.close()
        self.data_srv.close()
        if self.kiss_srv:
            self.kiss_srv.close()
        if self.sel is not None:
            self.sel.close()
