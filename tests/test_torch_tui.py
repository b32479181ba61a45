"""The port's operator console (``ria_tpu_torch.runtime.tui``) headless.

Mirrors tests/test_tui.py on the CPU port, plus: the renderers give the
reference's text on the same inputs; a sim-mode session driven by the same
keys is held to the reference's ``TuiApp`` block by block (the port fed the
reference's ``jax.random`` draws, tests/test_torch_jax_draws.py): the
console messages, the connection state and the status rows exact.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import pytest
import torch

import test_torch_jax_draws as D
from ria_tpu.runtime import tui as RT
from ria_tpu.sim import awgn as j_awgn
from ria_tpu_torch.runtime import tui as TT
from ria_tpu_torch.sim.channel import awgn

torch.set_num_threads(1)


def port_app(**kw):
    return TT.TuiApp(mycall="W1AW", sim_channel=awgn(18.0), device="cpu", **kw)


def test_tui_sim_session_frame():
    app = port_app(seed=7)
    app.handle_key("c")  # connect
    for _ in range(80):
        app.step()
        if app.station.conn.state.name == "CONNECTED":
            break
    assert app.station.conn.state.name == "CONNECTED"
    for ch in ":hello tui\n":   # ':' enters compose mode
        app.handle_key(ch)
    for _ in range(60):
        app.step()
    frame = "\n".join(app.build_frame())
    assert "CONNECTED" in frame
    assert "OFDM" in frame or "MC_DPSK" in frame
    assert "[tx] hello tui" in frame
    assert "[peer] hello tui" in frame       # virtual peer received it
    assert "snr" in frame and "dB" in frame
    # live SNR fed from decoded frames, not the 0.0 default
    assert app.monitor.status().snr_db > 5.0
    # constellation fed from equalized symbols
    assert len(app.monitor.constellation.snapshot()) > 0
    # quit key stops the loop
    app.handle_key("q")
    assert not app.state.running


def test_tui_sim_session_matches_reference():
    """The same keys into the reference's console and the port's: after
    every block the same console messages, connection states and status
    rows."""
    ref = RT.TuiApp(mycall="W1AW", sim_channel=j_awgn(18.0), seed=7)
    port = port_app(seed=7, draws=D.sim_draws(7))
    keys = {0: "c", 50: ":hello tui\n"}
    for tick in range(90):
        for app in (ref, port):
            for ch in keys.get(tick, ""):
                app.handle_key(ch)
            app.step()
        views = [(app.state.messages, app.station.conn.state.name,
                  app.sim.bravo.conn.state.name,
                  RT.render_status(app.monitor.status(), app.station.conn.link))
                 for app in (ref, port)]
        assert views[0][:3] == views[1][:3], f"block {tick}"
        # The status rows print the SNR to 0.1 dB; the port's is within 1e-3.
        assert abs(ref.monitor.status().snr_db - port.monitor.status().snr_db) <= 1e-3
        assert views[0][3] == views[1][3], f"block {tick}"
    assert ("peer", "hello tui") in port.state.messages


def test_tui_renderers_standalone():
    rows = TT.render_waterfall(np.random.default_rng(0).normal(0, 1, (40, 80)),
                               width=32, height=6)
    assert len(rows) == 6 and all(len(r) == 32 for r in rows)
    syms = (np.array([1 + 1j, -1 - 1j, 1 - 1j, -1 + 1j]) * 0.7)
    crows = TT.render_constellation(syms, width=21, height=11)
    assert sum(r.count("o") for r in crows) >= 3
    assert any("+" in r for r in crows)      # axes


@pytest.mark.parametrize("seed", range(3))
def test_renderers_equal_reference(seed):
    rng = np.random.default_rng(seed)
    db = rng.normal(-40, 10, (int(rng.integers(1, 60)), int(rng.integers(2, 120))))
    assert TT.render_waterfall(db, width=48, height=8) == RT.render_waterfall(
        db, width=48, height=8)
    assert TT.render_waterfall(np.zeros((0, 0))) == RT.render_waterfall(np.zeros((0, 0)))
    syms = (rng.normal(size=500) + 1j * rng.normal(size=500)) * 0.6
    assert TT.render_constellation(syms) == RT.render_constellation(syms)


def test_cli_gui_headless(capsys):
    from ria_tpu_torch.cli import main

    rc = main(["gui", "--device", "cpu", "--sim", "--snr", "15", "--frames", "3", "-s", "W1AW"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "operator console" in out and "W1AW" in out


def test_cli_gui_audio_mode_headless(capsys):
    """Without --sim the console runs one station on the loopback backend."""
    from ria_tpu_torch.cli import main

    assert main(["--device", "cpu", "gui", "--frames", "2"]) == 0
    assert "operator console — N0CALL" in capsys.readouterr().out


def test_attached_console_over_host_interface():
    """`ria gui --attach`: dashboard driving a RUNNING modem through the
    TCP host interface — STATUS polling, command keys, data-port TX."""
    from ria_tpu_torch.protocol.engine import ProtocolEngine
    from ria_tpu_torch.runtime.host_interface import HostInterface

    engine = ProtocolEngine()
    hi = HostInterface(engine, command_port=0, data_port=0, kiss_port=0,
                       backend="python")
    try:
        con = TT.AttachedConsole(command_port=hi.cmd_srv.port,
                                 data_port=hi.data_srv.port)
        for _ in range(20):
            hi.poll(0.02)
            con.step()
            if con.status:
                break
        assert con.status.get("state") == "DISCONNECTED"
        frame = "\n".join(con.build_frame())
        assert "attached console" in frame and "DISCONNECTED" in frame
        # keyed disconnect command reaches the engine (OK reply swallowed)
        con.handle_key("s")
        hi.poll(0.05)
        con.step()
        con.close()
    finally:
        hi.close()


def _interface_on_adjacent_ports():
    """A host interface whose data port is its command port + 1, as
    ``--attach`` assumes; the ports are picked by the system, not fixed."""
    import socket

    from ria_tpu_torch.protocol.engine import ProtocolEngine
    from ria_tpu_torch.runtime.host_interface import HostInterface

    for _ in range(50):
        with socket.socket() as probe:
            probe.bind(("127.0.0.1", 0))
            port = probe.getsockname()[1]
        try:
            return HostInterface(ProtocolEngine(), command_port=port, data_port=port + 1,
                                 backend="native")
        except OSError:
            continue
    raise AssertionError("no two adjacent free ports")


def test_cli_gui_attach_headless(capsys):
    """``gui --attach HOST:PORT --frames N`` reads STATUS from a running
    host interface and prints the attached console's frame."""
    import threading

    from ria_tpu_torch.cli import main

    hi = _interface_on_adjacent_ports()
    stop = threading.Event()

    def serve():
        while not stop.is_set():
            hi.poll(0.01)

    server = threading.Thread(target=serve)
    server.start()
    try:
        assert main(["--device", "cpu", "gui", "--attach", f"127.0.0.1:{hi.cmd_srv.port}",
                     "--frames", "20"]) == 0
    finally:
        stop.set()
        server.join(timeout=10)
        hi.close()
    assert not server.is_alive()
    assert "attached console" in capsys.readouterr().out


def test_tui_compose_mode_protects_command_letters():
    """A message starting with c/d/b/q must be composable — bare letters are
    commands only OUTSIDE compose mode."""
    app = port_app(seed=8)
    sent = []
    app.engine.send_message = lambda d: sent.append(bytes(d)) or True
    for ch in ":bye for now\n":
        app.handle_key(ch)
    assert sent == [b"bye for now"]
    assert app.state.running  # the 'b' did not fire the beacon/quit path
    # Esc cancels composing without sending
    app.handle_key(":")
    for ch in "draft":
        app.handle_key(ch)
    app.handle_key("\x1b")
    assert not app.state.composing and app.state.input_line == ""
    assert sent == [b"bye for now"]


def test_tui_settings_editor_persists_ini(tmp_path):
    """'s' shows the settings pane, `/set` edits a field live AND persists
    it to the INI, which the reference package loads to the same fields."""
    from ria_tpu.config import AppSettings as RSettings
    from ria_tpu_torch.config import AppSettings

    ini = tmp_path / "ria.ini"
    app = port_app(seed=9, settings_path=str(ini))
    app.handle_key("s")
    assert app.state.show_settings
    frame = "\n".join(app.build_frame(height=40))
    assert "settings" in frame and "mycall" in frame
    for ch in ":/set mycall K2XYZ\n":
        app.handle_key(ch)
    for ch in ":/set compression false\n":
        app.handle_key(ch)
    assert app.settings.mycall == "K2XYZ"
    assert app.station.callsign == "K2XYZ"
    assert app.engine.compression_enabled is False
    reloaded = AppSettings.load(ini)
    assert reloaded.mycall == "K2XYZ"
    assert reloaded.compression is False
    assert RSettings.load(ini).mycall == "K2XYZ"


def test_tui_recording_toggle(tmp_path):
    """'r' toggles recording; the files carry the audio that actually
    flowed."""
    app = port_app(seed=10, record_prefix=str(tmp_path / "cap"))
    app.handle_key("r")
    assert app.state.recording
    app.handle_key("c")
    for _ in range(40):
        app.step()
    app.handle_key("r")
    assert not app.state.recording
    rx = np.fromfile(tmp_path / "cap_rx.f32", np.float32)
    tx = np.fromfile(tmp_path / "cap_tx.f32", np.float32)
    assert len(rx) > 48000 and len(tx) > 1000
    assert float(np.abs(tx).max()) > 0.01  # the PING actually went out


def test_tui_records_under_the_temporary_directory():
    app = port_app(seed=12)
    assert app.record_prefix == os.path.join(tempfile.gettempdir(), "ria_tui")


def test_tui_file_transfer_progress():
    """File panel: /file sends through the engine, the progress bar renders,
    and the virtual peer receives the payload intact."""
    app = port_app(seed=11)
    app.handle_key("c")
    for _ in range(80):
        app.step()
        if app.station.conn.state.name == "CONNECTED":
            break
    assert app.station.conn.state.name == "CONNECTED"

    got = []
    app.peer_engine.on_file_received = \
        lambda name, data, ok: got.append((name, data, ok))
    payload = bytes(range(256)) * 2
    with tempfile.NamedTemporaryFile(suffix=".bin", delete=False) as f:
        f.write(payload)
        path = f.name
    try:
        for ch in f":/file {path}\n":
            app.handle_key(ch)
        for _ in range(400):
            app.step()
            if got:
                break
        assert got and got[0][1] == payload and got[0][2]
        frame = "\n".join(app.build_frame(height=40))
        assert "file" in frame and "%" in frame
    finally:
        os.unlink(path)
