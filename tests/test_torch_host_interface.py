"""The port's TCP host interface (``ria_tpu_torch.runtime.host_interface``)
and two-modem tool (``ria_tpu_torch.tools.dual_modem_tcp``) against the
reference package.

Mirrors tests/test_host_interface.py.  Every server listens on an ephemeral
port (the reference's dual-modem test binds 8300-8312 and may run beside
these).  Command replies, KISS frames and delivered bytes are compared
exactly.  H1 of ``chip_smoke.py`` phase 4f (``tools/host_paths.py``) runs
twice: the port alone over real sockets, at outcome level; and in lock step
with the reference's ``DualModemTcp``, the port fed the reference's
``jax.random`` draws (tests/test_torch_jax_draws.py), every block equal
(stations as in a session snapshot with the measured SNR within 1e-3 dB;
engine states, command replies, event lines and the bytes out of each data
port exact).
"""

import socket
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import test_torch_jax_draws as D
from ria_tpu.phy.station import Station as JStation
from ria_tpu.protocol.connection import ConnectionState as JState
from ria_tpu.protocol.engine import ProtocolEngine as JEngine
from ria_tpu.runtime import host_interface as RH
from ria_tpu_torch.phy.station import Station as TStation
from ria_tpu_torch.protocol.connection import ConnectionState as TState
from ria_tpu_torch.protocol.engine import ProtocolEngine as TEngine
from ria_tpu_torch.runtime import host_interface as TH
from ria_tpu_torch.sim.channel import awgn
from ria_tpu_torch.tools import host_paths as H
from ria_tpu_torch.tools.dual_modem_tcp import DualModemTcp, self_test

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def make_iface(pkg: str, backend: str, station: bool = False):
    if pkg == "port":
        st = TStation("W1AW", device="cpu") if station else None
        eng = TEngine(conn=st.conn) if st is not None else TEngine()
        return TH.HostInterface(eng, station=st, command_port=0, data_port=0, kiss_port=0,
                                backend=backend)
    st = JStation("W1AW") if station else None
    eng = JEngine(conn=st.conn) if st is not None else JEngine()
    return RH.HostInterface(eng, station=st, command_port=0, data_port=0, kiss_port=0,
                            backend=backend)


@pytest.fixture(params=["python", "native"])
def iface(request):
    hi = make_iface("port", request.param)
    yield hi
    hi.close()


def _cmd(iface, line: str) -> str:
    s = socket.create_connection(("127.0.0.1", iface.cmd_srv.port), timeout=2)
    s.sendall((line + "\r").encode())
    deadline = time.time() + 2
    buf = b""
    s.settimeout(0.05)
    while time.time() < deadline and b"\r\n" not in buf:
        iface.poll(0.05)
        try:
            buf += s.recv(4096)
        except (TimeoutError, socket.timeout):
            pass
    s.close()
    # Async events (CONNECTED/DISCONNECTED) may precede the reply line.
    lines = [l for l in buf.decode().split("\r\n") if l]
    return lines[-1] if lines else ""


def test_version_and_state(iface):
    assert _cmd(iface, "VERSION") == "VERSION ria_tpu 0.1.0"
    assert _cmd(iface, "STATE") == "STATE DISCONNECTED"


def test_mycall_and_connect_flow(iface):
    assert _cmd(iface, "MYCALL w1aw") == "OK"
    assert iface.engine.conn.local_call == "W1AW"
    assert _cmd(iface, "CONNECT VE3ABC") == "PENDING"
    assert _cmd(iface, "ABORT") == "OK"
    assert _cmd(iface, "DISCONNECT") == "OK"


def test_config_commands(iface):
    assert _cmd(iface, "COMPRESSION OFF") == "OK"
    assert not iface.engine.compression_enabled
    assert _cmd(iface, "ENCRYPTKEY secret words") == "OK"
    assert iface.engine.encryption_enabled
    assert _cmd(iface, "WAVEFORM MC_DPSK") == "OK"
    assert _cmd(iface, "CODERATE R1_2") == "OK"
    assert iface.engine.conn.config.forced_rate == "R1_2"
    assert _cmd(iface, "BOGUS").startswith("ERROR")


def test_cq_rawtx_ptt_cat_commands(iface):
    """Reference command set parity: CQ, RAWTX, PTT/PTTSTATE, CAT* commands
    (command_parser.hpp:21-83)."""
    assert _cmd(iface, "MYCALL W1AW") == "OK"
    assert _cmd(iface, "CQ hello") == "OK"
    assert _cmd(iface, "PTTSTATE").startswith("PTT ")
    # RAWTX without a station attached reports the error cleanly.
    assert _cmd(iface, "RAWTX MC_DPSK DBPSK R1_4 hi") == "ERROR No modem attached"
    assert _cmd(iface, "CATPTT ON") == "ERROR CAT not connected"
    assert _cmd(iface, "CATCONNECT") == "OK"
    assert _cmd(iface, "CATPTT ON") == "OK"
    assert _cmd(iface, "CATDISCONNECT") == "OK"


def test_auto_backend_is_native():
    hi = TH.HostInterface(TEngine(), command_port=0, data_port=0, kiss_port=0)
    try:
        assert hi.backend == "native"
    finally:
        hi.close()


# The whole command set, in one conversation, as a host program would send it.
SCRIPT = [
    "VERSION", "STATE", "BUSY", "BUSYSTATE", "BUFFER", "PTT", "PTTSTATE", "STATUS",
    "MYCALL", "MYCALL w1aw/p", "CONNECT", "CONNECT !!", "PING", "CQ", "CQ hello world",
    "BEACON", "LISTEN OFF", "LISTEN ON", "COMPRESSION OFF", "COMPRESSION ON",
    "ENCRYPT ON", "ENCRYPTKEY", "ENCRYPTKEY two words", "ENCRYPT ON", "ENCRYPT OFF",
    "ENCRYPT ON", "WAVEFORM", "WAVEFORM OFDM_CHIRP", "WAVEFORM AUTO", "MODULATION QAM16",
    "MODULATION AUTO", "CODERATE R2_3", "CODERATE AUTO", "MCDPSKCARRIERS 16",
    "PTTLEAD 150", "PTTLEAD", "PTTTAIL 30", "TXDRIVE 0.5", "CATPTT ON", "CATCONNECT",
    "CATPTT ON", "CATPTT OFF", "CATDISCONNECT", "RAWTX FOO DBPSK R1_4 x",
    "RAWTX MC_DPSK DBPSK R1_4 raw frame text", "PTT", "BUSY", "STATUS", "BUFFER",
    "CONNECT VE3ABC", "STATE", "CONNECT VE3ABC", "ABORT", "STATE", "PING K1ABC",
    "DISCONNECT", "CLOSE", "bogus command", "status",
]


@pytest.mark.parametrize("backend", ["python", "native"])
def test_command_set_replies_equal_reference(backend):
    """Every command of the set through both packages' interfaces with a
    station attached: the same reply strings, the same engine settings, and
    the RAWTX frame queued on both stations."""
    replies, state = {}, {}
    for pkg in ("ref", "port"):
        hi = make_iface(pkg, backend, station=True)
        try:
            replies[pkg] = [_cmd(hi, line) for line in SCRIPT]
            cfg = hi.engine.conn.config
            state[pkg] = (hi.listen, dict(hi.forced), hi.ptt_lead_ms, hi.ptt_tail_ms,
                          hi.tx_drive, hi.engine.compression_enabled,
                          hi.engine.encryption_enabled, hi.engine.conn.local_call,
                          cfg.preferred_mode.name, cfg.forced_modulation, cfg.forced_rate,
                          [len(a) for a in hi.station.tx_queue])
        finally:
            hi.close()
    assert replies["port"] == replies["ref"]
    assert state["port"] == state["ref"]
    assert "VERSION ria_tpu 0.1.0" in replies["port"]
    assert any(r.startswith("STATUS state=") for r in replies["port"])


def test_rawtx_builds_its_frame_on_the_station_device(monkeypatch):
    """RAWTX takes the station's device, and its frame is the port's TX of
    the reference's DATA frame to CQ."""
    from ria_tpu_torch.wave import api

    made = []
    inner = api.create_waveform
    monkeypatch.setattr(api, "create_waveform",
                        lambda *a, **kw: made.append(kw.get("device")) or inner(*a, **kw))
    hi = make_iface("port", "python", station=True)
    try:
        assert _cmd(hi, "MYCALL W1AW") == "OK"
        assert _cmd(hi, "RAWTX MC_DPSK DBPSK R1_4 hello") == "OK"
        assert made == [hi.station.device]
        frame = hi.station.tx_queue[-1]
        assert frame.dtype == np.float32 and frame.ndim == 1
        wf = inner(api.WaveformMode.MC_DPSK, "DBPSK", "R1_4", device="cpu")
        from ria_tpu_torch.phy.frame_v2 import DataFrame

        want = wf.tx_frame(DataFrame.make_data("W1AW", "CQ", 0, b"hello").serialize())
        np.testing.assert_array_equal(frame, want)
    finally:
        hi.close()


def test_data_and_kiss_ports_feed_the_engine():
    """Bytes into the data port and KISS frames into the KISS port reach the
    engine; a message out of the engine leaves the data port raw and the
    KISS port escaped, in both packages alike."""
    outs = {}
    for pkg in ("ref", "port"):
        hi = make_iface(pkg, "python")
        sent = []
        hi.engine.send_message = lambda d, s=sent: s.append(bytes(d)) or True
        d = socket.create_connection(("127.0.0.1", hi.data_srv.port), timeout=2)
        k = socket.create_connection(("127.0.0.1", hi.kiss_srv.port), timeout=2)
        for sock in (d, k):
            sock.settimeout(0.05)
        try:
            for _ in range(10):
                hi.poll(0.02)
            d.sendall(b"raw payload")
            k.sendall(TH.kiss_escape(b"kiss \xc0 frame \xdb!") + TH.kiss_escape(b"second"))
            for _ in range(50):
                hi.poll(0.02)
                if len(sent) >= 3:
                    break
            hi._on_engine_message(b"out \xc0\xdb bytes")
            got = {}
            for name, sock in (("data", d), ("kiss", k)):
                buf = b""
                for _ in range(20):
                    try:
                        buf += sock.recv(4096)
                    except (TimeoutError, socket.timeout):
                        if buf:
                            break
                got[name] = buf
            outs[pkg] = (sent, got)
        finally:
            d.close()
            k.close()
            hi.close()
    assert outs["port"] == outs["ref"]
    sent, got = outs["port"]
    assert sent == [b"raw payload", b"kiss \xc0 frame \xdb!", b"second"]
    assert got == {"data": b"out \xc0\xdb bytes", "kiss": TH.kiss_escape(b"out \xc0\xdb bytes")}


def test_kiss_framing_roundtrip():
    payload = bytes([1, 2, 0xC0, 3, 0xDB, 4])
    wire = TH.kiss_escape(payload)
    assert wire[0] == 0xC0 and wire[-1] == 0xC0
    buf = bytearray(wire)
    frames = TH.kiss_unescape(buf)
    assert frames == [payload]


@pytest.mark.parametrize("seed", range(3))
def test_kiss_equals_reference_on_seeded_bytes(seed):
    """Seeded byte strings rich in FEND/FESC: the same escaped frames, and
    the same frames (and leftover buffer) out of a stream cut at seeded
    points with garbage between frames."""
    rng = np.random.default_rng(seed)
    alphabet = np.array([0xC0, 0xDB, 0xDC, 0xDD, 0x00, 0x41, 0xFF], np.uint8)
    payloads = [bytes(rng.choice(alphabet, int(rng.integers(0, 40)))) for _ in range(20)]
    for p in payloads:
        assert TH.kiss_escape(p) == RH.kiss_escape(p)
    stream = b"".join(bytes(rng.choice(alphabet[2:], int(rng.integers(0, 3))))
                      + TH.kiss_escape(p) for p in payloads)
    cuts = sorted(rng.choice(len(stream), 6, replace=False).tolist())
    bufs = {"ref": bytearray(), "port": bytearray()}
    frames = {"ref": [], "port": []}
    for lo, hi in zip([0] + cuts, cuts + [len(stream)]):
        for pkg, mod in (("ref", RH), ("port", TH)):
            bufs[pkg].extend(stream[lo:hi])
            frames[pkg] += mod.kiss_unescape(bufs[pkg])
    assert frames["port"] == frames["ref"] and bufs["port"] == bufs["ref"]
    assert frames["port"] and all(p in frames["port"] for p in payloads if p)


def test_dual_modem_tcp_session():
    """Two full stacks (Station+Engine+HostInterface) cross-wired through
    simulated air, driven purely over TCP: the reference's self test, on the
    CPU port with ephemeral ports."""
    dm = DualModemTcp(awgn(15.0), seed=42, base_port_a=0, base_port_b=0, device="cpu")
    try:
        assert self_test(dm) == 0
    finally:
        dm.close()


def test_h1_over_sockets():
    """H1 on the CPU port alone (its own generators' draws): both payloads
    out of B's data port byte for byte, and B decodes the RAWTX frame.  B is
    not connected then, and like the reference it hands the DATA frame to
    CQ to its engine as a plain payload: the text leaves B's data port
    (the lock step below holds that to the reference)."""
    dm = DualModemTcp(awgn(H.H1_SNR_DB), seed=H.H1_SEED, base_port_a=0, base_port_b=0,
                      device="cpu")
    try:
        out = H.run(dm, TState)
    finally:
        dm.close()
    H.check_outcome(out)
    assert out["data_rx"] == H.SELF_TEST_PAYLOAD + H.MESSAGE + H.RAWTX_TEXT.encode()
    replies = [r for _, line, r in out["replies"] if line == "ENCRYPT ON"]
    assert replies == ["ERROR Set ENCRYPTKEY first", "OK", "OK"]


def test_h1_lock_step_with_reference():
    """H1 in the reference's ``DualModemTcp`` and the port's, the port fed
    the reference's draws: every block equal."""
    sys.path.insert(0, str(ROOT))
    from ria_tpu.sim import awgn as j_awgn
    from tools.dual_modem_tcp import DualModemTcp as JDualModemTcp

    ref = JDualModemTcp(j_awgn(H.H1_SNR_DB), seed=H.H1_SEED, base_port_a=0, base_port_b=0)
    port = DualModemTcp(awgn(H.H1_SNR_DB), seed=H.H1_SEED, base_port_a=0, base_port_b=0,
                        device="cpu", draws=D.sim_draws(H.H1_SEED))
    try:
        run = H.lock_step([ref, port], [JState, TState])
    finally:
        ref.close()
        port.close()
    H.check_outcome(run["outs"][1])
    assert run["max_snr_err"] <= 1e-3
    assert run["clients"][1].data_rx[1] == (H.SELF_TEST_PAYLOAD + H.MESSAGE
                                            + H.RAWTX_TEXT.encode())
