"""The port's ``ProtocolEngine`` against ``ria_tpu.protocol.engine``.

Mirrors the crypto and engine cases of tests/test_protocol.py (AES round
trip, compression gate, engine compression + encryption, file transfer),
each run in both packages on the same inputs with the same AES IVs: the
frames each engine transmits, its state and the bytes it delivers must be
equal, not close, after every step.  Then the engines front a whole
dual-station session (12 dB AWGN, seed 7), the port fed the reference's
``jax.random`` draws (tests/test_torch_jax_draws.py): tick for tick, the
stations as in a session snapshot (measured SNR within 1e-3 dB) and the
engines' states and delivered bytes exact.
"""

import numpy as np
import pytest
import torch

import test_torch_jax_draws as D
from ria_tpu.phy.frame_v2 import hash_callsign as j_hash
from ria_tpu.protocol import crypto as RC
from ria_tpu.protocol import engine as RE
from ria_tpu.protocol.connection import ConnectionState as JState
from ria_tpu.protocol.connection import LinkMode as JLink
from ria_tpu.sim.channel import awgn as j_awgn
from ria_tpu.sim.simulator import DualStationSim as JSim
from ria_tpu_torch.phy.frame_v2 import hash_callsign as t_hash
from ria_tpu_torch.protocol import crypto as TC
from ria_tpu_torch.protocol import engine as TE
from ria_tpu_torch.protocol.connection import ConnectionState as TState
from ria_tpu_torch.protocol.connection import LinkMode as TLink
from ria_tpu_torch.sim.channel import awgn as t_awgn
from ria_tpu_torch.sim.simulator import DualStationSim as TSim
from ria_tpu_torch.tools import session_paths as S

torch.set_num_threads(1)

PACKAGES = {"ref": (RE, RC, JLink, j_hash), "port": (TE, TC, TLink, t_hash)}


@pytest.fixture
def same_ivs(monkeypatch):
    """Each package's ``os.urandom`` becomes a numpy generator seeded 0, so
    both draw the same IVs in the same order."""
    class Urandom:
        def __init__(self):
            self.rng = np.random.default_rng(0)

        def urandom(self, n):
            return self.rng.bytes(n)

    for mod in (RC, TC):
        monkeypatch.setattr(mod, "os", Urandom())


def wired_pair(pkg: str, key: str | None = "hunter2"):
    """Two engines of ``pkg`` whose connections are wired to each other
    (no modem), forced CONNECTED; returns (a, b, frames each transmitted)."""
    E, _, Link, hash_callsign = PACKAGES[pkg]
    a, b = E.ProtocolEngine(), E.ProtocolEngine()
    a.set_callsign("W1AW")
    b.set_callsign("VE3ABC")
    if key:
        a.set_encryption_key(key)
        b.set_encryption_key(key)
    sent = {"a": [], "b": []}

    def tx(src, dst, name):
        def on_transmit(fb, hs):
            sent[name].append(bytes(fb))
            dst.conn.on_frame_received(fb)
        src.conn.on_transmit = on_transmit

    tx(a, b, "a")
    tx(b, a, "b")
    for eng, remote in ((a, "VE3ABC"), (b, "W1AW")):
        eng.conn.remote_call = remote
        eng.conn.remote_hash = hash_callsign(remote)
        eng.conn._enter_connected(Link())
    return a, b, sent


def test_aes256_roundtrip(same_ivs):
    got = {}
    for pkg, (_, C, _, _) in PACKAGES.items():
        key = C.AES256.from_passphrase("secret pass")
        ct = key.encrypt(b"attack at dawn")
        assert ct[16:] != b"attack at dawn"
        assert key.decrypt(ct) == b"attack at dawn"
        assert len(ct) % 16 == 0
        got[pkg] = ct
    assert got["port"] == got["ref"]


def test_compression_gate():
    for _, C, _, _ in PACKAGES.values():
        small, was = C.compress(b"short")
        assert not was and small == b"short"
        big = b"abcd" * 100
        packed, was = C.compress(big)
        assert was and len(packed) < len(big)
        assert C.decompress(packed) == big
    assert TC.compress(b"abcd" * 100) == RC.compress(b"abcd" * 100)


@pytest.mark.parametrize("case", ["compressed+encrypted", "encrypted", "compressed", "plain"])
def test_engine_message_compression_encryption(case, same_ivs):
    """One message each way: the same frames on the wire (flag header,
    deflate, IV || ciphertext) and the same bytes delivered."""
    outcome = {}
    for pkg in PACKAGES:
        a, b, sent = wired_pair(pkg, key="hunter2" if "encrypted" in case else None)
        a.compression_enabled = b.compression_enabled = "compressed" in case
        got_a, got_b = [], []
        a.on_message, b.on_message = got_a.append, got_b.append
        msg = b"compressible " * 20
        assert a.send_message(msg)
        assert b.send_message("short reply")
        assert got_b == [msg] and got_a == [b"short reply"]
        outcome[pkg] = (sent, got_a, got_b, a.state.name, b.state.name)
    assert outcome["port"] == outcome["ref"]


def test_engine_rejects_what_the_reference_rejects(same_ivs):
    """A message encrypted under another key, and an encrypted message to an
    engine without a key, are dropped by both packages."""
    for pkg in PACKAGES:
        a, b, _ = wired_pair(pkg)
        got = []
        b.on_message = got.append
        b.set_encryption_key("another key")
        assert a.send_message(b"x" * 64)
        b.set_encryption_key(None)
        assert a.send_message(b"y" * 64)
        assert got == [], pkg


def test_engine_file_transfer(same_ivs):
    """A 2 KB file, ticked 100 ms at a time: the same frames, states and
    progress after every tick, and the file delivered intact."""
    runs = {}
    for pkg in PACKAGES:
        a, b, sent = wired_pair(pkg)
        received, progress = [], []
        b.on_file_received = lambda name, data, ok, r=received: r.append((name, data, ok))
        a.files.on_progress = lambda p, pr=progress: pr.append(
            (p.transferred_bytes, p.total_bytes, p.is_sending))
        payload = bytes(range(256)) * 8
        assert a.send_file("test.bin", payload)
        trace = []
        for _ in range(100):
            a.tick(100)
            b.tick(100)
            trace.append((len(sent["a"]), len(sent["b"]), a.state.name, b.state.name,
                          len(received), len(progress)))
            if received:
                break
        assert received and received[0] == ("test.bin", payload, True), pkg
        runs[pkg] = (trace, sent, received, progress)
    assert runs["port"] == runs["ref"]


def engine_session(sim, engines: list, out: dict, ConnectionState):
    """Engines on both stations of ``sim``: connect, a compressed and
    encrypted message A -> B, an encrypted short one B -> A; one block per
    ``yield``."""
    a, b = engines
    for eng in engines:
        eng.set_encryption_key("over the air")
    got_a, got_b = out.setdefault("got_a", []), out.setdefault("got_b", [])
    a.on_message, b.on_message = got_a.append, got_b.append
    assert a.connect("BRAVO")
    out["connected"] = yield from S.run_until(sim, sim.both_connected, 200)
    if not out["connected"]:
        return
    msg = b"".join(b"engine message %03d over the simulated air; " % i for i in range(16))
    a.send_message(msg)
    out["a_to_b"] = yield from S.run_until(sim, lambda: got_b == [msg], sim.ticks + 150)
    b.send_message(b"ack")
    out["b_to_a"] = yield from S.run_until(sim, lambda: got_a == [b"ack"], sim.ticks + 150)


def test_engine_session_matches_reference(same_ivs):
    sims = [JSim(j_awgn(12.0), seed=7),
            TSim(t_awgn(12.0), seed=7, device="cpu", draws=D.sim_draws(7))]
    pkgs = [RE, TE]
    engines = [[E.ProtocolEngine(conn=st.conn) for st in (sim.alpha, sim.bravo)]
               for E, sim in zip(pkgs, sims)]
    outs = [{}, {}]
    gens = [engine_session(sim, eng, out, cs)
            for sim, eng, out, cs in zip(sims, engines, outs, (JState, TState))]
    ticks = 0
    while True:
        done = []
        for gen in gens:
            try:
                next(gen)
                done.append(False)
            except StopIteration:
                done.append(True)
        assert done[0] == done[1], f"the scripts ended at different ticks ({ticks})"
        if done[0]:
            break
        ticks += 1
        snaps = [dict(S.snapshot(sim, out), engines=[e.state.name for e in eng])
                 for sim, out, eng in zip(sims, outs, engines)]
        diff = S.first_difference(*snaps)
        assert diff is None, f"tick {snaps[0]['tick']}: {diff}"
    assert outs[0] == outs[1]
    assert outs[1]["connected"] and outs[1]["a_to_b"] and outs[1]["b_to_a"], outs[1]
