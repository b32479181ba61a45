"""The host-control runs of ``chip_smoke.py`` phase 4f: two modems driven
only over TCP (H1), its script, a per-tick snapshot and the comparison of
two runs tick by tick; the threaded continuous session (H2).

Test and bench harness, like ``tools/session_paths.py``.  H1 is
``DualModemTcp(awgn(15), seed=42)`` with ephemeral ports (base 0): two
stacks (Station + ProtocolEngine + HostInterface) whose only input is what a
host program sends to their command and data ports.  Its script:

1. the reference's ``self_test``: ``MYCALL`` on both sides, ``CONNECT
   BRAVO``, a 32-byte payload into A's data port and out of B's,
   ``DISCONNECT``;
2. ``ENCRYPT ON`` before a key (refused), then ``COMPRESSION ON``,
   ``ENCRYPTKEY`` and ``ENCRYPT ON`` on both sides, a second connection and a
   2,048-byte text message (zlib and AES-256-CBC on the path), ``DISCONNECT``;
3. ``RAWTX MC_DPSK DBPSK R1_4 <text>`` from A, decoded by B's station.

A command is sent at a fixed tick and the interface, not the simulator, is
polled until its reply reaches the client; data is polled until the engine
has taken all of it; after every block each client reads until it holds
everything its server sent.  So socket timing moves no tick, and two runs
(the port on two devices, or the port and the reference package with the
reference's draws replayed) can be compared after every block.  The
instrumentation wraps instance attributes of the interfaces and engines
(``handle_command``, the servers' ``broadcast``, ``send_message``), which
both packages share.  The AES IVs of each engine come from a numpy
generator seeded by side, so both runs encrypt with the same IVs.
"""

from __future__ import annotations

import socket
import time

import numpy as np

from ria_tpu_torch.tools import session_paths as S

H1_SNR_DB = 15.0
H1_SEED = 42
SELF_TEST_PAYLOAD = b"dual modem tcp self test payload"
PASSPHRASE = "correct horse battery staple"
MESSAGE = "".join(f"line {i:03d}: the quick brown fox jumps over the lazy dog; "
                  f"{i * 7919 % 1000:03d}\n" for i in range(40)).encode()[:2048]
RAWTX_TEXT = "hello from the host port"
REPLY_TIMEOUT_S = 10.0
CONNECT_TICKS = 300
DELIVER_TICKS = 400
DISCONNECT_TICKS = 120
RAWTX_TICKS = 60
RAWTX_TAIL_TICKS = 5
assert len(MESSAGE) == 2048


class Clients:
    """A host program's TCP clients of one ``DualModemTcp`` (either
    package's): the command and data port of each side, and the records
    the snapshot reads."""

    def __init__(self, dm):
        self.dm = dm
        (ca, da), (cb, db) = dm.ports()
        self.cmd = [socket.create_connection(("127.0.0.1", p), timeout=2) for p in (ca, cb)]
        self.data = [socket.create_connection(("127.0.0.1", p), timeout=2) for p in (da, db)]
        for s in self.cmd + self.data:
            s.setblocking(False)
        # What each side's servers sent and what each client holds.
        self.replies = [[], []]        # (line, reply) handled by each command port
        self.events_sent = [b"", b""]  # asynchronous event lines broadcast
        self.data_sent = [b"", b""]    # bytes out of each data port
        self.data_in = [0, 0]          # bytes each engine took from its data port
        self.cmd_rx = [b"", b""]       # what each command client received
        self.data_rx = [b"", b""]      # what each data client received
        self.reply_ms = []             # send -> reply at the client, per command
        for i, (hi, eng) in enumerate(zip(dm.ifaces, dm.engines)):
            self._wrap(i, hi, eng, np.random.default_rng(i))
        self._await_accepts()

    def _wrap(self, i: int, hi, eng, rng):
        handle, send_message = hi.handle_command, eng.send_message
        cmd_bcast, data_bcast = hi.cmd_srv.broadcast, hi.data_srv.broadcast
        set_key = eng.set_encryption_key

        def handle_command(line):
            reply = handle(line)
            self.replies[i].append((line, reply))
            return reply

        def cmd_broadcast(data):
            self.events_sent[i] += data
            return cmd_bcast(data)

        def data_broadcast(data):
            self.data_sent[i] += data
            return data_bcast(data)

        def send(data):
            self.data_in[i] += len(data)
            return send_message(data)

        def set_encryption_key(passphrase):
            set_key(passphrase)
            aes = eng._aes
            if aes is not None:
                encrypt = aes.encrypt
                aes.encrypt = lambda pt, iv=None: encrypt(pt, iv or rng.bytes(16))

        hi.handle_command = handle_command
        hi.cmd_srv.broadcast = cmd_broadcast
        hi.data_srv.broadcast = data_broadcast
        eng.send_message = send
        eng.set_encryption_key = set_encryption_key

    def _await_accepts(self):
        """Let both servers accept the four clients before the first block."""
        deadline = time.monotonic() + REPLY_TIMEOUT_S
        while time.monotonic() < deadline:
            for hi in self.dm.ifaces:
                hi.poll(0.001)
            counts = [hi.cmd_srv.srv.client_count + hi.data_srv.srv.client_count
                      if hasattr(hi.cmd_srv, "srv") else
                      len(hi.cmd_srv.clients) + len(hi.data_srv.clients)
                      for hi in self.dm.ifaces]
            if counts == [2, 2]:
                return
        raise AssertionError("the host interfaces did not accept their clients")

    def command(self, side: int, line: str) -> str:
        """Send ``line`` to ``side``'s command port and poll that interface
        until the reply reaches the client; returns the reply."""
        n0 = len(self.replies[side])
        t0 = time.perf_counter()
        self.cmd[side].sendall((line + "\r").encode())
        deadline = time.monotonic() + REPLY_TIMEOUT_S
        while len(self.replies[side]) == n0:
            if time.monotonic() > deadline:
                raise AssertionError(f"no reply to {line!r} within {REPLY_TIMEOUT_S} s")
            self.dm.ifaces[side].poll(0.001)
        reply = self.replies[side][n0][1]
        self._read_until(self.cmd[side], side, "cmd")
        self.reply_ms.append((time.perf_counter() - t0) * 1e3)
        return reply

    def send_data(self, side: int, payload: bytes):
        """Write ``payload`` to ``side``'s data port and poll that interface
        until its engine has taken all of it."""
        want = self.data_in[side] + len(payload)
        self.data[side].sendall(payload)
        deadline = time.monotonic() + REPLY_TIMEOUT_S
        while self.data_in[side] < want:
            if time.monotonic() > deadline:
                raise AssertionError(f"data port {side} took {self.data_in[side]} of {want} bytes")
            self.dm.ifaces[side].poll(0.001)

    def _read_until(self, sock, side: int, kind: str):
        """Read ``sock`` until the client holds everything its server sent
        (the replies and events of a command port, the bytes of a data
        port)."""
        if kind == "cmd":
            want = len(self.events_sent[side]) + sum(len((r + "\r\n").encode())
                                                     for _, r in self.replies[side] if r)
            have = lambda: len(self.cmd_rx[side])  # noqa: E731
        else:
            want = len(self.data_sent[side])
            have = lambda: len(self.data_rx[side])  # noqa: E731
        deadline = time.monotonic() + REPLY_TIMEOUT_S
        while have() < want:
            if time.monotonic() > deadline:
                raise AssertionError(f"{kind} client {side} holds {have()} of {want} bytes")
            try:
                chunk = sock.recv(65536)
            except BlockingIOError:
                time.sleep(0.0005)
                continue
            if kind == "cmd":
                self.cmd_rx[side] += chunk
            else:
                self.data_rx[side] += chunk

    def settle(self):
        """After a block: every client reads what its server sent."""
        for side in (0, 1):
            self._read_until(self.cmd[side], side, "cmd")
            self._read_until(self.data[side], side, "data")

    def close(self):
        for s in self.cmd + self.data:
            s.close()


def run_until(dm, clients, predicate, max_ticks: int):
    """``dm.tick()`` one block per ``yield`` (clients settled after each);
    returns whether ``predicate`` came true within ``max_ticks`` blocks."""
    for _ in range(max_ticks):
        dm.tick()
        clients.settle()
        yield
        if predicate():
            return True
    return False


def h1_script(dm, clients: Clients, out: dict, ConnectionState):
    """H1 on ``dm`` (either package's ``DualModemTcp``), one block per
    ``yield``.  Fills ``out``: ``replies`` (command, reply), ``connected``
    (per connection), ``link``, ``self_test``/``message`` (delivered byte for
    byte), ``payload_ticks`` (data port in to data port out),
    ``disconnected``, ``rawtx_decoded`` and ``b_frames_rx``."""
    sim = dm.sim
    replies = out.setdefault("replies", [])

    def cmd(side, line):
        replies.append((side, line, clients.command(side, line)))
        return replies[-1][2]

    def both(state):
        return lambda: all(e.state == state for e in dm.engines)

    def deliver(payload, key):
        before = len(clients.data_rx[1])
        clients.send_data(0, payload)
        t_in = sim.ticks
        ok = yield from run_until(dm, clients,
                                  lambda: clients.data_rx[1][before:] == payload, DELIVER_TICKS)
        out[key] = ok
        out.setdefault("payload_ticks", {})[key] = sim.ticks - t_in if ok else None
        return ok

    def connect_and_send(payload, key):
        cmd(0, "CONNECT BRAVO")
        ok = yield from run_until(dm, clients, both(ConnectionState.CONNECTED), CONNECT_TICKS)
        out.setdefault("connected", []).append(ok)
        if not ok:
            return False
        out.setdefault("link", []).append(S.link_name(dm.engines[0].conn.link))
        if not (yield from deliver(payload, key)):
            return False
        cmd(0, "DISCONNECT")
        ok = yield from run_until(dm, clients, both(ConnectionState.DISCONNECTED),
                                  DISCONNECT_TICKS)
        out.setdefault("disconnected", []).append(ok)
        return ok

    cmd(0, "MYCALL ALPHA")
    cmd(1, "MYCALL BRAVO")
    if not (yield from connect_and_send(SELF_TEST_PAYLOAD, "self_test")):
        return
    cmd(0, "ENCRYPT ON")  # refused: no key yet
    for side in (0, 1):
        cmd(side, "COMPRESSION ON")
        cmd(side, f"ENCRYPTKEY {PASSPHRASE}")
        cmd(side, "ENCRYPT ON")
    if not (yield from connect_and_send(MESSAGE, "message")):
        return
    b = sim.bravo.stats
    before = b.frames_rx
    cmd(0, f"RAWTX MC_DPSK DBPSK R1_4 {RAWTX_TEXT}")
    out["rawtx_decoded"] = yield from run_until(dm, clients, lambda: b.frames_rx > before,
                                                RAWTX_TICKS)
    yield from run_until(dm, clients, lambda: False, RAWTX_TAIL_TICKS)
    out["b_frames_rx"] = b.frames_rx - before
    for side in (0, 1):
        cmd(side, "STATUS")


def snapshot(dm, clients: Clients) -> dict:
    """Both stacks after a block: the stations as in a session snapshot
    (state, link, counters, ring, pending sync, measured SNR), the engines'
    states, and what every port sent and every client received."""
    snap = S.snapshot(dm.sim, {})
    for key in ("got_a", "got_b"):
        del snap[key]
    snap["engines"] = [e.state.name for e in dm.engines]
    snap["replies"] = [list(r) for r in clients.replies]
    snap["events"] = list(clients.events_sent)
    snap["data_out"] = list(clients.data_sent)
    snap["cmd_rx"] = list(clients.cmd_rx)
    snap["data_rx"] = list(clients.data_rx)
    return snap


def lock_step(dms: list, states: list, synchronize=None) -> dict:
    """Run H1 on each ``DualModemTcp`` of ``dms`` (each with its package's
    ``ConnectionState`` in ``states``) one block at a time, comparing their
    snapshots after every block; raises at the first tick that differs.
    Returns {"outs", "ticks", "max_snr_err", "tick_ms" (each run's host ms
    a block, ``synchronize()`` called before each reading), "reply_ms",
    "clients"}."""
    sync = synchronize or (lambda: None)
    clients = [Clients(dm) for dm in dms]
    outs = [{} for _ in dms]
    gens = [h1_script(dm, c, out, cs) for dm, c, out, cs in zip(dms, clients, outs, states)]
    tick_ms = [[] for _ in dms]
    max_snr_err = 0.0
    try:
        while True:
            done = []
            for i, gen in enumerate(gens):
                sync()
                t0 = time.perf_counter()
                try:
                    next(gen)
                    done.append(False)
                except StopIteration:
                    done.append(True)
                sync()
                if not done[-1]:
                    tick_ms[i].append((time.perf_counter() - t0) * 1e3)
            if any(done):
                if not all(done):
                    raise AssertionError("H1: the scripts ended at different ticks "
                                         f"({[dm.sim.ticks for dm in dms]})")
                break
            snaps = [snapshot(dm, c) for dm, c in zip(dms, clients)]
            for other in snaps[1:]:
                diff = S.first_difference(snaps[0], other)
                if diff:
                    raise AssertionError(f"H1: tick {snaps[0]['tick']} differs: {diff}")
                for side in ("alpha", "bravo"):
                    max_snr_err = max(max_snr_err,
                                      abs(snaps[0][side]["snr_db"] - other[side]["snr_db"]))
        for out in outs[1:]:
            if out != outs[0]:
                raise AssertionError(f"H1: outcome {outs[0]!r} != {out!r}")
    finally:
        for c in clients:
            c.close()
    return {"outs": outs, "ticks": dms[0].sim.ticks, "max_snr_err": max_snr_err,
            "tick_ms": tick_ms, "reply_ms": [c.reply_ms for c in clients],
            "clients": clients}


def run(dm, ConnectionState) -> dict:
    """H1 on one ``DualModemTcp``: the script's ``out`` with ``ticks``,
    ``tick_ms``, ``reply_ms`` and the bytes B's data client received."""
    clients = Clients(dm)
    out: dict = {}
    tick_ms = []
    try:
        last = time.perf_counter()
        for _ in h1_script(dm, clients, out, ConnectionState):
            now = time.perf_counter()
            tick_ms.append((now - last) * 1e3)
            last = now
    finally:
        clients.close()
    out.update(ticks=dm.sim.ticks, tick_ms=tick_ms, reply_ms=clients.reply_ms,
               data_rx=clients.data_rx[1])
    return out


def check_outcome(out: dict) -> str:
    """Raise unless both connections came up, both payloads came out of B's
    data port byte for byte, both links came down, and B decoded the RAWTX
    frame.  Returns a summary."""
    summary = (f"connected {out.get('connected')}, links {out.get('link')}, self-test payload "
               f"{out.get('self_test')}, compressed+encrypted message {out.get('message')} "
               f"(ticks in->out {out.get('payload_ticks')}), disconnected "
               f"{out.get('disconnected')}, RAWTX decoded by B {out.get('rawtx_decoded')}")
    expect = {"connected": [True, True], "disconnected": [True, True], "self_test": True,
              "message": True, "rawtx_decoded": True}
    for key, want in expect.items():
        if out.get(key) != want:
            raise AssertionError(f"H1: {key} {out.get(key)!r}: {summary}")
    return summary


def threaded_session(device=None, deadline_s: float = 120.0, seed: int = 5,
                     snr_db: float = 12.0) -> dict:
    """H2: ``ContinuousAudioSimulator(awgn(snr_db), seed, realtime_factor=0,
    ptt_jitter_ms=5)`` on ``device`` (None: the simulator's default, the
    card); ALPHA connects, then sends
    ``b"threaded hello"``.  Returns {"ok" (delivered before the deadline),
    "got", "wall_s", "ticks", "backpressure_waits" and "tick_ms" per
    thread, "connected_at_s", "sim"}."""
    from ria_tpu_torch.protocol.connection import ConnectionState
    from ria_tpu_torch.sim.channel import awgn
    from ria_tpu_torch.sim.continuous import ContinuousAudioSimulator

    kw = {} if device is None else {"device": device}
    sim = ContinuousAudioSimulator(awgn(snr_db), seed=seed, realtime_factor=0.0,
                                   ptt_jitter_ms=5.0, **kw)
    got, marks = [], {}
    sim.bravo.conn.on_message = got.append
    sim.alpha.conn.connect("BRAVO")
    t0 = time.perf_counter()

    def done():
        if (sim.alpha.conn.state == ConnectionState.CONNECTED
                and sim.bravo.conn.state == ConnectionState.CONNECTED
                and "connected" not in marks):
            marks["connected"] = time.perf_counter() - t0
            sim.alpha.conn.send_message(b"threaded hello")
        return got == [b"threaded hello"]

    ok = sim.run(duration_s=deadline_s, until=done)
    return {"ok": ok, "got": list(got), "wall_s": time.perf_counter() - t0,
            "ticks": dict(sim.ticks), "backpressure_waits": dict(sim.backpressure_waits),
            "tick_ms": {d: list(v) for d, v in sim.tick_ms.items()},
            "connected_at_s": marks.get("connected"), "sim": sim}
