"""Full protocol sessions of the station layer: the four sessions of
``chip_smoke.py`` phase 4e, their traffic, a per-tick snapshot of both
stations and the comparison of two runs tick by tick.

Test and bench harness, like ``tools/waveform_frames.py``.  A session is a
``DualStationSim`` at the reference's real geometry (48 kHz, 200 ms blocks,
the 40 s ring, an ITU-R preset channel, the 10-carrier MC-DPSK handshake,
the negotiated waveform) driven by a traffic script:

- S1 ``awgn(12)``, seed 7: connect, a message each way, disconnect
  (the reference package's ``test_full_session_awgn``);
- S2 ``awgn(6)``, seed 3: eight messages A -> B, where the stations move
  to the 16-carrier DQPSK R1/2 MC-DPSK profile (``test_mc_profile.py``);
- S3 ``poor(15)``, seed 42 and S4 ``good(-8)``, seed 42: ``run_session``
  of the simulator CLI, two messages (``test_session_floors.py``);

and the goodput sessions of ``tools/goodput.py`` (traffic ``goodput``, made
by ``goodput.session``): a 4,096-byte bulk transfer.

A traffic script is a generator that advances its simulator one block per
``yield``, so two simulators — the port on two devices, or the port and the
reference package with the reference's draws replayed — run in lock step
and :func:`first_difference` names the first tick at which they part.  The
script and the snapshot read only what both packages' simulators share.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

SNR_TOL_DB = 1e-3  # measured_snr_db between two runs of a session


@dataclass(frozen=True)
class Session:
    name: str
    channel: str          # a preset of sim.channel.PRESETS
    snr_db: float
    seed: int
    traffic: str          # "protocol", "mc_profile", "run_session" or "goodput"
    messages: int
    asserts_delivery: bool = True


SESSIONS = {
    "S1": Session("S1", "awgn", 12.0, 7, "protocol", 2),
    "S2": Session("S2", "awgn", 6.0, 3, "mc_profile", 8),
    "S3": Session("S3", "poor", 15.0, 42, "run_session", 2),
    # At the honest-noise session floor another draw stream may lose a
    # message: S4 runs to its end and reports, it does not assert delivery.
    "S4": Session("S4", "good", -8.0, 42, "run_session", 2, asserts_delivery=False),
}


def run_until(sim, predicate, max_ticks: int):
    """``sim.run_until`` one block per ``yield``; returns whether
    ``predicate`` came true before the absolute tick ``max_ticks``."""
    while sim.ticks < max_ticks:
        sim.step()
        yield
        if predicate():
            return True
    return False


def script(sim, session: Session, out: dict, ConnectionState):
    """The session's traffic on ``sim`` (either package's simulator), one
    block per ``yield``.  Fills ``out``: ``got_a``/``got_b`` (messages each
    station delivered), ``connected``, ``connect_ticks``, ``link``,
    ``messages``, ``disconnected``, ``final_link``.  ``ConnectionState`` is
    the enum of ``sim``'s package."""
    got_a, got_b = out.setdefault("got_a", []), out.setdefault("got_b", [])
    sim.bravo.conn.on_message = got_b.append
    sim.alpha.conn.on_message = got_a.append
    if session.traffic == "goodput":
        from ria_tpu_torch.tools.goodput import transfer

        out.update((yield from transfer(sim, session.seed, got=got_b)))
        return
    out.update(connected=False, messages=0, disconnected=False)
    if not sim.alpha.conn.connect("BRAVO"):
        raise AssertionError(f"{session.name}: connect() refused")
    budget = {"protocol": 200, "mc_profile": 600, "run_session": 450}[session.traffic]
    if not (yield from run_until(sim, sim.both_connected, budget)):
        return
    out["connected"] = True
    out["connect_ticks"] = sim.ticks
    out["link"] = link_name(sim.alpha.conn.link)
    if session.traffic == "protocol":
        sim.alpha.conn.send_message(b"hello from alpha")
        if (yield from run_until(sim, lambda: got_b == [b"hello from alpha"], sim.ticks + 150)):
            out["messages"] += 1
            sim.bravo.conn.send_message(b"hello back")
            if (yield from run_until(sim, lambda: got_a == [b"hello back"], sim.ticks + 150)):
                out["messages"] += 1
    elif session.traffic == "mc_profile":
        for i in range(session.messages):
            sim.alpha.conn.send_message(b"payload %d " % i * 3)
        yield from run_until(sim, lambda: len(got_b) >= session.messages, sim.ticks + 400)
        out["messages"] = len(got_b)
        out["final_link"] = link_name(sim.alpha.conn.link)
        return
    else:
        for i in range(session.messages):
            sim.alpha.conn.send_message(f"test message {i} through the ionosphere".encode())
            if (yield from run_until(sim, lambda: len(got_b) > i, sim.ticks + 200)):
                out["messages"] += 1
            else:
                break
    sim.alpha.conn.disconnect()
    budget = 100 * max(1, sim.alpha.conn.link.spreading)
    yield from run_until(sim, lambda: sim.bravo.conn.state == ConnectionState.DISCONNECTED,
                         sim.ticks + budget)
    out["disconnected"] = sim.bravo.conn.state == ConnectionState.DISCONNECTED
    out["final_link"] = link_name(sim.alpha.conn.link)


def link_name(link) -> str:
    return (f"{link.waveform.name} {link.mc_carriers}c {link.modulation} {link.rate}"
            + (f" x{link.spreading}" if link.spreading > 1 else ""))


STAT_FIELDS = ("frames_tx", "frames_rx", "decode_failures", "pings_rx", "sync_skips")


def snapshot(sim, out: dict) -> dict:
    """Both stations after a tick: connection state and link, the decode
    counters, the ring length, the pending sync start, the measured SNR, and
    the messages each side delivered so far."""
    snap = {"tick": sim.ticks}
    for side in ("alpha", "bravo"):
        st = getattr(sim, side)
        snap[side] = {
            "state": st.conn.state.name,
            "link": link_name(st.conn.link),
            **{f: getattr(st.stats, f) for f in STAT_FIELDS},
            "ring": len(st.rx_buffer),
            "pending": None if st._pending is None else int(st._pending["sync"]["start"]),
            "snr_db": float(st.conn.measured_snr_db),
        }
    snap["got_a"] = list(out.get("got_a", []))
    snap["got_b"] = list(out.get("got_b", []))
    return snap


def first_difference(a: dict, b: dict) -> str | None:
    """What differs between two snapshots of one tick, or None: every field
    exact, the measured SNR within :data:`SNR_TOL_DB`."""
    diffs = []
    for key in a:
        if key in ("alpha", "bravo"):
            for f, va in a[key].items():
                vb = b[key][f]
                same = abs(va - vb) <= SNR_TOL_DB if f == "snr_db" else va == vb
                if not same:
                    diffs.append(f"{key}.{f}: {va!r} != {vb!r}")
        elif a[key] != b[key]:
            diffs.append(f"{key}: {a[key]!r} != {b[key]!r}")
    return "; ".join(diffs) or None


def lock_step(sims: list, session: Session, states: list, synchronize=None,
              traffic=None) -> dict:
    """Run ``session``'s script (or ``traffic(sim, out, ConnectionState)``,
    a generator of the same kind) on each simulator of ``sims`` (each with
    its package's ``ConnectionState`` in ``states``) one block at a time, and
    compare their snapshots after every block.  Raises at the first tick
    that differs, with both sides.  Returns {"outs": the scripts' ``out``
    dicts, "ticks", "max_snr_err", "snapshots": the first run's, "sims",
    "tick_ms": each simulator's milliseconds per block on the host's clock,
    ``synchronize()`` (e.g. the card's) called before each reading}."""
    sync = synchronize or (lambda: None)
    outs = [{} for _ in sims]
    traffic = traffic or (lambda sim, out, cs: script(sim, session, out, cs))
    gens = [traffic(sim, out, cs) for sim, out, cs in zip(sims, outs, states)]
    snaps, max_snr_err = [], 0.0
    tick_ms = [[] for _ in sims]
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
                raise AssertionError(f"{session.name}: the scripts ended at different ticks "
                                     f"({[s.ticks for s in sims]})")
            break
        ticks = [snapshot(sim, out) for sim, out in zip(sims, outs)]
        for other in ticks[1:]:
            diff = first_difference(ticks[0], other)
            if diff:
                raise AssertionError(f"{session.name}: tick {ticks[0]['tick']} differs: {diff}\n"
                                     f"  first: {ticks[0]}\n  other: {other}")
            for side in ("alpha", "bravo"):
                max_snr_err = max(max_snr_err,
                                  abs(ticks[0][side]["snr_db"] - other[side]["snr_db"]))
        snaps.append(ticks[0])
    for out in outs[1:]:
        for key in ("connected", "messages", "disconnected", "link", "final_link"):
            if out.get(key) != outs[0].get(key):
                raise AssertionError(f"{session.name}: {key} {outs[0].get(key)!r} != "
                                     f"{out.get(key)!r}")
    return {"outs": outs, "ticks": sims[0].ticks, "max_snr_err": max_snr_err,
            "snapshots": snaps, "sims": sims, "tick_ms": tick_ms}


def make_sim(session: Session, device=None, draws=None):
    """The port's simulator for ``session`` on ``device`` (None: the
    simulator's default, the card), with ``draws`` (None: the default
    generators, else a pair of sources)."""
    from ria_tpu_torch.sim.channel import PRESETS
    from ria_tpu_torch.sim.simulator import DualStationSim

    kw = {} if device is None else {"device": device}
    return DualStationSim(PRESETS[session.channel](session.snr_db), seed=session.seed,
                          draws=draws, **kw)


def generator_draws(session: Session, device, generator_device):
    """The default draw sources of ``session`` with their generators on
    ``generator_device`` and their tensors moved to ``device``: two runs on
    different devices given generators on one device draw the same
    numbers."""
    from ria_tpu_torch.sim.channel import GeneratorDraws

    return (GeneratorDraws(session.seed, device, generator_device),
            GeneratorDraws(session.seed + 1, device, generator_device))


def run(session: Session, device=None, draws=None, synchronize=None) -> dict:
    """One session of the port on ``device``; the script's ``out`` with
    ``ticks``, ``wall_s``, ``tick_ms`` (host clock per block, read after
    ``synchronize()``), the stations' ``stats`` and the ``snapshots``."""
    from ria_tpu_torch.protocol.connection import ConnectionState

    sync = synchronize or (lambda: None)
    sim = make_sim(session, device, draws)
    out: dict = {}
    tick_ms, snaps = [], []
    sync()
    t0 = last = time.perf_counter()
    for _ in script(sim, session, out, ConnectionState):
        sync()
        now = time.perf_counter()
        tick_ms.append((now - last) * 1e3)
        snaps.append(snapshot(sim, out))
        last = time.perf_counter()
    out.update(ticks=sim.ticks, wall_s=time.perf_counter() - t0, tick_ms=tick_ms,
               stats={side: getattr(sim, side).stats for side in ("alpha", "bravo")},
               snapshots=snaps)
    return out


def decode_ticks(snapshots: list) -> list[int]:
    """The ticks at which either station decoded a frame."""
    out, last = [], (0, 0)
    for snap in snapshots:
        now = (snap["alpha"]["frames_rx"], snap["bravo"]["frames_rx"])
        if now != last:
            out.append(snap["tick"])
        last = now
    return out


def replay_to(session: Session, tick: int, device=None, draws=None):
    """A fresh simulator of ``session`` advanced by its script to just
    before block ``tick``; returns (sim, the script's generator): one more
    ``next()`` runs block ``tick``."""
    from ria_tpu_torch.protocol.connection import ConnectionState

    sim = make_sim(session, device, draws)
    gen = script(sim, session, {}, ConnectionState)
    while sim.ticks < tick - 1:
        next(gen)
    return sim, gen


class StageTimer:
    """While open, the host milliseconds of a session's stages on the card:
    ``channel`` (both directions' ``DualStationSim._channel``), and the
    station's waveform calls ``detect_sync``, ``peek_header``, ``rx_frame``
    and ``other`` (``_rx_at``, ``rx_burst``, ``_demod_bits`` called by the
    station itself).  Only calls on ``device_type`` count, each from its
    entry to its exit with the card synchronised at both (so the stages
    are what the tick waits for); a call inside a timed call (the
    ``_rx_at`` of an OFDM ``rx_frame``) counts in the outer one.  ``totals``
    holds the milliseconds by stage, ``calls`` the calls."""

    STAGES = ("channel", "detect_sync", "peek_header", "rx_frame", "other")

    def __init__(self, synchronize, device_type: str = "cuda"):
        self.sync = synchronize
        self.device_type = device_type
        self.totals = dict.fromkeys(self.STAGES, 0.0)
        self.calls = dict.fromkeys(self.STAGES, 0)
        self._depth = 0
        self._saved = []

    def _wrap(self, owner, name: str, stage: str, on_card):
        inner = getattr(owner, name)
        timer = self

        def timed(obj, *args, **kwargs):
            if timer._depth or not on_card(obj):
                return inner(obj, *args, **kwargs)
            timer._depth += 1
            timer.sync()
            t0 = time.perf_counter()
            try:
                return inner(obj, *args, **kwargs)
            finally:
                timer.sync()
                timer.totals[stage] += (time.perf_counter() - t0) * 1e3
                timer.calls[stage] += 1
                timer._depth -= 1

        self._saved.append((owner, name, inner))
        setattr(owner, name, timed)

    def __enter__(self):
        from ria_tpu_torch.sim.simulator import DualStationSim
        from ria_tpu_torch.wave import afdm, api

        def on_card(obj):
            return obj.device.type == self.device_type

        self._wrap(DualStationSim, "_channel", "channel", on_card)
        classes = [api.MCDPSKWaveform, api._OFDMWaveformBase, api.OFDMChirpWaveform,
                   api.OFDMCoxWaveform, api.OTFSWaveform, api.MFSKWaveform, api.DPSKWaveform,
                   afdm.AFDMWaveform]
        for cls in classes:
            for name, stage in (("detect_sync", "detect_sync"), ("peek_header", "peek_header"),
                                ("rx_frame", "rx_frame"), ("_rx_at", "other"),
                                ("rx_burst", "other"), ("_demod_bits", "other")):
                if name in vars(cls):
                    self._wrap(cls, name, stage, on_card)
        return self

    def __exit__(self, *exc):
        for owner, name, inner in reversed(self._saved):
            setattr(owner, name, inner)
        self._saved.clear()
        return False


def check_outcome(session: Session, out: dict) -> str:
    """Raise unless the session connected and delivered every message
    (S1 also a clean disconnect); S4 only reports.  Returns a summary."""
    summary = (f"connected {out.get('connected')} after {out.get('connect_ticks')} ticks, "
               f"{out.get('messages')}/{session.messages} messages, link "
               f"{out.get('link')} -> {out.get('final_link')}, disconnect "
               f"{'clean' if out.get('disconnected') else 'not seen'}")
    if not session.asserts_delivery:
        return summary
    if not out.get("connected") or out.get("messages") != session.messages:
        raise AssertionError(f"{session.name}: {summary}")
    if session.traffic == "protocol" and not out.get("disconnected"):
        raise AssertionError(f"{session.name}: no clean disconnect: {summary}")
    return summary



# ------------------------------------------------------- station scenarios
# Audio for one receiving station ("BRAVO"), fed block by block: the frames
# of one scenario behind a second of silence, half a second apart, plus
# seeded noise.  Made with either package's TX (``api``/``frame_v2`` of
# ``ria_tpu`` or of the port), so the reference station, the port's on the
# CPU and the port's on the card hear the same scenario.
STATION_SCENARIOS = ("ping", "connect", "ofdm_light", "ofdm_burst", "mfsk", "beacon")
STATION_BLOCK = 9600
# The counter each scenario must move on the reference station.
STATION_EXPECT = {"ping": ("pings_rx", 1), "connect": ("frames_rx", 1),
                  "ofdm_light": ("frames_rx", 3), "ofdm_burst": ("bursts_rx", 1),
                  "mfsk": ("frames_rx", 1), "beacon": ("frames_rx", 1)}


def station_scenario(name: str, api, frame_v2, **wf_kw) -> tuple[list, dict]:
    """(the TX audio of each frame, the station's set-up) of a scenario.
    ``wf_kw`` goes to every waveform built (the port's ``device``)."""
    from ria_tpu_torch.sync.css import CSS_PING

    def connect_bytes():
        return frame_v2.ConnectFrame(type=frame_v2.FrameType.CONNECT, src_callsign="ALPHA",
                                     dst_callsign="BRAVO", mode_capabilities=0x3F).serialize()

    def ofdm_frames(n):
        return [frame_v2.make_fixed_data_frame("ALPHA", "BRAVO", i, b"light frame %d" % i,
                                               "R1_2").serialize() for i in range(n)]

    hs = api.MCDPSKWaveform(**wf_kw)
    if name == "ping":
        return [hs.acq_preamble(CSS_PING)], {}
    if name == "connect":
        return [hs.tx_frame(connect_bytes())], {}
    ofdm = api.OFDMChirpWaveform("DQPSK", "R1_2", **wf_kw)
    setup = {"promiscuous": True, "data_wf": ("OFDM_CHIRP", "DQPSK", "R1_2")}
    if name == "ofdm_light":
        return [ofdm.tx_frame(fb, light=True) for fb in ofdm_frames(3)], setup
    if name == "ofdm_burst":
        return [ofdm.tx_burst(ofdm_frames(4))], dict(setup, burst_group=4)
    if name == "mfsk":
        # A single-codeword control frame (~21 s on the MFSK last-resort
        # waveform); an MFSK CONNECT, 2,015,232 samples, outgrows the 40 s ring.
        ack = frame_v2.ControlFrame.make_ack("ALPHA", frame_v2.hash_callsign("BRAVO"),
                                             seq=5).serialize()
        return [api.MFSKWaveform(**wf_kw).tx_frame(ack)], {"block": 48000}
    if name == "beacon":
        wf = api.MCDPSKWaveform(modulation="DBPSK", rate="R1_4", spreading=4, **wf_kw)
        return [wf.tx_frame(frame_v2.ControlFrame.make_beacon("ALPHA").serialize())], {}
    raise KeyError(name)


def scenario_audio(frames: list, seed: int, snr_db: float = 10.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    gap = np.zeros(24000, np.float32)
    parts = [np.zeros(48000, np.float32)]
    for f in frames:
        parts += [np.asarray(f, np.float32), gap]
    parts.append(np.zeros(72000, np.float32))
    audio = np.concatenate(parts)
    rms = float(np.sqrt(np.mean(np.square(np.concatenate(frames)))))
    return audio + rng.normal(0, rms * 10 ** (-snr_db / 20), audio.shape).astype(np.float32)


def scenario_station(station_mod, api, frame_v2, setup: dict, **kw):
    """(a fresh "BRAVO" station of ``station_mod`` set up for a scenario,
    {"frames": decoded frame bytes, "messages": delivered payloads})."""
    st = station_mod.Station("BRAVO", **kw)
    got = {"frames": [], "messages": []}
    st.on_rx_frame = lambda rx: got["frames"].append(rx.frame_bytes)
    st.conn.on_message = got["messages"].append
    if setup.get("promiscuous"):
        st.promiscuous = True
        mode, m, r = setup["data_wf"]
        st.data_wf = api.create_waveform(frame_v2.WaveformMode[mode], m, r, **kw)
    if setup.get("burst_group"):
        st.conn.link.burst_group = setup["burst_group"]
    return st, got


def station_view(st, got) -> dict:
    """What two stations fed the same audio must agree on after a block
    (the tracked noise floor, a float, is compared on its own)."""
    stats = {k: v for k, v in vars(st.stats).items() if k != "decode_time_ms_avg"}
    return {"stats": stats, "state": st.conn.state.name, "ring": len(st.rx_buffer),
            "pending": None if st._pending is None else int(st._pending["sync"]["start"]),
            "tx_queue": [len(a) for a in st.tx_queue],
            "frames": list(got["frames"]), "messages": list(got["messages"])}


def floor_close(a, b, rtol: float = 1e-5) -> bool:
    if a is None or b is None:
        return a is None and b is None
    return abs(a - b) <= rtol * abs(a)
