"""Connection management: PING/CONNECT handshake, mode negotiation, ARQ.

Host copy of ``ria_tpu/protocol/connection.py``, its imports pointed at the port.

State machine from the reference (src/protocol/connection.hpp:16-43,
connection.cpp, connection_handlers.cpp):
- DISCONNECTED -> PROBING (PING x5 fail-fast) -> CONNECTING (CONNECT with
  capabilities/forced mode, x10 retries) -> CONNECTED -> DISCONNECTING;
- responder measures SNR/fading from the handshake reception and answers
  CONNECT_ACK with the negotiated waveform/modulation/rate (waveform
  selection tables) + feature bits packed into the SNR byte;
- per-mode ARQ: MC-DPSK -> stop-and-wait w=1; OFDM -> selective repeat w=4
  (connection.cpp:1173);
- CONNECTED traffic: messages (fragmented to frame capacity), MODE_CHANGE,
  KEEPALIVE, DISCONNECT; broadcast BEACON outside connections.

Transport-agnostic: frames go out through a transmit callback tagged with
handshake/data intent; PING/PONG detections are injected by the modem layer.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Callable

from ria_tpu_torch.fec.ldpc_matrix import RATE_ENUM
from ria_tpu_torch.phy.frame_v2 import (
    DISCONNECT_SEQ,
    ConnectFrame, ControlFrame, DataFrame, Flags, FrameType, WaveformMode,
    decode_snr, encode_snr, decode_fading_index, encode_fading_index,
    fixed_frame_payload_capacity, hash_callsign,
)
from ria_tpu_torch.protocol.arq import ARQConfig, ARQMode, create_arq
from ria_tpu_torch.wave.selection import (
    cap_initial_ofdm_rate, recommend_data_mode, recommend_otfs_mode,
    recommend_waveform_and_rate,
)

RATE_NAME = {v: k for k, v in RATE_ENUM.items()}
MOD_ENUM = {"BPSK": 0, "DBPSK": 1, "QPSK": 2, "DQPSK": 3, "D8PSK": 4, "QAM8": 5,
            "QAM16": 6, "QAM32": 7, "QAM64": 8, "QAM256": 9}
MOD_NAME = {v: k for k, v in MOD_ENUM.items()}


class ConnectionState(enum.Enum):
    DISCONNECTED = 0
    PROBING = 1
    CONNECTING = 2
    CONNECTED = 3
    DISCONNECTING = 4


def burst_group_for_snr(snr_db: float) -> int:
    """Burst group size from the link SNR (both ends derive it from the
    same encoded SNR byte, so no extra negotiation field is needed).
    Bigger groups amortize the light preamble and the stream padding over
    more frames but put more payload at risk per fade; the reference caps
    its groups at 8 (burst_interleaver.hpp:10-31) — the 16 rung is our
    extension for stable high-SNR channels, where the measured fade risk
    is negligible and the R3/4 rows need the extra amortization to beat
    the reference's published bps (docs/PARITY.md §6)."""
    if snr_db >= 17.0:
        return 16
    if snr_db >= 12.0:
        return 8
    return 4


def burst_group_for_link(snr_db: float, modulation: str, rate: str,
                         fading_index: float = 1.0) -> int:
    """Deterministic burst group from the SIGNALED link parameters.

    The SNR rung alone sized G16 bursts at DQPSK R1/2 @ 20 dB Good-class
    fading — 4.4 s of air against a ~10 s channel coherence time, and
    whole groups faded out (measured: 72 decode failures in one 4 KiB
    transfer).  On a signaled near-AWGN channel (fading < 0.15 — the
    CONNECT_ACK carries the responder's fading index in its capabilities
    byte, and MODE_CHANGE carries it explicitly) the full SNR rung stands;
    under fading, differential-mode bursts are capped at ~4.6 s of air
    (G8 at DQPSK R1/2; measured 10/10 burst decodes at 15 dB Good, while
    the 8.6 s G16 span fails wholesale at 20 dB Good).
    Coherent QAM/QPSK modes only negotiate on near-AWGN channels and keep
    the rung either way.  Air time is computed from wire-visible
    quantities only ((mod, rate, group) -> symbols), so both ends agree."""
    from ria_tpu_torch.phy.frame_v2 import burst_stream_codewords
    from ria_tpu_torch.wave.ofdm import BITS_PER_SYMBOL
    from ria_tpu_torch.wave.selection import recommended_pilot_spacing

    g = burst_group_for_snr(snr_db)
    if fading_index < 0.15:
        return g
    while g > 4:
        spacing = recommended_pilot_spacing(modulation, rate)
        pilots = (59 + spacing - 1) // spacing
        bps_sym = (59 - pilots) * BITS_PER_SYMBOL.get(modulation, 2)
        syms = -(-burst_stream_codewords(g, rate) * 648 // bps_sym)
        air_s = (3 + syms) * 1120 / 48000.0
        if air_s <= 4.6:
            break
        g //= 2
    return g


@dataclass
class LinkMode:
    waveform: WaveformMode = WaveformMode.MC_DPSK
    modulation: str = "DBPSK"
    rate: str = "R1_4"
    spreading: int = 1
    # Burst-interleave group (0/1 = off): N fixed frames share one light
    # preamble with their coded bytes spread across all N physical frames
    # (reference BurstInterleaver, default group 4).  Negotiated at CONNECT:
    # initiator advertises capability bit 0x80, responder confirms via
    # feature bit 0 of the CONNECT_ACK SNR byte (the reference packs feature
    # bits there too, frame_v2.hpp:248-285).
    burst_group: int = 0
    # Interop safety latch: the reference defines CONNECT bit 0x80 as
    # MC_DPSK_CHANNEL_INTERLEAVE and ACK SNR bit0 as its confirmation
    # (frame_v2.hpp:38-56, 248-256), so a reference peer can legitimately
    # emit either bit.  The initiator's reading of ACK bit0 is unambiguous —
    # the reference only ever sets it when the negotiated waveform is
    # MC_DPSK (connection_handlers.cpp:184-187), never with OFDM_CHIRP —
    # but the responder's reading of CONNECT 0x80 is not.  So the responder
    # accepts burst RX immediately but transmits bursts only after this
    # latch flips: on the initiator it is set by the unambiguous ACK, on
    # the responder by the first burst actually received from the peer
    # (proof the peer speaks the burst extension).
    burst_tx_confirmed: bool = False
    # MC-DPSK carrier count.  The reference pins in-session MC-DPSK to 10
    # carriers (waveform_selection.hpp:257); >10 is reached only through
    # the ACK-gated MC_PROFILE upgrade (see request_mc_profile).
    mc_carriers: int = 10


@dataclass
class ConnectionConfig:
    arq: ARQConfig = field(default_factory=ARQConfig)
    ping_interval_ms: int = 3000
    ping_retries: int = 5
    connect_timeout_ms: int = 12000
    connect_retries: int = 10   # 5 DPSK attempts + 5 MFSK attempts
    dpsk_connect_attempts: int = 5  # switch to MFSK fallback after these
    keepalive_interval_ms: int = 30000
    disconnect_timeout_ms: int = 30000
    auto_accept: bool = True
    mode_capabilities: int = 0x3F | 0x40
    preferred_mode: WaveformMode = WaveformMode.AUTO
    forced_modulation: str | None = None
    forced_rate: str | None = None
    # Burst-interleave group this station is WILLING to run (0 = disabled;
    # the on-air group size is derived from the link SNR by both ends,
    # burst_group_for_snr).  Default ON since round 4: stream-packed bursts
    # are where the net-throughput margin over the reference lives
    # (docs/THROUGHPUT.md), and the burst_tx_confirmed latch already
    # protects reference peers — burst TX starts only after the peer
    # demonstrably confirms burst RX, so a reference station that emits
    # the ambiguous CONNECT 0x80 bit never receives a burst it cannot
    # decode.  Takes effect only on OFDM links when both ends enable it.
    burst_group: int = 8


@dataclass
class ConnectionStats:
    connects_initiated: int = 0
    connects_received: int = 0
    connects_failed: int = 0
    disconnects: int = 0
    messages_sent: int = 0
    messages_received: int = 0


class Connection:
    def __init__(self, config: ConnectionConfig | None = None):
        self.config = config or ConnectionConfig()
        self.state = ConnectionState.DISCONNECTED
        self.local_call = ""
        self.remote_call = ""
        self.remote_hash = 0
        self.link = LinkMode()
        self.stats = ConnectionStats()
        self.is_initiator = False

        # Channel quality measured by the modem layer on handshake RX.
        self.measured_snr_db = 10.0
        self.measured_fading = 0.0
        # Handshake channel probe (phy.channel_probe.estimate_mc_dpsk):
        # -1 = not measured this session.
        self.measured_delay_ms = -1.0
        self.measured_doppler_hz = -1.0
        # Last CONNECT_ACK sent (responder): re-sent on duplicate CONNECT.
        self._connect_ack_frame: bytes | None = None

        # Callbacks
        self.on_transmit: Callable[[bytes, bool], None] | None = None  # (frame, handshake?)
        self.on_ping_tx: Callable[[], None] | None = None
        self.on_pong_tx: Callable[[], None] | None = None
        self.on_connected: Callable[[], None] | None = None
        self.on_disconnected: Callable[[str], None] | None = None
        self.on_message: Callable[[bytes], None] | None = None
        self.on_message_sent: Callable[[bool], None] | None = None
        self.on_mode_changed: Callable[[LinkMode], None] | None = None
        # MC_PROFILE offer received: arm (carriers, mod, rate) as a second
        # RX hypothesis (see _handle_mc_profile).
        self.on_mc_profile_offer: Callable[[int, str, str], None] | None = None
        self.on_beacon: Callable[[int, bytes], None] | None = None
        self.on_incoming_call: Callable[[str], None] | None = None
        self.on_probe_report = None
        self._pending_connect: ConnectFrame | None = None

        self.arq = create_arq(ARQMode.STOP_AND_WAIT, self.config.arq)
        self._wire_arq()

        # Timers (virtual ms)
        self._timer = 0
        self._retries = 0
        self._keepalive_timer = 0
        self._ctrl_seq = 0
        self._rx_fragments: list[bytes] = []
        # Buffered TX chunks awaiting an open ARQ slot (the reference's
        # Connection buffers sendMessage and transmits from tick(); without
        # this, a send while the previous frame's ACK is still in flight
        # would be dropped).  Entries are (payload_chunk, frag_flags).
        self._tx_msg_queue: list[tuple[bytes, int]] = []
        # Pending ACK-gated MC-DPSK profile proposal (seq, carriers, mod,
        # rate) and the per-session proposal budget (a reference peer never
        # ACKs, so stop offering after a few tries).
        self._pending_profile: tuple[int, int, str, str] | None = None
        self._profile_attempts = 0
        # ACK-gated MODE_CHANGE (reference connection.cpp:741,924):
        # (seq, frame_bytes, mod, rate, waveform, snr_at_request).
        self._pending_mode_change: tuple | None = None
        self._mode_change_timer_ms = 0
        self._mode_change_retries = 0
        # Reliable disconnect handshake (connection.cpp:305-328, :956-1002):
        # initiator retransmits DISCONNECT until ACKed; responder holds a
        # grace period, proactively re-sending the ACK, before dropping.
        self._disc_frame: bytes | None = None
        self._disc_timeout_ms = 0
        self._disc_retx_ms = 0
        self._disc_retries = 0
        self._disc_ack_frame: bytes | None = None
        self._disc_pending_ms = 0
        self._disc_ack_retx_ms = 0

    # ------------------------------------------------------------ plumbing
    def _wire_arq(self):
        self.arq.on_transmit = lambda fb: self._tx(fb, handshake=False)
        self.arq.on_data = self._on_arq_data
        self.arq.on_send_complete = self._on_arq_send_complete

    def _on_arq_send_complete(self, ok: bool):
        if self.on_message_sent:
            self.on_message_sent(ok)
        self._drain_tx_queue()

    def _tx(self, frame_bytes: bytes, handshake: bool):
        if self.on_transmit:
            self.on_transmit(frame_bytes, handshake)

    def notify_tx_air_ms(self, frame_bytes: bytes, air_ms: float):
        """Modem feedback: `frame_bytes` occupies `air_ms` of TX audio.
        Back-dates the matching ARQ ack timer to TX completion (half-duplex:
        no ACK can arrive while our own frame is still on the air)."""
        self.arq.notify_tx_air_ms(frame_bytes, air_ms)
        if self.state == ConnectionState.CONNECTING:
            # The CONNECT retry timer likewise counts from TX completion:
            # an MFSK-fallback CONNECT occupies ~28 s of air — retrying on
            # the wall-clock 12 s timeout would queue overlapping copies.
            self._timer = min(self._timer, -int(air_ms))

    def _next_ctrl_seq(self) -> int:
        # Wrap below DISCONNECT_SEQ (0xFFFF).  The old `(x+1) & 0xFFFE`
        # cleared the LSB every increment, pinning the counter at 0 — which
        # defeated the ACK-gated proposals' reliance on per-proposal seq
        # uniqueness (a delayed ACK for an abandoned proposal could apply a
        # newer different one).
        self._ctrl_seq = (self._ctrl_seq + 1) % 0xFFFF
        return self._ctrl_seq

    def set_local_callsign(self, call: str):
        self.local_call = call

    # ------------------------------------------------------------ control
    def connect(self, remote_call: str) -> bool:
        if self.state != ConnectionState.DISCONNECTED or not self.local_call:
            return False
        self.remote_call = remote_call
        self.remote_hash = hash_callsign(remote_call)
        self.state = ConnectionState.PROBING
        self.is_initiator = True
        self.stats.connects_initiated += 1
        self._timer = 0
        self._retries = 0
        if self.on_ping_tx:
            self.on_ping_tx()
        return True

    DISCONNECT_RETRANSMIT_INTERVAL_MS = 5000
    DISCONNECT_MAX_RETRIES = 3
    DISCONNECT_GRACE_MS = 5000
    DISCONNECT_ACK_RETRANSMIT_MS = 2000

    def disconnect(self):
        if self.state != ConnectionState.CONNECTED:
            self._enter_disconnected("local abort")
            return
        f = ConnectFrame(type=FrameType.DISCONNECT, src_callsign=self.local_call,
                         dst_callsign=self.remote_call)
        self._disc_frame = f.serialize()
        self._tx(self._disc_frame, handshake=False)
        self.stats.disconnects += 1
        # Reliable teardown (connection.cpp:305-328): wait for the peer's
        # ACK, retransmitting DISCONNECT on fading loss; a timeout forces
        # the local drop so an unreachable peer can't wedge us.
        self.state = ConnectionState.DISCONNECTING
        self._disc_timeout_ms = self.config.disconnect_timeout_ms
        self._disc_retx_ms = self.DISCONNECT_RETRANSMIT_INTERVAL_MS
        self._disc_retries = 0

    def abort_tx_now(self):
        """Drop all pending TX state immediately (Connection::abortTxNow)."""
        self.arq.reset()
        self._rx_fragments = []
        self._tx_msg_queue = []

    def accept_call(self):
        """Accept a pending incoming CONNECT when auto_accept is off."""
        if self._pending_connect is not None:
            req = self._pending_connect
            self._pending_connect = None
            self._accept_connect(req)

    def reject_call(self):
        if self._pending_connect is not None:
            req = self._pending_connect
            self._pending_connect = None
            f = ConnectFrame(type=FrameType.CONNECT_NAK, src_callsign=self.local_call,
                             dst_callsign=req.src_callsign)
            self._tx(f.serialize(), handshake=True)

    def send_messages(self, texts: list[bytes | str]) -> bool:
        """Batch send (reference sendMessages: burst-friendly fan-out)."""
        ok = True
        for t in texts:
            ok &= self.send_message(t)
        return ok

    def send_beacon(self, payload: bytes = b""):
        f = ControlFrame.make_beacon(self.local_call)
        f.payload = payload[:6].ljust(6, b"\x00")
        self._tx(f.serialize(), handshake=True)

    def send_probe(self, remote_call: str):
        """Channel probe request; the peer answers PROBE_ACK with a
        ChannelReport (snr/delay/doppler/recommended mode)."""
        f = ControlFrame(type=FrameType.PROBE, seq=self._next_ctrl_seq(),
                         src_hash=hash_callsign(self.local_call),
                         dst_hash=hash_callsign(remote_call))
        self._tx(f.serialize(), handshake=True)

    # ------------------------------------------------------------ messaging
    def message_capacity(self) -> int:
        if self.link.waveform == WaveformMode.MC_DPSK:
            return 200  # variable-CW frames; keep bursts modest
        return fixed_frame_payload_capacity(self.link.rate)

    def send_message(self, data: bytes | str) -> bool:
        """Buffer a message for transmission (fragmented to link capacity).

        Chunks queue behind any frame still awaiting its ACK and drain from
        tick()/send-complete, so back-to-back sends are never dropped
        (reference Connection buffers TX the same way).
        """
        if self.state != ConnectionState.CONNECTED:
            return False
        if isinstance(data, str):
            data = data.encode()
        cap = self.message_capacity()
        chunks = [data[i : i + cap] for i in range(0, len(data), cap)] or [b""]
        for i, chunk in enumerate(chunks):
            flags = Flags.MORE_FRAG if i < len(chunks) - 1 else Flags.FINAL
            self._tx_msg_queue.append((chunk, int(flags)))
        self.stats.messages_sent += 1
        self._drain_tx_queue()
        return True

    def _drain_tx_queue(self):
        while (self._tx_msg_queue and self.state == ConnectionState.CONNECTED
               and self.arq.is_ready_to_send()):
            chunk, flags = self._tx_msg_queue.pop(0)
            if not self.arq.send_data(chunk, flags):
                self._tx_msg_queue.insert(0, (chunk, flags))
                break

    def is_ready_to_send(self) -> bool:
        """True when a new send would transmit immediately (no queue, open
        ARQ slot) — used for pacing bulk transfers."""
        return (self.state == ConnectionState.CONNECTED and
                not self._tx_msg_queue and self.arq.is_ready_to_send())

    def _on_arq_data(self, payload: bytes, flags: int):
        if flags & Flags.MORE_FRAG:
            self._rx_fragments.append(payload)
            return
        data = b"".join(self._rx_fragments) + payload
        self._rx_fragments = []
        self.stats.messages_received += 1
        if self.on_message:
            self.on_message(data)

    # ------------------------------------------------------------ handshake
    def notify_ping_received(self):
        """Modem detected a PING addressed to the channel (responder side)."""
        if self.state == ConnectionState.DISCONNECTED and self.config.auto_accept:
            if self.on_pong_tx:
                self.on_pong_tx()

    @property
    def use_mfsk_fallback(self) -> bool:
        """True once CONNECT attempts exceed the DPSK budget — the modem
        layer should carry further handshake frames on MFSK
        (connection.hpp:29-33 DPSK_ATTEMPTS fallback)."""
        return (self.state == ConnectionState.CONNECTING
                and self._retries >= self.config.dpsk_connect_attempts)

    @property
    def handshake_spreading(self) -> int:
        """Spreading escalation for CONNECT retries (beyond reference):
        after two spread-1 DPSK attempts fail, remaining DPSK attempts ride
        4x time-spreading (+6 dB) before the MFSK last resort — the
        receiver's spread-4 hypothesis peek decodes them without prior
        agreement.  Extends the honest-noise session floor below the
        spread-1 CONNECT decode floor (~-8 dB AWGN)."""
        if (self.state == ConnectionState.CONNECTING and self._retries >= 2
                and not self.use_mfsk_fallback):
            return 4
        return 1

    def notify_pong_received(self):
        """Initiator: remote is alive; send the full CONNECT."""
        if self.state == ConnectionState.PROBING:
            self.state = ConnectionState.CONNECTING
            self._timer = 0
            self._retries = 0
            self._send_connect()

    def _send_connect(self):
        forced_wf = int(self.config.preferred_mode)
        caps = self.config.mode_capabilities
        if self.config.burst_group >= 2:
            caps |= 0x80  # burst-interleave capable
        f = ConnectFrame(
            type=FrameType.CONNECT, seq=self._next_ctrl_seq(),
            src_callsign=self.local_call, dst_callsign=self.remote_call,
            mode_capabilities=caps,
            negotiated_mode=forced_wf,
            initial_modulation=MOD_ENUM.get(self.config.forced_modulation, 0xFF)
            if self.config.forced_modulation else 0xFF,
            initial_code_rate=RATE_ENUM.get(self.config.forced_rate, 0xFF)
            if self.config.forced_rate else 0xFF)
        self._tx(f.serialize(), handshake=True)

    def _negotiate(self, req: ConnectFrame) -> LinkMode:
        snr, fading = self.measured_snr_db, self.measured_fading
        if req.negotiated_mode != 0xFF:
            wf = WaveformMode(req.negotiated_mode)
            mod, rate, spread = recommend_data_mode(snr, wf, fading)
        else:
            rec = recommend_waveform_and_rate(snr, fading)
            wf, mod, rate, spread = rec.waveform, rec.modulation, rec.rate, rec.spreading
            if wf in (WaveformMode.OFDM_CHIRP, WaveformMode.OFDM_COX):
                rate = cap_initial_ofdm_rate(snr, fading, rate)
            otfs = self._route_otfs(req, wf, snr)
            if otfs is not None:
                wf, (mod, rate), spread = WaveformMode.OTFS_EQ, otfs, 1
        if req.initial_modulation != 0xFF:
            mod = MOD_NAME.get(req.initial_modulation, mod)
        if req.initial_code_rate != 0xFF:
            rate = RATE_NAME.get(req.initial_code_rate, rate)
        return LinkMode(waveform=wf, modulation=mod, rate=rate, spreading=spread)

    def _route_otfs(self, req: ConnectFrame, table_wf: WaveformMode,
                    snr: float) -> tuple[str, str] | None:
        """OFDM<->OTFS arbitration from the handshake channel probe.

        Reference AdaptiveModem (adaptive_modem.hpp:216-224) routes by the
        ITU-R class of the characterized channel: Good -> OTFS_EQ,
        Moderate -> OFDM, Poor -> OTFS (our re-measured table keeps the
        equalized mode for Poor too, channel_probe.recommended_mode).
        Deviations, both measurement-driven:
        - an AWGN-clean probe (no resolvable multipath or Doppler) stays
          on OFDM — the class table calls delay<0.75/doppler<0.3 "Good",
          but OTFS QPSK R1/2 (~1.7 kbps gross) would forfeit the QAM
          ladder's 4.8-7.2 kbps on a channel OFDM decodes at 10/10;
        - a Good-class probe at snr >= 18 dB keeps OFDM for the same
          throughput reason: the reference's own preset notes put QAM16
          R2/3 at 4.9 kbps/96% on Good 20 dB (types.hpp:361), and the
          round-4 goodput harness measured OTFS QPSK at <1 kbps with
          partial delivery there — OTFS earns its keep on Poor/Flutter
          classes and low-SNR Good, not on a clean 18+ dB channel.
        Requires both ends OTFS_EQ-capable (capability bit 1<<OTFS_EQ).
        """
        if table_wf != WaveformMode.OFDM_CHIRP:
            return None
        cap = 1 << int(WaveformMode.OTFS_EQ)
        if not (req.mode_capabilities & cap) or not (self.config.mode_capabilities & cap):
            return None
        if self.measured_delay_ms < 0.0:
            return None  # no probe this session
        from ria_tpu_torch.phy.channel_probe import ChannelEstimate

        est = ChannelEstimate(snr_db=snr, delay_spread_ms=self.measured_delay_ms,
                              doppler_spread_hz=self.measured_doppler_hz)
        dispersive = est.delay_spread_ms >= 0.25 or est.doppler_spread_hz >= 0.05
        if not dispersive or est.recommended_mode() != "OTFS_EQ":
            return None
        if est.is_good() and snr >= 18.0:
            return None
        return recommend_otfs_mode(snr)

    def _enter_connected(self, link: LinkMode):
        self.link = link
        self.state = ConnectionState.CONNECTED
        self._keepalive_timer = 0
        self._pending_profile = None
        self._profile_attempts = 0
        self._pending_mode_change = None
        mode = (ARQMode.STOP_AND_WAIT if link.waveform == WaveformMode.MC_DPSK
                else ARQMode.SELECTIVE_REPEAT)
        arq_cfg = self.config.arq
        if link.burst_group >= 2 and arq_cfg.window_size < 2 * link.burst_group:
            # A burst group only forms when `group` frames are queued at
            # once; the selective-repeat window must cover at least one
            # full group or the 4-frame default (reference
            # arq_interface.hpp:19-28) silently degrades bursts to singles.
            # 2x the group pipelines the NEXT burst while the previous
            # one's SACK is in flight (dead-air was ~40% of a burst cycle);
            # flush_window = one group so the receiver SACKs per burst.
            from dataclasses import replace

            arq_cfg = replace(arq_cfg, window_size=2 * link.burst_group,
                              rx_buffer_size=max(arq_cfg.rx_buffer_size,
                                                 2 * link.burst_group),
                              flush_window=link.burst_group)
        self.arq = create_arq(mode, arq_cfg)
        self.arq.set_callsigns(self.local_call, self.remote_call)
        self._wire_arq()
        if self.on_mode_changed:
            self.on_mode_changed(link)
        if self.on_connected:
            self.on_connected()

    def _enter_disconnected(self, reason: str):
        prev = self.state
        self.state = ConnectionState.DISCONNECTED
        self.remote_call = ""
        self.remote_hash = 0
        self._rx_fragments = []
        self._disc_frame = None
        self._disc_timeout_ms = self._disc_retx_ms = self._disc_retries = 0
        self._disc_ack_frame = None
        self._disc_pending_ms = self._disc_ack_retx_ms = 0
        self._connect_ack_frame = None
        self.measured_delay_ms = -1.0
        self.measured_doppler_hz = -1.0
        self.arq.reset()
        if prev != ConnectionState.DISCONNECTED and self.on_disconnected:
            self.on_disconnected(reason)

    # ------------------------------------------------------------ RX dispatch
    def on_frame_received(self, frame_bytes: bytes):
        ctrl = ControlFrame.deserialize(frame_bytes) if len(frame_bytes) >= 20 else None
        conn = ConnectFrame.deserialize(frame_bytes)
        df = DataFrame.deserialize(frame_bytes)

        if conn is not None and conn.type == FrameType.CONNECT:
            self._handle_connect(conn)
            return
        if conn is not None and conn.type == FrameType.CONNECT_ACK:
            self._handle_connect_ack(conn)
            return
        if conn is not None and conn.type == FrameType.CONNECT_NAK:
            if self.state == ConnectionState.CONNECTING:
                self.stats.connects_failed += 1
                self._enter_disconnected("rejected")
            return
        if conn is not None and conn.type == FrameType.DISCONNECT:
            if self.state == ConnectionState.DISCONNECTED:
                return
            # Grace period (connection_handlers.cpp:304-331): ACK and stay
            # up so a lost ACK can be re-sent when the initiator
            # retransmits; drop only after the grace expires.
            self._disc_ack_frame = ControlFrame.make_ack(
                self.local_call, hash_callsign(conn.src_callsign),
                DISCONNECT_SEQ).serialize()
            self._tx(self._disc_ack_frame, handshake=False)
            if not self._disc_pending_ms:
                self.stats.disconnects += 1
            self._disc_pending_ms = self.DISCONNECT_GRACE_MS
            self._disc_ack_retx_ms = self.DISCONNECT_ACK_RETRANSMIT_MS
            return
        if ctrl is not None:
            if ctrl.type == FrameType.BEACON:
                if self.on_beacon:
                    self.on_beacon(ctrl.src_hash, ctrl.payload)
                return
            if ctrl.type == FrameType.MODE_CHANGE:
                self._handle_mode_change(ctrl)
                return
            if ctrl.type == FrameType.MC_PROFILE:
                self._handle_mc_profile(ctrl)
                return
            if ctrl.type == FrameType.KEEPALIVE:
                return
            if ctrl.type == FrameType.PROBE:
                # Answer with the measured channel report
                # (reference ProbeAck + ChannelReport wire format).
                from ria_tpu_torch.phy.channel_probe import ChannelReport
                from ria_tpu_torch.wave.selection import recommend_waveform_and_rate

                rec = recommend_waveform_and_rate(self.measured_snr_db,
                                                  self.measured_fading)
                report = ChannelReport(snr_db=self.measured_snr_db,
                                       delay_spread_ms=0.0,
                                       doppler_spread_hz=0.0,
                                       recommended_mode=int(rec.waveform),
                                       capabilities=self.config.mode_capabilities & 0xFF)
                ack = ControlFrame(type=FrameType.PROBE_ACK, seq=ctrl.seq,
                                   src_hash=hash_callsign(self.local_call),
                                   dst_hash=ctrl.src_hash,
                                   payload=report.encode().ljust(6, b"\x00"))
                self._tx(ack.serialize(), handshake=True)
                return
            if ctrl.type == FrameType.PROBE_ACK:
                if self.on_probe_report:
                    from ria_tpu_torch.phy.channel_probe import ChannelReport

                    self.on_probe_report(ChannelReport.decode(ctrl.payload))
                return
            if ctrl.type in (FrameType.ACK, FrameType.NACK):
                if ctrl.seq == DISCONNECT_SEQ:
                    if self.state == ConnectionState.DISCONNECTING:
                        self._enter_disconnected("disconnect complete")
                    return
                if self.state == ConnectionState.DISCONNECTING:
                    return  # stale data ACK while tearing down
                if (ctrl.type == FrameType.ACK
                        and (self._complete_mc_profile(ctrl.seq)
                             or self._complete_mode_change(ctrl.seq))):
                    return
                if (ctrl.seq & 0xFF00) in (0xFD00, 0xFE00):
                    # Control-plane ACK (MODE_CHANGE 0xFDxx / MC_PROFILE
                    # 0xFExx) whose pending entry is already consumed — a
                    # retransmitted proposal elicits one ACK per copy.  It
                    # must NEVER reach the data ARQ: selective repeat's
                    # cumulative _complete_upto(0xFDxx) would mark every
                    # in-flight data slot delivered and permanently stall
                    # the receiver on the holes (observed: good@20 bulk
                    # transfer frozen at 83% with rx_next stuck).
                    return
                self.arq.on_frame_received(frame_bytes)
                return
        if df is not None and 0x30 <= int(df.type) <= 0x33:
            self.arq.on_frame_received(frame_bytes)

    def _handle_connect(self, req: ConnectFrame):
        if (self.state == ConnectionState.CONNECTED
                and hash_callsign(req.src_callsign) == self.remote_hash
                and self._connect_ack_frame is not None):
            # Duplicate CONNECT: our CONNECT_ACK was lost — re-send it
            # (reference handleConnect re-acks an already-accepted peer,
            # connection_handlers.cpp:82; without this a faded ACK leaves
            # the initiator retrying CONNECT forever against silence).
            self._tx(self._connect_ack_frame, handshake=True)
            return
        if self.state not in (ConnectionState.DISCONNECTED, ConnectionState.PROBING):
            return
        if not self.config.auto_accept:
            # Park the request for the operator; accept_call()/reject_call()
            # resolve it (reference incoming-call flow).
            self._pending_connect = req
            if self.on_incoming_call:
                self.on_incoming_call(req.src_callsign)
            return
        self._accept_connect(req)

    def _accept_connect(self, req: ConnectFrame):
        self.remote_call = req.src_callsign
        self.remote_hash = hash_callsign(req.src_callsign)
        self.is_initiator = False
        self.stats.connects_received += 1
        link = self._negotiate(req)
        feature_bits = 0
        if (self.config.burst_group >= 2 and (req.mode_capabilities & 0x80)
                and link.waveform in (WaveformMode.OFDM_CHIRP,
                                      WaveformMode.OFDM_COX)):
            # CONNECT 0x80 is ambiguous (reference: MC-DPSK channel
            # interleave capability), so the responder only arms burst RX
            # here; burst TX waits for the burst_tx_confirmed latch (see
            # LinkMode) to avoid sending bursts a reference peer cannot
            # decode.  A reference peer ignores our ACK bit0 on OFDM
            # links (it gates on negotiated MC_DPSK), so setting it is safe.
            # Both ends derive the group size from the SAME encoded SNR byte
            # this ACK carries, so no extra signaling is needed.
            link.burst_group = burst_group_for_link(
                decode_snr(encode_snr(self.measured_snr_db) & ~0x03),
                link.modulation, link.rate,
                decode_fading_index(encode_fading_index(self.measured_fading)))
            feature_bits |= 0x01
        ack = ConnectFrame(
            type=FrameType.CONNECT_ACK, seq=self._next_ctrl_seq(),
            src_callsign=self.local_call, dst_callsign=self.remote_call,
            mode_capabilities=encode_fading_index(self.measured_fading),
            negotiated_mode=int(link.waveform),
            initial_modulation=MOD_ENUM[link.modulation],
            initial_code_rate=RATE_ENUM[link.rate],
            measured_snr=(encode_snr(self.measured_snr_db) & ~0x03) | feature_bits)
        self._connect_ack_frame = ack.serialize()
        self._tx(self._connect_ack_frame, handshake=True)
        self._enter_connected(link)

    def _handle_connect_ack(self, ack: ConnectFrame):
        if self.state != ConnectionState.CONNECTING:
            return
        link = LinkMode(
            waveform=WaveformMode(ack.negotiated_mode)
            if ack.negotiated_mode != 0xFF else WaveformMode.MC_DPSK,
            modulation=MOD_NAME.get(ack.initial_modulation, "DBPSK"),
            rate=RATE_NAME.get(ack.initial_code_rate, "R1_4"))
        if ((ack.measured_snr & 0x01) and self.config.burst_group >= 2
                and link.waveform in (WaveformMode.OFDM_CHIRP,
                                      WaveformMode.OFDM_COX)):
            # bit0 + an OFDM waveform cannot come from a reference peer (it
            # only sets bit0 for negotiated MC_DPSK,
            # connection_handlers.cpp:184), so the initiator may burst-TX
            # immediately.  The group is derived from the SAME SNR byte the
            # responder used, keeping both ends' burst geometry identical.
            link.burst_group = burst_group_for_link(
                decode_snr(ack.measured_snr & ~0x03),
                link.modulation, link.rate,
                decode_fading_index(ack.mode_capabilities))
            link.burst_tx_confirmed = True
        if link.waveform == WaveformMode.MC_DPSK:
            _, _, link.spreading = recommend_data_mode(
                decode_snr(ack.measured_snr & ~0x03), link.waveform)
        self._enter_connected(link)

    def _handle_mode_change(self, ctrl: ControlFrame):
        if self.state != ConnectionState.CONNECTED:
            return
        p = ctrl.payload
        link = LinkMode(waveform=self.link.waveform,
                        modulation=MOD_NAME.get(p[0], self.link.modulation),
                        rate=RATE_NAME.get(p[1], self.link.rate),
                        spreading=self.link.spreading,
                        burst_group=self.link.burst_group,
                        burst_tx_confirmed=self.link.burst_tx_confirmed)
        if p[5] & 0x80:
            link.waveform = WaveformMode(p[5] & 0x7F)
        if link.waveform not in (WaveformMode.OFDM_CHIRP, WaveformMode.OFDM_COX):
            link.burst_group = 0
        elif link.burst_group >= 2:
            # Re-derive the group from the peer's reported SNR (same byte
            # both ends see) so the burst geometry tracks the new mode.
            link.burst_group = burst_group_for_link(
                decode_snr(p[2]), link.modulation, link.rate,
                decode_fading_index(p[4]))
        if link.waveform == WaveformMode.MC_DPSK:
            # Spreading follows the peer's reported SNR (reference
            # modem_mode.cpp:93-128 derives MC-DPSK DATA spreading from the
            # MODE_CHANGE payload's peer_snr) so both ends stay aligned.
            _, _, link.spreading = recommend_data_mode(
                decode_snr(p[2]), WaveformMode.MC_DPSK)
        self.link = link
        self._sync_arq_window()
        # Rebuild the waveform BEFORE transmitting the ACK: the ACK rides
        # the data waveform, and a stale one trips the TX drift guard.
        if self.on_mode_changed:
            self.on_mode_changed(link)
        ack = ControlFrame.make_ack(self.local_call, self.remote_hash, ctrl.seq)
        self._tx(ack.serialize(), handshake=False)

    def _sync_arq_window(self):
        """Grow the live ARQ window to cover the negotiated burst group
        after a MODE_CHANGE (the ARQ itself is not recreated mid-session —
        in-flight seq state must survive — so only the window is resized)."""
        if (self.link.burst_group >= 2
                and self.arq.config.window_size < 2 * self.link.burst_group):
            from dataclasses import replace

            self.arq.config = replace(
                self.arq.config, window_size=2 * self.link.burst_group,
                rx_buffer_size=max(self.arq.config.rx_buffer_size,
                                   2 * self.link.burst_group),
                flush_window=self.link.burst_group)

    # ------------------------------------------------- MC-DPSK profile
    # ACK-gated extension (FrameType.MC_PROFILE): the proposer applies the
    # upgraded profile only after the peer's ACK; the peer applies on
    # receipt.  A reference peer never ACKs an unknown control type, so
    # links to it stay on the standard 10-carrier R1/4 profile.  A lost
    # ACK leaves the ends mismatched only until the adapter re-proposes;
    # meanwhile the station's standard-profile RX hypothesis still decodes
    # the peer's frames (phy/station.py profile fallback).

    MC_PROFILE_MAX_ATTEMPTS = 3

    def request_mc_profile(self, carriers: int, modulation: str,
                           rate: str) -> bool:
        if (self.state != ConnectionState.CONNECTED
                or self.link.waveform != WaveformMode.MC_DPSK
                or self._profile_attempts >= self.MC_PROFILE_MAX_ATTEMPTS):
            return False
        # Dedicated seq range: data ACKs carry small ARQ seqs, and an ACK
        # seq match is what applies the profile — a collision with a data
        # ACK must be impossible (0xFFFF stays reserved for DISCONNECT).
        seq = 0xFE00 | (self._next_ctrl_seq() & 0xFF)
        f = ControlFrame(type=FrameType.MC_PROFILE, seq=seq,
                         src_hash=hash_callsign(self.local_call),
                         dst_hash=self.remote_hash,
                         payload=bytes([carriers, MOD_ENUM[modulation],
                                        RATE_ENUM[rate],
                                        encode_snr(self.measured_snr_db),
                                        encode_fading_index(self.measured_fading),
                                        0]))
        self._pending_profile = (seq, carriers, modulation, rate)
        self._profile_attempts += 1
        self._tx(f.serialize(), handshake=False)
        return True

    def _handle_mc_profile(self, ctrl: ControlFrame):
        """Peer side: ACK the offer and ARM the new profile as a second RX
        hypothesis (on_mc_profile_offer -> station) — do NOT switch TX yet.
        The peer adopts the profile only once a frame actually decodes
        under it (adopt_mc_profile), so a lost ACK can never leave the two
        ends transmitting mutually undecodable profiles."""
        if self.state != ConnectionState.CONNECTED:
            return
        p = ctrl.payload
        carriers = int(p[0])
        if not (3 <= carriers <= 20):
            return
        ack = ControlFrame.make_ack(self.local_call, self.remote_hash, ctrl.seq)
        self._tx(ack.serialize(), handshake=False)
        if self.on_mc_profile_offer:
            self.on_mc_profile_offer(carriers, MOD_NAME.get(p[1], "DBPSK"),
                                     RATE_NAME.get(p[2], "R1_2"))

    def adopt_mc_profile(self, carriers: int, modulation: str, rate: str):
        """Silent link switch once the armed profile decoded a real frame
        (the station keeps the waveform object; no on_mode_changed)."""
        self.link = LinkMode(waveform=WaveformMode.MC_DPSK,
                             modulation=modulation, rate=rate,
                             spreading=1, mc_carriers=carriers)

    def _complete_mc_profile(self, seq: int) -> bool:
        """ACK arrived for a pending profile proposal -> apply it."""
        if self._pending_profile is None or self._pending_profile[0] != seq:
            return False
        _, carriers, modulation, rate = self._pending_profile
        self._pending_profile = None
        self._profile_attempts = 0
        self.link = LinkMode(waveform=WaveformMode.MC_DPSK,
                             modulation=modulation, rate=rate,
                             spreading=1, mc_carriers=carriers)
        if self.on_mode_changed:
            self.on_mode_changed(self.link)
        return True

    MODE_CHANGE_TIMEOUT_MS = 45_000       # reference connection.hpp:296 (DPSK RTT)
    MODE_CHANGE_TIMEOUT_OFDM_MS = 12_000  # OFDM ctrl RTT is seconds, not 45 s
    MODE_CHANGE_MAX_RETRIES = 2           # reference connection.hpp:297

    @property
    def _mode_change_timeout(self) -> int:
        return (self.MODE_CHANGE_TIMEOUT_MS
                if self.link.waveform == WaveformMode.MC_DPSK
                else self.MODE_CHANGE_TIMEOUT_OFDM_MS)

    def request_mode_change(self, modulation: str, rate: str, reason: int = 2,
                            waveform: WaveformMode | None = None) -> bool:
        """ACK-GATED, like the reference (connection.cpp:741-770, 924-950):
        the requester applies the new mode only when the peer's ACK
        arrives, retries on timeout, and keeps the current mode after the
        retry budget.  (Optimistic apply deadlocks the link whenever the
        MODE_CHANGE frame is lost in a fade: the ends transmit mutually
        undecodable data profiles and only the hardened control path still
        crosses.)"""
        if self.state != ConnectionState.CONNECTED:
            return False
        if self._pending_mode_change is not None:
            return False  # one in flight at a time (reference behavior)
        # Dedicated seq range (cf. MC_PROFILE): the apply trigger is an
        # ACK seq match, which must never collide with a data ACK.
        seq = 0xFD00 | (self._next_ctrl_seq() & 0xFF)
        snr_at_request = self.measured_snr_db
        f = ControlFrame.make_mode_change(
            self.local_call, self.remote_hash, seq,
            MOD_ENUM[modulation], rate, snr_at_request,
            self.measured_fading, reason, waveform)
        fb = f.serialize()
        # Keep the SNR that went INTO the frame: the receiver derives
        # spreading/burst geometry from that byte, and both ends must use
        # the same value even if measured_snr_db moves before the ACK.
        self._pending_mode_change = (seq, fb, modulation, rate, waveform,
                                     snr_at_request, self.measured_fading)
        self._mode_change_timer_ms = 0
        self._mode_change_retries = 0
        self._tx(fb, handshake=False)
        return True

    def _complete_mode_change(self, seq: int) -> bool:
        """Peer ACKed our MODE_CHANGE -> apply it (reference :741-770)."""
        if (self._pending_mode_change is None
                or self._pending_mode_change[0] != seq):
            return False
        (_, _, modulation, rate, waveform, snr_req,
         fading_req) = self._pending_mode_change
        self._pending_mode_change = None
        snr_wire = decode_snr(encode_snr(snr_req))
        spreading = self.link.spreading
        if (waveform or self.link.waveform) == WaveformMode.MC_DPSK:
            # Mirror the receiver's derivation (see _handle_mode_change):
            # both ends compute spreading from the same encoded SNR byte.
            _, _, spreading = recommend_data_mode(snr_wire,
                                                  WaveformMode.MC_DPSK)
        new_wf = waveform or self.link.waveform
        burst_ok = new_wf in (WaveformMode.OFDM_CHIRP, WaveformMode.OFDM_COX)
        group = self.link.burst_group
        if burst_ok and group >= 2:
            # Mirror the receiver's re-derivation from the same wire bytes.
            group = burst_group_for_link(
                snr_wire, modulation, rate,
                decode_fading_index(encode_fading_index(fading_req)))
        self.link = LinkMode(waveform=new_wf,
                             modulation=modulation, rate=rate,
                             spreading=spreading,
                             burst_group=group if burst_ok else 0,
                             burst_tx_confirmed=self.link.burst_tx_confirmed)
        self._sync_arq_window()
        if self.on_mode_changed:
            self.on_mode_changed(self.link)
        return True

    # ------------------------------------------------------------ timing
    def tick(self, elapsed_ms: int):
        if self.state == ConnectionState.PROBING:
            self._timer += elapsed_ms
            if self._timer >= self.config.ping_interval_ms:
                self._timer = 0
                self._retries += 1
                if self._retries >= self.config.ping_retries:
                    self.stats.connects_failed += 1
                    self._enter_disconnected("no answer to ping")
                elif self.on_ping_tx:
                    self.on_ping_tx()
        elif self.state == ConnectionState.CONNECTING:
            self._timer += elapsed_ms
            if self._timer >= self.config.connect_timeout_ms:
                self._timer = 0
                self._retries += 1
                if self._retries >= self.config.connect_retries:
                    self.stats.connects_failed += 1
                    self._enter_disconnected("connect timeout")
                else:
                    self._send_connect()
        elif self.state == ConnectionState.CONNECTED:
            # Disconnect grace period (responder side, connection.cpp:956-976):
            # stay connected, re-send the ACK periodically in case fading ate
            # it, and drop once the initiator has gone silent.
            if self._disc_pending_ms:
                if elapsed_ms >= self._disc_pending_ms:
                    self._enter_disconnected("remote disconnect")
                    return
                self._disc_pending_ms -= elapsed_ms
                if self._disc_ack_frame is not None:
                    if elapsed_ms >= self._disc_ack_retx_ms:
                        self._disc_ack_retx_ms = self.DISCONNECT_ACK_RETRANSMIT_MS
                        self._tx(self._disc_ack_frame, handshake=False)
                    else:
                        self._disc_ack_retx_ms -= elapsed_ms
                self.arq.tick(elapsed_ms)
                return
            # MODE_CHANGE retry / abandon (reference connection.cpp:924-950).
            if self._pending_mode_change is not None:
                self._mode_change_timer_ms += elapsed_ms
                if self._mode_change_timer_ms >= self._mode_change_timeout:
                    self._mode_change_timer_ms = 0
                    self._mode_change_retries += 1
                    if self._mode_change_retries > self.MODE_CHANGE_MAX_RETRIES:
                        # Keep the current mode (reference behavior,
                        # connection.cpp:928-933).  If the peer DID apply
                        # and only the ACKs were lost, the ends diverge
                        # until a later mode change completes — the
                        # reference accepts the same residual risk; the
                        # hardened control profile keeps control traffic
                        # decodable meanwhile, so recovery stays possible.
                        self._pending_mode_change = None
                    else:
                        self._tx(self._pending_mode_change[1], handshake=False)
            self.arq.tick(elapsed_ms)
            self._drain_tx_queue()
            self._keepalive_timer += elapsed_ms
            if self._keepalive_timer >= self.config.keepalive_interval_ms:
                self._keepalive_timer = 0
                f = ControlFrame.make_keepalive(self.local_call, self.remote_call)
                self._tx(f.serialize(), handshake=False)
        elif self.state == ConnectionState.DISCONNECTING:
            # Initiator side (connection.cpp:981-1002): retransmit the
            # DISCONNECT until ACKed; force the drop on timeout.
            if elapsed_ms >= self._disc_timeout_ms:
                self._enter_disconnected("disconnect timeout")
                return
            self._disc_timeout_ms -= elapsed_ms
            if elapsed_ms >= self._disc_retx_ms:
                self._disc_retx_ms = self.DISCONNECT_RETRANSMIT_INTERVAL_MS
                if (self._disc_retries < self.DISCONNECT_MAX_RETRIES
                        and self._disc_frame is not None):
                    self._disc_retries += 1
                    self._tx(self._disc_frame, handshake=False)
            else:
                self._disc_retx_ms -= elapsed_ms
