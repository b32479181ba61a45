"""Station runtime: the ModemEngine-equivalent gluing waveforms + protocol.

Mirrors the reference's modem runtime behavior (src/gui/modem/modem_engine.*,
streaming_decoder.*) in block-processing form:

- TX: protocol frames -> waveform TX (handshake frames on the chirp-preamble
  handshake waveform, connected traffic on the negotiated waveform with
  light preambles), queued as audio;
- RX: ring buffer + sync search + decode; PING/PONG are chirp + raw uncoded
  "ULTR" bits (frame_v2.hpp:363-397), discriminated from data frames after
  chirp detection, with PING vs PONG resolved by connection context;
- incremental readiness: decode is attempted only once the buffer can hold
  the full frame implied by the CW0 header (streaming_decoder
  checkIfReadyToDecode), with sync-position backoff on failures.

Used by the lock-step dual-station simulator and as the host-side serving
runtime.

Port of ``ria_tpu/phy/station.py``.  The station logic is the reference
package's host code; every waveform it builds runs on the station's
``device`` (default the card; without one construction raises), so each
sync search, demodulation and LDPC decode (K1 on the card) runs there.  The
ring buffer stays a host array, as in the reference.  The first waveform
call of a poll uploads the whole ring once as an ``AudioBuffer``
(:meth:`Station._ring`), and every call of that poll — the sliding sync
windows, the PING probe, the header peeks and their recovery offsets, the
frame and burst decodes — reads that one buffer; ``feed_audio`` and
``_consume`` drop it.  The PING ratio, the noise-floor tracking and the
link adaptation stay host numpy, as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ria_tpu_torch.phy.frame_v2 import PING_MAGIC, WaveformMode
from ria_tpu_torch.phy.modem import AudioBuffer
from ria_tpu_torch.protocol.connection import Connection, ConnectionConfig, ConnectionState, LinkMode
from ria_tpu_torch.utils.bits import bytes_to_bits
from ria_tpu_torch.utils.device import resolve_device
from ria_tpu_torch.wave.api import MCDPSKWaveform, create_waveform

# PING parity note (frame_v2.hpp:363-375): the reference sends the raw
# un-coded "ULTR" magic on SINGLE-carrier DPSK, concentrating all TX power
# in one carrier (32 bits at 93.75 baud = 341 ms).  Here the same 32 bits
# ride the MC-DPSK mixer bank with each bit replicated across all carriers
# and soft-combined at RX — identical airtime and per-bit energy, one
# demod path, and the +10 dB carrier-combining gain that single-carrier
# concentration gives the reference.
PING_SYMBOLS = 32  # one magic bit per MC symbol, replicated across carriers


@dataclass
class StationStats:
    """Decoder telemetry (reference DecoderStats, streaming_decoder.hpp:83-105)."""

    frames_tx: int = 0
    frames_rx: int = 0
    decode_failures: int = 0
    pings_rx: int = 0
    sync_skips: int = 0
    bursts_tx: int = 0                # burst groups transmitted
    bursts_rx: int = 0                # burst groups received (any frame ok)
    overflow_drops: int = 0           # samples dropped at the buffer cap
    decode_time_ms_avg: float = 0.0   # EMA of host decode wall time
    config_mismatches: int = 0        # TX profile drift caught + healed
    sync_recoveries: dict = field(default_factory=dict)  # {offset: rescues}


class Station:
    def __init__(self, callsign: str, config: ConnectionConfig | None = None,
                 seed: int = 0, mc_carriers: int = 10,
                 chase_enabled: bool = True, use_css: bool = False,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.callsign = callsign
        self.conn = Connection(config)
        self.conn.set_local_callsign(callsign)
        self.stats = StationStats()
        # Monitor mode: search light/data preambles even when disconnected
        # (set by runtime.monitor / `ria monitor`).
        self.promiscuous = False
        # CSS acquisition preambles on the handshake waveform (reference
        # --css): frame type from the chirp's cyclic shift.
        self.use_css = use_css

        # Forced MC-DPSK carrier count (cli_simulator --carriers / host
        # MCDPSKCARRIERS command; reference MultiCarrierDPSKConfig).  Applies
        # to handshake and negotiated MC-DPSK data waveforms; beacons keep
        # the fixed 10-carrier broadcast geometry.
        self.mc_carriers = mc_carriers
        self.handshake_wf = MCDPSKWaveform(num_carriers=mc_carriers,
                                           modulation="DBPSK", rate="R1_4",
                                           use_css=use_css, device=self.device)
        self.data_wf = self.handshake_wf
        self._pending_link: LinkMode | None = None
        self._mfsk_wf = None  # lazy MFSK fallback waveform
        self._respond_mfsk = False  # peer's CONNECT arrived on MFSK
        self._respond_spread4 = False  # peer's CONNECT arrived 4x-spread
        self._respond_set_ms = 0.0  # when the reciprocity flags were set
        self._prev_conn_state = ConnectionState.DISCONNECTED
        self._spread4_wf = None  # lazy 4x-spread handshake waveform

        self.tx_queue: list[np.ndarray] = []
        # Burst-interleave TX buffer: data frames held until a full group is
        # collected (reference Connection burst TX buffering); leftovers are
        # flushed as normal light frames from tick().
        self._burst_buf: list[bytes] = []
        # ModemEngine::postProcessTx parity (modem_engine.hpp:356).  The
        # band FIR is OFF by default like the reference's FilterConfig
        # (modem_types.hpp:105-111, "radio's SSB filter sufficient") — a
        # ~100-tap FIR at 48 kHz has a >1 kHz transition band that shades
        # the outer OFDM carriers and reads as fading.  Lead-in is 0 here;
        # PTT lead timing lives in runtime/cat.py, not the sample stream.
        self.tx_filter_enabled = False
        self.tx_lead_in_ms = 0.0
        self.rx_buffer = np.zeros(0, np.float32)
        # The ring on the device for the current poll (see _ring); None
        # until a waveform call needs it, dropped when the ring changes.
        self._ring_buf: AudioBuffer | None = None
        # DEVIATION from the reference's 20 s ring cap
        # (streaming_decoder.hpp:448): an MFSK last-resort control frame is
        # ~28 s of audio and must fit the ring to be decodable at all.
        self.max_buffer = 48000 * 40
        self._last_failed_sync = -1
        self._searched_len = -1  # skip re-search until new audio arrives
        # Sliding-window sync search cursors, one per (waveform mode, light):
        # content before the cursor has been searched and holds no sync
        # (reference correlation_pos_, streaming_decoder.cpp:386-470).
        self._search_pos: dict = {}
        # Waveform keys searched in the current poll (drives the idle-trim
        # and noise-floor windows; stale cursors are excluded).
        self._polled_keys: list = []
        # SYNC_FOUND state (reference state machine SEARCHING -> SYNC_FOUND
        # -> DECODING): a detected sync waiting for enough buffered samples.
        # Caching it avoids re-running the sync search and the CW0 peek on
        # every audio tick while a long frame is still arriving.
        self._pending: dict | None = None
        # Receiver-tracked in-band noise floor (reference ofdm_sync
        # energy-gate tracker, ofdm_sync.cpp:20-47): learned from
        # sync-search-miss (silence) windows, EMA'd, and handed to the
        # waveforms' spectral SNR estimator for frames whose inter-frame
        # gap was already consumed.
        self._noise_floor: float | None = None
        # Floor readings rejected by the contamination guard below.  The
        # guard alone is a one-way ratchet: a floor learned during a
        # quieter-than-operational stretch (the simulator's idle noise
        # rides last_rms=0.1 while frames carry 2-4x that; a real radio's
        # band noise can simply rise) makes every TRUE reading >= 4x the
        # tracked value and permanently rejected, pinning session SNR
        # exactly +6 dB high (measured: 15 dB AWGN read 21, the ladder
        # upgraded past D8PSK into QAM16 R3/4).  Persistent evidence
        # breaks the ratchet: 3 consecutive rejected idle windows mean
        # the floor really moved, so relearn from their minimum.
        self._floor_rejects: list[float] = []

        from ria_tpu_torch.fec.chase import ChaseCache
        from ria_tpu_torch.phy.adaptive import LinkAdapter

        # The chase TTL runs on the protocol's time, as every other timer
        # here does, so a simulated session does not depend on the host's
        # speed (the reference's cache reads the wall clock).
        self.chase = ChaseCache(clock=self._now_s) if chase_enabled else None
        self.link_adapter = LinkAdapter()
        self._now_ms = 0.0
        # MC-DPSK profile-ladder state (see _feed_mc_profile).  Median
        # windows, not EMAs: a single outlier SNR measurement (short
        # control frames occasionally read 8 dB low) must not crash the
        # ladder into a spread-4 downgrade.
        self._mc_snr_win: list[float] = []
        self._mc_fading_win: list[float] = []
        self._mc_want: tuple | None = None
        self._mc_want_hits = 0
        # Transition dual-RX (see _arm_mc_profile): while armed, ZC-synced
        # frames that fail the primary profile are retried under the
        # alternate one, so a lost MC_PROFILE ACK can never deadlock the
        # link — whichever profile the peer is on, its frames decode.
        self._mc_alt_wf = None
        self._mc_alt_is_new = False
        self._mc_alt_deadline = 0.0
        # Consecutive in-session data decode failures (opportunistic-mode
        # fallback; see _process_pending failure tail).
        self._consec_data_failures = 0

        # Observer hook for dashboards (runtime.tui / monitor): called with
        # every successfully decoded RxFrame.
        self.on_rx_frame = None

        self.conn.on_transmit = self._on_conn_transmit
        self.conn.on_ping_tx = self._tx_ping
        self.conn.on_pong_tx = self._tx_ping  # same waveform; context decides
        self.conn.on_mode_changed = self._on_mode_changed
        self.conn.on_mc_profile_offer = self._arm_mc_profile

    # ------------------------------------------------------------------ TX
    def _tx_ping(self):
        from ria_tpu_torch.sync.css import CSS_PING

        wf = self.handshake_wf
        # Wire format (round-4 interop): a PING is the BARE acquisition
        # preamble — the reference's encodePing emits only the chirp
        # (streaming_encoder.cpp:393-431) and its RX discriminates PING
        # from DATA by the post-chirp energy ratio.  The old ria_tpu raw
        # "ULTR" DPSK tail read as data energy to a reference peer
        # (measured ratio 0.635 > 0.6 gate) and broke PING interop; RX
        # here still accepts legacy magic-tail pings (see _try_ping).
        self._enqueue_tx(wf.acq_preamble(CSS_PING))
        self.stats.frames_tx += 1

    def _enqueue_tx(self, samples: np.ndarray):
        if self.tx_filter_enabled:
            from ria_tpu_torch.phy.adaptive import tx_post_process

            samples = tx_post_process(samples, lead_in_ms=0.0, device=self.device)
        if self.tx_lead_in_ms:
            lead = np.zeros(int(48 * self.tx_lead_in_ms), np.float32)
            samples = np.concatenate([lead, np.asarray(samples, np.float32)])
        self.tx_queue.append(np.asarray(samples, np.float32))

    @property
    def mfsk_wf(self):
        if self._mfsk_wf is None:
            from ria_tpu_torch.wave.api import MFSKWaveform

            self._mfsk_wf = MFSKWaveform(device=self.device)
        return self._mfsk_wf

    def _on_conn_transmit(self, frame_bytes: bytes, handshake: bool):
        # Beacons ride MC-DPSK with 4x spreading for maximum range
        # (ModemEngine::transmitBeacon, modem_engine.hpp:76-80).
        if len(frame_bytes) >= 3 and frame_bytes[2] == 0x40:
            wf = MCDPSKWaveform(modulation="DBPSK", rate="R1_4", spreading=4,
                                device=self.device)
            self._enqueue_tx(np.asarray(wf.tx_frame(frame_bytes), np.float32))
            self.stats.frames_tx += 1
            return
        # DISCONNECTING is still connected-mode traffic: the reference only
        # reconfigures the modem in enterDisconnected, so DISCONNECT
        # retransmits and disconnect ACKs ride the negotiated data waveform
        # (a chirp-preamble retransmit would false-sync the peer's LTS
        # search and never decode).
        in_session = self.conn.state in (ConnectionState.CONNECTED,
                                         ConnectionState.DISCONNECTING)
        if handshake or not in_session:
            # After the DPSK budget, handshake frames ride the MFSK
            # last-resort waveform (connection.hpp:29-33).  A responder
            # whose CONNECT arrived on MFSK answers in kind — the initiator
            # fell back because DPSK is not getting through.
            if handshake and (self.conn.use_mfsk_fallback or self._respond_mfsk):
                wf, light = self.mfsk_wf, False
            elif handshake and (self.conn.handshake_spreading > 1
                                or self._respond_spread4):
                # Spreading escalation for CONNECT retries / their ACKs
                # (+6 dB); decoded by the peer's spread-4 hypothesis peek.
                if self._spread4_wf is None:
                    self._spread4_wf = MCDPSKWaveform(
                        num_carriers=self.mc_carriers, modulation="DBPSK",
                        rate="R1_4", spreading=4, use_css=self.use_css,
                        device=self.device)
                wf, light = self._spread4_wf, False
            else:
                wf, light = self.handshake_wf, False
        else:
            self._verify_config_match()
            wf, light = self.data_wf, True

            link = self.conn.link
            if (link.burst_group >= 2 and link.burst_tx_confirmed
                    and hasattr(wf, "tx_burst")
                    and len(frame_bytes) >= 3 and 0x30 <= frame_bytes[2] <= 0x33):
                # Collect data frames into a burst group; a full group rides
                # ONE light preamble with burst-interleaved coded bytes.
                self._burst_buf.append(frame_bytes)
                if len(self._burst_buf) >= link.burst_group:
                    self._flush_burst()
                return
        samples = np.asarray(wf.tx_frame(frame_bytes, light=light), np.float32)
        self._enqueue_tx(samples)
        self.conn.notify_tx_air_ms(frame_bytes, self._tx_backlog_ms())
        self.stats.frames_tx += 1

    def _tx_backlog_ms(self) -> float:
        """Audio-ms until everything currently queued finishes airing.

        This — not the frame's own duration — is what ACK timers must be
        back-dated by: with two 8-frame bursts queued back-to-back
        (selective-repeat window = 2x group), the second burst's slots
        otherwise start their ack timers ~a full burst (~17 s at DQPSK
        R1/2 G8) before their audio even starts, and the spurious timeout
        retransmits flood the half-duplex channel faster than it drains
        (observed at good@20: 48 timeouts in the first 40 s and a frozen
        transfer)."""
        return sum(len(a) for a in self.tx_queue) / 48.0

    def _verify_config_match(self):
        """TX/RX config-divergence guard (reference
        StreamingEncoder::verifyConfigMatch, streaming_encoder.cpp:559).

        The negotiated LinkMode is the single source of truth; data_wf can
        drift from it through live host-interface mutation (WAVEFORM /
        MODULATION / CODERATE commands) or any future direct configure()
        call.  A drifted profile fails silently as decode losses at the
        peer, so before every in-session data TX the profile is compared
        and — unlike the reference, which only asserts — healed by
        rebuilding the waveform from the link, with the event counted in
        stats.config_mismatches and logged."""
        link = self.conn.link
        wf = self.data_wf
        spreading = getattr(getattr(wf, "cfg", None), "spreading", 1)
        if (wf.mode == link.waveform and wf.modulation == link.modulation
                and wf.rate == link.rate
                and (link.waveform != WaveformMode.MC_DPSK
                     or spreading == link.spreading)):
            return
        self.stats.config_mismatches += 1
        from ria_tpu_torch.utils.logging import get_logger

        get_logger("MODEM").error(
            f"TX config drift: waveform {wf.mode.name}/{wf.modulation}/"
            f"{wf.rate}/s{spreading} != negotiated {link.waveform.name}/"
            f"{link.modulation}/{link.rate}/s{link.spreading} - rebuilding")
        self._on_mode_changed(link)

    def _flush_burst(self):
        """TX the buffered burst group (or leftovers as single frames)."""
        frames, self._burst_buf = self._burst_buf, []
        if not frames:
            return
        group = self.conn.link.burst_group
        if len(frames) == group:
            burst = self.data_wf.tx_burst(frames)
            if burst is not None:
                samples = np.asarray(burst, np.float32)
                self._enqueue_tx(samples)
                air_ms = self._tx_backlog_ms()
                for fb in frames:
                    # every frame in the burst completes when the burst does
                    self.conn.notify_tx_air_ms(fb, air_ms)
                self.stats.frames_tx += len(frames)
                self.stats.bursts_tx += 1
                return
        for fb in frames:  # partial group: normal light frames
            samples = np.asarray(self.data_wf.tx_frame(fb, light=True), np.float32)
            self._enqueue_tx(samples)
            self.conn.notify_tx_air_ms(fb, self._tx_backlog_ms())
            self.stats.frames_tx += 1

    def _on_mode_changed(self, link: LinkMode):
        self._respond_mfsk = False
        self._respond_spread4 = False
        if link.waveform == WaveformMode.MC_DPSK:
            # A negotiated MC_PROFILE (carriers > 10) wins; otherwise the
            # station's configured carrier count (operator/TCP override).
            carriers = (link.mc_carriers if link.mc_carriers != 10
                        else self.mc_carriers)
            wf = MCDPSKWaveform(num_carriers=carriers,
                                modulation=link.modulation, rate=link.rate,
                                spreading=link.spreading, device=self.device)
            old = self.data_wf
            if (isinstance(old, MCDPSKWaveform)
                    and (old.cfg.num_carriers, old.modulation, old.rate)
                    != (carriers, link.modulation, link.rate)):
                # Any MC->MC profile transition (upgrade apply, downgrade
                # apply, responder side of either): keep the old profile
                # armed as the alternate RX hypothesis until the peer
                # demonstrably switched (a frame decodes under the new
                # primary), so in-flight frames from the other side of the
                # transition still decode.
                self._mc_alt_wf = old
                self._mc_alt_is_new = False
                self._mc_alt_deadline = self._now_ms + 30_000
        else:
            wf = create_waveform(link.waveform, link.modulation, link.rate,
                                 device=self.device)
            self._mc_alt_wf = None
        self.data_wf = wf

    def _promote_mc_profile(self):
        """A frame decoded under the armed NEW profile: the proposer is
        demonstrably transmitting it — adopt it for TX too (peer side of
        the MC_PROFILE handshake)."""
        alt = self._mc_alt_wf
        self._mc_alt_wf, self._mc_alt_is_new = None, False
        self.conn.adopt_mc_profile(alt.cfg.num_carriers, alt.modulation, alt.rate)
        self.data_wf = alt

    def _arm_mc_profile(self, carriers: int, modulation: str, rate: str):
        """Peer side of the MC_PROFILE handshake: arm the offered profile
        as the alternate RX hypothesis; adopt it (link + TX) only once a
        frame actually decodes under it (_process_pending promotion)."""
        self._mc_alt_wf = MCDPSKWaveform(num_carriers=carriers,
                                         modulation=modulation, rate=rate,
                                         device=self.device)
        self._mc_alt_is_new = True
        self._mc_alt_deadline = self._now_ms + 30_000

    def pull_tx(self, max_samples: int) -> np.ndarray:
        """Drain up to max_samples of queued TX audio (half-duplex block)."""
        out = np.zeros(max_samples, np.float32)
        pos = 0
        while self.tx_queue and pos < max_samples:
            head = self.tx_queue[0]
            n = min(len(head), max_samples - pos)
            out[pos : pos + n] = head[:n]
            pos += n
            if n == len(head):
                self.tx_queue.pop(0)
            else:
                self.tx_queue[0] = head[n:]
        return out

    @property
    def tx_pending(self) -> bool:
        return bool(self.tx_queue)

    # ------------------------------------------------------------------ RX
    def _ring(self) -> AudioBuffer:
        """The whole ring as one ``AudioBuffer`` on the device: uploaded at
        the first waveform call of a poll and shared by every later call
        until the ring changes (the reference package hands the host array
        to each call, which uploads it each time: up to 8 header peeks of a
        40 s ring in one sync recovery)."""
        if self._ring_buf is None:
            self._ring_buf = AudioBuffer(self.rx_buffer, self.device)
        return self._ring_buf

    def feed_audio(self, samples: np.ndarray):
        self._ring_buf = None
        self.rx_buffer = np.concatenate([self.rx_buffer, np.asarray(samples, np.float32)])
        if len(self.rx_buffer) > self.max_buffer:
            drop = len(self.rx_buffer) - self.max_buffer
            self.rx_buffer = self.rx_buffer[drop:]
            self._last_failed_sync = max(-1, self._last_failed_sync - drop)
            self._search_pos = {k: max(0, v - drop) for k, v in self._search_pos.items()}
            if self._pending is not None:
                self._pending["sync"]["start"] -= drop
                if self._pending["sync"]["start"] < 0:
                    self._pending = None
            self.stats.overflow_drops += drop

    @property
    def buffer_fill_percent(self) -> float:
        return 100.0 * len(self.rx_buffer) / self.max_buffer

    @property
    def backlog_ms(self) -> float:
        return len(self.rx_buffer) / 48.0

    def _ping_ratio(self, start: int) -> float | None:
        """Noise-subtracted post-preamble/training signal-power ratio.

        ~0 for a bare-preamble PING (post region is TX silence), ~1 for a
        DATA frame.  Per-carrier mix-integrate magnitudes (27 dB
        processing gain) with the noise reference taken from the chirp's
        trailing TX-silence gap — the reference's raw post/train RMS gate
        (streaming_decoder.cpp:1128-1200, threshold 0.6) saturates below
        ~-1 dB SNR because noise dominates both windows.  None when the
        buffer does not yet hold the post window."""
        cfg = self.handshake_wf.cfg
        sym = cfg.samples_per_symbol
        train_syms = cfg.training_symbols + 1
        # Adaptive windows: at least 4 post symbols, up to 8 when buffered
        # (median over 8x10 values separates deep-fade pings at 0.00-0.06
        # from data frames at 0.9+; 4 symbols left marginal seeds at 0.5).
        avail = (len(self.rx_buffer) - start) // sym - train_syms
        post_syms = min(8, avail)
        if post_syms < 4:
            return None
        gap_syms = min(8, start // sym)
        need = (train_syms + post_syms) * sym
        lo = start - gap_syms * sym
        seg = np.asarray(
            self.rx_buffer[lo: start + need], np.float32
        ).reshape(gap_syms + train_syms + post_syms, sym)
        freqs = np.asarray(cfg.carrier_freqs, np.float64)
        n = np.arange(sym, dtype=np.float64)
        mixers = np.exp(-2j * np.pi * freqs[:, None] * n[None, :]
                        / cfg.sample_rate)  # [C, sym]
        z = np.abs(seg @ mixers.T.conj()) / sym  # [S, C]
        m_gap = float(np.median(z[:gap_syms])) if gap_syms else 0.0
        m_train = float(np.median(z[gap_syms: gap_syms + train_syms]))
        m_post = float(np.median(z[gap_syms + train_syms:]))
        sig_post = max(m_post * m_post - m_gap * m_gap, 0.0)
        sig_train = max(m_train * m_train - m_gap * m_gap, 1e-12)
        return sig_post / sig_train

    # A ratio below PING_FAST is accepted as PING immediately; between
    # PING_FAST and PING_WEAK the decision defers to the frame decode (a
    # decodable frame wins; an undecodable chirp sync with noise-like post
    # energy is ruled a PING at the header give-up).  Deep-fade seeds sit
    # in the deferred band — see _try_ping/_process_pending.
    PING_FAST_RATIO = 0.3
    PING_WEAK_RATIO = 0.8

    def _try_ping(self, start: int, cfo: float) -> bool:
        """Fast-path PING discrimination at a chirp sync.

        A PING is the bare acquisition preamble: chirp + training + ref
        symbol, then silence (reference encodePing).  Accept when the post
        region is clearly noise; otherwise fall back to the legacy
        ria_tpu raw "ULTR" magic tail so pre-round-4 peers still ping us
        (weak-but-noise-like cases resolve later via PING_WEAK_RATIO)."""
        cfg = self.handshake_wf.cfg
        wf = self.handshake_wf
        sym = cfg.samples_per_symbol
        ratio = self._ping_ratio(start)
        if ratio is None:
            return False
        if ratio < self.PING_FAST_RATIO:
            return True
        train_syms = cfg.training_symbols + 1
        if start + (train_syms + PING_SYMBOLS * cfg.spreading) * sym \
                > len(self.rx_buffer):
            return False
        # Legacy magic tail (ria_tpu <= round 3).
        num_bits = PING_SYMBOLS * cfg.bits_per_mc_symbol
        soft, _ = wf._demod_bits(self._ring(), start, cfo, num_bits)
        per_bit = np.asarray(soft).reshape(PING_SYMBOLS, cfg.bits_per_mc_symbol)
        combined = np.sum(per_bit, axis=1)
        hard = (combined < 0).astype(np.uint8)
        magic = bytes_to_bits(PING_MAGIC)
        match = np.mean(hard[: len(magic)] == magic[:PING_SYMBOLS])
        return match >= 0.85

    def _consume(self, upto: int):
        upto = max(0, upto)
        self._ring_buf = None
        self.rx_buffer = self.rx_buffer[upto:]
        self._last_failed_sync = -1
        self._searched_len = -1
        self._search_pos = {k: max(0, v - upto) for k, v in self._search_pos.items()}
        self._pending = None

    def poll(self):
        """Attempt decode of buffered audio; dispatch to the connection."""
        # Throttle: nothing new arrived since the last unsuccessful pass.
        if len(self.rx_buffer) <= self._searched_len:
            return
        self._searched_len = len(self.rx_buffer)

        connected = self.conn.state in (ConnectionState.CONNECTED,
                                        ConnectionState.DISCONNECTING)
        self._polled_keys = []
        if self._pending is None:
            wf = self.data_wf if connected else self.handshake_wf
            light = connected
            sync = self._windowed_detect(wf, light)
            if sync is None and connected:
                # Handshake-preamble frames (e.g. DISCONNECT retry) can
                # still arrive.
                wf, light = self.handshake_wf, False
                sync = self._windowed_detect(wf, False)
            if sync is None and not connected and self.promiscuous:
                # Monitor mode: also search light (data) preambles out of
                # session — a passive observer sees connected-mode traffic
                # it never negotiated (the reference modem cannot; its prx
                # forces connected mode for the same effect, main.cpp:221).
                sync = self._windowed_detect(self.data_wf, True)
                if sync is not None:
                    wf, light = self.data_wf, True
            if sync is None and not connected:
                # Idle stations also listen for the MFSK last-resort
                # handshake (a peer past its DPSK CONNECT budget,
                # connection.hpp:29-33) — the fallback is useless if only
                # the transmitter switches.
                sync = self._windowed_detect(self.mfsk_wf, False)
                if sync is not None:
                    wf, light = self.mfsk_wf, False
            if sync is None:
                # No sync anywhere in the *searched* audio: the region up to
                # the search cursor is noise — feed the tracked floor from a
                # window ENDING AT THE CURSOR, not the buffer end (the tail
                # can hold a partially-arrived preamble/frame deferred by
                # the trailing-margin check, which would poison the EMA and
                # bias SNR estimates low).
                from ria_tpu_torch.dsp.snr import measure_noise_floor

                mp = self._min_search_pos()
                if mp > 2048:
                    nf = measure_noise_floor(self.rx_buffer[max(0, mp - 8192):mp])
                    # Guard: a window far above the current floor is signal
                    # (e.g. an OFDM body ahead of its detected preamble), not
                    # a quieter channel — skip rather than learn it.  But a
                    # PERSISTENT high reading in idle (no-sync) windows is a
                    # genuinely risen floor, which the guard alone would
                    # reject forever (see _floor_rejects above): after 3
                    # consecutive rejections relearn from their minimum,
                    # robust to one window still holding missed signal.
                    if nf is not None and nf > 0.0:
                        if (self._noise_floor is None
                                or nf < 4.0 * self._noise_floor):
                            self._noise_floor = (nf if self._noise_floor is None
                                                 else 0.5 * self._noise_floor + 0.5 * nf)
                            self._floor_rejects.clear()
                        else:
                            self._floor_rejects.append(nf)
                            if len(self._floor_rejects) >= 3:
                                self._noise_floor = min(self._floor_rejects)
                                self._floor_rejects.clear()
                keep = 140000
                if len(self.rx_buffer) > keep and mp >= len(self.rx_buffer) - keep:
                    self._consume(len(self.rx_buffer) - keep)
                return
            self._pending = {"sync": sync, "wf": wf, "light": light,
                             "header": None, "peeked": False,
                             "ping_checked": False}
        self._process_pending(connected)

    def _min_search_pos(self) -> int:
        """Min cursor over the waveforms searched in the CURRENT poll.

        Stale cursors from waveforms no longer being searched (e.g. the
        pre-connect MFSK cursor once connected) must not pin the idle-buffer
        trim at 0 forever — only cursors that are still advancing count."""
        pos = [self._search_pos[k] for k in self._polled_keys
               if k in self._search_pos]
        return min(pos) if pos else 0

    def _windowed_detect(self, wf, light: bool):
        """Sliding fixed-size sync search with a persistent cursor.

        Fixed window shapes keep the jitted detectors at one compiled
        signature each (a growing ring buffer would otherwise recompile the
        XLA search program on every audio tick); the cursor means already-
        searched audio is never re-correlated (reference correlation_pos_,
        streaming_decoder.cpp:386-470)."""
        n = len(self.rx_buffer)
        if n <= 4000:
            return None
        key = (wf.mode, light)
        if key not in self._polled_keys:
            self._polled_keys.append(key)
        W = wf.search_window(light)
        ov = wf.search_overlap(light)
        p = max(0, min(self._search_pos.get(key, 0), n))
        ring = self._ring()
        while True:
            end = min(p + W, n)
            # The window, zero-padded to W past the ring's end, as a slice
            # of the poll's device buffer (no upload of its own).
            sync = wf.detect_sync(ring.chunk(p, W), light=light)
            if sync is not None:
                # CSS partial-view guard: a preamble cut by the window tail
                # can alias into a confident-looking wrong (shift, pos) —
                # a cyclic shift IS a wrapped time shift.  A full in-window
                # view scores ~0.97; anything weaker near the window tail
                # is checked against the next overlapping window (deep
                # buffer) or deferred until more audio arrives (buffer end).
                if (sync.get("kind") == "css" and sync["corr"] < 0.9
                        and end < n):
                    p2 = end - ov
                    s2 = wf.detect_sync(ring.chunk(p2, W), light=light)
                    if s2 is not None and s2["corr"] > sync["corr"]:
                        sync, p = s2, p2
                margin = 1024
                if sync.get("kind") == "css" and sync["corr"] < 0.9:
                    # Possible truncated preamble still arriving: wait until
                    # the buffer extends a full chirp+gap past the start.
                    margin = 30000
                start = sync["start"] + p
                # A content start within the trailing margin may come from a
                # preamble truncated by the buffer end — its timing can be
                # early/late.  Leave the cursor and re-detect next tick with
                # the preamble fully buffered.
                if start <= n - margin:
                    sync["start"] = start
                    return sync
                return None
            if end >= n:
                self._search_pos[key] = max(p, n - ov)
                return None
            p = end - ov

    def _process_pending(self, connected: bool):
        """SYNC_FOUND -> (wait for samples) -> DECODING (reference
        checkIfReadyToDecode + decodeCurrentFrame).  The CW0 header peek
        runs once per sync; the full decode runs once, only when the whole
        frame (by peeked total_cw, or the waveform's fallback bound) is
        buffered — never on zero-padded partial audio."""
        pend = self._pending
        sync, wf, light = pend["sync"], pend["wf"], pend["light"]
        start = sync["start"]
        n = len(self.rx_buffer)

        # Burst accumulation (reference BURST_ACCUMULATING,
        # streaming_decoder.cpp:3065): a 3-LTS light preamble HINTS at a
        # burst-interleaved group of fixed frames under one preamble.  The
        # repeat count is a hint only — a single frame's first data symbol
        # can correlate like a 3rd LTS (a reference peer's standard light
        # preamble measured repeats=3 in the round-3 judge's interop
        # probe), so the DETERMINISTIC discriminator runs first: attempt
        # the single-frame decode at this sync and let the frame CRC
        # arbitrate.  A real burst's striped stream cannot produce a
        # CRC-valid single-frame decode (16-bit frame CRC + header CRC),
        # so singles — including reference peers' frames — never mis-route,
        # at the cost of one wasted 4-CW decode per genuine burst.
        if (light and sync.get("kind") == "lts"
                and sync.get("lts_repeats", 2) >= 3
                and self.conn.link.burst_group >= 2 and hasattr(wf, "rx_burst")):
            group = self.conn.link.burst_group
            if not pend.get("burst_single_ruled_out"):
                if start + self._frame_body_samples(wf, 4) > n:
                    return  # wait for the single-frame span first
                if self._noise_floor is not None:
                    wf._noise_floor = self._noise_floor
                rx = wf._rx_at(self._ring(), start, sync["cfo_hz"],
                               chase=self.chase)
                if rx.ok:
                    ncw = (1 if rx.header["is_control"]
                           else max(1, int(rx.header["total_cw"])))
                    self._consume(start + self._frame_body_samples(
                        wf, ncw, rx.header["is_control"]))
                    self.stats.frames_rx += 1
                    self.conn.measured_snr_db = rx.snr_db
                    self.conn.on_frame_received(rx.frame_bytes)
                    self._feed_link_adapter(rx)
                    return
                pend["burst_single_ruled_out"] = True
            if start + wf.burst_samples(group) > n:
                return  # wait for the whole burst span
            if self._noise_floor is not None:
                wf._noise_floor = self._noise_floor
            # Decode from a buffer snapshot and defer consumption until we
            # know whether this was a real burst: trimming first would leave
            # `start` indexing past the frame for the false-positive
            # fallback below, and over-consume into the next preamble.
            res = wf.rx_burst(self._ring(), group, sync=sync)
            if res is None:
                self.stats.decode_failures += 1
                self._note_data_failure()
                self._consume(start + wf.burst_samples(group))
                return
            frames, snr, fading = res
            nf = getattr(wf, "_noise_floor", None)
            if nf is not None and nf > 0.0:
                self._noise_floor = nf
            any_ok = False
            delivered = []
            n_fail = 0
            for okf, fb in frames:
                if okf and fb is not None:
                    if not any_ok:
                        self.stats.bursts_rx += 1
                    any_ok = True
                    delivered.append(fb)
                else:
                    self.stats.decode_failures += 1
                    n_fail += 1
            # Mode-envelope feedback: a burst losing a third or more of
            # its frames is a failing mode even though SOME frames land.
            if n_fail * 3 >= len(frames):
                self._note_data_failure()
            elif n_fail == 0 and delivered:
                self._consec_data_failures = 0
            if any_ok:
                # Receiving a burst proves the peer speaks the burst
                # extension — the responder may now burst-TX too (see
                # LinkMode.burst_tx_confirmed interop note).
                self.conn.link.burst_tx_confirmed = True
                self._consume(start + wf.burst_samples(group))
                for fb in delivered:
                    self.stats.frames_rx += 1
                    self.conn.measured_snr_db = snr
                    self.conn.on_frame_received(fb)
                # Burst deliveries feed the in-session link adapter —
                # without this a bulk transfer running entirely in bursts
                # never upgrades its code rate.  ONE feed per burst: all
                # frames of a burst share a single channel measurement, and
                # feeding it group-size times collapses the adapter's
                # averaging window into 1-2 independent samples (measured:
                # an instantaneous fading dip to 0.13 on a Good-class
                # channel read as stable AWGN and negotiated QAM16, which
                # then failed 9/10 frames there).
                from types import SimpleNamespace

                self.conn.measured_fading = fading
                self._feed_link_adapter(
                    SimpleNamespace(snr_db=snr, fading_index=fading))
                return
            # Both hypotheses failed (the single-frame decode was already
            # ruled out above): a faded burst — consume its span.
            self.stats.decode_failures += 1
            self._consume(start + wf.burst_samples(group))
            return

        # PING/PONG discrimination on acquisition-preamble signals (once).
        # With CSS preambles the frame type arrives in the chirp's cyclic
        # shift (reference css_sync.hpp): non-PING shifts skip the check
        # entirely; a PING shift still verifies the raw magic bits.
        if (sync["kind"] in ("chirp", "css") and isinstance(wf, MCDPSKWaveform)
                and not pend["ping_checked"]):
            if sync["kind"] == "css":
                from ria_tpu_torch.sync.css import CSS_PING

                if sync.get("css_type") != CSS_PING:
                    pend["ping_checked"] = True
            cfg = wf.cfg
            # Span to wait for / consume: bare-preamble pings (round-4
            # wire format) need only training + ref + the 3-symbol post
            # window _try_ping inspects; the consumed span stays at the
            # training+ref block so a legacy magic tail is just skipped
            # as noise by the next search.
            ping_need = (cfg.training_symbols + 1 + 3) * cfg.samples_per_symbol
            if not pend["ping_checked"]:
                if start + ping_need > n:
                    return  # wait for more audio
                pend["ping_checked"] = True
                if self._try_ping(start, sync["cfo_hz"]):
                    self.stats.pings_rx += 1
                    self._consume(start + ping_need)
                    if self.conn.state == ConnectionState.PROBING:
                        self.conn.notify_pong_received()
                    else:
                        self.conn.notify_ping_received()
                    return

        # Wait until the buffer can hold the CW0 peek span.
        if start + self._frame_body_samples(wf, 1, control=True) > n:
            return
        if not pend["peeked"]:
            header = wf.peek_header(self._ring(), start, sync["cfo_hz"], light)
            if header is None and wf.header_required:
                # Variable-CW waveforms carry the frame length in CW0: with
                # no decodable header the frame cannot be sized or parsed,
                # so waiting buys nothing.  Probe the reference's recovery
                # offsets with cheap plain-BP peeks (timing rescue), then
                # give up on this sync fast — the old behavior waited for a
                # worst-case 8-CW span (~44 s of audio at MC-DPSK R1/4,
                # longer than the ring buffer) and stalled the decoder.
                for off in (-8, 8, -16, 16, -24, 24, -32, 32):
                    h2 = wf.peek_header(self._ring(), max(start + off, 0),
                                        sync["cfo_hz"], light)
                    if h2 is not None:
                        start = max(start + off, 0)
                        sync["start"] = start
                        header = h2
                        self.stats.sync_recoveries[off] = \
                            self.stats.sync_recoveries.get(off, 0) + 1
                        break
            pend["header"] = header
            pend["peeked"] = True
        header = pend["header"]
        if header is None and wf.header_required:
            # 4x-spread beacon hypothesis (reference beacons broadcast as
            # spread MC-DPSK): a beacon's CW0 never decodes under the
            # spread-1 profile, so peek with the spread-4 profile before
            # giving up on a chirp sync.
            # Spread-4 hypothesis applies to beacons AND to handshake
            # escalation frames — the latter can arrive while CONNECTED
            # (a duplicate CONNECT retried spread-4 after our ACK faded).
            if (sync["kind"] in ("chirp", "css")
                    and isinstance(wf, MCDPSKWaveform) and wf.cfg.spreading == 1
                    and not pend.get("beacon_ruled_out")):
                hyps = pend.get("bwfs")
                if hyps is None:
                    # Session geometry first (spread-4 CONNECT escalation),
                    # then the fixed 10-carrier broadcast beacon geometry.
                    hyps = [MCDPSKWaveform(num_carriers=self.mc_carriers,
                                           modulation="DBPSK", rate="R1_4",
                                           spreading=4, use_css=self.use_css,
                                           device=self.device)]
                    if self.mc_carriers != 10:
                        hyps.append(MCDPSKWaveform(modulation="DBPSK",
                                                   rate="R1_4", spreading=4,
                                                   device=self.device))
                    pend["bwfs"] = hyps
                if start + max(self._frame_body_samples(h, 1) for h in hyps) > n:
                    return  # wait for the spread CW0 span
                for bwf in hyps:
                    if self._noise_floor is not None:
                        bwf._noise_floor = self._noise_floor
                    b_hdr = bwf.peek_header(self._ring(), start, sync["cfo_hz"])
                    if b_hdr is not None:
                        pend["wf"] = wf = bwf
                        pend["light"] = light = False
                        pend["header"] = header = b_hdr
                        break
                else:
                    pend["beacon_ruled_out"] = True
            # MC-profile transition dual-RX (see _arm_mc_profile): a
            # ZC-synced frame that fails the current profile may be on
            # the other side of an in-flight MC_PROFILE switch.
            if (header is None and sync["kind"] == "zc"
                    and self._mc_alt_wf is not None
                    and isinstance(wf, MCDPSKWaveform)
                    and not pend.get("alt_ruled_out")):
                alt = self._mc_alt_wf
                if start + self._frame_body_samples(alt, 1) > n:
                    return  # wait for the alternate profile's CW0 span
                if self._noise_floor is not None:
                    alt._noise_floor = self._noise_floor
                a_hdr = alt.peek_header(self._ring(), start,
                                        sync["cfo_hz"], light)
                if a_hdr is not None:
                    if self._mc_alt_is_new:
                        self._promote_mc_profile()
                    pend["wf"] = wf = alt
                    pend["header"] = header = a_hdr
                else:
                    pend["alt_ruled_out"] = True
            if header is None:
                # Deferred PING ruling: a chirp sync whose header never
                # decodes and whose post-training energy is noise-like is
                # a PING in a deep fade (the fast path's 0.3 gate missed
                # it) — the strongest discriminator available at the floor
                # is the LDPC decode itself failing.
                if sync["kind"] in ("chirp", "css") \
                        and isinstance(wf, MCDPSKWaveform):
                    ratio = self._ping_ratio(start)
                    if ratio is not None and ratio < self.PING_WEAK_RATIO:
                        self.stats.pings_rx += 1
                        cfgh = self.handshake_wf.cfg
                        self._consume(start + (cfgh.training_symbols + 4)
                                      * cfgh.samples_per_symbol)
                        if self.conn.state == ConnectionState.PROBING:
                            self.conn.notify_pong_received()
                        else:
                            self.conn.notify_ping_received()
                        return
                self.stats.decode_failures += 1
                self.stats.sync_skips += 1
                self._consume(start + self._frame_body_samples(wf, 1))
                return
        control = bool(header and header["is_control"])
        if header is not None:
            ncw = 1 if control else max(1, int(header["total_cw"]))
        else:
            ncw = wf.fallback_cw
        if start + self._frame_body_samples(wf, ncw, control) > n:
            return  # wait for the exact frame length

        import time as _time

        # Hand the station's tracked floor to the waveform's SNR estimator
        # (and absorb any fresher gap measurement back after the decode).
        if self._noise_floor is not None:
            wf._noise_floor = self._noise_floor
        t0 = _time.perf_counter()
        rx = wf.rx_frame(self._ring(), light=light, chase=self.chase, sync=sync)
        dt_ms = (_time.perf_counter() - t0) * 1e3
        self.stats.decode_time_ms_avg = (0.9 * self.stats.decode_time_ms_avg
                                         + 0.1 * dt_ms)
        if not rx.ok and rx.header is None and hasattr(wf, "_rx_at"):
            # Sync-recovery re-decode at shifted offsets (reference
            # streaming_decoder retries +-8/16/24/32; stats histogram at
            # streaming_decoder.hpp:95-105).  Only when even the header
            # failed — a decoded header means timing was right.
            # Cost control: probe each offset with the cheap plain-BP
            # header peek first; the expensive retry-ladder decode runs
            # only at an offset whose header parses.  Data-frame timing
            # errors (invisible to the control peek) get two full attempts
            # at the nearest offsets.
            recovered = False
            for off in (-8, 8, -16, 16, -24, 24, -32, 32):
                if wf.peek_header(self._ring(), max(start + off, 0),
                                  sync["cfo_hz"], light) is None:
                    continue
                r2 = wf._rx_at(self._ring(), max(start + off, 0), sync["cfo_hz"])
                if r2.ok:
                    rx, recovered = r2, True
                    self.stats.sync_recoveries[off] = \
                        self.stats.sync_recoveries.get(off, 0) + 1
                    break
            if not recovered:
                for off in (-8, 8):
                    r2 = wf._rx_at(self._ring(), max(start + off, 0), sync["cfo_hz"])
                    if r2.ok:
                        rx = r2
                        self.stats.sync_recoveries[off] = \
                            self.stats.sync_recoveries.get(off, 0) + 1
                        break
        nf = getattr(wf, "_noise_floor", None)
        if nf is not None and nf > 0.0:
            self._noise_floor = nf
        if rx.ok:
            self._consec_data_failures = 0
            if (self._mc_alt_wf is not None and not self._mc_alt_is_new
                    and wf is self.data_wf and isinstance(wf, MCDPSKWaveform)):
                # Proposer side: a frame decoded under the NEW (primary)
                # profile — the peer demonstrably switched; drop the old-
                # profile hypothesis.
                self._mc_alt_wf = None
            if not connected and self._is_connect_for_me(rx.header):
                # Remember which waveform carried the peer's CONNECT so the
                # replies ride the same one (MFSK / spread-4 reciprocity).
                # Gated on a CONNECT-family frame addressed to THIS station:
                # an overheard 4x-spread BEACON or third-party handshake
                # must not escalate our own future handshakes (~4x air time
                # / ~28 s MFSK frames) on a clean channel.
                from ria_tpu_torch.wave.api import MFSKWaveform

                self._respond_mfsk = isinstance(wf, MFSKWaveform)
                self._respond_spread4 = (isinstance(wf, MCDPSKWaveform)
                                         and wf.cfg.spreading == 4)
                self._respond_set_ms = self._now_ms
            ncw = 1 if rx.header["is_control"] else max(1, rx.header["total_cw"])
            self._consume(rx.start_sample + self._frame_body_samples(wf, ncw, rx.header["is_control"]))
            self.stats.frames_rx += 1
            self.conn.measured_snr_db = rx.snr_db
            self.conn.measured_fading = rx.fading_index
            if getattr(rx, "delay_spread_ms", -1.0) >= 0.0:
                self.conn.measured_delay_ms = rx.delay_spread_ms
                self.conn.measured_doppler_hz = rx.doppler_spread_hz
            self.conn.on_frame_received(rx.frame_bytes)
            self._feed_link_adapter(rx)
            if self.on_rx_frame is not None:
                self.on_rx_frame(rx)
            return

        # Failed decode with the whole frame span present: the decode is
        # deterministic on a complete span, so fail once and skip (the old
        # two-strike retry re-ran an identical multi-second decode).
        self.stats.decode_failures += 1
        self.stats.sync_skips += 1
        # Opportunistic-mode failure fallback (see _note_data_failure).
        if connected:
            self._note_data_failure()
        # Partial data frame with a decoded header: request a retransmit
        # with the per-CW failure bitmap (NACK), which feeds chase
        # combining on the next reception.
        if (connected and rx.header is not None
                and not rx.header["is_control"] and rx.cw_ok is not None):
            from ria_tpu_torch.phy.frame_v2 import ControlFrame

            bitmap = 0
            for i, okcw in enumerate(np.asarray(rx.cw_ok)):
                if not okcw and i < 32:
                    bitmap |= 1 << i
            nack = ControlFrame.make_nack(self.callsign, rx.header["src_hash"],
                                          rx.header["seq"], bitmap)
            self._on_conn_transmit(nack.serialize(), handshake=False)
        self._consume(start + self._frame_body_samples(wf, ncw, control))

    def _note_data_failure(self):
        """Failure-streak mode fallback: a streak of failed data decodes
        while CONNECTED means the channel left the mode's envelope (e.g.
        fading developed under a D8PSK/QAM link, whose upgrades are
        AWGN-gated by measurement and cannot re-trigger the adapter
        because failures never feed it).  Step down to the robust DQPSK
        ladder 3 dB below the last known SNR.  Fed by both the single-
        frame failure tail AND the burst path — bulk transfers running
        entirely in bursts previously never triggered the fallback and
        ground through retransmit storms at ~0.4 kbps (measured, QAM16
        R2/3 on Good 20 dB)."""
        self._consec_data_failures += 1
        link = self.conn.link
        if (self._consec_data_failures >= 3
                and link.waveform in (WaveformMode.OFDM_CHIRP,
                                      WaveformMode.OFDM_COX)
                and link.modulation != "DQPSK"
                and not self.conn.config.forced_modulation):
            from ria_tpu_torch.wave.selection import select_ofdm_code_rate

            snr = self.conn.measured_snr_db - 3.0
            self.conn.request_mode_change(
                "DQPSK", select_ofdm_code_rate(snr, 0.5), reason=1)
            self._consec_data_failures = 0

    def _is_connect_for_me(self, header: dict | None) -> bool:
        """True when header is a CONNECT/CONNECT_ACK addressed to us."""
        if header is None:
            return False
        from ria_tpu_torch.phy.frame_v2 import FrameType, hash_callsign

        if header.get("type") not in (FrameType.CONNECT, FrameType.CONNECT_ACK):
            return False
        return header.get("dst_hash") == hash_callsign(self.callsign)

    @staticmethod
    def _frame_body_samples(wf, ncw: int, control: bool = False) -> int:
        """Samples from sync start (content start) to frame end."""
        if isinstance(wf, MCDPSKWaveform):
            cfg = wf.cfg
            n_sym = cfg.num_data_symbols(ncw * 648)
            return (cfg.training_symbols + 1 + n_sym * cfg.spreading) * cfg.samples_per_symbol
        from ria_tpu_torch.wave.api import MFSKWaveform, OTFSWaveform

        if isinstance(wf, OTFSWaveform):
            # sync start = first OTFS frame (after the ZC acquisition
            # preamble); each frame carries its own channel-est preamble.
            K = wf._frames_for_bits(ncw * 648)
            return K * (wf.cfg.preamble_samples + wf.cfg.frame_samples)
        if isinstance(wf, MFSKWaveform):
            return wf.cfg.num_symbols_for_bits(ncw * 648) * \
                wf.cfg.repetition * wf.cfg.samples_per_symbol
        cfg = wf.ctrl_cfg if control else wf.cfg
        S = cfg.num_symbols_for_bits((1 if control else 4) * 648)
        return (2 + S) * cfg.symbol_samples

    # ------------------------------------------------------------------ tick
    def _feed_link_adapter(self, rx):
        """In-session link adaptation (App::updateAdaptiveAdvisory parity,
        src/gui/app.cpp:1914-2010): feed every decoded frame's measured
        (SNR, fading) while CONNECTED; on a confirmed recommendation send
        a MODE_CHANGE unless the user forced a modulation."""
        if (self.conn.state != ConnectionState.CONNECTED
                or self.conn.config.forced_modulation):
            return
        link = self.conn.link
        if link.waveform == WaveformMode.MC_DPSK:
            self._feed_mc_profile(rx, link)
            return
        decision = self.link_adapter.feed(rx.snr_db, rx.fading_index,
                                          self._now_ms, link.waveform,
                                          link.modulation, link.rate)
        if decision is None:
            return
        (mod, rate, spreading), is_upgrade, avg_snr, avg_fading = decision
        reason = 0 if is_upgrade else 1  # CHANNEL_IMPROVED / CHANNEL_DEGRADED
        self.conn.request_mode_change(mod, rate, reason=reason)

    def _feed_mc_profile(self, rx, link):
        """MC-DPSK link adaptation: the generic adapter's table pins the
        reference's 10-carrier R1/4 profile, so MC-DPSK links run their own
        ladder here — the ACK-gated MC_PROFILE upgrade when the measured
        SNR supports it (recommend_mc_profile), the standard MODE_CHANGE
        path (which also resets carriers to 10) when it no longer does."""
        from ria_tpu_torch.wave.selection import recommend_data_mode, recommend_mc_profile

        for win, v in ((self._mc_snr_win, rx.snr_db),
                       (self._mc_fading_win, rx.fading_index)):
            win.append(float(v))
            if len(win) > 5:
                win.pop(0)
        snr_med = float(np.median(self._mc_snr_win))
        fading_med = float(np.median(self._mc_fading_win))
        want = recommend_mc_profile(snr_med, fading_med)
        cur = (link.mc_carriers, link.modulation, link.rate)
        if want == cur:
            self._mc_want, self._mc_want_hits = None, 0
            return
        if want == self._mc_want:
            self._mc_want_hits += 1
        else:
            self._mc_want, self._mc_want_hits = want, 1
        if want is None:
            # Channel degraded below the upgrade band: fall back fast to
            # the standard ladder (2-frame confirmation, like the generic
            # adapter's downgrade path).  2 dB hysteresis: a profile that
            # just engaged at its threshold must not flap back on the
            # ~0.3 dB measurement bias of the spectral SNR estimate.
            if (link.mc_carriers > 10 and self._mc_want_hits >= 2
                    and recommend_mc_profile(snr_med + 2.0, fading_med) is None):
                mod, rate, spread = recommend_data_mode(snr_med,
                                                        WaveformMode.MC_DPSK,
                                                        fading_med)
                if self.conn.request_mode_change(mod, rate, reason=1):
                    # The peer applies on receipt and its ACK rides the
                    # NEW standard profile — arm it as the alternate RX
                    # hypothesis so the ACK (and any data the peer sends
                    # before our own ack-gated switch) still decodes.
                    self._mc_alt_wf = MCDPSKWaveform(
                        num_carriers=10, modulation=mod, rate=rate,
                        spreading=spread, device=self.device)
                    self._mc_alt_is_new = False
                    self._mc_alt_deadline = self._now_ms + 30_000
                self._mc_want, self._mc_want_hits = None, 0
            return
        if self._mc_want_hits >= 4:
            self.conn.request_mc_profile(*want)
            self._mc_want, self._mc_want_hits = None, 0

    def _now_s(self) -> float:
        """The protocol's time in seconds: the sum of ``tick``'s elapsed ms."""
        return self._now_ms / 1000.0

    def tick(self, elapsed_ms: int, poll: bool = True):
        """Advance protocol timers; optionally attempt a decode pass.

        `poll=False` lets a caller delay decode passes while audio keeps
        arriving (cli_simulator --decode-delay-blocks stress knob, the
        analogue of the reference's --decode-delay-ms: decode falls behind
        the audio thread and must catch up from a deep ring buffer)."""
        self._now_ms += elapsed_ms
        if poll:
            self.poll()
        self.conn.tick(elapsed_ms)
        if self._burst_buf:
            # Frames the ARQ window released this tick that did not fill a
            # group ride normal light preambles, preserving order.
            self._flush_burst()
        # Reciprocity-flag hygiene: clear on session end (the peer that
        # escalated is gone) and after a 60 s TTL when the handshake that set
        # them never completed — a stale flag would otherwise escalate every
        # future handshake to spread-4/MFSK air time forever.
        state = self.conn.state
        if self._mc_alt_wf is not None and (
                self._now_ms > self._mc_alt_deadline
                or state == ConnectionState.DISCONNECTED):
            self._mc_alt_wf = None
            self._mc_alt_is_new = False
        if self._respond_mfsk or self._respond_spread4:
            ended = (state == ConnectionState.DISCONNECTED
                     and self._prev_conn_state != ConnectionState.DISCONNECTED)
            stale = (state == ConnectionState.DISCONNECTED
                     and self._now_ms - self._respond_set_ms > 60_000)
            if ended or stale:
                self._respond_mfsk = False
                self._respond_spread4 = False
        self._prev_conn_state = state
