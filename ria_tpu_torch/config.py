"""Modem configuration: presets and persisted settings.

Host copy of ``ria_tpu/config.py``; a preset's OFDM profile is the port's
``wave/ofdm.py::OFDMConfig``.

Three config layers, mirroring the reference
(docs/CONFIGURATION_SYSTEM.md:9-14):
1. AppSettings: INI-persisted user prefs incl. expert forced waveform/
   modulation/rate;
2. ModemPreset: runtime DSP profiles (include/ultra/types.hpp:316-413) —
   conservative / balanced / turbo / high_throughput / high_speed /
   maximum_speed;
3. negotiated per-connection link mode (protocol state, see
   ria_tpu_torch.protocol.connection.LinkMode).
"""

from __future__ import annotations

import configparser
import pathlib
from dataclasses import dataclass, field, asdict

from ria_tpu_torch.wave.ofdm import OFDMConfig


@dataclass(frozen=True)
class ModemPreset:
    name: str
    cp_len: int
    symbol_guard: int
    use_pilots: bool
    pilot_spacing: int
    modulation: str
    code_rate: str

    def ofdm_config(self) -> OFDMConfig:
        return OFDMConfig(cp_len=self.cp_len, symbol_guard=self.symbol_guard,
                          use_pilots=self.use_pilots, pilot_spacing=self.pilot_spacing,
                          modulation=self.modulation)


# CP scales with FFT size: base {SHORT:32, MEDIUM:48, LONG:64} x (1024/512)
# (types.hpp:252-262).
_CP_SHORT, _CP_MEDIUM, _CP_LONG = 64, 96, 128

PRESETS: dict[str, ModemPreset] = {
    "conservative": ModemPreset("conservative", _CP_LONG, 8, True, 2, "QPSK", "R1_2"),
    "balanced": ModemPreset("balanced", _CP_MEDIUM, 0, False, 2, "DQPSK", "R1_2"),
    "turbo": ModemPreset("turbo", _CP_SHORT, 0, True, 2, "QAM256", "R5_6"),
    "high_throughput": ModemPreset("high_throughput", _CP_MEDIUM, 0, True, 4, "QAM16", "R2_3"),
    "high_speed": ModemPreset("high_speed", _CP_MEDIUM, 0, False, 2, "DQPSK", "R3_4"),
    "maximum_speed": ModemPreset("maximum_speed", _CP_SHORT, 0, True, 6, "QAM64", "R5_6"),
}


@dataclass
class AppSettings:
    """INI-persisted user preferences (docs/CONFIGURATION_SYSTEM.md:20-32)."""

    mycall: str = ""
    auto_accept: bool = True
    compression: bool = True
    encryption_key: str = ""
    preset: str = "balanced"
    forced_waveform: str = "AUTO"
    forced_modulation: str = "AUTO"
    forced_rate: str = "AUTO"
    ptt_lead_ms: int = 100
    ptt_tail_ms: int = 50
    tx_drive: float = 1.0

    def save(self, path: str | pathlib.Path):
        cp = configparser.ConfigParser()
        cp["ria"] = {k: str(v) for k, v in asdict(self).items()}
        with open(path, "w") as f:
            cp.write(f)

    @classmethod
    def load(cls, path: str | pathlib.Path) -> "AppSettings":
        cp = configparser.ConfigParser()
        cp.read(path)
        s = cls()
        if "ria" not in cp:
            return s
        sec = cp["ria"]
        s.mycall = sec.get("mycall", s.mycall)
        s.auto_accept = sec.getboolean("auto_accept", s.auto_accept)
        s.compression = sec.getboolean("compression", s.compression)
        s.encryption_key = sec.get("encryption_key", s.encryption_key)
        s.preset = sec.get("preset", s.preset)
        s.forced_waveform = sec.get("forced_waveform", s.forced_waveform)
        s.forced_modulation = sec.get("forced_modulation", s.forced_modulation)
        s.forced_rate = sec.get("forced_rate", s.forced_rate)
        s.ptt_lead_ms = sec.getint("ptt_lead_ms", s.ptt_lead_ms)
        s.ptt_tail_ms = sec.getint("ptt_tail_ms", s.ptt_tail_ms)
        s.tx_drive = sec.getfloat("tx_drive", s.tx_drive)
        return s
