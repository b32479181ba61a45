"""CAT / PTT rig control.

Host copy of ``ria_tpu/runtime/cat.py`` (it imports nothing of either
package).

Mirrors the reference (src/cat/): CatController with PTT lead/tail timing
and a TX watchdog, over pluggable backends:

- NullBackend: no-op (VOX or simulation);
- SerialBackend: DTR/RTS keying via pyserial (gated import);
- HamlibBackend: `rigctl` subprocess (200+ rigs, gated on binary presence);
- KenwoodTCPBackend: Kenwood CAT protocol over TCP (FlexRadio et al.).

Timing is virtual-ms driven (tick) like the rest of the runtime so it is
simulation-friendly; wall-clock use just ticks with real elapsed time.
"""

from __future__ import annotations

import socket
import subprocess
from typing import Optional

TX_WATCHDOG_MS = 120_000  # reference cat_controller.hpp TX watchdog


class CatBackend:
    def set_ptt(self, on: bool) -> bool:
        raise NotImplementedError

    def close(self):
        pass


class NullBackend(CatBackend):
    def __init__(self):
        self.ptt = False

    def set_ptt(self, on: bool) -> bool:
        self.ptt = on
        return True


class SerialBackend(CatBackend):  # pragma: no cover - needs hardware
    def __init__(self, port: str, use_rts: bool = False):
        try:
            import serial
        except ImportError as e:
            raise RuntimeError("pyserial not installed") from e
        self.ser = serial.Serial(port)
        self.use_rts = use_rts

    def set_ptt(self, on: bool) -> bool:
        if self.use_rts:
            self.ser.rts = on
        else:
            self.ser.dtr = on
        return True

    def close(self):
        self.ser.close()


class HamlibBackend(CatBackend):  # pragma: no cover - needs rigctl
    def __init__(self, model: int = 1, device: str = "/dev/ttyUSB0"):
        self.model = model
        self.device = device

    def set_ptt(self, on: bool) -> bool:
        r = subprocess.run(["rigctl", "-m", str(self.model), "-r", self.device,
                            "T", "1" if on else "0"], capture_output=True)
        return r.returncode == 0


class KenwoodTCPBackend(CatBackend):  # pragma: no cover - needs radio
    def __init__(self, host: str, port: int = 4532):
        self.sock = socket.create_connection((host, port), timeout=5)

    def set_ptt(self, on: bool) -> bool:
        cmd = b"TX;" if on else b"RX;"
        self.sock.sendall(cmd)
        return True

    def close(self):
        self.sock.close()


class CatController:
    """PTT sequencing: lead delay before TX audio, tail delay after, and a
    watchdog that force-releases a stuck PTT (cat_controller.hpp:14-60)."""

    def __init__(self, backend: Optional[CatBackend] = None,
                 ptt_lead_ms: int = 100, ptt_tail_ms: int = 50):
        self.backend = backend or NullBackend()
        self.ptt_lead_ms = ptt_lead_ms
        self.ptt_tail_ms = ptt_tail_ms
        self.ptt = False
        self._lead_left = 0
        self._tail_left = 0
        self._tx_time_ms = 0

    @property
    def tx_ready(self) -> bool:
        """True when PTT is keyed and the lead delay has elapsed."""
        return self.ptt and self._lead_left <= 0

    def request_tx(self):
        if not self.ptt:
            self.backend.set_ptt(True)
            self.ptt = True
            self._lead_left = self.ptt_lead_ms
            self._tx_time_ms = 0
        self._tail_left = self.ptt_tail_ms

    def tx_done(self):
        self._tail_left = self.ptt_tail_ms

    def tick(self, elapsed_ms: int, tx_active: bool):
        if not self.ptt:
            return
        self._tx_time_ms += elapsed_ms
        if self._lead_left > 0:
            self._lead_left -= elapsed_ms
            return
        if tx_active:
            self._tail_left = self.ptt_tail_ms
        else:
            self._tail_left -= elapsed_ms
            if self._tail_left <= 0:
                self._release()
        if self._tx_time_ms >= TX_WATCHDOG_MS:
            self._release()  # watchdog: never stay keyed forever

    def _release(self):
        self.backend.set_ptt(False)
        self.ptt = False
        self._tx_time_ms = 0
