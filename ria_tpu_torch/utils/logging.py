"""Leveled, categorized logging (reference include/ultra/logging.hpp).

Host copy of ``ria_tpu/utils/logging.py``, its imports pointed at the port.

Categories DEMOD/MODEM/LDPC/SYNC/CHAN/PROTO, relative-ms timestamps,
per-thread station tag for dual-modem logs, runtime level and file control.
Thin wrapper over the stdlib logging module with the reference's surface.
"""

from __future__ import annotations

import logging
import threading
import time

CATEGORIES = ("DEMOD", "MODEM", "LDPC", "SYNC", "CHAN", "PROTO", "ARQ", "IFACE")

_t0 = time.monotonic()
_tls = threading.local()
_level = logging.WARNING
_loggers: dict[str, logging.Logger] = {}


class _RelativeMsFormatter(logging.Formatter):
    def format(self, record):
        ms = (time.monotonic() - _t0) * 1000.0
        tag = getattr(_tls, "station", "")
        prefix = f"[{ms:10.1f}ms]"
        if tag:
            prefix += f"[{tag}]"
        record.msg = f"{prefix}[{record.name}] {record.msg}"
        return super().format(record)


def set_station_tag(tag: str):
    """Thread-local station tag (ALPHA/BRAVO in dual-modem runs)."""
    _tls.station = tag


def set_level(level: int | str):
    global _level
    _level = logging.getLevelName(level) if isinstance(level, str) else level
    for lg in _loggers.values():
        lg.setLevel(_level)


def set_log_file(path: str | None):
    handler = logging.FileHandler(path) if path else logging.StreamHandler()
    handler.setFormatter(_RelativeMsFormatter())
    for lg in _loggers.values():
        lg.handlers = [handler]


def get_logger(category: str) -> logging.Logger:
    if category not in _loggers:
        lg = logging.getLogger(f"ria.{category}")
        lg.setLevel(_level)
        if not lg.handlers:
            h = logging.StreamHandler()
            h.setFormatter(_RelativeMsFormatter())
            lg.addHandler(h)
        lg.propagate = False
        _loggers[category] = lg
    return _loggers[category]


def log(category: str, level: int, msg: str, *args):
    get_logger(category).log(level, msg, *args)
