"""Named spans of the port's work: one host-clock interval each, kept in a
ring, and a ``record_function`` range as well while a profiler runs.

    from ria_tpu_torch.utils.trace import span

    with span("rx.sync"):
        ...

With no torch profiler running, a span takes two timestamps and appends
``(begin_ns, end_ns)`` to the ring of its name: the last :data:`RING`
occurrences and a running count.  That is all it does, so it costs a few
tenths of a microsecond and can sit on the served path.  While a profiler
runs it also enters ``torch.profiler.record_function(name)``, so a trace
holds the span's host range and its device-side range.  A profiler ties each
kernel to the innermost span open at its launch, and a device-side range
runs from the first to the last kernel tied to its span: a span with spans
inside it covers its whole work on the device only if it launches kernels
of its own before and after them (``rx.sync`` around ``sync.coarse`` and
``sync.fine``).

Timestamps are ``time.time_ns()``: nanoseconds since the Unix epoch, the
clock of the profiler's own events (``_KinetoEvent.start_ns()``), so a
ring's intervals can be laid over a trace's device work.

Spans may be opened from several threads at once (each station of
``sim/continuous.py`` decodes on a thread of its own); every append is
kept.  :func:`intervals` and :func:`count` read a name's ring,
:func:`names` the names seen, :func:`reset` clears them all.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque

import torch.autograd.profiler as _profiler

RING = 1024   # occurrences a name keeps

_now = time.time_ns


class _Ring:
    """A name's last :data:`RING` ``(begin_ns, end_ns, seq)``: ``seq`` numbers
    the occurrences from 0 as they close.  A deque's append and a counter's
    ``next`` each hold the GIL throughout, so threads need no lock here, and
    the highest ``seq`` kept is the count less one."""

    __slots__ = ("times", "seq")

    def __init__(self):
        self.times: deque[tuple[int, int, int]] = deque(maxlen=RING)
        self.seq = itertools.count()


_rings: dict[str, _Ring] = {}
_rings_lock = threading.Lock()


def _ring(name: str) -> _Ring:
    with _rings_lock:
        return _rings.setdefault(name, _Ring())


class span:
    """Context manager: the time spent inside it, under ``name``."""

    __slots__ = ("name", "rf", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        # A torch without the flag keeps the ranges: better a costly span
        # than a trace without it.
        if getattr(_profiler, "_is_profiler_enabled", True):
            self.rf = _profiler.record_function(self.name)
            self.rf.__enter__()
        else:
            self.rf = None
        self.t0 = _now()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = _now()
        if self.rf is not None:
            self.rf.__exit__(exc_type, exc, tb)
        try:
            ring = _rings[self.name]
        except KeyError:
            ring = _ring(self.name)
        ring.times.append((self.t0, t1, next(ring.seq)))


def intervals(name: str) -> list[tuple[int, int]]:
    """The last :data:`RING` ``(begin_ns, end_ns)`` of ``name`` in the order
    they closed; empty for a name never closed."""
    ring = _rings.get(name)
    return [] if ring is None else [(b, e) for b, e, _ in list(ring.times)]


def count(name: str) -> int:
    """How many times ``name`` has closed since the last :func:`reset`."""
    ring = _rings.get(name)
    times = [] if ring is None else list(ring.times)
    return max((n for _, _, n in times), default=-1) + 1


def names() -> list[str]:
    """Every name with a record, sorted."""
    return sorted(_rings)


def reset() -> None:
    """Forget every record."""
    with _rings_lock:
        _rings.clear()
