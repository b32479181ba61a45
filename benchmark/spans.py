"""The port's own spans (``ria_tpu_torch/utils/trace.py``) as the per-layer
readers take them.

Each span keeps the host-clock interval of its last 1,024 occurrences in a
ring.  The readers of a ``--trace 1`` run run after its untraced window,
and nothing of the port runs after that window, so a ring ends on the
window's calls: the host's time at the served pace, which neither traced
stretch shows (CUPTI slows every launch; the second stretch profiles every
host operator).

A program without the module (one older than its spans) reads nothing, and
so does a run whose trace holds no device work (the CPU tests' runs: there
a span's host time is its computation, not dispatch beside a card).
"""

from __future__ import annotations

import statistics


def _rings(trace):
    """The port's span module, or None where the run has no card or the
    program has no spans."""
    if not trace.ops:
        return None
    try:
        from ria_tpu_torch.utils import trace as rings
    except ImportError:
        return None
    return rings


def host_median_s(trace, name: str) -> float | None:
    """Median seconds on the host's clock of the span ``name`` over its ring."""
    rings = _rings(trace)
    got = rings.intervals(name) if rings is not None else []
    if not got:
        return None
    return statistics.median(e - b for b, e in got) / 1e9


def union_s(trace, prefix: str) -> float | None:
    """Seconds in the union of every interval of the spans whose names start
    with ``prefix``, so that nested spans count once."""
    rings = _rings(trace)
    if rings is None:
        return None
    got = sorted(iv for name in rings.names() if name.startswith(prefix)
                 for iv in rings.intervals(name))
    if not got:
        return None
    total, lo, hi = 0, *got[0]
    for b, e in got[1:]:
        if b > hi:
            total += hi - lo
            lo, hi = b, e
        else:
            hi = max(hi, e)
    return (total + hi - lo) / 1e9
