"""The traced calls of a ``--trace 1`` run, read from ``torch.profiler``.

Two traced stretches of the served loop, one after the other:

1. the device's activity alone (kernels, copies and memsets, from CUPTI),
   which costs the host next to nothing, so the calls keep their pace: the
   device's busy time, the traced window, the kernels a call and each
   kernel's time come from it;
2. the host's operators as well, which slows the host's dispatch: the
   device-side range of every ``record_function`` span the program opens
   and the host operator under way in each idle gap come from it.  A piece
   of device work belongs to a span when it runs inside one of the span's
   device-side ranges (the attribution of
   ``ria_tpu_torch/tools/bench_profile.py::span_split``, frozen here).

A :class:`Trace` holds both for the per-layer readers (``metrics/*.py``),
and the seconds a call of the untraced window that follows: tracing slows
the host's launches (under CUPTI alone by some 4-6 us a launch on an
NVIDIA H100 80GB HBM3), so the traced window's idle share reads high, and
the device's idle share in the served loop is its busy seconds a call
against that pace.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field

import torch

TOP = 10  # entries of each list of the breakdown


def _is_annotation(e) -> bool:
    """Whether a profiler event is a ``record_function`` span (on the host
    or its device-side range) rather than work."""
    return bool(getattr(e, "is_user_annotation", False)) or \
        "annotation" in str(getattr(e, "activity_type", "")).lower()


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


@dataclass
class Trace:
    """Times in microseconds on the profiler's clock, unless named ``_s``.
    ``calls``, ``window_s``, ``ops`` and ``iterations`` are the first
    stretch's; ``span_calls``, ``span_ops``, ``spans`` and ``host`` the
    second's."""

    calls: int
    window_s: float
    ops: list[tuple[str, float, float]]                 # device work
    spans: dict[str, list[tuple[float, float]]]         # device-side span ranges
    host: list[tuple[str, float, float]]                # host operators and spans
    iterations: list[int] = field(default_factory=list)  # codeword-iterations a call
    work: dict = field(default_factory=dict)            # the entry's work a call
    kind: str = ""                                      # the device's name
    span_calls: int = 0
    span_ops: list[tuple[str, float, float]] = field(default_factory=list)
    served_call_s: float = 0.0                          # the untraced window's seconds a call
    latencies: list[float] = field(default_factory=list)  # the untraced window's calls, s

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in _union([(s, e) for _, s, e in self.ops])) / 1e6

    def span_device_s(self, name: str) -> float | None:
        """Seconds of device work a call inside the span's device-side
        ranges; None where the trace holds no such range."""
        ranges = sorted(self.spans.get(name, []))
        if not ranges:
            return None
        starts = [s for s, _ in ranges]
        total = 0.0
        for _, s, e in self.span_ops:
            i = bisect.bisect_right(starts, s) - 1
            if i >= 0 and e <= ranges[i][1]:
                total += e - s
        return total / 1e6 / self.span_calls

    def ops_named(self, part: str) -> list[tuple[str, float, float]]:
        return [op for op in self.ops if part in op[0]]

    def breakdown(self) -> dict:
        """The device operations that took most time (first stretch), and the
        longest idle gaps between device work by the host operator that was
        running as each began, its innermost one (second stretch), in
        seconds."""
        by_op: dict[str, float] = defaultdict(float)
        for name, s, e in self.ops:
            by_op[name] += (e - s) / 1e6
        busy = _union([(s, e) for _, s, e in self.span_ops])
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        by_gap: dict[str, float] = defaultdict(float)
        for (_, end), (nxt, _) in zip(busy, busy[1:]):
            i = bisect.bisect_right(starts, end) - 1
            label = "no host operator"
            for j in range(i, max(i - 400, -1), -1):
                if host[j][2] >= end:
                    label = host[j][0]
                    break
            by_gap[label] += (nxt - end) / 1e6

        def top(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

        return {"device_ops": top(by_op), "idle_gaps": top(by_gap)}


def _profiled(serve_calls, activities, device):
    from torch.autograd import DeviceType
    from torch.profiler import profile

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    with profile(activities=activities) as prof:
        win = serve_calls()
    ops, host = [], []
    spans: dict[str, list[tuple[float, float]]] = defaultdict(list)
    for e in prof.events():
        r = e.time_range
        if e.device_type == DeviceType.CUDA:
            if _is_annotation(e):
                spans[e.name].append((r.start, r.end))
            else:
                ops.append((e.name, r.start, r.end))
        else:
            host.append((e.name, r.start, r.end))
    return win, ops, dict(spans), host


def traced_calls(serve_calls, device: torch.device) -> Trace:
    """Trace two stretches of ``serve_calls()`` (the served loop over a
    fixed number of calls) and return their :class:`Trace`."""
    from torch.profiler import ProfilerActivity

    if device.type == "cuda":
        win, ops, _, _ = _profiled(serve_calls, [ProfilerActivity.CUDA], device)
        activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        kind = torch.cuda.get_device_name(device)
    else:
        win, ops, kind = serve_calls(), [], "cpu"
        activities = [ProfilerActivity.CPU]
    span_win, span_ops, spans, host = _profiled(serve_calls, activities, device)
    return Trace(win.calls, win.seconds, ops, spans, host, kind=kind,
                 span_calls=span_win.calls, span_ops=span_ops)
