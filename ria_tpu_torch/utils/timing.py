"""Timing on the card: CUDA events around calls, device time from torch.profiler."""

from __future__ import annotations

import numpy as np
import torch


def cuda_ms(fn, reps: int, windows: int = 7) -> tuple[float, float, float]:
    """(median, min, max) over ``windows`` windows of the milliseconds per
    call of ``fn`` on the card, each window timed by CUDA events around
    ``reps`` calls."""
    per_call = []
    for _ in range(windows):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        per_call.append(start.elapsed_time(end) / reps)
    return float(np.median(per_call)), min(per_call), max(per_call)


def device_us(fn, kernel: str, reps: int = 20) -> float | None:
    """Device microseconds per launch of the CUDA kernel whose name holds
    ``kernel``, from torch.profiler over ``reps`` calls of ``fn``; None when
    the trace shows no such kernel."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if kernel in e.key]
    count = sum(e.count for e in events)
    return sum(e.device_time_total for e in events) / count if count else None


def trace_call(fn, top: int = 3) -> tuple[int, float, list[tuple[str, float]]]:
    """(device activities, device-busy microseconds, the ``top`` activity
    names by device microseconds summed over the call) of one call of
    ``fn``, from a torch.profiler trace: every kernel, copy and memset on
    the card, and the length of the union of their intervals."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in device)
    busy, end = 0.0, float("-inf")
    for lo, hi in spans:
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    by_name: dict[str, float] = {}
    for e in device:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.end - e.time_range.start
    return len(spans), busy, sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
