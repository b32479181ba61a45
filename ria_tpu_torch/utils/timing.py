"""Timing on the card: CUDA events around calls, device time from torch.profiler."""

from __future__ import annotations

import time

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


# A profiler run now and then comes back without its device events; it is run
# again this many times before its caller is told so.
PROFILER_TRIES = 3


def device_us(fn, kernel: str, reps: int = 20) -> float | None:
    """Device microseconds per launch of the CUDA kernel whose name holds
    ``kernel``, from torch.profiler over ``reps`` calls of ``fn``; None when
    no trace of ``PROFILER_TRIES`` shows such a kernel."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILER_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if kernel in e.key]
        count = sum(e.count for e in events)
        if count:
            return sum(e.device_time_total for e in events) / count
    return None


def queued_us(fn, reps: int = 20, spin_cycles: int = 8_000_000) -> float:
    """Microseconds per call of ``fn`` on the card's clock with the host's
    launch cost hidden: the calls are queued behind a kernel that spins for
    ``spin_cycles`` clocks (a few ms) and run back to back once it ends, CUDA
    events before the first and after the last.  For an ``fn`` that launches
    one kernel this is that kernel's time plus the gap between two launches
    on a stream (a microsecond or two), so it reads a little above
    :func:`device_us`."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(spin_cycles)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / reps


def kernel_us(fn, kernel: str, reps: int = 20) -> tuple[float, str]:
    """(device microseconds per launch of ``kernel`` in ``fn``, how it was
    read): :func:`device_us` where the profiler shows the kernel, else
    :func:`queued_us`, so that a trace without device events costs the
    figure's precision and not the run."""
    us = device_us(fn, kernel, reps)
    if us is not None:
        return us, f"torch.profiler, {reps} launches"
    return queued_us(fn, reps), f"CUDA events around {reps} queued launches, no profiler trace"


def _device_summary(events, top: int = 3) -> tuple[int, float, list[tuple[str, float]]]:
    """(device activities, the microseconds in the union of their intervals,
    the ``top`` activity names by device microseconds) of a profiler run's
    events: every kernel, copy and memset on the card (not the device-side
    ranges of ``record_function`` spans, which cover the gaps between their
    kernels)."""
    from torch.autograd import DeviceType

    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not is_annotation(e)]
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


def is_annotation(e) -> bool:
    """Whether a profiler event is a ``record_function`` span (on the host
    or its device-side range) rather than work."""
    return bool(getattr(e, "is_user_annotation", False)) or \
        "annotation" in str(getattr(e, "activity_type", "")).lower()


def trace_call(fn, top: int = 3) -> tuple[int, float, list[tuple[str, float]]]:
    """(device activities, device-busy microseconds, the ``top`` activity
    names by device microseconds summed over the call) of one call of
    ``fn``, from a torch.profiler trace."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILER_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        summary = _device_summary(prof.events(), top)
        if summary[0]:
            break
    return summary


def wall_ms(fn, reps: int = 9) -> tuple[float, float, float]:
    """(median, min, max) milliseconds of ``reps`` calls of ``fn`` on the
    host's clock, the card synchronised before and after each call: for a
    call that returns host values, where the host's own work is part of
    what its caller waits for."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), min(times), max(times)


SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


def trace_syncs(fn) -> dict:
    """One call of ``fn`` (which returns host values, so it ends
    synchronised) under torch.profiler: ``device`` (kernels, copies and
    memsets on the card), ``busy_us`` (the union of their intervals),
    ``syncs`` (the host's cudaStream/Device/EventSynchronize calls inside the
    call: each is a point where the host waits for the card), ``d2h`` and
    ``h2d`` (copies to and from the host) and ``top`` (the three heaviest
    device activities)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILER_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
        events = list(prof.events())
        n_dev, busy, top = _device_summary(events)
        if n_dev:
            break
    on_card = [e.name for e in events if e.device_type == DeviceType.CUDA
               and not is_annotation(e)]
    return {
        "device": n_dev, "busy_us": busy, "top": top,
        "syncs": sum(e.name in SYNC_CALLS for e in events if e.device_type != DeviceType.CUDA),
        "d2h": sum("Memcpy DtoH" in name for name in on_card),
        "h2d": sum("Memcpy HtoD" in name for name in on_card),
    }
