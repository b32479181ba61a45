"""The spans on the card (needs a GPU; skips without one):

    python -m pytest -q tests/test_torch_trace_cuda.py

A span's ring interval (``time.time_ns()``) and a device-only profiler
trace's kernels (``trace_start_ns`` plus each event's offset) are on one
clock: a kernel launched and waited for inside a span lies within the
span's interval, to 50 us.  A reader can then lay the ring's spans of an
untraced stretch over a device-only trace.  And in a profiled call of each
chain the device-side range of ``rx.sync`` holds those of ``sync.coarse``
and ``sync.fine``, and all of sync's device work.
"""

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ria_tpu_torch.phy.pipeline import LDPC_BITS, make_ofdm_rx_pipeline, make_rx_pipeline
from ria_tpu_torch.utils import trace
from ria_tpu_torch.utils.timing import PROFILER_TRIES, is_annotation
from ria_tpu_torch.wave.mc_dpsk import MCDPSKConfig
from ria_tpu_torch.wave.ofdm import OFDMConfig

SLACK_NS = 50_000


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the device's clock is read from its trace")
    return torch.device("cuda", 0)


def _trace_start_ns(prof) -> int:
    results = prof.profiler.kineto_results
    if hasattr(results, "trace_start_ns"):
        return results.trace_start_ns()
    return results.trace_start_us() * 1000


@pytest.mark.cuda
def test_kernel_lies_inside_its_span(cuda_device):
    trace.reset()
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    for _ in range(PROFILER_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            with trace.span("t.card"):
                torch.cuda._sleep(2_000_000)      # about 1 ms
                torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA and not is_annotation(e)]
        if kernels:
            break
    assert kernels, "no device-only trace showed the kernel"
    (b, e) = trace.intervals("t.card")[-1]
    start = _trace_start_ns(prof)
    (k,) = [k for k in kernels if k.time_range.elapsed_us() > 100]
    k_b = start + int(k.time_range.start * 1000)
    k_e = start + int(k.time_range.end * 1000)
    assert b - SLACK_NS <= k_b < k_e <= e + SLACK_NS, (b, e, k_b, k_e)
    trace.reset()


def _chain(name, dev):
    """The benchmark's two chains at four channels a call, noise windows."""
    g = torch.Generator().manual_seed(4)
    if name == "mcdpsk":
        cfg = MCDPSKConfig(num_carriers=10, bits_per_symbol=1)
        window = cfg.frame_samples(4 * LDPC_BITS) + 12000
        rx = make_rx_pipeline(cfg, "R1_4", 4, window, device=dev)
    else:
        cfg = OFDMConfig(fft_size=1024, num_carriers=59, cp_len=96, modulation="DQPSK",
                         use_pilots=False)
        window = 42720
        rx = make_ofdm_rx_pipeline(cfg, "R1_4", window, 118, device=dev)
    return rx, (0.01 * torch.randn(4, window, generator=g)).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("chain", ["mcdpsk", "ofdm"])
def test_rx_sync_range_holds_its_parts(cuda_device, chain):
    rx, audio = _chain(chain, cuda_device)
    rx(audio)
    torch.cuda.synchronize()
    names = ("rx.sync", "sync.coarse", "sync.fine")
    for _ in range(PROFILER_TRIES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            rx(audio)
            torch.cuda.synchronize()
        ranges = {e.name: (e.time_range.start, e.time_range.end) for e in prof.events()
                  if e.device_type == DeviceType.CUDA and is_annotation(e) and e.name in names}
        if len(ranges) == len(names):
            break
    assert set(ranges) == set(names), sorted(ranges)
    (lo, hi), coarse, fine = ranges["rx.sync"], ranges["sync.coarse"], ranges["sync.fine"]
    assert lo <= coarse[0] <= coarse[1] <= fine[0] <= fine[1] <= hi

    def work_in(r):
        return sum(e.time_range.elapsed_us() for e in prof.events()
                   if e.device_type == DeviceType.CUDA and not is_annotation(e)
                   and r[0] <= e.time_range.start and e.time_range.end <= r[1])

    assert work_in(ranges["rx.sync"]) >= work_in(coarse) + work_in(fine) > 0
