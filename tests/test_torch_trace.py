"""The port's spans (``ria_tpu_torch/utils/trace.py``) on the CPU.

With no profiler running a span keeps its host interval in a ring and never
enters ``record_function``; under a profiler it is a user annotation too,
``sync.coarse`` and ``sync.fine`` inside ``rx.sync`` for the chain
geometries the benchmark serves (the chirp zoom search and the Schmidl-Cox
search), at one channel a call.  Rings keep their last occurrences and a
true count, from several threads at once; each fresh build of a pipeline, a
decoder or K1's library is one set-up span.
"""

import ctypes.util
import sys
import threading
from types import SimpleNamespace

import pytest
import torch
import torch.autograd.profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from ria_tpu_torch.fec import ldpc_kernel
from ria_tpu_torch.fec.ldpc import decode_batch, ldpc_decoder
from ria_tpu_torch.phy.pipeline import LDPC_BITS, make_ofdm_rx_pipeline, make_rx_pipeline
from ria_tpu_torch.tools import bench_profile
from ria_tpu_torch.utils import trace
from ria_tpu_torch.wave.mc_dpsk import MCDPSKConfig
from ria_tpu_torch.wave.ofdm import OFDMConfig

torch.set_num_threads(1)

CHAIN_SPANS = ("rx.sync", "sync.coarse", "sync.fine", "rx.demod", "rx.decode")


def _mcdpsk():
    """Chain 1 of the benchmark (10-carrier DBPSK, R1/4, 4 codewords, a
    207,328-sample window: the chirp zoom branch) and one noise window."""
    cfg = MCDPSKConfig(num_carriers=10, bits_per_symbol=1)
    window = cfg.frame_samples(4 * LDPC_BITS) + 12000
    rx = make_rx_pipeline(cfg, "R1_4", 4, window, device="cpu")
    assert rx.sync.zoom
    return rx, 0.01 * torch.randn(1, window, generator=torch.Generator().manual_seed(1))


def _ofdm():
    """The OFDM DQPSK R1/4 chain of the benchmark (59 carriers, 1024 FFT, CP
    96, Schmidl-Cox, a 42,720-sample window) and one noise window."""
    cfg = OFDMConfig(fft_size=1024, num_carriers=59, cp_len=96, modulation="DQPSK",
                     use_pilots=False)
    rx = make_ofdm_rx_pipeline(cfg, "R1_4", 42720, 118, device="cpu")
    return rx, torch.randn(1, 42720, generator=torch.Generator().manual_seed(2))


def _decode():
    llrs = 4.0 + torch.randn(2, 648, generator=torch.Generator().manual_seed(3))
    return decode_batch(llrs, [0.75, 0.75], "R1_4", device="cpu")


class _Counting:
    """Stands in for ``record_function`` and counts its entries."""

    entered = 0

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        type(self).entered += 1
        return self

    def __exit__(self, *exc):
        return False


@pytest.fixture
def rings():
    trace.reset()
    yield trace
    trace.reset()


def test_no_profiler_no_record_function(rings, monkeypatch):
    monkeypatch.setattr(autograd_profiler, "record_function", _Counting)
    monkeypatch.setattr(_Counting, "entered", 0)
    for rx, audio in (_mcdpsk(), _ofdm()):
        rx(audio)
    _decode()
    assert _Counting.entered == 0
    assert {n: rings.count(n) for n in CHAIN_SPANS} == dict.fromkeys(CHAIN_SPANS, 2)
    assert rings.count("ldpc.decode_batch") == 1
    # Under a profiler the same spans do enter it: the count above is no
    # accident of the stand-in.
    with profile(activities=[ProfilerActivity.CPU]):
        _decode()
    assert _Counting.entered == 1


def test_a_torch_without_the_flag_keeps_record_function(rings, monkeypatch):
    monkeypatch.setattr(autograd_profiler, "record_function", _Counting)
    monkeypatch.setattr(_Counting, "entered", 0)
    monkeypatch.delattr(autograd_profiler, "_is_profiler_enabled")
    with trace.span("t.kept"):
        pass
    assert _Counting.entered == 1 and rings.count("t.kept") == 1


def _annotations(prof, name):
    kr = prof.profiler.kineto_results
    return sorted((e.start_ns(), e.end_ns()) for e in kr.events() if e.name() == name)


@pytest.mark.parametrize("chain", ["mcdpsk", "ofdm"])
def test_profiled_chain_nests_sync_parts_in_rx_sync(rings, chain):
    rx, audio = _mcdpsk() if chain == "mcdpsk" else _ofdm()
    rx(audio)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rx(audio)
    marked = {e.name for e in prof.events() if e.is_user_annotation}
    assert set(CHAIN_SPANS) <= marked
    (sync,) = _annotations(prof, "rx.sync")
    (coarse,) = _annotations(prof, "sync.coarse")
    (fine,) = _annotations(prof, "sync.fine")
    assert sync[0] <= coarse[0] <= coarse[1] <= fine[0] <= fine[1] <= sync[1]
    # A profiler ties a kernel to the innermost span, so ``rx.sync`` keeps a
    # device-side range over the whole search only if kernels of its own
    # open and close it: the mix's product and sum, the decision's selects.
    ops = sorted((e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
                 if e.name() in ("aten::mul", "aten::sum", "aten::where")
                 and sync[0] <= e.start_ns() <= sync[1])
    assert ops[0][1] <= coarse[0] and ops[-1][0] >= fine[1]
    (demod,) = _annotations(prof, "rx.demod")
    (dec,) = _annotations(prof, "rx.decode")
    assert sync[1] <= demod[0] <= demod[1] <= dec[0]
    assert all(rings.count(n) == 2 for n in CHAIN_SPANS)


def test_profiled_decode_batch_is_one_annotation(rings):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _decode()
    assert len(_annotations(prof, "ldpc.decode_batch")) == 1
    assert any(e.is_user_annotation and e.name == "ldpc.decode_batch" for e in prof.events())


def test_ring_lies_on_the_profilers_clock(rings):
    """A ring interval lies inside its annotation's host range (the ring's
    stamps are taken inside ``record_function``): one clock."""
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("t.clock"):      # the first annotation of a process is slow
            pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("t.clock"):
            torch.randn(64, 64).sum()
    (b, e) = rings.intervals("t.clock")[-1]
    ((pb, pe),) = _annotations(prof, "t.clock")
    slack = 50_000   # ns: the profiler converts its own clock to the epoch's
    assert pb - slack <= b <= e <= pe + slack


def test_ring_keeps_the_last_occurrences_and_a_true_count(rings, monkeypatch):
    clock = iter(range(10**6))
    monkeypatch.setattr(trace, "_now", lambda: next(clock))
    n = trace.RING + 476
    for _ in range(n):
        with trace.span("t.ring"):
            pass
    got = rings.intervals("t.ring")
    assert len(got) == trace.RING == 1024
    assert got == [(2 * k, 2 * k + 1) for k in range(n - trace.RING, n)]
    assert rings.count("t.ring") == n
    assert rings.intervals("t.never") == [] and rings.count("t.never") == 0
    assert rings.names() == ["t.ring"]
    rings.reset()
    assert rings.names() == [] and rings.count("t.ring") == 0


def test_four_threads_lose_nothing(rings):
    each = 3000
    start = threading.Barrier(4)

    def work(i):
        start.wait()
        for _ in range(each):
            with trace.span("t.shared"):
                with trace.span(f"t.own{i}"):
                    pass

    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)     # threads change hands inside the spans
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(before)
    assert not any(t.is_alive() for t in threads)
    assert rings.count("t.shared") == 4 * each
    assert [rings.count(f"t.own{i}") for i in range(4)] == [each] * 4
    assert len(rings.intervals("t.shared")) == trace.RING
    assert all(b <= e for b, e in rings.intervals("t.shared"))


def test_setup_spans_once_for_each_fresh_build(rings, monkeypatch):
    ldpc_decoder.cache_clear()
    _mcdpsk()
    assert rings.count("setup.rx_pipeline") == 1 and rings.count("setup.ldpc_decoder") == 1
    _mcdpsk()                                   # the decoder comes from the cache
    assert rings.count("setup.rx_pipeline") == 2 and rings.count("setup.ldpc_decoder") == 1
    ldpc_decoder.cache_clear()
    _ofdm()
    assert rings.count("setup.rx_pipeline") == 3 and rings.count("setup.ldpc_decoder") == 2
    # The decoder's build lies inside the pipeline's.
    (b, e), (db, de) = rings.intervals("setup.rx_pipeline")[-1], rings.intervals(
        "setup.ldpc_decoder")[-1]
    assert b <= db <= de <= e

    # K1's library: its first load only (any shared library stands in for it).
    libc = ctypes.util.find_library("c") or "libc.so.6"
    monkeypatch.setattr(ldpc_kernel, "_LIBRARIES", {})
    monkeypatch.setattr(ldpc_kernel, "build", lambda: {
        name: SimpleNamespace(path=libc) for name in ldpc_kernel.LIBRARIES})
    ldpc_kernel._library("ldpc_bp")
    ldpc_kernel._library("ldpc_bp")
    assert rings.count("setup.k1_library") == 1
    ldpc_kernel._library("ldpc_bp_v1")          # K2's build is no K1 set-up
    ldpc_kernel._library("ldpc_bp_bf16")
    assert rings.count("setup.k1_library") == 2


def test_stage_names_stay_bench_profiles(rings):
    assert bench_profile.SPANS == ("rx.sync", "rx.demod", "rx.decode")
    rx, audio = _mcdpsk()
    rx(audio)
    stages = [n for n in rings.names() if n.startswith("rx.")]
    assert stages == sorted(bench_profile.SPANS)
