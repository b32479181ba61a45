"""The per-layer readers and the trace's arithmetic on a profile written
out as the profiler gives it (microseconds on one clock): two calls of a
chain and two decode calls; and a CPU profile, which holds no device work."""

import pytest
import torch

from benchmark import harness, roofline, tracing
from benchmark.tests.conftest import ROOT

H100 = "NVIDIA H100 80GB HBM3"


def _reader(name):
    return harness.load_module(ROOT / "benchmark" / "metrics" / f"{name}.py")


def chain_trace() -> tracing.Trace:
    ops, spans, host = [], {"rx.sync": [], "rx.demod": [], "rx.decode": []}, []
    for c in range(2):
        t = 10_000.0 * c
        ops.append(("Memcpy HtoD (Pinned -> Device)", t, t + 2000))
        spans["rx.sync"].append((t + 2000, t + 3500))
        ops += [("fft_c2c", t + 2100, t + 2600), ("argmax", t + 3000, t + 3400)]
        spans["rx.demod"].append((t + 3600, t + 5000))
        ops.append(("gemm", t + 3700, t + 4500))
        spans["rx.decode"].append((t + 5100, t + 5300))
        ops.append(("ldpc_bp_kernel", t + 5150, t + 5250))
        ops.append(("Memcpy DtoH (Device -> Pinned)", t + 5400, t + 5500))
        host += [("aten::fft_fft", t + 1900, t + 2050), ("cudaStreamSynchronize", t + 5300, t + 5600)]
    return tracing.Trace(calls=2, window_s=0.02, ops=ops, spans=spans, host=host,
                         iterations=[4, 4], work={"samples": 10, "codewords": 4}, kind=H100,
                         span_calls=2, span_ops=list(ops))


def test_span_attribution_and_counts():
    t = chain_trace()
    assert _reader("kernels_per_call.rx").read(t) == 6
    assert _reader("sync_device_ms.rx").read(t) == pytest.approx(0.9)
    assert _reader("demod_device_ms.rx").read(t) == pytest.approx(0.8)
    busy = 2 * (2000 + 500 + 400 + 800 + 100 + 100) / 1e6
    assert t.busy_s == pytest.approx(busy)
    assert _reader("device_idle_pct.rx").read(t) is None   # no untraced window yet
    t.served_call_s = 0.008
    assert _reader("device_idle_pct.rx").read(t) == pytest.approx(100 * (1 - busy / 2 / 0.008))
    assert _reader("call_p95_ms.rx").read(t) is None      # no window yet
    t.latencies = [0.001 * (i + 1) for i in range(100)]
    assert _reader("call_p95_ms.rx").read(t) == pytest.approx(95.05)
    assert _reader("call_p95_ms.decode").read(t) == pytest.approx(95.05)


def test_breakdown_names_ops_and_gaps():
    b = chain_trace().breakdown()
    assert b["device_ops"][0] == ["Memcpy HtoD (Pinned -> Device)", pytest.approx(0.004)]
    assert len(b["device_ops"]) == 6 and len(b["idle_gaps"]) <= tracing.TOP
    gaps = dict((k, v) for k, v in b["idle_gaps"])
    # The gap after the copy back of call 0 runs while the host synchronises.
    assert gaps["cudaStreamSynchronize"] == pytest.approx(0.0045)


def test_overlapping_work_counts_once():
    t = tracing.Trace(1, 1.0, [("a", 0, 100), ("b", 50, 150), ("c", 300, 400)], {}, [])
    assert t.busy_s == pytest.approx(250e-6)


def test_k1_roofline_from_the_code():
    from benchmark.reference import ldpc_matrix

    code = ldpc_matrix.get_code("R1_4")
    edges = int(code.row_mask.sum())
    w = {"codewords": 512, "n": code.n, "k": code.k, "m": code.m, "edges": edges}
    its = [8115, 8200]
    ops = [("ldpc_bp_kernel", 0.0, 126.0), ("ldpc_bp_kernel", 1000.0, 1127.0)]
    t = tracing.Trace(2, 0.002, ops, {}, [], iterations=its, work=w, kind=H100)
    peak = roofline.peaks(H100)
    bound = [roofline.decode_bound_s(512, i, code.n, code.k, code.m, edges, peak) for i in its]
    assert all(side == "operations" for _, side in bound)
    want = 100 * sum(b for b, _ in bound) / 253e-6
    assert _reader("k1_roofline.decode").read(t) == pytest.approx(want)
    assert 2.0 < want < 5.0       # PERF.md: K1 at the A/B point, 3.1-3.4% of its bound
    assert roofline.decode_ops(1, code.n, edges) == 14 * edges + code.n


def test_readers_return_nothing_without_their_work():
    empty = tracing.Trace(2, 0.01, [], {}, [], kind=H100)
    for name in ("kernels_per_call.rx", "sync_device_ms.rx", "demod_device_ms.rx",
                 "device_idle_pct.rx", "device_idle_pct.decode", "k1_roofline.decode"):
        assert _reader(name).read(empty) is None, name
    unknown = chain_trace()
    unknown.kind = "a card without published peaks"
    assert _reader("k1_roofline.decode").read(unknown) is None


def test_a_cpu_profile_has_no_device_work():
    x = torch.randn(64, 64)
    trace = tracing.traced_calls(
        lambda: harness.Window(1, 0.01, [0.01]) if (x @ x).sum() is not None else None,
        torch.device("cpu"))
    assert trace.ops == [] and trace.span_ops == [] and trace.busy_s == 0.0 and trace.host
