"""The readers of the port's spans on hand-made rings and traces: host ms or
us a call from a span's ring, the device ms inside ``sync.fine``, and
set-up's seconds as the union of the ``setup.*`` intervals; each reads
nothing without its span, without a card's trace, or from a program that
has no spans."""

import sys

import pytest

from benchmark import harness, tracing
from benchmark.tests.conftest import ROOT

H100 = "NVIDIA H100 80GB HBM3"
MS = 1_000_000   # ns


def _reader(name):
    return harness.load_module(ROOT / "benchmark" / "metrics" / f"{name}.py")


def _trace(spans=None) -> tracing.Trace:
    """Two calls' device work, with ``spans`` as device-side ranges."""
    ops = [("fft_c2c", 2100.0, 2600.0), ("argmax", 3000.0, 3400.0),
           ("fft_c2c", 12100.0, 12600.0), ("argmax", 13000.0, 13400.0)]
    return tracing.Trace(calls=2, window_s=0.02, ops=ops, spans=spans or {}, host=[],
                         kind=H100, span_calls=2, span_ops=list(ops))


@pytest.fixture
def rings(monkeypatch):
    """The port's span module with hand-made rings."""
    from ria_tpu_torch.utils import trace

    made: dict[str, list[tuple[int, int]]] = {}
    monkeypatch.setattr(trace, "intervals", lambda name: list(made.get(name, [])))
    monkeypatch.setattr(trace, "names", lambda: sorted(made))
    return made


def test_host_readers_take_the_median_of_the_ring(rings):
    t0 = 1_700_000_000 * 10**9
    rings["rx.sync"] = [(t0 + k * 10 * MS, t0 + k * 10 * MS + d)
                        for k, d in enumerate((2 * MS, 3 * MS, 2_500_000, 9 * MS))]
    rings["rx.demod"] = [(t0, t0 + 1_200_000)]
    rings["ldpc.decode_batch"] = [(t0, t0 + 20_000), (t0, t0 + 30_000), (t0, t0 + 26_000)]
    t = _trace()
    assert _reader("sync_host_ms.rx").read(t) == pytest.approx(2.75)
    assert _reader("demod_host_ms.rx").read(t) == pytest.approx(1.2)
    assert _reader("decode_host_us.decode").read(t) == pytest.approx(26.0)


def test_setup_counts_nested_spans_once(rings):
    t0 = 1_700_000_000 * 10**9
    rings["setup.rx_pipeline"] = [(t0, t0 + 400 * MS)]
    rings["setup.ldpc_decoder"] = [(t0 + 100 * MS, t0 + 300 * MS)]       # inside
    rings["setup.k1_library"] = [(t0 + 350 * MS, t0 + 900 * MS),         # overlaps
                                 (t0 + 2000 * MS, t0 + 2100 * MS)]       # apart
    rings["rx.sync"] = [(t0, t0 + 5000 * MS)]                              # no set-up
    assert _reader("setup_program_s").read(_trace()) == pytest.approx(1.0)


def test_device_ms_inside_sync_fine():
    spans = {"rx.sync": [(2000.0, 3500.0), (12000.0, 13500.0)],
             "sync.fine": [(2900.0, 3500.0), (12900.0, 13500.0)]}
    t = _trace(spans)
    assert _reader("sync_fine_device_ms.rx").read(t) == pytest.approx(0.4)
    assert _reader("sync_fine_device_ms.rx").read(t) <= _reader("sync_device_ms.rx").read(t)


READERS = ["sync_host_ms.rx", "demod_host_ms.rx", "sync_fine_device_ms.rx",
           "decode_host_us.decode", "setup_program_s"]


@pytest.mark.parametrize("name", READERS)
def test_nothing_without_the_span(rings, name):
    assert _reader(name).read(_trace()) is None


@pytest.mark.parametrize("name", READERS)
def test_nothing_without_a_cards_trace(rings, name):
    rings.update({n: [(0, MS)] for n in ("rx.sync", "rx.demod", "ldpc.decode_batch",
                                         "setup.rx_pipeline")})
    empty = tracing.Trace(2, 0.01, [], {}, [], kind="cpu")
    assert _reader(name).read(empty) is None


@pytest.mark.parametrize("name", READERS)
def test_nothing_from_a_program_without_spans(monkeypatch, name):
    # A parent program has no ``ria_tpu_torch.utils.trace``.
    monkeypatch.setitem(sys.modules, "ria_tpu_torch.utils.trace", None)
    import ria_tpu_torch.utils as utils

    monkeypatch.delattr(utils, "trace", raising=False)
    assert _reader(name).read(_trace()) is None
