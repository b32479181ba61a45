"""The HARQ cell ``mcdpsk_s4_r14.harq64x2_m19db`` (config #2) on the CPU at a
small size (the look for a card skipped): whole runs, its generator and the
plain round at that size, its readers on a hand-made trace, the round's
spans, and the check failing on a broken round; on the card, the control
(the plain round with TF32 matmuls) not correct and the program correct."""

import json

import pytest
import torch

from benchmark import harness, tracing
from benchmark.tests.conftest import ROOT, copy_root, run_cpu

CELL = "mcdpsk_s4_r14.harq64x2_m19db"
H100 = "NVIDIA H100 80GB HBM3"
CHECKS = {"sync_mismatch", "cfo_gap_hz", "snr_gap_db", "cw_mismatch", "sent_start_gap",
          "sent_cw_wrong_excess"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return copy_root(tmp_path_factory.mktemp("checkout"))


@pytest.fixture(scope="module")
def cell(root):
    return harness.load_cell(root, CELL)


def _reader(name):
    return harness.load_module(ROOT / "benchmark" / "metrics" / f"{name}.py")


@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct_on_the_cpu(root, trace):
    from ria_tpu_torch.utils import trace as spans

    spans.reset()
    r = run_cpu(root, CELL, trace=trace)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "checks" and set(r["checks"]) == CHECKS
    assert all(c["value"] <= 0 or k == "sent_start_gap" for k, c in r["checks"].items())
    if not trace:
        assert set(r["metrics"]) == {"rx_samples_per_s", "setup_s"}
        assert all(m["value"] > 0 for m in r["metrics"].values())
    else:
        # No device trace on the CPU: only the host clock's tail is read.
        assert list(r["metrics"]) == ["call_p95_ms.rx"]
    # Each call of the round ran the chain's spans and the chase beside them.
    calls = spans.count("rx.chase")
    assert calls >= r["attempted"] and spans.count("rx.decode") == calls
    assert spans.count("rx.sync") == spans.count("rx.demod") == calls


def test_work_counts_every_copy(cell):
    w = cell.entry.work(cell.config, cell.traffic)
    assert w == {"samples": 2 * 2 * 606688, "codewords": 2 * 4}
    full = json.loads((ROOT / "benchmark" / "traffic" / "harq64x2_m19db.json").read_text())
    assert cell.entry.work(cell.config, full)["samples"] == 64 * 2 * 606688


def test_generator_repeats_from_its_seed(cell):
    dev = torch.device("cpu")
    a, sa = cell.generator.make_pool(cell.config, cell.traffic, 2**31 + 11, dev)
    b, sb = cell.generator.make_pool(cell.config, cell.traffic, 2**31 + 11, dev)
    d, _ = cell.generator.make_pool(cell.config, cell.traffic, 2**31 + 12, dev)
    assert len(a) == len(sa) == cell.traffic["pool"]
    assert a[0].shape == (2, 2, 606688)
    assert sa[0]["start"].shape == (2, 2) and sa[0]["info_bits"].shape == (2, 4, 162)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(torch.equal(x[k], y[k]) for x, y in zip(sa, sb) for k in x)
    assert not torch.equal(a[0], d[0]) and not torch.equal(a[0], a[1])
    # Each copy under noise of its own, at a lead of its own.
    assert not torch.equal(a[0][:, 0], a[0][:, 1])


def test_copies_carry_the_same_frame(cell):
    """Without noise every copy of a channel is the one frame at its lead."""
    traffic = dict(cell.traffic, snr_db=300.0)
    pool, sent = cell.generator.make_pool(cell.config, traffic, 3, torch.device("cpu"))
    x, lead = pool[0], sent[0]["start"]
    n = 594688
    for b in range(x.shape[0]):
        frames = [x[b, r, int(lead[b, r]): int(lead[b, r]) + n] for r in range(x.shape[1])]
        assert torch.allclose(frames[0], frames[1], atol=1e-12)
        assert float(frames[0].abs().max()) > 0.1


def test_reference_decodes_what_was_sent(cell):
    """At -19 dB the plain round finds every copy at its sent start and,
    combining where a copy fails, decodes every codeword to the sent bits."""
    dev = torch.device("cpu")
    pool, sent = cell.generator.make_pool(cell.config, cell.traffic, 5, dev)
    out = cell.entry.reference(cell.config, cell.traffic, dev)(pool[0])
    assert bool(out["detected"].all())
    assert int((out["start"].long() - sent[0]["start"].long()).abs().max()) <= 16
    assert bool(out["cw_success"].all())
    assert torch.equal(out["info_bits"], sent[0]["info_bits"])
    assert bool((out["source"] >= 0).all()) and out["source"].dtype == torch.int8
    assert bool((out["iterations"] > 1).any())


# -- readers ------------------------------------------------------------------


def _round_trace() -> tracing.Trace:
    spans = {"rx.sync": [], "rx.demod": [], "rx.decode": [], "rx.chase": []}
    ops = []
    for c in range(2):
        t = 10_000.0 * c
        spans["rx.sync"].append((t + 100, t + 2000))
        ops.append(("fft_c2c", t + 200, t + 1900))
        spans["rx.demod"].append((t + 2100, t + 4000))
        ops.append(("gemm", t + 2200, t + 3900))
        spans["rx.decode"].append((t + 4100, t + 4600))
        ops += [("fill", t + 4100, t + 4110), ("ldpc_bp_kernel", t + 4150, t + 4600)]
        spans["rx.chase"].append((t + 4700, t + 5000))
        ops += [("where", t + 4700, t + 4720), ("ldpc_bp_kernel", t + 4750, t + 4950),
                ("where", t + 4960, t + 5000)]
    return tracing.Trace(calls=2, window_s=0.02, ops=ops, spans=spans, host=[], kind=H100,
                         span_calls=2, span_ops=list(ops))


def test_decode_and_chase_readers():
    t = _round_trace()
    assert _reader("decode_device_ms.rx").read(t) == pytest.approx(0.46)
    assert _reader("chase_device_ms.rx").read(t) == pytest.approx(0.26)
    assert _reader("kernels_per_call.rx").read(t) == 7


@pytest.mark.parametrize("name", ["decode_device_ms.rx", "chase_device_ms.rx"])
def test_readers_read_nothing_without_their_span(name):
    t = _round_trace()
    t.spans = {k: v for k, v in t.spans.items() if k not in ("rx.decode", "rx.chase")}
    assert _reader(name).read(t) is None
    assert _reader(name).read(tracing.Trace(2, 0.01, [], {}, [], kind="cpu")) is None


# -- the check fails on a broken round ----------------------------------------


def _alter_answer(forward):
    def broken(self, audio):
        r = forward(self, audio)
        bits = r.info_bits.clone()
        bits.view(-1)[0] ^= 1
        return r._replace(info_bits=bits)
    return broken


def _copy_one_twice(forward):
    """Every channel's first copy handed in as both: the second copy lost."""
    def broken(self, audio):
        return forward(self, audio[:, :1].expand(-1, audio.shape[1], -1).contiguous())
    return broken


@pytest.mark.parametrize("fault", ["answer_altered", "copy_lost"])
def test_a_broken_round_is_not_correct(root, monkeypatch, fault):
    from ria_tpu_torch.phy import pipeline

    wrap = _alter_answer if fault == "answer_altered" else _copy_one_twice
    monkeypatch.setattr(pipeline.HarqRxPipeline, "forward",
                        wrap(pipeline.HarqRxPipeline.forward))
    r = run_cpu(root, CELL)
    assert not r["correct"], r["checks"]
    if fault == "copy_lost":     # what was sent catches it alone
        assert r["checks"]["sent_start_gap"]["value"] > r["checks"]["sent_start_gap"]["limit"]
    else:
        assert r["checks"]["sent_cw_wrong_excess"]["value"] > 0


def test_a_parent_without_the_round_fails_at_once(root, monkeypatch):
    """A program that lacks the round (the parent of the change that added
    it) fails cleanly, when the entry builds its program."""
    from ria_tpu_torch.phy import pipeline

    monkeypatch.delattr(pipeline, "make_harq_rx_pipeline")
    with pytest.raises(ImportError):
        run_cpu(root, CELL)


# -- on the card: the control is not correct, the program is --------------------


SEEDS = [2**31 + 101, 2**31 + 102, 2**31 + 103]


@pytest.mark.cuda
def test_control_fails_and_program_holds(cuda_device, tmp_path):
    from benchmark import calibrate

    torch.backends.cuda.matmul.allow_tf32 = False
    full = copy_root(tmp_path, small=False)
    c = harness.load_cell(full, CELL)
    for row in calibrate.readings(c, SEEDS, cuda_device, control="tf32"):
        assert any(row[k] > lim for k, lim in c.limits.items()), row
    for row in calibrate.readings(c, SEEDS, cuda_device):
        assert all(row[k] <= lim for k, lim in c.limits.items()), row
