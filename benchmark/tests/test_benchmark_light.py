"""The light-preamble cell ``ofdm_dqpsk_r12.gw1024_awgn15`` (config #3) on
the CPU at a small size (the look for a card skipped): whole runs, its
generator's frame and sent start, the frozen light chain against the port's,
the new reader on a hand-made trace, and the check failing on a broken
chain; on the card, the bf16 control not correct and the program correct."""

import numpy as np
import pytest
import torch

from benchmark import harness, tracing
from benchmark.tests.conftest import ROOT, copy_root, run_cpu

CELL = "ofdm_dqpsk_r12.gw1024_awgn15"
H100 = "NVIDIA H100 80GB HBM3"
CHECKS = {"sync_mismatch", "cfo_gap_hz", "snr_gap_db", "cw_mismatch", "sent_start_gap",
          "sent_cw_wrong"}
CPU = torch.device("cpu")


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
    assert all(c["value"] == 0 for c in r["checks"].values())
    if not trace:
        assert set(r["metrics"]) == {"rx_samples_per_s", "setup_s"}
        assert all(m["value"] > 0 for m in r["metrics"].values())
    else:
        # No device trace on the CPU: only the host clock's tail is read.
        assert list(r["metrics"]) == ["call_p95_ms.rx"]
    # Every call searched once, its parts inside ``rx.sync``.
    calls = spans.count("rx.sync")
    assert calls >= r["attempted"]
    assert spans.count("sync.coarse") == spans.count("sync.fine") == calls


def test_the_frame_and_its_sent_start(cell):
    """Without noise each window holds the frozen light frame (two LTS and 25
    data symbols, 30,240 samples) at the sent start, nothing around it."""
    from benchmark import deploy_pilots
    from benchmark.reference import ofdm

    traffic = dict(cell.traffic, snr_db=300.0)
    pool, sent = cell.generator.make_pool(cell.config, traffic, 3, CPU)
    wf = ofdm.OFDMConfig(**deploy_pilots.ofdm_kwargs(cell.config))
    assert (wf.num_data_carriers, len(ofdm.carrier_layout(wf)[2])) == (53, 6)
    n = 27 * wf.symbol_samples
    assert n == 30240 and cell.config["window_samples"] == n + cell.config["window_slack"]
    lts = ofdm._mix_to_real(np.tile(ofdm._lts_symbol(wf), 2), wf)
    x = pool[0]
    for b, s in enumerate(sent[0]["start"].tolist()):
        assert 0 <= s < traffic["max_lead"]
        assert torch.allclose(x[b, s : s + len(lts)], torch.as_tensor(lts), atol=1e-5)
        assert float(torch.cat([x[b, :s], x[b, s + n :]]).abs().max()) < 1e-12
        assert float(x[b, s + n - 1120 : s + n].abs().max()) > 0.1


def test_batched_light_tx_is_the_frozen_tx(cell):
    """The generator's light TX over a batch gives what the frozen per-frame
    ``tx_frame(..., preamble="lts")`` gives, frame by frame."""
    from benchmark import deploy_pilots
    from benchmark.generators import air_light
    from benchmark.reference import interleave, ldpc_matrix, ofdm

    wf = ofdm.OFDMConfig(**deploy_pilots.ofdm_kwargs(cell.config))
    info = np.random.default_rng(1).integers(0, 2, (3 * 4, 324), dtype=np.uint8)
    coded = ldpc_matrix.encode_np(info, cell.config["rate"]).reshape(3, 4, 648)
    got = air_light._light_tx(cell.config, coded, CPU).numpy()
    frames = interleave.frame_interleave(interleave.apply_perm(
        coded, interleave.channel_perm(cell.config["channel_interleave_bits"])))
    want = np.stack([ofdm.tx_frame(f, wf, preamble="lts") for f in frames])
    assert got.shape == want.shape == (3, 30240)
    assert np.abs(got - want).max() < 1e-5 * np.abs(want).max()


def test_generator_repeats_from_its_seed(cell):
    a, sa = cell.generator.make_pool(cell.config, cell.traffic, 2**31 + 11, CPU)
    b, sb = cell.generator.make_pool(cell.config, cell.traffic, 2**31 + 11, CPU)
    d, _ = cell.generator.make_pool(cell.config, cell.traffic, 2**31 + 12, CPU)
    assert len(a) == len(sa) == cell.traffic["pool"]
    assert a[0].shape == (cell.traffic["channels"], 48000)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(torch.equal(x[k], y[k]) for x, y in zip(sa, sb) for k in x)
    assert not torch.equal(a[0], d[0]) and not torch.equal(a[0], a[1])


def test_generator_refuses_other_preambles(cell):
    with pytest.raises(ValueError, match="light preamble"):
        cell.generator.make_pool(dict(cell.config, preamble="cox"), cell.traffic, 1, CPU)


def test_reference_decodes_what_was_sent(cell):
    """At 15 dB the frozen light chain finds every frame at its sent start and
    decodes every codeword to the sent bits."""
    pool, sent = cell.generator.make_pool(cell.config, cell.traffic, 5, CPU)
    out = cell.entry.reference(cell.config, cell.traffic, CPU)(pool[0])
    assert bool(out["detected"].all())
    assert torch.equal(out["start"].long(), sent[0]["start"].long())
    assert bool(out["cw_success"].all())
    assert torch.equal(out["info_bits"], sent[0]["info_bits"])


@pytest.mark.parametrize("snr_db", [15.0, -1.0])
def test_frozen_light_chain_equals_the_port_on_the_cpu(cell, snr_db):
    """Bit for bit, at the cell's SNR and at one where BP iterates."""
    traffic = dict(cell.traffic, snr_db=snr_db, channels=3)
    x = cell.generator.make_pool(cell.config, traffic, 9, CPU)[0][1]
    got = cell.entry.Program(cell.config, traffic, CPU)(x)
    want = cell.entry.reference(cell.config, traffic, CPU)(x)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert bool(got["detected"].all())
    if snr_db < 15:
        assert bool((got["iterations"] > 1).any())


# -- the reader ----------------------------------------------------------------


def _search_trace() -> tracing.Trace:
    spans = {"rx.sync": [], "sync.coarse": [], "sync.fine": []}
    ops = []
    for c in range(2):
        t = 10_000.0 * c
        spans["rx.sync"].append((t + 100, t + 3000))
        ops.append(("square", t + 100, t + 150))
        spans["sync.coarse"].append((t + 200, t + 2200))
        ops += [("fft_c2c", t + 200, t + 1200), ("cumsum", t + 1300, t + 2100)]
        spans["sync.fine"].append((t + 2300, t + 2900))
        ops.append(("argmax", t + 2300, t + 2800))
        ops.append(("where", t + 2950, t + 3000))
    return tracing.Trace(calls=2, window_s=0.02, ops=ops, spans=spans, host=[], kind=H100,
                         span_calls=2, span_ops=list(ops))


def test_sync_coarse_reader():
    t = _search_trace()
    assert _reader("sync_coarse_device_ms.rx").read(t) == pytest.approx(1.8)
    assert _reader("sync_fine_device_ms.rx").read(t) == pytest.approx(0.5)
    assert _reader("sync_device_ms.rx").read(t) == pytest.approx(2.4)
    t.spans = {k: v for k, v in t.spans.items() if k != "sync.coarse"}
    assert _reader("sync_coarse_device_ms.rx").read(t) is None
    assert _reader("sync_coarse_device_ms.rx").read(
        tracing.Trace(2, 0.01, [], {}, [], kind="cpu")) is None


# -- the check fails on a broken chain -----------------------------------------


def _alter_answer(forward):
    def broken(self, audio):
        r = forward(self, audio)
        bits = r.info_bits.clone()
        bits.view(-1)[0] ^= 1
        return r._replace(info_bits=bits)
    return broken


def _half_batch(forward):
    """The chain run on the first half of the channels, the rest filled
    from it."""
    def broken(self, audio):
        B = audio.shape[0]
        r = forward(self, audio[: max(B // 2, 1)])
        idx = torch.arange(B) % max(B // 2, 1)
        return type(r)(*(t[idx.to(t.device)] for t in r))
    return broken


def _start_shifted(forward):
    def broken(self, audio):
        r = forward(self, audio)
        return r._replace(lts_start=r.lts_start + 17)
    return broken


@pytest.mark.parametrize("fault", ["answer_altered", "half_batch", "start_shifted_17"])
def test_a_broken_chain_is_not_correct(root, monkeypatch, fault):
    from ria_tpu_torch.phy import pipeline

    wrap = {"answer_altered": _alter_answer, "half_batch": _half_batch,
            "start_shifted_17": _start_shifted}[fault]
    monkeypatch.setattr(pipeline.OFDMRxPipeline, "forward",
                        wrap(pipeline.OFDMRxPipeline.forward))
    r = run_cpu(root, CELL)
    assert not r["correct"], r["checks"]
    # What was sent catches it alone, without the reference.
    sent = {k: c for k, c in r["checks"].items() if k.startswith("sent_")}
    assert any(c["value"] > c["limit"] for c in sent.values()), sent


def test_a_parent_without_the_light_chain_fails_at_once(root, monkeypatch):
    """A program whose `make_ofdm_rx_pipeline` takes no preamble (the parent of the
    change that added it) fails cleanly, when the entry builds its program."""
    from ria_tpu_torch.phy import pipeline

    build = pipeline.make_ofdm_rx_pipeline

    def without_preamble(cfg, rate, window_samples, ci_bits=None, batch_hint=0,
                         min_sum_factor=0.9375, device="cuda"):
        return build(cfg, rate, window_samples, ci_bits, batch_hint, min_sum_factor, device)

    monkeypatch.setattr(pipeline, "make_ofdm_rx_pipeline", without_preamble)
    with pytest.raises(TypeError):
        run_cpu(root, CELL)


# -- on the card: the control is not correct, the program is ---------------------


SEEDS = [2**31 + 301, 2**31 + 302]


@pytest.mark.cuda
def test_control_fails_and_program_holds(cuda_device, tmp_path):
    from benchmark import calibrate

    torch.backends.cuda.matmul.allow_tf32 = False
    full = copy_root(tmp_path, small=False)
    c = harness.load_cell(full, CELL)
    for row in calibrate.readings(c, SEEDS, cuda_device, control="bf16"):
        assert any(row[k] > lim for k, lim in c.limits.items()), row
    for row in calibrate.readings(c, SEEDS, cuda_device):
        assert all(row[k] <= lim for k, lim in c.limits.items()), row
