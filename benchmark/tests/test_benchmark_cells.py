"""Whole runs of each cell on the CPU at a small size (the look for a card
skipped), the generators and the reference at that size, a cell added from
data files alone, and the check failing on a broken program."""

import json

import numpy as np
import pytest
import torch

from benchmark.tests.conftest import copy_root, run_cpu

CELLS = ["mcdpsk_r14.gw256_awgn0", "ofdm_dqpsk_r14.gw1024_awgn10",
         "mcdpsk_r14.decode512_m1db"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return copy_root(tmp_path_factory.mktemp("checkout"))


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_cpu(root, cell, trace):
    r = run_cpu(root, cell, trace=trace)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "checks"
    assert all(c["value"] == 0 for c in r["checks"].values())
    if not trace:
        assert "setup_s" in r["metrics"] and len(r["metrics"]) == 2
        assert all(m["value"] > 0 for m in r["metrics"].values())
    else:
        # No device trace on the CPU: only the host clock's tail is read.
        assert list(r["metrics"]) == ["call_p95_ms.decode" if "decode" in cell
                                      else "call_p95_ms.rx"]
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("cell", CELLS)
def test_generator_repeats_from_its_seed(root, cell):
    from benchmark import harness

    c = harness.load_cell(root, cell)
    a, sa = c.generator.make_pool(c.config, c.traffic, 2**31 + 11, torch.device("cpu"))
    b, sb = c.generator.make_pool(c.config, c.traffic, 2**31 + 11, torch.device("cpu"))
    d, _ = c.generator.make_pool(c.config, c.traffic, 2**31 + 12, torch.device("cpu"))
    assert len(a) == len(sa) == c.traffic["pool"]
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(torch.equal(x[k], y[k]) for x, y in zip(sa, sb) for k in x)
    assert not torch.equal(a[0], d[0]) and not torch.equal(a[0], a[1])


@pytest.mark.parametrize("cell", CELLS)
def test_reference_decodes_what_was_sent(root, cell):
    """At the traffic's SNR the plain reference recovers the sent frames:
    every channel detected at the sent start, every codeword decoded to the
    sent bits (at the decode cell's -1 dB, most of them: some decode to a
    codeword 13 bits from the sent one)."""
    from benchmark import harness

    c = harness.load_cell(root, cell)
    pool, sent = c.generator.make_pool(c.config, c.traffic, 5, torch.device("cpu"))
    out = c.entry.reference(c.config, c.traffic, torch.device("cpu"))(pool[0])
    ok = (out["info_bits"] == sent[0]["info_bits"]).all(dim=-1)
    if "detected" in out:
        assert bool(out["detected"].all())
        assert torch.equal(out["start"].long(), sent[0]["start"].long())
        assert bool(out["cw_success"].all()) and bool(ok.all())
    else:
        assert 0.5 < float(out["cw_success"].float().mean()) < 1.0
        assert float((ok & out["cw_success"]).float().mean()) > 0.5


def test_reference_chain_equals_the_port_on_the_cpu(root):
    """The frozen chain computes what the port's CPU path computes, bit for bit."""
    from benchmark import harness

    for cell in ("mcdpsk_r14.gw256_awgn0", "ofdm_dqpsk_r14.gw1024_awgn10"):
        c = harness.load_cell(root, cell)
        x = c.generator.make_pool(c.config, c.traffic, 9, torch.device("cpu"))[0][1]
        got = c.entry.Program(c.config, c.traffic, torch.device("cpu"))(x)
        want = c.entry.reference(c.config, c.traffic, torch.device("cpu"))(x)
        for k in want:
            assert torch.equal(got[k], want[k]), (cell, k)


def test_batched_ofdm_tx_is_the_frozen_tx(root):
    """The generator's OFDM TX over a batch gives what the frozen per-frame
    ``tx_frame`` gives, frame by frame."""
    from benchmark import deploy, harness
    from benchmark.generators import air
    from benchmark.reference import interleave, ldpc_matrix, ofdm

    c = harness.load_cell(root, "ofdm_dqpsk_r14.gw1024_awgn10")
    info = np.random.default_rng(1).integers(0, 2, (3 * 4, 162), dtype=np.uint8)
    coded = ldpc_matrix.encode_np(info, c.config["rate"]).reshape(3, 4, 648)
    got = air._ofdm_tx(c.config, coded, torch.device("cpu")).numpy()
    wf = ofdm.OFDMConfig(**deploy.ofdm_kwargs(c.config))
    frames = interleave.frame_interleave(interleave.apply_perm(
        coded, interleave.channel_perm(c.config["channel_interleave_bits"])))
    want = np.stack([ofdm.tx_frame(f, wf, preamble="cox") for f in frames])
    assert got.shape == want.shape
    assert np.abs(got - want).max() < 1e-5 * np.abs(want).max()


def test_a_cell_from_data_files_alone(tmp_path):
    """A new cell needs a traffic file, a cell file and BENCHMARK.json's
    entry: no file of the harness changes."""
    root = copy_root(tmp_path)
    here = root / "benchmark"
    (here / "traffic" / "dummy_gw3_awgn12.json").write_text(json.dumps(
        {"generator": "air", "entry": "rx_chain", "channels": 3, "pool": 2, "snr_db": 12.0,
         "max_lead": 3000, "trace_calls": 2, "why": "a dummy"}))
    (here / "workloads" / "ofdm_dqpsk_r14.dummy_gw3_awgn12.json").write_text(json.dumps(
        {"config": "ofdm_dqpsk_r14", "traffic": "dummy_gw3_awgn12",
         "limits": {"sync_mismatch": 0, "cfo_gap_hz": 0.0, "snr_gap_db": 0.0,
                    "cw_mismatch": 0, "sent_start_gap": 16, "sent_cw_wrong": 0}}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "ofdm_dqpsk_r14.dummy_gw3_awgn12",
                               "config": "ofdm_dqpsk_r14", "traffic": "dummy_gw3_awgn12",
                               "chips": 1, "why": "a dummy"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "ofdm_dqpsk_r14.gw1024_awgn10" in m.get("workloads", []):
            m["workloads"].append("ofdm_dqpsk_r14.dummy_gw3_awgn12")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    r = run_cpu(root, "ofdm_dqpsk_r14.dummy_gw3_awgn12")
    assert r["correct"]
    assert set(r["metrics"]) == {"rx_samples_per_s", "setup_s"}


# -- the check fails on a broken program ------------------------------------


def _alter_answer(result):
    bits = result.info_bits.clone()
    bits.view(-1)[0] ^= 1
    return result._replace(info_bits=bits)


def _half_batch(forward):
    """The chain run on the first half of the channels, the rest filled
    from it."""
    def broken(self, audio):
        B = audio.shape[0]
        r = forward(self, audio[: max(B // 2, 1)])
        idx = torch.arange(B) % max(B // 2, 1)
        return type(r)(*(t[idx.to(t.device)] for t in r))
    return broken


@pytest.mark.parametrize("fault", ["answer_altered", "half_batch"])
@pytest.mark.parametrize("cell,cls", [("mcdpsk_r14.gw256_awgn0", "RxPipeline"),
                                      ("ofdm_dqpsk_r14.gw1024_awgn10", "OFDMRxPipeline")])
def test_a_broken_chain_is_not_correct(root, monkeypatch, cell, cls, fault):
    from ria_tpu_torch.phy import pipeline

    forward = getattr(pipeline, cls).forward
    if fault == "answer_altered":
        monkeypatch.setattr(getattr(pipeline, cls), "forward",
                            lambda self, audio: _alter_answer(forward(self, audio)))
    else:
        monkeypatch.setattr(getattr(pipeline, cls), "forward", _half_batch(forward))
    r = run_cpu(root, cell)
    assert not r["correct"], r["checks"]
    # What was sent catches it alone, without the reference.
    sent = {k: c for k, c in r["checks"].items() if k.startswith("sent_")}
    assert any(c["value"] > c["limit"] for c in sent.values()), sent


@pytest.mark.parametrize("fault", ["state_unchanged", "answer_altered", "half_batch"])
def test_a_broken_decoder_is_not_correct(root, monkeypatch, fault):
    from ria_tpu_torch.fec import ldpc

    decode = ldpc.decode_batch

    def broken(llrs, factors, rate, *a, **kw):
        if fault == "state_unchanged":   # BP returns the channel LLRs untouched
            B, k = llrs.shape[0], ldpc.get_code(rate).k
            return ldpc.DecodeResult((llrs[:, :k] < 0).to(torch.uint8),
                                     torch.zeros(B, dtype=torch.bool),
                                     torch.zeros(B, dtype=torch.int32), llrs.clone())
        if fault == "answer_altered":
            return _alter_answer(decode(llrs, factors, rate, *a, **kw))
        half = max(llrs.shape[0] // 2, 1)
        r = decode(llrs[:half], factors[:half], rate, *a, **kw)
        idx = torch.arange(llrs.shape[0]) % half
        return ldpc.DecodeResult(*(t[idx] for t in r))

    monkeypatch.setattr(ldpc, "decode_batch", broken)
    r = run_cpu(root, "mcdpsk_r14.decode512_m1db")
    assert not r["correct"], r["checks"]


def test_the_check_reads_every_kept_call(root):
    """The reservoir keeps KEEP calls beyond each batch's first, drawn from
    the seed, and the same seed keeps the same calls."""
    from benchmark import harness

    def kept(seed):
        k = harness.Keeper(seed)
        for call in range(500):
            k.offer(call % 2, {"x": torch.tensor([call])})
        return [int(o["x"]) for _, o in k.kept()]

    a = kept(3)
    assert len(a) == 2 + harness.KEEP and a[:2] == [0, 1]
    assert a == kept(3) and a != kept(4)
    assert max(a) > 250 and np.unique(a).size == len(a)
