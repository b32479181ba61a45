"""The coherent OFDM cell ``ofdm_qam64_r34.gw2048_awgn25`` on the CPU at a
small size (the look for a card skipped): whole runs, its generator and the
reference at that size, the batched pilot TX against the frozen per-frame
TX, and the check failing on an equaliser that is wrong by less than the
decoder can see."""

import numpy as np
import pytest
import torch

from benchmark.tests.conftest import copy_root, run_cpu

CELL = "ofdm_qam64_r34.gw2048_awgn25"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return copy_root(tmp_path_factory.mktemp("checkout"))


@pytest.fixture(scope="module")
def cell(root):
    from benchmark import harness

    return harness.load_cell(root, CELL)


@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct_on_the_cpu(root, trace):
    r = run_cpu(root, CELL, trace=trace)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "checks"
    assert all(c["value"] == 0 for c in r["checks"].values())
    assert set(r["checks"]) == {"sync_mismatch", "cfo_gap_hz", "snr_gap_db", "cw_mismatch",
                                "sent_start_gap", "sent_cw_wrong", "evm_gap"}
    if not trace:
        assert set(r["metrics"]) == {"rx_samples_per_s", "setup_s"}
        assert all(m["value"] > 0 for m in r["metrics"].values())
    else:
        # No device trace on the CPU: the span readers read nothing.
        assert list(r["metrics"]) == ["call_p95_ms.rx"]


def test_generator_repeats_from_its_seed(cell):
    dev = torch.device("cpu")
    a, sa = cell.generator.make_pool(cell.config, cell.traffic, 2**31 + 11, dev)
    b, sb = cell.generator.make_pool(cell.config, cell.traffic, 2**31 + 11, dev)
    d, _ = cell.generator.make_pool(cell.config, cell.traffic, 2**31 + 12, dev)
    assert len(a) == len(sa) == cell.traffic["pool"]
    assert a[0].shape == (cell.traffic["channels"], cell.config["window_samples"])
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(torch.equal(x[k], y[k]) for x, y in zip(sa, sb) for k in x)
    assert not torch.equal(a[0], d[0]) and not torch.equal(a[0], a[1])


def test_reference_decodes_what_was_sent(cell):
    """At 25 dB the plain reference finds every frame at its sent start and
    decodes every codeword to the sent bits, in one iteration."""
    dev = torch.device("cpu")
    pool, sent = cell.generator.make_pool(cell.config, cell.traffic, 5, dev)
    out = cell.entry.reference(cell.config, cell.traffic, dev)(pool[0])
    assert bool(out["detected"].all())
    assert torch.equal(out["start"].long(), sent[0]["start"].long())
    assert bool(out["cw_success"].all())
    assert torch.equal(out["info_bits"], sent[0]["info_bits"])
    assert bool((out["iterations"] == 1).all())
    assert bool(((out["evm"] > 2e-4) & (out["evm"] < 1e-3)).all()), out["evm"]


def test_batched_pilot_tx_is_the_frozen_tx(cell):
    """The generator's OFDM TX over a batch, with the configuration's pilots,
    gives what the frozen per-frame ``tx_frame`` gives, frame by frame."""
    from benchmark import deploy_pilots
    from benchmark.generators import air_pilots
    from benchmark.reference import interleave, ldpc_matrix, ofdm

    wf = ofdm.OFDMConfig(**deploy_pilots.ofdm_kwargs(cell.config))
    assert len(ofdm.carrier_layout(wf)[2]) == 8 and wf.num_data_carriers == 51
    info = np.random.default_rng(1).integers(0, 2, (3 * 4, 486), dtype=np.uint8)
    coded = ldpc_matrix.encode_np(info, cell.config["rate"]).reshape(3, 4, 648)
    got = air_pilots.AIR._ofdm_tx(cell.config, coded, torch.device("cpu")).numpy()
    frames = interleave.frame_interleave(interleave.apply_perm(
        coded, interleave.channel_perm(cell.config["channel_interleave_bits"])))
    want = np.stack([ofdm.tx_frame(f, wf, preamble="cox") for f in frames])
    assert got.shape == want.shape
    assert np.abs(got - want).max() < 1e-5 * np.abs(want).max()


# -- the check fails on an equaliser the decoder cannot see ------------------


def _no_tracking(from_bins):
    """The equaliser without pilot tracking: the ratio to the LTS estimate
    held at 1 on every carrier and symbol, which is the broadcast MMSE of a
    layout with no pilots."""
    return lambda self, Y_data, Y_pilot: from_bins(self, Y_data, None)


def _eq_scaled(from_bins):
    def scaled(self, Y_data, Y_pilot):
        r = from_bins(self, Y_data, Y_pilot)
        return r._replace(symbols=r.symbols * 1.001)
    return scaled


@pytest.mark.parametrize("fault", ["no_tracking", "eq_scaled_1.001", "audio_bf16"])
def test_a_wrong_equaliser_is_not_correct(root, monkeypatch, fault):
    from ria_tpu_torch.phy import pipeline
    from ria_tpu_torch.wave import ofdm

    if fault == "audio_bf16":
        forward = pipeline.OFDMRxPipeline.forward
        monkeypatch.setattr(pipeline.OFDMRxPipeline, "forward",
                            lambda self, audio: forward(self, audio.bfloat16().float()))
    else:
        wrap = _no_tracking if fault == "no_tracking" else _eq_scaled
        monkeypatch.setattr(ofdm.OFDMDemodulator, "from_bins",
                            wrap(ofdm.OFDMDemodulator.from_bins))
    r = run_cpu(root, CELL)
    assert not r["correct"], r["checks"]
    # Every frame still decodes to the sent bits: only the EVM (and, for
    # bf16 audio, the estimates) can see the fault.
    assert r["checks"]["cw_mismatch"]["value"] == 0
    assert r["checks"]["sent_cw_wrong"]["value"] == 0
    if fault != "audio_bf16":
        assert r["checks"]["evm_gap"]["value"] > r["checks"]["evm_gap"]["limit"]
