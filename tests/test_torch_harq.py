"""One HARQ round with chase combining (``phy/pipeline.py::make_harq_rx_pipeline``,
``fec/chase.py::chase_round``) on the CPU.

- The round against the benchmark's plain round (``benchmark/reference/
  harq.py``) on seeded audio of config #2 (4x-spread MC-DPSK DBPSK, R1/4)
  at -19 dB on the published 606,688-sample window, where sums rescue
  codewords and one copy is noise alone: every output equal.
- The walk against the host's ``ChaseCache`` driven as
  ``wave/api.py::_chase_combine`` drives it, on seeded LLR sets for 1-4
  copies, with copies whose sync missed.
- Faults that the benchmark's check catches: combining off (the outcome is
  the last copy alone), an undetected copy's LLRs summed, the sum tried
  before the copy alone.
- The round's counter, and the MC-DPSK chain at 4x spreading against
  ``ria_tpu``'s on the same audio.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from ria_tpu.phy.pipeline import make_rx_pipeline as jax_rx_pipeline
from ria_tpu.wave.mc_dpsk import MCDPSKConfig as JConfig
from ria_tpu_torch.entry import _make_batch
from ria_tpu_torch.fec import chase
from ria_tpu_torch.fec.chase import (
    ChaseCache,
    ChaseKey,
    ChaseOutcome,
    chase_round,
    walk_position,
)
from ria_tpu_torch.fec.ldpc import ldpc_decoder, make_encoder
from ria_tpu_torch.fec.ldpc_matrix import RECOMMENDED_ITERS, get_code
from ria_tpu_torch.phy import pipeline
from ria_tpu_torch.phy.pipeline import make_rx_pipeline
from ria_tpu_torch.wave.mc_dpsk import MCDPSKConfig

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CELL = "mcdpsk_s4_r14.harq64x2_m19db"
RATE, NCW, N = "R1_4", 4, 648
FACTOR = 0.75
CPU = torch.device("cpu")
SEED = 2**31 + 2
OUTPUTS = ("detected", "start", "cfo_hz", "snr_db", "cw_success", "info_bits", "iterations",
           "source")


def decode(llrs: torch.Tensor):
    """The round's decoder on the CPU: the plain decoder, K1's computation."""
    factors = torch.full((llrs.shape[0],), FACTOR, dtype=torch.float32)
    return ldpc_decoder(RATE, RECOMMENDED_ITERS[RATE], CPU)(llrs, factors)


def host_walk(llrs, received, decode, *, sum_first=False, sum_missed=False) -> ChaseOutcome:
    """The round's outcome as a gateway's host cache gives it: each channel's
    received copies handed in arrival order to a :class:`ChaseCache` as
    ``wave/api.py::_chase_combine`` hands it a frame's codewords (one that
    decodes alone is marked decoded; one that fails is stored and, from its
    second store on, its sum decoded), the first success kept and, where
    none came, the last decode tried.

    Faults: ``sum_first``, the sum decoded before the copy alone (every
    codeword not yet decoded is stored first); ``sum_missed``, a copy whose
    sync missed is stored and summed as well."""
    B, R, ncw, n = llrs.shape
    k = get_code(RATE).k
    ok = torch.zeros((B, ncw), dtype=torch.bool)
    bits = torch.zeros((B, ncw, k), dtype=torch.uint8)
    its = torch.zeros((B, ncw), dtype=torch.int32)
    src = torch.full((B, ncw), -1, dtype=torch.int8)
    for b in range(B):
        cache, key = ChaseCache(clock=lambda: 0.0), ChaseKey(0, 1, 2)
        first = None

        def settle(i, d, j, pos):
            if not ok[b, i]:
                bits[b, i], its[b, i] = d.info_bits[j], d.iterations[j]
                if d.success[j]:
                    ok[b, i], src[b, i] = True, pos

        for r in range(R):
            got = bool(received[b, r])
            alone = decode(llrs[b, r]) if got or r == 0 else None
            if r == 0:
                first = alone     # copy 1 alone: the outcome where nothing was tried
                bits[b], its[b] = alone.info_bits, alone.iterations
            if got and not sum_first:
                for i in range(ncw):
                    settle(i, alone, i, walk_position(r, False))
            rows, idx = [], []
            for i in range(ncw):
                if (ok[b, i] if sum_first else got and alone.success[i]):
                    cache.mark_decoded(key, i)
                    continue
                if not (got or sum_missed):
                    continue
                cache.store(key, i, llrs[b, r, i].numpy(), ncw, 0)
                acc = cache.get_combined(key, i)
                if acc is not None and cache.get_combine_count(key, i) > 1:
                    rows.append(acc)
                    idx.append(i)
            if rows:
                s = decode(torch.from_numpy(np.stack(rows)))
                for j, i in enumerate(idx):
                    settle(i, s, j, walk_position(r, True))
            if got and sum_first:
                for i in range(ncw):
                    settle(i, alone, i, walk_position(r, False))
        assert first is not None
    return ChaseOutcome(ok, bits, its, src)


def last_alone(llrs, received, alone) -> ChaseOutcome:
    """Combining off: the outcome is the last copy decoded alone."""
    B, R, ncw, _ = llrs.shape
    k = alone.info_bits.shape[-1]
    ok = alone.success.reshape(B, R, ncw)[:, -1] & received[:, -1:]
    src = torch.where(ok, walk_position(R - 1, False), -1).to(torch.int8)
    return ChaseOutcome(ok, alone.info_bits.reshape(B, R, ncw, k)[:, -1],
                        alone.iterations.reshape(B, R, ncw)[:, -1], src)


def _equal(a: ChaseOutcome, b: ChaseOutcome) -> None:
    for name, x, y in zip(a._fields, a, b):
        assert x.dtype == y.dtype and torch.equal(x, y), name


# -- the round against the plain reference, on audio ------------------------


@pytest.fixture(scope="module")
def cell():
    from benchmark import harness

    c = harness.load_cell(ROOT, CELL)
    c.traffic.update(channels=4, pool=1)
    return c


@pytest.fixture(scope="module")
def batch(cell):
    """4 channels x 2 copies at -19 dB; channel 0's second copy is noise alone."""
    pool, sent = cell.generator.make_pool(cell.config, cell.traffic, SEED, CPU)
    audio = pool[0].clone()
    g = torch.Generator().manual_seed(7)
    audio[0, 1] = torch.randn(audio.shape[-1], generator=g) * audio[0, 0].std()
    return audio, sent[0]


@pytest.fixture(scope="module")
def want(cell, batch):
    with torch.no_grad():
        return cell.entry.reference(cell.config, cell.traffic, CPU)(batch[0])


def _run(cell, audio):
    with torch.no_grad():
        return cell.entry.Program(cell.config, cell.traffic, CPU)(audio)


def test_round_equals_the_plain_reference(cell, batch, want):
    audio, sent = batch
    got = _run(cell, audio)
    for name in OUTPUTS:
        assert got[name].dtype == want[name].dtype and torch.equal(got[name], want[name]), name
    numbers = cell.entry.compare([got], [want], [sent])
    assert numbers["cw_mismatch"] == 0 and numbers["sync_mismatch"] == 0
    assert all(v <= cell.limits[k] for k, v in numbers.items()), numbers
    # What the round is for: sums rescue codewords that no copy decodes
    # alone; channel 0, left with one copy, keeps a codeword it cannot decode.
    assert want["detected"].tolist() == [[True, False]] + [[True, True]] * 3
    assert bool((got["source"] == walk_position(1, True)).any())
    assert bool((got["source"] == walk_position(0, False)).any())
    assert bool((got["source"][0] == -1).any())
    ok = got["cw_success"] & (got["info_bits"] == sent["info_bits"]).all(dim=-1)
    assert bool(ok[1:].all()), got["source"]


@pytest.mark.parametrize("fault", ["combining_off", "undetected_summed", "sum_first"])
def test_a_wrong_walk_is_not_correct(cell, batch, want, monkeypatch, fault):
    if fault == "combining_off":
        monkeypatch.setattr(pipeline, "chase_round",
                            lambda llrs, received, alone, dec: last_alone(llrs, received, alone))
    else:
        kw = {"sum_missed": True} if fault == "undetected_summed" else {"sum_first": True}
        monkeypatch.setattr(pipeline, "chase_round",
                            lambda llrs, received, alone, dec: host_walk(llrs, received, dec,
                                                                         **kw))
    got = _run(cell, batch[0])
    numbers = cell.entry.compare([got], [want], [batch[1]])
    assert numbers["cw_mismatch"] > 0, numbers
    assert numbers["sync_mismatch"] == 0


def test_host_walk_is_the_reference_walk(cell, batch, want, monkeypatch):
    """The host cache's walk, in the round's place, gives the reference's
    outcome: the fault controls above differ from the right walk only where
    they say."""
    monkeypatch.setattr(pipeline, "chase_round",
                        lambda llrs, received, alone, dec: host_walk(llrs, received, dec))
    got = _run(cell, batch[0])
    for name in OUTPUTS:
        assert torch.equal(got[name], want[name]), name


# -- the walk against the host cache, on LLR sets -----------------------------


def _llr_sets(copies: int, seed: int) -> torch.Tensor:
    """[6, copies, 4, 648] LLRs of BPSK codewords, every channel's copies of
    the same codewords under independent noise, some copies weaker than
    others, so that copies fail alone and sums rescue them."""
    rng = np.random.default_rng(seed)
    B = 6
    info = rng.integers(0, 2, (B * NCW, get_code(RATE).k), dtype=np.uint8)
    coded = make_encoder(RATE, "cpu")(torch.as_tensor(info)).numpy().reshape(B, 1, NCW, N)
    sigma = rng.uniform(1.05, 1.55, (B, copies, NCW, 1))
    y = (1.0 - 2.0 * coded) + sigma * rng.standard_normal((B, copies, NCW, N))
    return torch.as_tensor((2.0 * y / sigma**2).astype(np.float32))


RECEIVED = {   # each channel's copies found by the sync
    1: [[1], [1], [0], [1], [1], [1]],
    2: [[1, 1], [0, 1], [1, 0], [0, 0], [1, 1], [1, 1]],
    3: [[1, 1, 1], [0, 1, 1], [1, 0, 1], [1, 1, 0], [0, 0, 1], [1, 1, 1]],
    4: [[1, 1, 1, 1], [0, 1, 1, 1], [1, 0, 1, 1], [1, 1, 1, 0], [0, 1, 0, 1], [1, 1, 1, 1]],
}


@pytest.mark.parametrize("copies", [1, 2, 3, 4])
def test_walk_equals_the_host_cache(copies):
    llrs = _llr_sets(copies, 100 + copies)
    received = torch.tensor(RECEIVED[copies], dtype=torch.bool)
    alone = decode(llrs.reshape(-1, N))
    got = chase_round(llrs, received, alone, decode)
    _equal(got, host_walk(llrs, received, decode))
    # The sets reach what they are for: failures alone, and (from two
    # copies on) sums that rescue.
    assert bool((~alone.success).any())
    if copies > 1:
        sums = [walk_position(r, True) for r in range(1, copies)]
        assert bool(torch.isin(got.source, torch.tensor(sums, dtype=torch.int8)).any())


def test_walk_positions():
    assert [walk_position(0, False), walk_position(1, False), walk_position(1, True),
            walk_position(2, False), walk_position(2, True), walk_position(3, False),
            walk_position(3, True)] == list(range(7))


def test_a_channel_with_no_copy_received_decodes_nothing():
    llrs = _llr_sets(2, 7)
    received = torch.zeros((6, 2), dtype=torch.bool)
    alone = decode(llrs.reshape(-1, N))
    got = chase_round(llrs, received, alone, decode)
    assert not bool(got.cw_success.any()) and bool((got.source == -1).all())
    # The outcome is copy 1's decode alone, its success withheld.
    assert torch.equal(got.info_bits, alone.info_bits.reshape(6, 2, NCW, -1)[:, 0])
    assert torch.equal(got.iterations, alone.iterations.reshape(6, 2, NCW)[:, 0])
    _equal(got, host_walk(llrs, received, decode))


@pytest.mark.parametrize("copies", [0, 5])
def test_copies_past_the_cache_are_refused(copies):
    with pytest.raises(ValueError):
        pipeline.make_harq_rx_pipeline(MCDPSKConfig(spreading=4), RATE, NCW, 606688, copies,
                                       device="cpu")
    llrs = torch.zeros((1, copies, NCW, N))
    alone = decode(llrs.reshape(-1, N))
    with pytest.raises(ValueError):
        chase_round(llrs, torch.ones((1, copies), dtype=torch.bool), alone, decode)


def test_counter_counts_rounds_copies_and_sum_rows():
    llrs = _llr_sets(3, 11)
    received = torch.tensor(RECEIVED[3], dtype=torch.bool)
    alone = decode(llrs.reshape(-1, N))
    chase.CHASE_ROUNDS.clear()
    calls = []
    chase_round(llrs, received, alone, lambda x: calls.append(x.shape[0]) or decode(x))
    chase_round(llrs[:2, :1], received[:2, :1], decode(llrs[:2, :1].reshape(-1, N)), decode)
    assert calls == [6 * NCW, 6 * NCW]      # one decode a sum, at fixed width
    assert dict(chase.CHASE_ROUNDS) == {"rounds": 2, "copies": 6 * 3 + 2,
                                        "sum_rows": 2 * 6 * NCW}


# -- the chain at 4x spreading against ria_tpu ----------------------------------


def test_spread4_chain_matches_jax():
    """``make_rx_pipeline`` at config #2's waveform (4x spreading) and
    window, 2 channels at leads in [0, 8000) under extra noise so that BP
    iterates: every output equal to ``ria_tpu``'s on the same audio, the
    estimates within 1e-3."""
    cfg = MCDPSKConfig(num_carriers=10, bits_per_symbol=1, spreading=4)
    window = cfg.frame_samples(NCW * N) + 12000
    assert window == 606688
    audio, info = _make_batch(cfg, NCW, 2, window, seed=3, production=True, device="cpu")
    audio += torch.as_tensor(
        np.random.default_rng(5).normal(0, 1.5, audio.shape).astype(np.float32))
    got = make_rx_pipeline(cfg, RATE, NCW, window, device="cpu")(audio)
    want = jax_rx_pipeline(JConfig(num_carriers=10, bits_per_symbol=1, spreading=4), RATE,
                           NCW, window)(audio.numpy())
    for name in ("detected", "start", "cw_success", "info_bits", "iterations"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape and np.array_equal(g, w), name
    for name in ("cfo_hz", "snr_db"):
        assert np.allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                           rtol=0, atol=1e-3), name
    assert got.detected.all() and got.cw_success.all()
    assert np.array_equal(got.info_bits.numpy(), info)
    assert bool((got.iterations > 1).any())
