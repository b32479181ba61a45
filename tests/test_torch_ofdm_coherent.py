"""OFDM QAM64 R3/4 with pilot tracking (config #4, the benchmark's
``ofdm_qam64_r34``) through the served chain on the CPU.

The port's chain at four channels gives what the benchmark's frozen plain
chain (``benchmark/reference/chains.OfdmChain``) gives, output by output,
and so does each channel's EVM, read through a forward hook on each chain's
demodulator; the EVM's nearest constellation point, taken axis by axis, is
the nearest of the 64.  The demodulator opens one ``demod.equalize`` and one
``demod.demap`` a call inside ``rx.demod``, which keeps work of its own
before and after them (its device-side range covers the whole stage), and
counts the equaliser path of every call in ``wave/ofdm.EQ_PATHS``.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ria_tpu_torch.utils import trace
from ria_tpu_torch.wave import ofdm

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CELLS = {"qam64": "ofdm_qam64_r34.gw2048_awgn25", "dqpsk": "ofdm_dqpsk_r14.gw1024_awgn10"}
OUTPUTS = ("detected", "start", "cfo_hz", "snr_db", "cw_success", "info_bits", "iterations",
           "evm")

torch.set_num_threads(1)


def _cell(name: str, channels: int = 4):
    """The benchmark's cell ``name`` at ``channels`` a call and one batch."""
    from benchmark import harness

    cell = harness.load_cell(ROOT, CELLS[name])
    cell.traffic = dict(cell.traffic, channels=channels, pool=1)
    return cell


def _batch(cell, seed: int) -> tuple[torch.Tensor, dict]:
    pool, sent = cell.generator.make_pool(cell.config, cell.traffic, seed, torch.device("cpu"))
    return pool[0], sent[0]


@pytest.fixture(scope="module")
def qam64_outputs():
    """(program, reference, sent) outputs of config #4 at 4 channels, two seeds."""
    cell = _cell("qam64")
    program = cell.entry.Program(cell.config, cell.traffic, torch.device("cpu"))
    reference = cell.entry.reference(cell.config, cell.traffic, torch.device("cpu"))
    out = {}
    with torch.no_grad():
        for seed in (3, 2**31 + 77):
            audio, sent = _batch(cell, seed)
            out[seed] = (program(audio), reference(audio), sent)
    return out


@pytest.mark.parametrize("name", OUTPUTS)
@pytest.mark.parametrize("seed", [3, 2**31 + 77])
def test_port_chain_equals_the_frozen_chain(qam64_outputs, seed, name):
    got, want, _ = qam64_outputs[seed]
    assert got[name].dtype == want[name].dtype and torch.equal(got[name], want[name]), name


@pytest.mark.parametrize("seed", [3, 2**31 + 77])
def test_chain_decodes_what_was_sent_and_reads_its_evm(qam64_outputs, seed):
    """At 25 dB every frame is found at its sent start and every codeword
    decodes to the sent bits; the EVM is near 4e-4 on every channel (-34
    dB: noise at 25 dB below the frames over the whole 24 kHz band lies
    about 9.4 dB lower in the 59 carriers' 2.77 kHz)."""
    got, _, sent = qam64_outputs[seed]
    assert bool(got["detected"].all()) and bool(got["cw_success"].all())
    assert torch.equal(got["start"].long(), sent["start"].long())
    assert torch.equal(got["info_bits"], sent["info_bits"])
    assert got["evm"].shape == (4,) and got["evm"].dtype == torch.float32
    assert bool(((got["evm"] > 2e-4) & (got["evm"] < 1e-3)).all()), got["evm"]


def test_evm_takes_the_nearest_of_the_64_points():
    """Over the first 432 carriers in symbol order (2,592 bits at 6 a carrier)."""
    from benchmark.entries.rx_chain_pilots import Evm

    table = torch.as_tensor(ofdm.constellation_table("QAM64"))
    g = torch.Generator().manual_seed(5)
    eq = torch.complex(torch.randn(3, 9, 51, generator=g), torch.randn(3, 9, 51, generator=g))
    eq = eq * 0.9 + table[torch.randint(0, 64, (3, 9, 51), generator=g)]
    demod = torch.nn.Identity()
    evm = Evm(demod, "QAM64", 432)
    demod(ofdm.OFDMDemodResult(*([None] * 5), symbols=eq))
    nearest = table[torch.argmin(torch.abs(eq[..., None] - table), dim=-1)]
    d = torch.square(torch.abs(eq - nearest)).flatten(-2)[..., :432]
    want = d.sum(-1) / torch.square(torch.abs(nearest)).flatten(-2)[..., :432].sum(-1)
    torch.testing.assert_close(evm.read(), want, rtol=1e-5, atol=0)


def _annotations(prof, name):
    kr = prof.profiler.kineto_results
    return sorted((e.start_ns(), e.end_ns()) for e in kr.events() if e.name() == name)


@pytest.mark.parametrize("name", list(CELLS))
def test_equalize_and_demap_nest_once_in_rx_demod(name):
    cell = _cell(name, channels=2)
    program = cell.entry.Program(cell.config, cell.traffic, torch.device("cpu"))
    audio, _ = _batch(cell, 11)
    trace.reset()
    try:
        with torch.no_grad():
            program(audio)
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                program(audio)
        assert {n: trace.count(n) for n in ("rx.demod", "demod.equalize", "demod.demap")} == \
            {"rx.demod": 2, "demod.equalize": 2, "demod.demap": 2}
    finally:
        trace.reset()
    (demod,) = _annotations(prof, "rx.demod")
    (equalize,) = _annotations(prof, "demod.equalize")
    (demap,) = _annotations(prof, "demod.demap")
    assert demod[0] <= equalize[0] <= equalize[1] <= demap[0] <= demap[1] <= demod[1]
    # A profiler ties a kernel to the innermost span, so ``rx.demod`` keeps a
    # device-side range over the whole stage only if work of its own opens
    # and closes it: the slice, downmix and FFT before, the deinterleave
    # gathers after.
    ops = [e.start_ns() for e in prof.profiler.kineto_results.events()
           if e.name().startswith("aten::") and demod[0] <= e.start_ns() <= demod[1]]
    assert any(t < equalize[0] for t in ops) and any(t > demap[1] for t in ops)
    assert any(e.name() == "aten::index" and e.start_ns() > demap[1]
               for e in prof.profiler.kineto_results.events())


@pytest.mark.parametrize("name,path", [("qam64", "pilot_tracking"), ("dqpsk", "common_phase")])
def test_eq_path_counter_of_the_served_chains(name, path):
    cell = _cell(name, channels=2)
    program = cell.entry.Program(cell.config, cell.traffic, torch.device("cpu"))
    audio, _ = _batch(cell, 13)
    before = ofdm.EQ_PATHS.copy()
    with torch.no_grad():
        for _ in range(3):
            program(audio)
    moved = ofdm.EQ_PATHS - before
    assert dict(moved) == {path: 3}


@pytest.mark.parametrize("kw,path", [
    (dict(modulation="QAM64", use_pilots=True, pilot_spacing=8), "pilot_tracking"),
    (dict(modulation="QAM16", use_pilots=True, pilot_spacing=60), "common_phase"),
    (dict(modulation="DQPSK", use_pilots=False), "common_phase"),
    (dict(modulation="QAM16", use_pilots=True, pilot_spacing=8, adaptive_eq=True), "adaptive"),
    (dict(modulation="D8PSK", use_pilots=True, pilot_spacing=10), "d8psk"),
])
def test_eq_path_counter_names_each_path(kw, path):
    """One count a ``from_bins`` call, under the path the configuration
    takes; a single pilot (spacing 60 on 59 carriers) is no tracking."""
    cfg = ofdm.OFDMConfig(**kw)
    _, data_bins, pilot_bins = ofdm.carrier_layout(cfg)
    rng = np.random.default_rng(1)

    def bins(n):
        return None if not n else torch.as_tensor(
            (rng.standard_normal((2, 5, n)) + 1j * rng.standard_normal((2, 5, n)))
            .astype(np.complex64))

    before = ofdm.EQ_PATHS.copy()
    ofdm.demodulate_from_bins(bins(len(data_bins)), bins(len(pilot_bins)), cfg, 3)
    assert dict(ofdm.EQ_PATHS - before) == {path: 1}
