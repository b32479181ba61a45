"""The port's acceptance sweep (``ria_tpu_torch/tools/acceptance_sweep.py``)
on the CPU against the reference tool's (``tools/acceptance_sweep.py``).

Its fourteen cases are the reference ``main``'s, read from inside it; each
case at ``--seeds 2`` through both tools' ``run_case``, the port fed the
reference's ``jax.random`` keys (``PRNGKey(1000 + s)``): every seed's outcome
equal, and where the frame decoded, its bytes.
"""

import pytest
import torch

from test_torch_tools import replayed_draws
from ria_tpu_torch.tools import acceptance_sweep as A

torch.set_num_threads(1)

SEEDS = 2


def _reference_cases(monkeypatch) -> list[dict]:
    """The cases the reference ``main`` runs, with the waveform each builds."""
    import tools.acceptance_sweep as ref

    cases = []

    def record(name, make_wf, payload, snr_db, channel_name, seeds, fixed_rate=None,
               min_pass=None):
        cases.append({"name": name, "wf": make_wf(), "payload": payload, "snr_db": snr_db,
                      "channel": channel_name, "seeds": seeds, "fixed_rate": fixed_rate,
                      "min_pass": min_pass})
        return True

    monkeypatch.setattr(ref, "run_case", record)
    assert ref.main(["--seeds", "5"]) == 0
    return cases


def test_the_cases_are_the_reference_tools(monkeypatch):
    ref_cases = _reference_cases(monkeypatch)
    assert len(ref_cases) == len(A.CASES) == 14
    for want, case in zip(ref_cases, A.CASES):
        wf = A.make_waveform(case, "cpu")
        assert (case.name, case.snr_db, case.channel) == (want["name"], want["snr_db"],
                                                          want["channel"])
        assert want["payload"] == A.PAYLOAD
        assert (case.rate if case.fixed_frame else None) == want["fixed_rate"]
        assert case.need(5) == (5 if want["min_pass"] is None else want["min_pass"])
        assert type(wf).__name__ == type(want["wf"]).__name__
        assert repr(wf.cfg) == repr(want["wf"].cfg), case.name


def _reference_run(case: A.Case) -> list:
    """The reference ``run_case`` of ``case`` at SEEDS seeds -> each seed's
    ``RxFrame``."""
    import tools.acceptance_sweep as ref
    from ria_tpu.phy.frame_v2 import WaveformMode
    from ria_tpu.wave.api import create_waveform

    seen = []

    def make_wf():
        kw = {"spreading": case.spreading} if case.spreading > 1 else {}
        wf = create_waveform(WaveformMode[case.mode], case.modulation, case.rate, **kw)
        rx_frame = wf.rx_frame

        def rx_seen(*a, **k):
            seen.append(rx_frame(*a, **k))
            return seen[-1]

        wf.rx_frame = rx_seen
        return wf

    ref.run_case(case.name, make_wf, A.PAYLOAD, case.snr_db, case.channel, SEEDS,
                 fixed_rate=case.rate if case.fixed_frame else None,
                 min_pass=case.need(SEEDS) if case.one_outage else None)
    return seen


@pytest.mark.parametrize("case", A.CASES, ids=[c.name for c in A.CASES])
def test_case_matches_the_reference_tool(case, capsys):
    want = _reference_run(case)
    ref_line = capsys.readouterr().out
    got = A.run_case(case, SEEDS, "cpu", replayed_draws)
    assert capsys.readouterr().out == ref_line
    assert [rx.ok for rx in want] == [f is not None for f in got["frames"]]
    for s, rx in enumerate(want):
        if rx.ok:
            assert got["frames"][s] == rx.frame_bytes, (case.name, s)
    assert got["passes"] == int(ref_line.split()[-2].split("/")[0])
