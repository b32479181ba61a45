"""``ria_tpu_torch.parallel`` against ``ria_tpu.parallel`` on the CPU.

The port runs as gloo ranks on the CPU (one process each, started by
``parallel.launch``); the reference runs jitted on a mesh of the conftest's
virtual CPU devices (``make_stream_mesh(4)``, ``make_mesh(4)``).  Both get
the same numpy-seeded data (``tools/parallel_paths.py``): the small geometry
of ``__graft_entry__.dryrun_multichip`` for the batch mesh, the streams,
the FIR and the hybrid mesh, and one production-geometry stream (G3 at
top_k 1, 4 blocks of 192,000 samples).  One launch of 4 ranks runs them
all; one of 8 ranks runs the OFDM stream RX, whose second ladder variant
needs 8.  Each launch has a deadline of its own, so a hang fails its test.

Decisions (detected, start, success, info bits, iterations) are exact; CFO
within 1e-3 Hz and SNR within 1e-3 dB; soft bits within 2e-3, the
reference's own bound between its sharded and single-chip soft bits
(``tests/test_parallel.py``); the FIR within 1e-5 of ``np.convolve``.
Every rank's result is equal to rank 0's: the outputs are replicated.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from ria_tpu.parallel import mesh as JM
from ria_tpu.parallel import stream as JS
from ria_tpu.sync.chirp import ChirpConfig as JChirp
from ria_tpu.wave.mc_dpsk import MCDPSKConfig as JMC
from ria_tpu.wave.ofdm import OFDMConfig as JOFDM
from ria_tpu_torch.parallel.launch import launch
from ria_tpu_torch.tools import parallel_paths as P

torch.set_num_threads(1)

N = 4
DEADLINE_S = 120.0
CFO_TOL = 1e-3
SNR_TOL = 1e-3
SOFT_TOL = 2e-3
FIR_TOL = 1e-5


def _jcfg(cfg):
    """The reference's config equal to the port's ``cfg``."""
    d = dataclasses.asdict(cfg)
    if "chirp" in d:
        return JMC(**{**d, "chirp": JChirp(**d["chirp"])})
    if "num_carriers" in d and "fft_size" in d:
        return JOFDM(**d)
    return JChirp(**d)


def _cases():
    cases, data, sent = P.tiny_cases(N)
    prod_cfg = P.MCDPSKConfig(num_carriers=10, bits_per_symbol=1)
    stream, infos = P.mc_stream(prod_cfg, P.NCW, N * P.STREAM_BLOCK, (P.FRAME_POS,), P.CFO_HZ,
                                10.0, seed=7)
    cases.append(P.Case("G3 production", "stream_rx", (prod_cfg, P.RATE, P.NCW,
                                                       P.STREAM_BLOCK, 1)))
    data["G3 production"] = stream
    sent["G3 production"] = {"positions": (P.FRAME_POS,), "infos": infos}
    return cases, data, sent


@pytest.fixture(scope="module")
def run():
    cases, data, sent = _cases()
    outs = launch(P.run_rank, N, args=(cases, 0),
                  rank_args=[(d,) for d in P.rank_data(cases, data, N)],
                  device="cpu", timeout_s=DEADLINE_S)
    return {c.name: c for c in cases}, data, sent, outs


def _replicated(outs, name):
    """Rank 0's result of ``name``, after holding every rank's equal to it."""
    P.same_on_every_rank(name, [o[name]["result"] for o in outs])
    return outs[0][name]["result"]


def _hold(got: dict, want: dict, exact=(), close=(), soft=()) -> dict:
    """Hold the port's fields against the reference's; the largest errors."""
    errs = {}
    for key in exact:
        assert np.array_equal(np.asarray(got[key]), np.asarray(want[key])), key
    for key in close:
        errs[key] = float(np.max(np.abs(np.asarray(got[key]) - np.asarray(want[key]))))
        assert errs[key] <= (CFO_TOL if key == "cfo_hz" else SNR_TOL), (key, errs[key])
    for key in soft:
        errs[key] = float(np.max(np.abs(np.asarray(got[key]) - np.asarray(want[key]))))
        assert errs[key] <= SOFT_TOL, (key, errs[key])
    return errs


def _jax_dict(out) -> dict:
    out = jax.block_until_ready(out)
    if isinstance(out, dict):
        return {k: np.asarray(v) for k, v in out.items()}
    return {k: np.asarray(v) for k, v in out._asdict().items()}


def _stream_ref(case, stream, n=N):
    cfg, rate, ncw, block, top_k = case.params
    rx = JS.make_stream_rx(JS.make_stream_mesh(n), _jcfg(cfg), rate, ncw, block, top_k=top_k)
    return _jax_dict(rx(stream))


def _check_stream(case, got, want, sent):
    _hold(got, want, exact=("detected", "start", "cw_success", "info_bits"),
          close=("cfo_hz", "snr_db"), soft=("soft_bits",))
    P.check_sent(case, got, sent)


def test_batch_mesh_mc_dpsk(run):
    """G1: make_sharded_rx on a (2 x 2) mesh, 2 rows a rank, 2 codewords a
    frame.  Measured: every field equal, CFO 0 apart, SNR 1.9e-6 dB."""
    cases, data, sent, outs = run
    case = cases["G1"]
    got = _replicated(outs, "G1")
    cfg, rate, ncw, window = case.params
    mesh = JM.make_mesh(N)
    with mesh:
        want = _jax_dict(JM.make_sharded_rx(mesh, _jcfg(cfg), rate, ncw, window)(data["G1"]))
    _hold(got._asdict(), want, exact=("detected", "start", "cw_success", "info_bits",
                                       "iterations"), close=("cfo_hz", "snr_db"))
    P.check_sent(case, got, sent["G1"])


def test_batch_mesh_ofdm(run):
    """G2: make_sharded_ofdm_rx on the 128-point OFDM, 2 rows a rank.
    Measured: every field equal, CFO 1.5e-6 Hz apart, SNR 1.9e-6 dB."""
    cases, data, sent, outs = run
    got = _replicated(outs, "G2")
    cfg, rate, window, ci = cases["G2"].params
    mesh = JM.make_mesh(N)
    with mesh:
        want = _jax_dict(JM.make_sharded_ofdm_rx(mesh, _jcfg(cfg), rate, window, ci)(data["G2"]))
    _hold(got._asdict(), want, exact=("detected", "lts_start", "cw_success", "info_bits",
                                       "iterations"), close=("cfo_hz", "snr_db"))
    P.check_sent(cases["G2"], got, sent["G2"])


@pytest.mark.parametrize("name", ["G3", "G3 top_k=2", "G3 production"])
def test_stream_rx(run, name):
    """G3: make_stream_rx, the frame straddling a block boundary: the small
    geometry at top_k 1 and 2 (two frames, one straddling), and the
    production geometry at top_k 1 (a 16 s stream, +5 Hz CFO, 10 dB).
    Measured: decisions equal, soft bits within 9.1e-6 (5.7e-6 and 8.3e-6
    at the small geometry), CFO 0 apart, SNR within 1.9e-6 dB."""
    cases, data, sent, outs = run
    case = cases[name]
    got = _replicated(outs, name)
    _check_stream(case, got, _stream_ref(case, data[name]), sent[name])


def test_stream_search(run):
    """G4: make_stream_search alone, on the small stream.  Measured:
    detection and start equal, CFO 0 apart."""
    cases, data, sent, outs = run
    chirp, block = cases["G4"].params
    det, start, cfo = _replicated(outs, "G4")
    jdet, jstart, jcfo = jax.block_until_ready(
        JS.make_stream_search(JS.make_stream_mesh(N), _jcfg(chirp), block)(data["G4"]))
    assert bool(det) == bool(jdet) and int(start) == int(jstart)
    assert abs(float(cfo) - float(jcfo)) <= CFO_TOL
    P.check_sent(cases["G4"], (det, start, cfo), sent["G4"])


def _check_ofdm_stream(case, got, want, sent):
    _hold(got, want, exact=("detected", "lts_start", "cw_success", "info_bits"),
          close=("cfo_hz", "snr_db"))
    P.check_sent(case, got, sent)


def test_ofdm_stream_rx(run):
    """G5: make_ofdm_stream_rx on 4 ranks, the preamble straddling the
    first boundary.  Measured: decisions equal, CFO 1.2e-6 Hz apart, SNR
    1.9e-6 dB."""
    cases, data, sent, outs = run
    cfg, rate, block, ci = cases["G5"].params
    got = _replicated(outs, "G5")
    want = _jax_dict(JS.make_ofdm_stream_rx(JS.make_stream_mesh(N), _jcfg(cfg), rate, block,
                                            ci)(data["G5"]))
    _check_ofdm_stream(cases["G5"], got, want, sent["G5"])


def test_ofdm_stream_rx_eight_ranks():
    """G5 on 8 ranks, so that ranks 4-7 decode at the second ladder factor
    (0.75): the one launch of 8 ranks.  Measured: decisions equal, CFO
    1.2e-6 Hz apart, SNR 1.9e-6 dB."""
    n = 8
    case = P.tiny_ofdm_stream_case(n)
    stream, sent = P.tiny_ofdm(n)[3:]
    outs = launch(P.run_rank, n, args=((case,), 0),
                  rank_args=[(d,) for d in P.rank_data([case], {"G5": stream}, n)],
                  device="cpu", timeout_s=DEADLINE_S)
    cfg, rate, block, ci = case.params
    got = _replicated(outs, "G5")
    want = _jax_dict(JS.make_ofdm_stream_rx(JS.make_stream_mesh(n), _jcfg(cfg), rate, block,
                                            ci)(stream))
    _check_ofdm_stream(case, got, want, sent)
    assert [o["G5"]["k1_launches"] for o in outs] == [0] * n  # the CPU decodes with plain


def test_sharded_fir(run):
    """G6: make_sharded_fir, 101-tap bandpass, 3 rows x 4 x 12,000.
    Measured: 3.6e-7 from np.convolve (the reference's sharded FIR 3.6e-7),
    3.3e-7 from the reference's."""
    cases, data, _, outs = run
    taps, block = cases["G6"].params
    got = np.concatenate([o["G6"]["result"] for o in outs], axis=-1)
    x = data["G6"]
    ref = np.stack([np.convolve(r, np.asarray(taps))[: x.shape[1]] for r in x])
    assert np.abs(got - ref).max() < FIR_TOL
    want = np.asarray(JS.make_sharded_fir(JS.make_stream_mesh(N), np.asarray(taps), block)(x))
    assert np.abs(got - want).max() < FIR_TOL


def test_hybrid_mesh(run):
    """G7: the (ch=2, t=2) hybrid mesh: each rank keeps its host's row's
    column block, the row sums cross both axes, and one small frame goes
    through the stream RX on each t line, held against the reference on a
    2-device stream mesh.  Measured: decisions equal, soft bits within
    5.7e-6, SNR 9.5e-7 dB."""
    cases, data, sent, outs = run
    ch, t, cfg, rate, ncw, block = cases["G7"].params
    coords = [tuple(int(c) for c in o["G7"]["result"]["coords"]) for o in outs]
    assert coords == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for o in outs:
        assert o["G7"]["result"]["sums"].tolist() == sent["G7"]["sums"]
    P.same_on_every_rank("G7", [o["G7"]["result"]["stream"] for o in outs])
    got = outs[0]["G7"]["result"]["stream"]
    case = P.Case("G7 stream", "stream_rx", (cfg, rate, ncw, block, 1))
    _check_stream(case, got, _stream_ref(case, data["G7"]["stream"], n=t), sent["G7"])


def test_no_kernel_on_the_cpu(run):
    """On the CPU every decode is the plain decoder: no rank launches K1 or
    K2, and there is nothing for the recorder to hold."""
    _, _, _, outs = run
    for out in outs:
        for name, res in out.items():
            assert res["k1_launches"] == res["k2_launches"] == 0, name
            assert res["k1_calls"] == [] and res["k1_inputs"] == {}, name


@pytest.mark.parametrize("name", ["G1", "G2", "G3", "G3 top_k=2", "G3 production", "G4", "G5",
                                  "G6", "G7"])
def test_sharded_equals_single_process(run, name):
    """Each case against the single-process port on one rank
    (``parallel_paths.single_process``, what ``chip_smoke.py`` phase 4g
    holds the card's ranks to): decisions exact, CFO and SNR within 1e-3,
    soft bits within 2e-3, the FIR within 1e-5.  Measured on the CPU: the
    stream soft bits and CFOs equal, the OFDM batch CFO 2.4e-7 Hz apart
    (two rows a rank against all rows at once), the OFDM stream SNR 3.2e-5
    dB (a slab-assembled spectrum against one FFT of the frame), the FIR
    3.6e-7 from np.convolve."""
    cases, data, _, outs = run
    case = cases[name]
    got = outs[0][name]["result"]
    if case.kind == "fir":
        got = np.concatenate([o[name]["result"] for o in outs], axis=-1)
    P.hold_single(case, got, P.single_process(case, data[name], got, N, "cpu"))


def test_dryrun_multichip_prints_the_reference_lines(capsys):
    """``entry.dryrun_multichip(4)`` on 4 gloo CPU ranks prints the backend
    line and then the reference's four lines word for word (the same
    geometry and seeds: every frame found at its sample, cw decode 1.00)."""
    import __graft_entry__

    from ria_tpu_torch.entry import dryrun_multichip

    dryrun_multichip(N, device="cpu")
    ours = capsys.readouterr().out.strip().splitlines()
    __graft_entry__.dryrun_multichip(N)
    theirs = capsys.readouterr().out.strip().splitlines()
    assert ours[0] == f"dryrun_multichip({N}): {N} ranks, backend gloo, devices {['cpu'] * N}"
    assert ours[1:] == theirs and len(theirs) == 4


def test_scaling_bench_on_the_cpu():
    """``tools/scaling_bench.py --ofdm-stream`` on the CPU: 1 and 2 ranks
    reported as skipped (the OFDM stream RX needs 4), 4 gloo ranks decode
    every codeword; the rows come back as the JSON line has them."""
    from ria_tpu_torch.tools import scaling_bench

    rows = scaling_bench.run(["--device", "cpu", "--ofdm-stream"])
    assert [(r["ranks"], r["backend"], r["decode"]) for r in rows] == [(4, "gloo", 1.0)]
    assert rows[0]["ms"] > 0
