"""The port's public entry points run on the card unless asked for the CPU.

Each entry point is called with no ``device``.  Without a card the call
must raise instead of running on the host; with one, its result must lie on
the card.  Whether a card is present is decided inside the test.
"""

import importlib

import numpy as np
import pytest
import torch

from ria_tpu_torch.entry import (RATE, _make_ofdm_batch, bench_batches, entry, geometry,
                                 ofdm_geometry)
from ria_tpu_torch.fec import ldpc as T
from ria_tpu_torch import cli
from ria_tpu_torch.phy import frame_v2
from ria_tpu_torch.phy import adaptive, station
from ria_tpu_torch.protocol.engine import ProtocolEngine
from ria_tpu_torch.runtime import host_interface, tui
from ria_tpu_torch.phy.modem import AudioBuffer, MCDPSKModem
from ria_tpu_torch.phy.pipeline import make_ofdm_rx_pipeline, make_rx_pipeline, make_tx_pipeline
from ria_tpu_torch.sim import channel as sim_channel
from ria_tpu_torch.sim import continuous, simulator
from ria_tpu_torch.sync import css, zc
from ria_tpu_torch.tools import dual_modem_tcp, waveform_paths
from ria_tpu_torch.utils import cuda_kernels
from ria_tpu_torch.wave import afdm, api, dpsk, mfsk, ofdm, otfs
from ria_tpu_torch import entry as entry_mod
from ria_tpu_torch.parallel import distributed, launch, mesh as pmesh, stream as pstream
from ria_tpu_torch.tools import parallel_paths, scaling_bench

torch.set_num_threads(1)


def _rx_pipeline():
    cfg, ncw, _, window = geometry()
    return make_rx_pipeline(cfg, RATE, ncw, window).decoder.row_idx


def _tx_pipeline():
    cfg, ncw, _, _ = geometry()
    return make_tx_pipeline(cfg, ncw).synth_t


def _ofdm_rx_pipeline():
    g = ofdm_geometry(4)
    return make_ofdm_rx_pipeline(g.cfg, g.rate, g.window, g.ci_bits).frame_idx


def _decode_fixed_frame():
    rate = "R1_2"
    bits = frame_v2.encode_fixed_frame(b"hello", rate, 118)
    return frame_v2.decode_fixed_frame((1.0 - 2.0 * bits) * 4.0, rate, 118)[0]


CFG3 = ofdm.OFDMConfig()

CALLS = {
    "entry": lambda: entry()[1][0],
    "make_rx_pipeline": _rx_pipeline,
    "make_tx_pipeline": _tx_pipeline,
    "LDPCCodec": lambda: T.LDPCCodec("R1_2").device,
    "make_decoder": lambda: T.make_decoder("R1_2")(
        torch.zeros((1, 648), device="cuda")).llr_total,
    "decode_batch": lambda: T.decode_batch(np.zeros((2, 648), np.float32),
                                           np.full(2, 0.75, np.float32), "R1_2").success,
    "make_ofdm_rx_pipeline": _ofdm_rx_pipeline,
    "_make_ofdm_batch": lambda: _make_ofdm_batch(ofdm_geometry(3), 1)[0],
    "SchmidlCoxDetector": lambda: ofdm.SchmidlCoxDetector(CFG3, 20000).lts_fft,
    "LTSDetector": lambda: ofdm.LTSDetector(CFG3, 9000).lts_fft,
    "OFDMDemodulator": lambda: ofdm.OFDMDemodulator(CFG3, 4).t,
    "decode_fixed_frame": _decode_fixed_frame,
    "decode_codewords": lambda: frame_v2.decode_codewords(np.zeros((1, 648), np.float32))[0],
    "bench_batches": lambda: bench_batches().ldpc.variants[0],
    "ZCDetector": lambda: zc.ZCDetector(zc.ZCConfig(), 9000).tmpl_fft,
    "zc_detector": lambda: zc.zc_detector(zc.ZCConfig(), 9000).t,
    "CSSDetector": lambda: css.CSSDetector(css.CSSConfig(), 60000).tmpl_fft,
    "BarkerDetector": lambda: dpsk.BarkerDetector(dpsk.DPSKConfig(), 90000).mixer,
    "DPSKDemodulator": lambda: dpsk.DPSKDemodulator(dpsk.DPSKConfig(), 64).mixer,
    "MFSKPreambleDetector": lambda: mfsk.MFSKPreambleDetector(mfsk.MFSKConfig(), 40000).bank,
    "MFSKDemodulator": lambda: mfsk.MFSKDemodulator(mfsk.MFSKConfig(), 48).bank,
    "OTFSDemodulator": lambda: otfs.OTFSDemodulator(otfs.OTFSConfig()).t,
    "make_path_batch": lambda: waveform_paths.make_path_batch("otfs_eq", 1).inputs[0],
    "create_waveform": lambda: api.create_waveform(frame_v2.WaveformMode.MC_DPSK).device,
    "create_waveform[AFDM]": lambda: api.create_waveform(frame_v2.WaveformMode.AFDM).device,
    "MCDPSKWaveform": lambda: api.MCDPSKWaveform().device,
    "OFDMChirpWaveform": lambda: api.OFDMChirpWaveform().device,
    "OFDMCoxWaveform": lambda: api.OFDMCoxWaveform().device,
    "OTFSWaveform": lambda: api.OTFSWaveform().device,
    "MFSKWaveform": lambda: api.MFSKWaveform().device,
    "DPSKWaveform": lambda: api.DPSKWaveform().device,
    "AFDMWaveform": lambda: afdm.AFDMWaveform().device,
    "MCDPSKModem": lambda: MCDPSKModem().device,
    "AudioBuffer": lambda: AudioBuffer(np.zeros(8, np.float32)).samples,
    "_control_crc_gate": lambda: _gate_launches(),
    "Station": lambda: station.Station("W1AW").handshake_wf.device,
    "DualStationSim": lambda: simulator.DualStationSim().state["ab"].last_rms,
    "GeneratorDraws": lambda: sim_channel.GeneratorDraws(1).init()["h1"],
    "init_channel_state": lambda: sim_channel.init_channel_state(
        sim_channel.poor(), {"h1": np.zeros(2), "h2": np.zeros(2)}).h1,
    "apply_channel": lambda: sim_channel.apply_channel(
        np.ones(64, np.float32), sim_channel.awgn(), {"noise": np.zeros(64)}).samples,
    "apply_channel_stream": lambda: _stream_block(),
    "tx_post_process": lambda: _launch_free(adaptive.tx_post_process(np.ones(64, np.float32))),
    "afdm.modulate_block": lambda: _launch_free(afdm.modulate_block(
        np.ones(64, np.complex64), afdm.AFDMConfig())),
    "DualModemTcp": lambda: _dual_modem(),
    "ContinuousAudioSimulator": lambda: continuous.ContinuousAudioSimulator(
        sim_channel.awgn()).bravo.handshake_wf.device,
    "TuiApp[sim]": lambda: tui.TuiApp(sim_channel=sim_channel.awgn()).station.handshake_wf.device,
    "TuiApp[audio]": lambda: tui.TuiApp().station.handshake_wf.device,
    "HostInterface.RAWTX": lambda: _rawtx(),
    "cli gui": lambda: _cli_gui(),
    "initialize": lambda: (distributed.initialize(), distributed.rank_device("cuda"))[1],
    "make_mesh": lambda: pmesh.make_mesh().device,
    "make_hybrid_mesh": lambda: distributed.make_hybrid_mesh().device,
    "make_stream_mesh": lambda: pstream.make_stream_mesh().device,
    "make_sharded_rx": lambda: _sharded_rx(),
    "make_stream_rx": lambda: _stream_rx(),
    "launch": lambda: launch.launch(parallel_paths.where, 1)[0],
    "dryrun_multichip": lambda: _dryrun(),
}


def _sharded_rx():
    """The batch mesh of one rank, built with no ``device``: its result lies
    on the card."""
    cfg, ncw, _, window = geometry()
    rx = pmesh.make_sharded_rx(pmesh.make_mesh(), cfg, RATE, ncw, window)
    return rx(np.zeros((1, window), np.float32)).snr_db


def _stream_rx():
    cfg, ncw, _, _ = geometry()
    block, _ = parallel_paths.tiny_stream_geometry(cfg, ncw, 1)
    rx = pstream.make_stream_rx(pstream.make_stream_mesh(), cfg, RATE, ncw, block)
    return rx(np.zeros(block, np.float32))["snr_db"]


def _dryrun():
    """The dry run on 4 ranks with no ``device``: each rank's device is a
    card (the result holds rank 0's program results)."""
    import contextlib
    import io

    with contextlib.redirect_stdout(io.StringIO()):
        entry_mod.dryrun_multichip(4)
    return launch.launch(parallel_paths.where, 1)[0]


def _dual_modem():
    dm = dual_modem_tcp.DualModemTcp(sim_channel.awgn(), base_port_a=0, base_port_b=0)
    try:
        return dm.sim.alpha.handshake_wf.device
    finally:
        dm.close()


def _rawtx():
    """A host interface over a station built with no ``device``: RAWTX's
    waveform lies where the station's do."""
    st = station.Station("W1AW")
    made = []
    inner = api.create_waveform
    api.create_waveform = lambda *a, **kw: made.append(inner(*a, **kw)) or made[-1]
    hi = host_interface.HostInterface(ProtocolEngine(conn=st.conn), station=st,
                                      command_port=0, data_port=0)
    try:
        assert hi.handle_command("RAWTX MC_DPSK DBPSK R1_4 hi") == "OK"
    finally:
        api.create_waveform = inner
        hi.close()
    return made[0].device


def _cli_gui():
    """``gui --sim --frames 1`` with no --device: the console's stations lie
    on the card."""
    import contextlib
    import io

    made = []
    inner = tui.TuiApp
    tui.TuiApp = lambda *a, **kw: made.append(inner(*a, **kw)) or made[-1]
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            assert cli.main(["gui", "--sim", "--frames", "1"]) == 0
    finally:
        tui.TuiApp = inner
    return made[0].station.handshake_wf.device


def _stream_block():
    cfg = sim_channel.awgn()
    state = sim_channel.init_channel_state(cfg, {"h1": np.zeros(2), "h2": np.zeros(2)})
    return sim_channel.apply_channel_stream(np.ones(64, np.float32), cfg, state,
                                            {"noise": np.zeros(64)})[0].samples


def _gate_launches():
    """The gate's rescue decode runs on the card: a host result."""
    ok, _ = api._control_crc_gate(None, np.zeros(648, np.float32), "R1_4")
    return np.asarray(ok)


def _launch_free(_):
    """A host result of a call that decodes nothing: only the device rule
    (no card, no result) is held."""
    return torch.device("cuda")


@pytest.mark.parametrize("cmd", [["info"], ["ptx", "ping"], ["prx", "-"]])
def test_cli_defaults_to_the_card(cmd, capsys, tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            cli.main(cmd)
        return
    if cmd == ["info"]:
        assert cli.main(cmd) == 0
        assert "cuda" in capsys.readouterr().out
        return
    # The command itself, with no --device: every waveform it builds lies on
    # the card (ptx writes a PING, prx reads that file in place of stdin).
    made = []
    inner = cli.create_waveform
    monkeypatch.setattr(cli, "create_waveform",
                        lambda *a, **kw: made.append(inner(*a, **kw)) or made[-1])
    f32 = str(tmp_path / "ping.f32")
    assert cli.main(["ptx", "ping", "-o", f32]) == 0
    if cmd[0] == "prx":
        made.clear()
        assert cli.main(["prx", f32, "-w", "MC_DPSK"]) == 0
        assert "type=PING" in capsys.readouterr().out
    assert made and all(wf.device.type == "cuda" for wf in made)


@pytest.mark.parametrize("name", list(CALLS))
def test_default_device_is_the_card(name):
    if torch.cuda.is_available():
        before = cuda_kernels.launches("ldpc_bp_decode")
        got = CALLS[name]()
        if isinstance(got, np.ndarray):  # a host result: decoded by K1 on the card
            assert cuda_kernels.launches("ldpc_bp_decode") > before
            return
        assert (got if isinstance(got, torch.device) else got.device).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            CALLS[name]()


@pytest.mark.parametrize("argv", [[], ["--stream"], ["--ofdm-stream"]])
def test_scaling_bench_defaults_to_the_card(argv, monkeypatch):
    """``tools/scaling_bench.py`` with no ``--device`` runs its ranks on the
    card: without one it raises before starting any; with one, the device
    it hands ``launch`` is the card (the launches themselves are not run
    here)."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            scaling_bench.run(argv)
        return
    seen = []

    def stop(case, x, n, reps, device, backend):
        seen.append(device)
        raise StopIteration

    monkeypatch.setattr(scaling_bench, "_time", stop)
    with pytest.raises(StopIteration):
        scaling_bench.run(argv)
    assert seen and seen[0].type == "cuda"


# The root tools' twins, each with short arguments; without --device each
# must reach the card.
TOOLS = {
    "verify_cfo_chain": [],
    "profile_acquisition": ["--batch", "1", "--iters", "1"],
    "acceptance_sweep": ["--seeds", "1"],
    "otfs_mode_sweep": ["--seeds", "1"],
    "throughput_test": [],
    "goodput": ["--seeds", "1"],
    "adaptive_session_sweep": ["--snrs", "12"],
    "bench_profile": [],
    "bench": ["--iters", "1", "--trials", "1", "--windows", "2", "--serving-calls", "1"],
}


@pytest.mark.parametrize("tool", list(TOOLS))
def test_tool_defaults_to_the_card(tool, monkeypatch):
    """``python -m ria_tpu_torch.tools.<tool>`` with no ``--device``: without
    a card it raises before any work; with one, the device it resolves (and
    hands to everything it builds) is the card (the tool is stopped there)."""
    mod = importlib.import_module(f"ria_tpu_torch.tools.{tool}")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            mod.main(TOOLS[tool])
        return
    seen = []
    resolve = mod.resolve_device

    def stop(device):
        seen.append(resolve(device))
        raise StopIteration

    monkeypatch.setattr(mod, "resolve_device", stop)
    with pytest.raises(StopIteration):
        mod.main(TOOLS[tool])
    assert seen and seen[0].type == "cuda"
