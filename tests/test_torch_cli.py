"""The port's CLI on the CPU (``--device cpu``): the cases of
tests/test_cli.py, the port's ``ptx`` files against the reference's (within
1e-5) and decoded by the reference's ``prx``, the reference's ``ptx`` files
decoded by the port's ``prx``, pure noise, ``monitor`` against the
reference's, and the session simulator's command line.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ria_tpu.cli import main as j_main
from ria_tpu_torch.cli import main as t_main

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]
AUTODETECTED = ("MC_DPSK", "OFDM_CHIRP", "OFDM_COX", "OTFS_EQ")


def test_info(capsys):
    assert t_main(CPU + ["info"]) == 0
    out = capsys.readouterr().out
    assert "MC-DPSK" in out and "OFDM" in out and "cpu" in out
    assert t_main(["info", "--device", "cpu"]) == 0        # after the sub-command too


def test_ptx_prx_roundtrip(tmp_path, capsys):
    f32 = tmp_path / "tx.f32"
    assert t_main(CPU + ["ptx", "cli loopback test", "-s", "W1AW", "-d", "VE3ABC",
                         "-o", str(f32)]) == 0
    assert f32.stat().st_size > 0
    assert t_main(CPU + ["prx", str(f32)]) == 0
    out = capsys.readouterr().out
    assert "cli loopback test" in out and "type=DATA" in out and "snr=" in out


@pytest.mark.parametrize("what,expect", [("connect", "CONNECT"), ("disconnect", "DISCONNECT")])
def test_ptx_connect_frames(what, expect, tmp_path, capsys):
    f32 = tmp_path / "conn.f32"
    assert t_main(CPU + ["ptx", what, "-s", "W1AW", "-d", "VE3ABC", "-o", str(f32)]) == 0
    assert t_main(CPU + ["prx", str(f32)]) == 0
    out = capsys.readouterr().out
    assert f"type={expect}" in out and "W1AW" in out and "VE3ABC" in out


@pytest.mark.parametrize("wfn", AUTODETECTED)
def test_prx_waveform_autodetect(wfn, tmp_path, capsys):
    f32 = tmp_path / f"ad_{wfn}.f32"
    assert t_main(CPU + ["ptx", f"autodetect {wfn}", "-s", "W1AW", "-d", "VE3ABC",
                         "-w", wfn, "-o", str(f32)]) == 0
    assert t_main(CPU + ["prx", str(f32)]) == 0
    cap = capsys.readouterr()
    assert f"autodetect {wfn}" in cap.out, (wfn, cap.out)
    assert f"waveform={wfn}" in cap.err, (wfn, cap.err)


@pytest.mark.parametrize("wfn,extra", [("OTFS_RAW", []), ("DPSK", []), ("DPSK", ["-m", "DBPSK"]),
                                       ("OFDM_CHIRP", ["-m", "QAM16", "-r", "R1_2"])])
def test_prx_with_waveform_given(wfn, extra, tmp_path, capsys):
    f32 = tmp_path / "given.f32"
    common = ["-w", wfn] + extra
    assert t_main(CPU + ["ptx", f"given {wfn}", "-s", "W1AW", "-d", "VE3ABC", "-o", str(f32)]
                  + common) == 0
    assert t_main(CPU + ["prx", str(f32)] + common) == 0
    cap = capsys.readouterr()
    assert f"given {wfn}" in cap.out and "waveform=" not in cap.err


def test_prx_autodetect_ping(tmp_path, capsys):
    f32 = tmp_path / "ping.f32"
    assert t_main(CPU + ["ptx", "ping", "-s", "W1AW", "-o", str(f32)]) == 0
    assert t_main(CPU + ["prx", str(f32)]) == 0
    assert "type=PING" in capsys.readouterr().out
    assert t_main(CPU + ["ptx", "ping", "-w", "OFDM_CHIRP", "-o", str(f32)]) == 1
    assert "ping requires MC_DPSK" in capsys.readouterr().err


def test_pure_noise_decodes_nothing(tmp_path, capsys):
    f32 = tmp_path / "noise.f32"
    np.random.default_rng(0).normal(0, 0.05, 60000).astype(np.float32).tofile(f32)
    assert t_main(CPU + ["prx", str(f32)]) == 1
    assert "no frame decoded" in capsys.readouterr().out


@pytest.mark.parametrize("wfn", AUTODETECTED)
def test_ptx_files_agree_and_cross_decode(wfn, tmp_path, capsys):
    """Both packages' ``ptx`` write the same samples (within 1e-5); the
    port's file decodes in the reference's ``prx`` and the reference's in
    the port's (``-w`` given: auto-detection has its own test), and the two
    ``prx`` print the same lines."""
    text = f"cross {wfn}"
    args = ["ptx", text, "-s", "W1AW", "-d", "VE3ABC", "-w", wfn]
    t_file, j_file = tmp_path / "port.f32", tmp_path / "ref.f32"
    assert t_main(CPU + args + ["-o", str(t_file)]) == 0
    assert j_main(args + ["-o", str(j_file)]) == 0
    got, want = np.fromfile(t_file, np.float32), np.fromfile(j_file, np.float32)
    assert got.shape == want.shape and np.max(np.abs(got - want)) <= 1e-5
    capsys.readouterr()
    assert j_main(["prx", str(t_file), "-w", wfn]) == 0
    ref_reads_port = capsys.readouterr()
    assert t_main(CPU + ["prx", str(j_file), "-w", wfn]) == 0
    port_reads_ref = capsys.readouterr()
    assert text in port_reads_ref.out and "type=DATA" in port_reads_ref.out
    assert port_reads_ref.out == ref_reads_port.out


def test_ptx_to_stdout_and_prx_from_stdin(tmp_path):
    """``python -m ria_tpu_torch.cli``: samples on stdout, read back from stdin."""
    cmd = [sys.executable, "-m", "ria_tpu_torch.cli", "--device", "cpu"]
    tx = subprocess.run(cmd + ["ptx", "piped", "-s", "W1AW", "-d", "VE3ABC"], cwd=ROOT,
                        capture_output=True, timeout=120)
    assert tx.returncode == 0 and len(tx.stdout) % 4 == 0 and len(tx.stdout) > 100000
    rx = subprocess.run(cmd + ["prx", "-", "-w", "MC_DPSK"], cwd=ROOT, input=tx.stdout,
                        capture_output=True, timeout=120)
    assert rx.returncode == 0 and b"piped" in rx.stdout


def test_monitor_and_gui_are_not_registered():
    """``gui`` waits for the runtime's TUI and stays unregistered; ``monitor``
    is registered since the station layer was ported (a missing file is an
    OSError, not an unknown command)."""
    with pytest.raises(SystemExit):
        t_main(CPU + ["gui", "x.f32"])
    with pytest.raises(FileNotFoundError):
        t_main(CPU + ["monitor", "no-such-recording.f32"])


def test_monitor_matches_reference(tmp_path, capsys):
    """Mirror of tests/test_cli.py::test_monitor_waterfall_and_decode: the
    reference's ``ptx`` file through both packages' ``monitor`` prints the
    same waterfall, status line and message."""
    f32 = tmp_path / "mon.f32"
    assert j_main(["ptx", "monitor smoke", "-s", "W1AW", "-d", "VE3ABC", "-o", str(f32)]) == 0
    capsys.readouterr()
    assert j_main(["monitor", str(f32), "-s", "VE3ABC"]) == 0
    want = capsys.readouterr().out
    assert t_main(CPU + ["monitor", str(f32), "-s", "VE3ABC"]) == 0
    got = capsys.readouterr().out
    assert "state=" in got and "Hz" in got and "monitor smoke" in got
    assert got == want


def test_simulator_cli_on_the_cpu(capsys):
    """``python -m ria_tpu_torch.tools.cli_simulator --device cpu``: one
    seed of a full session at 12 dB AWGN."""
    from ria_tpu_torch.tools.cli_simulator import main as sim_main

    assert sim_main(["--device", "cpu", "--snr", "12", "--channel", "awgn",
                     "--seed-base", "7"]) == 0
    out = capsys.readouterr().out
    assert "RESULT: 1/1 seeds passed" in out and "device cpu" in out
    assert "2/2 msgs" in out and "disconnect=clean" in out


def test_monitor_and_simulator_default_to_the_card(tmp_path, capsys):
    """Without ``--device``, ``monitor`` and the simulator run on the card:
    with no card they raise before doing anything, with one they run there."""
    from ria_tpu_torch.tools.cli_simulator import main as sim_main

    f32 = tmp_path / "noise.f32"
    np.zeros(48000, np.float32).tofile(f32)
    sim_args = ["--snr", "12", "--channel", "awgn", "--seed-base", "7"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            t_main(["monitor", str(f32)])
        with pytest.raises(RuntimeError, match="cuda"):
            sim_main(sim_args)
        return
    assert t_main(["monitor", str(f32)]) == 0
    assert sim_main(sim_args) == 0
    assert "device cuda" in capsys.readouterr().out
