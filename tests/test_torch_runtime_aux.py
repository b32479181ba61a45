"""The port's configuration layer and threaded continuous simulator.

Mirrors the config and continuous-simulator cases of
tests/test_runtime_aux.py (logging and signal capture are mirrored by the
slice-4 tests).  ``PRESETS`` and their OFDM profiles equal the reference's;
settings files written by either package load in the other.  The threaded
session is compared at outcome level only: the two station threads
interleave differently on every run.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ria_tpu import config as R
from ria_tpu_torch import config as T
from ria_tpu_torch.tools import host_paths as H

torch.set_num_threads(1)


def test_presets_table():
    assert set(T.PRESETS) == {"conservative", "balanced", "turbo", "high_throughput",
                              "high_speed", "maximum_speed"}
    b = T.PRESETS["balanced"]
    assert b.cp_len == 96 and b.modulation == "DQPSK" and not b.use_pilots
    t = T.PRESETS["turbo"]
    assert t.modulation == "QAM256" and t.code_rate == "R5_6"
    cfg = T.PRESETS["high_throughput"].ofdm_config()
    assert cfg.use_pilots and cfg.pilot_spacing == 4


@pytest.mark.parametrize("name", sorted(R.PRESETS))
def test_presets_equal_reference(name):
    """Each preset and its OFDM profile, field by field, as the reference's."""
    got, want = T.PRESETS[name], R.PRESETS[name]
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(got.ofdm_config()) == dataclasses.asdict(want.ofdm_config())


def test_app_settings_roundtrip(tmp_path):
    s = T.AppSettings(mycall="W1AW", compression=False, preset="turbo",
                      forced_rate="R1_2", tx_drive=0.8)
    p = tmp_path / "settings.ini"
    s.save(p)
    g = T.AppSettings.load(p)
    assert g.mycall == "W1AW" and not g.compression
    assert g.preset == "turbo" and g.forced_rate == "R1_2"
    assert abs(g.tx_drive - 0.8) < 1e-9


def test_app_settings_interchange_with_reference(tmp_path):
    """The INI a package writes is the other's byte for byte, and each loads
    the other's to the same fields; a missing file or section gives the
    defaults in both."""
    kw = dict(mycall="K2XYZ", auto_accept=False, encryption_key="pass words",
              preset="high_speed", forced_waveform="OFDM_CHIRP",
              forced_modulation="QAM16", ptt_lead_ms=150, ptt_tail_ms=20, tx_drive=0.55)
    tp, rp = tmp_path / "port.ini", tmp_path / "ref.ini"
    T.AppSettings(**kw).save(tp)
    R.AppSettings(**kw).save(rp)
    assert tp.read_bytes() == rp.read_bytes()
    assert dataclasses.asdict(T.AppSettings.load(rp)) == dataclasses.asdict(
        R.AppSettings.load(tp)) == dataclasses.asdict(R.AppSettings(**kw))
    other = tmp_path / "other.ini"
    other.write_text("[elsewhere]\nmycall = X\n")
    for path in (other, tmp_path / "missing.ini"):
        assert dataclasses.asdict(T.AppSettings.load(path)) == dataclasses.asdict(
            R.AppSettings.load(path))


def test_continuous_simulator_session():
    """Threaded wall-clock sim: full connect + message under real threads,
    on the CPU, within the 120 s bound of chip_smoke.py's H2."""
    run = H.threaded_session("cpu", deadline_s=120.0)
    sim = run["sim"]
    assert run["ok"], (f"A={sim.alpha.conn.state} B={sim.bravo.conn.state} got={run['got']} "
                       f"ticks={run['ticks']}")
    assert run["got"] == [b"threaded hello"]
    assert min(run["ticks"].values()) > 0
    assert sim.alpha.device.type == "cpu" and sim.bravo.handshake_wf.device.type == "cpu"


def test_continuous_simulator_refuses_a_missing_native_library(monkeypatch):
    """The reference runs with no channel and no noise when its native
    library is missing; the port raises instead."""
    from ria_tpu_torch.runtime import native
    from ria_tpu_torch.sim.channel import awgn
    from ria_tpu_torch.sim.continuous import ContinuousAudioSimulator

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", "native library unavailable: g++ not found")
    with pytest.raises(RuntimeError, match="native library unavailable"):
        ContinuousAudioSimulator(awgn(12.0), device="cpu")


def test_continuous_simulator_reraises_a_station_failure():
    """A station thread that raises ends the run, and ``run`` raises it."""
    from ria_tpu_torch.sim.channel import awgn
    from ria_tpu_torch.sim.continuous import ContinuousAudioSimulator

    sim = ContinuousAudioSimulator(awgn(12.0), device="cpu")

    def broken(samples):
        raise ValueError("decoder fault")

    sim.bravo.feed_audio = broken
    sim.alpha._enqueue_tx(np.ones(4800, np.float32))
    with pytest.raises(RuntimeError, match="station thread failed") as info:
        sim.run(duration_s=30.0, until=lambda: False)
    assert isinstance(info.value.__cause__, ValueError)
