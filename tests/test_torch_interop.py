"""The reference C++ modem's captured audio through the port on the CPU.

The 12 captures of tests/golden/interop (what tests/test_interop.py decodes
through ``ria_tpu``): each of the 11 data captures decodes byte for byte
through ``ria_tpu_torch`` (payload and callsign hashes), ``ref_ping.f32``
reads as a PING through the port's CLI, and, as a wire check of its own,
each data capture gives the same ``frame_bytes`` in both packages.
"""

import pytest
import torch

from ria_tpu.phy import frame_v2 as JF
from ria_tpu.wave.api import create_waveform as j_create
from ria_tpu_torch.cli import main
from ria_tpu_torch.phy import frame_v2 as TF
from ria_tpu_torch.tools import waveform_frames as F
from ria_tpu_torch.wave.api import create_waveform as t_create

torch.set_num_threads(1)

# (fixture, waveform, modulation, rate): REF_TO_US of tests/test_interop.py
REF_TO_US = list(F.CAPTURES)
IDS = [r[0] for r in REF_TO_US]


@pytest.mark.parametrize("fixture,wf_mode,mod,rate", REF_TO_US, ids=IDS)
def test_reference_tx_decodes_in_the_port(fixture, wf_mode, mod, rate):
    wf = t_create(TF.WaveformMode[wf_mode], mod, rate, device="cpu")
    rx = F.rx_full_then_light(wf, F.capture(fixture))
    assert rx.ok, f"{fixture}: no decode"
    F.check_capture_frame(rx, fixture)


@pytest.mark.parametrize("fixture,wf_mode,mod,rate", REF_TO_US, ids=IDS)
def test_capture_gives_the_same_bytes_in_both_packages(fixture, wf_mode, mod, rate):
    audio = F.capture(fixture)
    want = F.rx_full_then_light(j_create(JF.WaveformMode[wf_mode], mod, rate), audio)
    got = F.rx_full_then_light(t_create(TF.WaveformMode[wf_mode], mod, rate, device="cpu"), audio)
    assert got.ok and want.ok
    F.same_rx(got, want, fixture)


def test_reference_ping_detected_in_the_port(capsys):
    path = str(F.CAPTURE_DIR / F.PING_CAPTURE)
    assert main(["--device", "cpu", "prx", path, "-w", "MC_DPSK"]) == 0
    assert "type=PING" in capsys.readouterr().out
