"""The waveform API and the CLI on the card (needs a GPU).

Imports no JAX, so it runs on a GPU host that has none:

    python -m pytest -q -m cuda tests/test_torch_waveform_api_cuda.py

Without a card every test skips but the last, which holds the K1-against-
plain check itself to a wrong result on the CPU.  One frame per waveform class of
``ria_tpu_torch.tools.waveform_frames`` goes through
``create_waveform(...).rx_frame`` with the default device and with
``device="cpu"``: ok, frame bytes, header, per-CW flags and start equal, CFO
and SNR within 1e-3, soft bits within 2e-3; at least one K1 launch and no K2
launch per ``rx_frame``, and every K1 call of it equal to the plain decoder
on the call's own LLRs (B = 1 for the header, B = total_cw or 4 for the
body), on clean frames and on two near their decode floor where K1 runs
several iterations.  The same for two of the reference modem's
captures, the OFDM burst, AFDM and a ``ptx`` -> ``prx`` loopback through
``cli.main``.  The CPU classes themselves are held against the JAX package
by tests/test_torch_waveform_api.py.
"""

import numpy as np
import pytest
import torch

from ria_tpu_torch import cli
from ria_tpu_torch.phy.frame_v2 import WaveformMode, make_fixed_data_frame
from ria_tpu_torch.tools import waveform_frames as F
from ria_tpu_torch.wave.api import create_waveform

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: every rx_frame decodes with K1, which is CUDA C++")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("spec", F.CLEAN_FRAMES, ids=[s.name for s in F.CLEAN_FRAMES])
def test_rx_frame_on_card_matches_cpu(spec, cuda_device):
    wf, audio, fb = F.make_clean_frame(spec, seed=1)
    assert wf.device.type == "cuda"
    cpu_wf = F.make_clean_frame(spec, seed=1, device="cpu")[0]
    got, k1, k2, calls = F.counted_k1(lambda: wf.rx_frame(audio, light=spec.light))
    assert k1 >= 1 and k2 == 0 and len(calls) == k1
    assert {r["B"] for r in F.hold_k1_calls(calls, spec.name)} >= {1}
    F.check_clean_frame(got, spec)
    F.same_rx(got, cpu_wf.rx_frame(audio, light=spec.light), spec.name)
    # A tensor on the card is used where it lies.
    again = wf.rx_frame(torch.as_tensor(audio, device=cuda_device), light=spec.light)
    assert again.frame_bytes == got.frame_bytes and again.start_sample == got.start_sample
    with pytest.raises(ValueError, match="device"):
        wf.rx_frame(torch.as_tensor(audio), light=spec.light)


@pytest.mark.cuda
@pytest.mark.parametrize("spec", F.NOISY_FRAMES, ids=[s.name for s in F.NOISY_FRAMES])
def test_noisy_rx_frame_holds_k1_over_several_iterations(spec, cuda_device):
    wf, audio, _ = F.make_clean_frame(spec, seed=0)
    cpu_wf = F.make_clean_frame(spec, seed=0, device="cpu")[0]
    got, k1, k2, calls = F.counted_k1(lambda: wf.rx_frame(audio))
    assert k1 >= 2 and k2 == 0 and len(calls) == k1
    F.check_clean_frame(got, spec)
    F.same_rx(got, cpu_wf.rx_frame(audio), spec.name)
    rows = F.hold_k1_calls(calls, spec.name)
    assert any(r["B"] == 4 and r["converged"] == 4 and np.mean(r["iterations"]) >= 2
               for r in rows)
    assert any(r["B"] == 1 for r in rows)


@pytest.mark.cuda
@pytest.mark.parametrize("fixture,mode,mod,rate", [F.CAPTURES[1], F.CAPTURES[9], F.CAPTURES[10]],
                         ids=lambda v: v if str(v).endswith(".f32") else None)
def test_capture_on_card_matches_cpu(fixture, mode, mod, rate, cuda_device):
    audio = F.capture(fixture)
    wf = create_waveform(WaveformMode[mode], mod, rate)
    cpu_wf = create_waveform(WaveformMode[mode], mod, rate, device="cpu")
    got, k1, k2, calls = F.counted_k1(lambda: F.rx_full_then_light(wf, audio))
    assert k1 >= 1 and k2 == 0 and len(calls) == k1
    F.hold_k1_calls(calls, fixture)
    F.check_capture_frame(got, fixture)
    F.same_rx(got, F.rx_full_then_light(cpu_wf, audio), fixture)


@pytest.mark.cuda
def test_burst_and_afdm_on_card_match_cpu(cuda_device):
    wf = create_waveform(WaveformMode.OFDM_CHIRP, "DQPSK", "R1_2")
    cpu_wf = create_waveform(WaveformMode.OFDM_CHIRP, "DQPSK", "R1_2", device="cpu")
    frames = [make_fixed_data_frame("W1AW", "VE3ABC", i, f"burst frame {i}".encode(),
                                    "R1_2").serialize() for i in range(4)]
    audio = F.awgn(wf.tx_burst(frames), 15.0, seed=8)
    (got, snr, fading), k1, k2 = F.counted(lambda: wf.rx_burst(audio, group=4))
    want, snr_c, fading_c = cpu_wf.rx_burst(audio, group=4)
    assert got == want and [fb for _, fb in got] == frames and k1 >= 1 and k2 == 0
    assert snr == pytest.approx(snr_c, abs=1e-3) and fading == pytest.approx(fading_c, abs=1e-3)

    afdm = create_waveform(WaveformMode.AFDM)
    cpu_afdm = create_waveform(WaveformMode.AFDM, device="cpu")
    fb = F.control_frame_bytes()
    audio = F.awgn(afdm.tx_frame(fb, tx_cfo_hz=5.0), 10.0, seed=9)
    (ok, got_fb, info), k1, k2 = F.counted(lambda: afdm.rx_frame(audio))
    ok_c, fb_c, info_c = cpu_afdm.rx_frame(audio)
    assert ok and got_fb[:20] == fb and (ok_c, fb_c) == (ok, got_fb) and k1 >= 1 and k2 == 0
    assert info["start"] == info_c["start"]
    assert info["cfo_hz"] == pytest.approx(info_c["cfo_hz"], abs=1e-3)


@pytest.mark.cuda
def test_cli_loopback_on_card(cuda_device, tmp_path, capsys):
    f32 = tmp_path / "tx.f32"
    assert cli.main(["ptx", "card loopback", "-s", "W1AW", "-d", "VE3ABC", "-w", "OFDM_CHIRP",
                     "-o", str(f32)]) == 0
    capsys.readouterr()
    (rc, k1, k2) = F.counted(lambda: cli.main(["prx", str(f32)]))
    cap = capsys.readouterr()
    assert rc == 0 and "card loopback" in cap.out and "waveform=OFDM_CHIRP" in cap.err
    assert k1 >= 1 and k2 == 0
    assert cli.main(["--device", "cpu", "prx", str(f32)]) == 0
    assert capsys.readouterr().out.splitlines()[:-1] == cap.out.splitlines()[:-1]
    noise = tmp_path / "noise.f32"
    np.random.default_rng(0).normal(0, 0.05, 60000).astype(np.float32).tofile(noise)
    assert cli.main(["prx", str(noise)]) == 1
    assert "no frame decoded" in capsys.readouterr().out


def test_hold_k1_calls_refuses_a_wrong_result():
    """The K1-against-plain check on the CPU, where no kernel runs: the
    plain decoder's own result passes; a result that stopped after the first
    iteration, that is the input's hard decision, or whose posteriors alone
    differ, is refused."""
    from ria_tpu_torch.fec.ldpc import DecodeResult, ldpc_decoder

    spec = F.NOISY_FRAMES[0]
    wf, audio, _ = F.make_clean_frame(spec, seed=0, device="cpu")
    soft = torch.as_tensor(wf.rx_frame(audio).soft_bits.reshape(-1, 648))
    dec = ldpc_decoder("R1_4", None, "cpu")
    factors = torch.full((soft.shape[0],), 0.75)
    want = dec.plain(soft, factors)
    assert bool(want.success.all()) and int(want.iterations.min()) >= 2
    for llrs in (soft[:1], soft):
        f, right = factors[: llrs.shape[0]], dec.plain(llrs, factors[: llrs.shape[0]])
        rows = F.hold_k1_calls([(dec, llrs, f, right)])
        assert rows[0]["B"] == llrs.shape[0] and rows[0]["converged"] == llrs.shape[0]
        one_iteration = ldpc_decoder("R1_4", 1, "cpu").plain(llrs, f)
        hard = DecodeResult(right.info_bits, right.success, right.iterations, llrs)
        for wrong in (one_iteration, hard):
            with pytest.raises(AssertionError, match="differs from the plain decoder"):
                F.hold_k1_calls([(dec, llrs, f, wrong)])
        # Posteriors alone apart, by as little as one ulp on one value: refused
        # (K1 and the plain decoder sum in one order, so they agree bit for bit).
        apart = DecodeResult(right.info_bits, right.success, right.iterations,
                             right.llr_total + 0.01)
        ulp = right.llr_total.clone()
        ulp[-1, 5] = torch.nextafter(ulp[-1, 5], torch.tensor(float("inf")))
        for wrong in (apart, DecodeResult(right.info_bits, right.success, right.iterations, ulp)):
            with pytest.raises(AssertionError, match="differs from the plain decoder"):
                F.hold_k1_calls([(dec, llrs, f, wrong)])
    # Several calls of one decoder are held together: each against its own rows.
    rows = F.hold_k1_calls([(dec, soft[:1], factors[:1], dec.plain(soft[:1], factors[:1])),
                            (dec, soft, factors, want)])
    assert [r["B"] for r in rows] == [1, soft.shape[0]]
    early = ldpc_decoder("R1_4", 1, "cpu").plain(soft[:1], factors[:1])
    with pytest.raises(AssertionError, match="K1 at B=1"):
        F.hold_k1_calls([(dec, soft, factors, want), (dec, soft[:1], factors[:1], early)])
