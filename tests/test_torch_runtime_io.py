"""The port's audio engine and CAT controller against the reference package.

Mirrors the audio and CAT cases of tests/test_runtime_io.py (the monitor and
channel-probe cases are mirrored by tests/test_torch_station.py and
tests/test_torch_channel_probe.py).  Each case runs both packages on the
same inputs: the blocks delivered, the files written and the PTT sequence
must be equal, not close.
"""

import numpy as np
import pytest
import torch

from ria_tpu.runtime import audio as RA
from ria_tpu.runtime import cat as RC
from ria_tpu_torch.runtime import audio as TA
from ria_tpu_torch.runtime import cat as TC

torch.set_num_threads(1)

PACKAGES = {"ref": (RA, RC), "port": (TA, TC)}


def test_audio_loopback():
    outs = {}
    for pkg, (A, _) in PACKAGES.items():
        got = []
        eng = A.AudioEngine(A.LoopbackBackend(), rx_callback=got.append)
        eng.start()
        tone = np.sin(2 * np.pi * 1000 * np.arange(4096) / 48000).astype(np.float32)
        eng.queue_tx(tone)
        assert eng.tx_pending() == 4096
        for _ in range(4):
            eng.process_block()
        eng.stop()
        out = np.concatenate(got)
        assert np.allclose(out, tone[: len(out)], atol=1e-6)
        outs[pkg] = out
    np.testing.assert_array_equal(outs["port"], outs["ref"])


def test_audio_engine_uses_the_native_ring():
    eng = TA.AudioEngine()
    assert eng._tx_ring is not None and eng._tx_ring.capacity == TA.SAMPLE_RATE * 30


def test_audio_loopback_through_a_channel_fn():
    """The loopback's channel function sees each TX block; a short queue
    is padded with zeros to a whole block in both packages."""
    outs = {}
    for pkg, (A, _) in PACKAGES.items():
        got, seen = [], []
        eng = A.AudioEngine(A.LoopbackBackend(lambda b, s=seen: s.append(len(b)) or 0.5 * b),
                            rx_callback=got.append)
        eng.queue_tx(np.arange(1500, dtype=np.float32))
        for _ in range(3):
            eng.process_block()
        outs[pkg] = (np.concatenate(got), seen)
    np.testing.assert_array_equal(outs["port"][0], outs["ref"][0])
    assert outs["port"][1] == outs["ref"][1] == [TA.BLOCK_SAMPLES] * 3


def test_audio_file_backend(tmp_path):
    outs = {}
    for pkg, (A, _) in PACKAGES.items():
        rx_path = tmp_path / f"{pkg}_rx.f32"
        tx_path = tmp_path / f"{pkg}_tx.f32"
        ref = np.arange(2048, dtype=np.float32)
        ref.tofile(rx_path)
        got = []
        eng = A.AudioEngine(A.FileBackend(str(rx_path), str(tx_path)), rx_callback=got.append)
        eng.queue_tx(np.ones(A.BLOCK_SAMPLES, np.float32))
        eng.process_block()
        eng.process_block()
        eng.process_block()  # past the end: no block delivered
        eng.stop()
        assert np.array_equal(np.concatenate(got), ref)
        tx = np.fromfile(tx_path, np.float32)
        assert tx[:A.BLOCK_SAMPLES].sum() == A.BLOCK_SAMPLES
        outs[pkg] = (np.concatenate(got), tx)
    for a, b in zip(outs["port"], outs["ref"]):
        np.testing.assert_array_equal(a, b)


def test_sound_device_backend_is_gated():
    """Without ``sounddevice`` both packages refuse the same way."""
    try:
        import sounddevice  # noqa: F401
    except ImportError:
        for A, _ in PACKAGES.values():
            with pytest.raises(RuntimeError, match="sounddevice not installed"):
                A.SoundDeviceBackend()
    else:  # with it, both import it inside the constructor
        for A, _ in PACKAGES.values():
            assert A.SoundDeviceBackend().stream is None


def _ptt_trace(C, steps):
    cat = C.CatController(C.NullBackend(), ptt_lead_ms=100, ptt_tail_ms=50)
    trace = [(cat.ptt, cat.tx_ready, cat.backend.ptt)]
    for step in steps:
        if step == "request":
            cat.request_tx()
        elif step == "done":
            cat.tx_done()
        else:
            ms, active = step
            cat.tick(ms, tx_active=active)
        trace.append((cat.ptt, cat.tx_ready, cat.backend.ptt))
    return trace


def test_cat_ptt_sequencing():
    cat = TC.CatController(TC.NullBackend(), ptt_lead_ms=100, ptt_tail_ms=50)
    assert not cat.ptt
    cat.request_tx()
    assert cat.ptt and not cat.tx_ready  # lead delay
    cat.tick(100, tx_active=True)
    assert cat.tx_ready
    cat.tick(100, tx_active=True)
    assert cat.ptt
    # TX ends -> tail then release
    cat.tick(30, tx_active=False)
    assert cat.ptt
    cat.tick(30, tx_active=False)
    assert not cat.ptt


@pytest.mark.parametrize("seed", range(4))
def test_cat_sequences_equal_reference(seed):
    """Seeded sequences of requests, TX-done marks and ticks (up to the
    120 s watchdog): the same PTT, ready and keyed states after every step."""
    rng = np.random.default_rng(seed)
    steps = []
    for _ in range(200):
        r = rng.random()
        if r < 0.1:
            steps.append("request")
        elif r < 0.15:
            steps.append("done")
        else:
            steps.append((int(rng.integers(1, 4000)), bool(rng.random() < 0.7)))
    assert _ptt_trace(TC, steps) == _ptt_trace(RC, steps)


def test_cat_watchdog_releases():
    for _, C in PACKAGES.values():
        cat = C.CatController(C.NullBackend())
        cat.request_tx()
        for _ in range(130):
            cat.tick(1000, tx_active=True)
        assert not cat.ptt and not cat.backend.ptt
