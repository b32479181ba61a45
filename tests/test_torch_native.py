"""The port's native runtime library (``ria_tpu_torch.runtime.native``).

Mirrors tests/test_native.py against the port's build of
``native/ria_native.cpp`` (into ``build/ria_tpu_torch/``, named by a hash of
the source).  The same C++ source is built by both packages, so the port's
ring buffer, resampler and Watterson channel must give the reference's
results bit for bit on the same inputs.  Also: ``require`` raises with the
compiler's output, and the CRC checks against the port's ``frame_v2``.  (The
build itself, ``utils/native_build.py``, is held in
tests/test_torch_kernel_threads.py, with the CUDA kernels'.)
"""

import stat
import sys

import numpy as np
import pytest
import torch

from ria_tpu.runtime import native as R
from ria_tpu_torch.runtime import native as T
from ria_tpu_torch.utils import native_build

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def built():
    T.require()


def test_ring_buffer_spsc():
    rb = T.NativeRingBuffer(1000)
    x = np.arange(600, dtype=np.float32)
    assert rb.write(x) == 600
    assert len(rb) == 600
    got = rb.read(100)
    assert np.array_equal(got, x[:100])
    assert len(rb) == 500
    # overflow accounting
    assert rb.write(np.zeros(2000, np.float32)) == 500
    assert rb.overflows == 1500
    # peek doesn't consume
    p = rb.peek(50)
    assert len(rb) == 1000 and len(p) == 50
    rb.consume(1000)
    assert len(rb) == 0


def test_native_resampler_tone():
    rs = T.NativeResampler(48000, 8000)
    t = np.arange(48000) / 48000.0
    x = np.sin(2 * np.pi * 1000 * t).astype(np.float32)
    y = rs.process(x)
    assert abs(len(y) - 8000) <= 1
    spec = np.abs(np.fft.rfft(y[800:]))
    peak_hz = np.argmax(spec) * 8000 / len(y[800:])
    assert abs(peak_hz - 1000.0) < 5.0


@pytest.mark.parametrize("rates", [(48000, 8000), (8000, 48000), (48000, 44100)])
def test_native_resampler_equals_reference(rates):
    """Streamed in uneven blocks, the port's resampler and the reference
    package's give the same samples (exact)."""
    rng = np.random.default_rng(sum(rates))
    x = rng.normal(size=9000).astype(np.float32)
    a, b = T.NativeResampler(*rates), R.NativeResampler(*rates)
    for lo, hi in ((0, 1000), (1000, 1001), (1001, 9000)):
        np.testing.assert_array_equal(a.process(x[lo:hi]), b.process(x[lo:hi]))


def test_native_watterson_awgn_snr():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 0.3, 48000).astype(np.float32)
    ch = T.NativeWatterson(snr_db=10.0, noise=True)
    y = ch.process(x)
    noise = y - x
    snr = 10 * np.log10(np.mean(x**2) / np.mean(noise**2))
    assert abs(snr - 10.0) < 0.5


@pytest.mark.parametrize("preset", ["awgn", "good", "poor", "cfo"])
def test_native_watterson_equals_reference(preset):
    """The same seed and blocks through both packages' libraries: the same
    samples (exact), fading, multipath and CFO included."""
    kw = {"awgn": dict(snr_db=12.0),
          "good": dict(snr_db=15.0, delay_ms=0.5, doppler_hz=0.1, fading=True, multipath=True),
          "poor": dict(snr_db=15.0, delay_ms=2.0, doppler_hz=1.0, fading=True, multipath=True),
          "cfo": dict(snr_db=20.0, cfo_hz=7.5)}[preset]
    a, b = T.NativeWatterson(seed=3, **kw), R.NativeWatterson(seed=3, **kw)
    rng = np.random.default_rng(5)
    for _ in range(3):
        x = rng.normal(0, 0.2, 4800).astype(np.float32)
        np.testing.assert_array_equal(a.process(x), b.process(x))


def test_native_watterson_fading_stats_match_port_channel():
    """The native per-sample model and the port's AR(1)-scan channel agree
    statistically (mean fading power within a factor ~2), as the reference
    test holds the native model against the JAX channel."""
    from ria_tpu_torch.sim.channel import ChannelConfig, GeneratorDraws, apply_channel

    n = 48000 * 2
    x = np.ones(n, np.float32)
    nat = T.NativeWatterson(snr_db=100.0, doppler_hz=5.0, fading=True,
                            multipath=False, noise=False)
    y_nat = nat.process(x)
    cfg = ChannelConfig(snr_db=100.0, doppler_spread_hz=5.0, multipath_enabled=False,
                        noise_enabled=False)
    draws = GeneratorDraws(0, "cpu").block(x.shape, cfg)
    y_port = apply_channel(x, cfg, draws, device="cpu").samples.numpy()
    p_nat = np.mean(y_nat[48000:] ** 2)
    p_port = np.mean(y_port[48000:] ** 2)
    assert 0.4 < p_nat / p_port < 2.5, (p_nat, p_port)


def test_native_crc_matches_port_frame_v2():
    from ria_tpu.phy.frame_v2 import crc16 as ref_crc16
    from ria_tpu_torch.phy.frame_v2 import crc16

    for data in (b"123456789", b"", b"\x00\xff" * 50):
        assert T.crc16_native(data) == crc16(data) == ref_crc16(data)


def test_native_tcp_server_events():
    """accept -> data -> disconnect through the port's C++ server."""
    import socket

    srv = T.NativeTcpServer(0)
    try:
        c = socket.create_connection(("127.0.0.1", srv.port), timeout=2)
        c.sendall(b"hello")
        events = []
        for _ in range(200):
            srv.poll(10)
            events += list(srv.drain())
            if any(ev == "data" for ev, _, _ in events):
                break
        assert [ev for ev, _, _ in events][:2] == ["connect", "data"]
        cid = events[0][1]
        assert events[1][2] == b"hello" and srv.client_count == 1
        assert srv.send(cid, b"back") == 4
        assert c.recv(16) == b"back"
        c.close()
        for _ in range(200):
            srv.poll(10)
            if any(ev == "disconnect" for ev, _, _ in srv.drain()):
                break
        assert srv.client_count == 0
    finally:
        srv.close()


def _stand_in_compiler(tmp_path, log, body: str = "") -> str:
    """An executable standing in for g++: it logs its run, sleeps so that a
    second caller would overlap it, and writes its ``-o`` file in two parts."""
    script = tmp_path / "cxx"
    script.write_text(
        f"#!{sys.executable}\n"
        "import sys, time, os\n"
        f"open({str(log)!r}, 'a').write(str(os.getpid()) + '\\n')\n"
        f"{body}"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "with open(out, 'wb') as f:\n"
        "    f.write(b'A' * 4096)\n"
        "    f.flush()\n"
        "    time.sleep(0.3)\n"
        "    f.write(b'B' * 4096)\n")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    return str(script)


def test_require_raises_with_the_compiler_output(tmp_path, monkeypatch):
    log = tmp_path / "runs.log"
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_build, "find_compiler", lambda name: _stand_in_compiler(
        tmp_path, log, "print('ria_native.cpp:1: error: no toolchain here'); sys.exit(1)\n"))
    monkeypatch.setattr(T, "_lib", None)
    monkeypatch.setattr(T, "_error", None)
    with pytest.raises(RuntimeError, match="no toolchain here"):
        T.require()
    assert not T.available()
    with pytest.raises(RuntimeError, match="no toolchain here"):
        T.require()
    assert len(log.read_text().split()) == 1  # the failure is remembered
    assert list((tmp_path / "build").iterdir()) == []
    # Without the library the CRC keeps its pure-Python form.
    from ria_tpu_torch.phy.frame_v2 import crc16

    assert T.crc16_native(b"123456789") == crc16(b"123456789")
