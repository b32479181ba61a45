"""The LDPC kernels' build and launch counters under threads.

Stations decode from threads of their own (``sim/continuous.py``), so two
first decodes can ask for the kernels at once and two launches can count at
once.  There is no ``nvcc`` and no card here: the build runs a stand-in
compiler (a script that writes its ``-o`` file), and the counters are moved
through the wrappers with the launch itself stubbed.
"""

import os
import stat
import sys
import threading

import pytest
import torch

from ria_tpu_torch.fec import ldpc_kernel

torch.set_num_threads(1)


@pytest.fixture
def stand_in_nvcc(tmp_path, monkeypatch):
    """``_nvcc`` returns a script that logs each run, then writes its output
    in two parts with a pause between, so an overlapping second run or a
    reader of a half-written library would show."""
    log = tmp_path / "runs.log"
    script = tmp_path / "nvcc"
    script.write_text(
        f"#!{sys.executable}\n"
        "import sys, time, os\n"
        f"open({str(log)!r}, 'a').write(str(os.getpid()) + '\\n')\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "with open(out, 'wb') as f:\n"
        "    f.write(b'\\x7fELF' + b'A' * 4092)\n"
        "    f.flush()\n"
        "    time.sleep(0.3)\n"
        "    f.write(b'B' * 4096)\n"
        "print('ptxas info    : Used 40 registers')\n")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(ldpc_kernel, "_nvcc", lambda: str(script))
    monkeypatch.setattr(ldpc_kernel, "BUILD_DIR", tmp_path / "build")
    source = tmp_path / "kernel.cu"
    source.write_text("// a kernel\n")
    return log, source


def test_two_threads_build_one_library(stand_in_nvcc):
    log, source = stand_in_nvcc
    barrier = threading.Barrier(2)
    results = []

    def worker():
        barrier.wait()
        results.append(ldpc_kernel.compile_libraries({"k": (source, ())})["k"])

    threads = [threading.Thread(target=worker) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert len(log.read_text().split()) == 1, "the library was compiled twice"
    assert {r.path for r in results} == {ldpc_kernel.library_path(source)}
    path = results[0].path
    assert path.read_bytes() == b"\x7fELF" + b"A" * 4092 + b"B" * 4096
    assert sorted(bool(r.log) for r in results) == [False, True]  # built once, then found
    assert os.listdir(path.parent) == [path.name]  # no temporary left behind


def test_temporary_is_named_by_process_and_thread(stand_in_nvcc, monkeypatch):
    """The compile writes ``<library>.<pid>.<thread id>.tmp.so`` and moves it
    into place."""
    _, source = stand_in_nvcc
    seen = []
    inner = ldpc_kernel.os.replace
    monkeypatch.setattr(ldpc_kernel.os, "replace",
                        lambda a, b: seen.append((str(a), str(b))) or inner(a, b))
    ldpc_kernel.compile_libraries({"k": (source, ())})
    out = ldpc_kernel.library_path(source)
    assert seen == [(str(out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}"
                                       f".tmp.so")), str(out))]


def test_launch_counters_lose_no_increment(monkeypatch):
    """Eight threads count 20,000 launches each through every wrapper, with
    the interpreter switching threads every microsecond: no increment is
    lost.  (CPython 3.12 switches threads only at calls and backward jumps,
    so here the unguarded ``+=`` held too; the lock keeps the count for an
    interpreter that switches between the read and the write.)"""
    monkeypatch.setattr(ldpc_kernel, "launch", lambda *args: ((), 1))
    monkeypatch.setattr(ldpc_kernel, "LAUNCHES", 0)
    monkeypatch.setattr(ldpc_kernel, "LAUNCHES_V1", 0)
    monkeypatch.setattr(ldpc_kernel, "LAUNCHES_BF16", 0)
    monkeypatch.setattr(ldpc_kernel, "LAUNCHES_V1_BF16", 0)
    calls, threads_n = 20000, 8
    barrier = threading.Barrier(threads_n)

    def worker():
        barrier.wait()
        for _ in range(calls):
            ldpc_kernel.bp_decode(None, None, None, 0, 0)
            ldpc_kernel.bp_decode_v1(None, None, None, 0, 0)
            ldpc_kernel.bp_decode(None, None, None, 0, 0, "bf16")
            ldpc_kernel.bp_decode_v1(None, None, None, 0, 0, "bf16")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(threads_n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert ldpc_kernel.LAUNCHES == calls * threads_n
    assert ldpc_kernel.LAUNCHES_V1 == calls * threads_n
    assert ldpc_kernel.LAUNCHES_BF16 == calls * threads_n
    assert ldpc_kernel.LAUNCHES_V1_BF16 == calls * threads_n
