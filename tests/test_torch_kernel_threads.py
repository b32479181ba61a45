"""The kernel runtime's build and launch counters (``utils/native_build.py``,
``utils/cuda_kernels.py``), under threads and on a host with no compiler.

Stations decode from threads of their own (``sim/continuous.py``), so two
first decodes can ask for a library at once and two launches can count at
once.  There is no ``nvcc`` and no card here: the build runs a stand-in
compiler (a script that writes its ``-o`` file), and the counters are moved
through the launch helper with the C entry points stubbed.
"""

import ctypes
import hashlib
import os
import stat
import sys
import threading
import types
from pathlib import Path

import pytest
import torch

from ria_tpu_torch.fec import ldpc_kernel
from ria_tpu_torch.runtime import native
from ria_tpu_torch.sync import zoom_kernel
from ria_tpu_torch.utils import cuda_kernels, native_build

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def stand_in_compiler(tmp_path, monkeypatch):
    """``find_compiler`` returns a script that logs each run and the source
    it compiles, then writes its output in two parts with a pause between,
    so an overlapping second run or a reader of a half-written library
    would show."""
    log = tmp_path / "runs.log"
    script = tmp_path / "compiler"
    script.write_text(
        f"#!{sys.executable}\n"
        "import sys, time, os\n"
        f"open({str(log)!r}, 'a').write(os.path.basename(sys.argv[-1]) + '\\n')\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "with open(out, 'wb') as f:\n"
        "    f.write(b'\\x7fELF' + b'A' * 4092)\n"
        "    f.flush()\n"
        "    time.sleep(0.3)\n"
        "    f.write(b'B' * 4096)\n"
        "print('ptxas info    : Used 40 registers')\n")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(native_build, "find_compiler", lambda name: str(script))
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "build")
    source = tmp_path / "kernel.cu"
    source.write_text("// a kernel\n")
    return log, source


def _builds(compiler: str, source: Path):
    """(a build call, the library it makes) for the library of ``compiler``:
    the native runtime's with g++, a CUDA source's with nvcc."""
    if compiler == "g++":
        return native.build, native_build.library_path(native._SRC, native._CXX_FLAGS)
    return (lambda: cuda_kernels.compile_libraries({"k": (source, ())})["k"],
            cuda_kernels.library_path(source))


@pytest.mark.parametrize("compiler", ["g++", "nvcc"])
def test_two_threads_build_one_library(compiler, stand_in_compiler):
    log, source = stand_in_compiler
    build, want = _builds(compiler, source)
    barrier = threading.Barrier(2)
    results = []

    def worker():
        barrier.wait()
        results.append(build())

    threads = [threading.Thread(target=worker) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert len(log.read_text().split()) == 1, "the library was compiled twice"
    assert {r.path for r in results} == {want}
    path = results[0].path
    assert path.read_bytes() == b"\x7fELF" + b"A" * 4092 + b"B" * 4096
    assert sorted(bool(r.log) for r in results) == [False, True]  # built once, then found
    assert sorted(r.seconds > 0 for r in results) == [False, True]
    assert os.listdir(path.parent) == [path.name]  # no temporary left behind


def test_temporary_is_named_by_process_and_thread(stand_in_compiler, monkeypatch):
    """The compile writes ``<library>.<pid>.<thread id>.tmp.so`` and moves it
    into place."""
    _, source = stand_in_compiler
    seen = []
    inner = native_build.os.replace
    monkeypatch.setattr(native_build.os, "replace",
                        lambda a, b: seen.append((str(a), str(b))) or inner(a, b))
    cuda_kernels.compile_libraries({"k": (source, ())})
    out = cuda_kernels.library_path(source)
    assert seen == [(str(out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}"
                                       f".tmp.so")), str(out))]


class _Library:
    """Stands in for a loaded library: any entry point can be typed."""

    def __init__(self, path):
        self.path = path

    def __getattr__(self, name):
        fn = types.SimpleNamespace()
        setattr(self, name, fn)
        return fn


@pytest.mark.parametrize("load,want", [
    (lambda: ldpc_kernel._library("ldpc_bp"), ["ldpc_bp.cu"]),
    (zoom_kernel.load, ["zoom_front.cu"]),
    (cuda_kernels.build, sorted(src.name for src, _ in cuda_kernels.LIBRARIES.values())),
], ids=["k1", "zoom_front", "build"])
def test_a_first_load_compiles_its_own_library(load, want, stand_in_compiler, monkeypatch):
    """Loading K1's library compiles ``ldpc_bp`` alone, loading the window
    pass's compiles ``zoom_front`` alone, and ``build()`` compiles all seven."""
    log, _ = stand_in_compiler
    monkeypatch.setattr(cuda_kernels, "_LOADED", {})
    monkeypatch.setattr(ctypes, "CDLL", _Library)
    monkeypatch.setattr(zoom_kernel._KERNEL, "_fn", None)
    load()
    assert sorted(log.read_text().split()) == want


@pytest.mark.parametrize("name", ["ria_native", "ldpc_bp", "ldpc_bp_v1"])
def test_library_lives_under_build_named_by_its_source(name, tmp_path):
    """The native runtime's library (g++), K1's and K2's (nvcc): each under
    ``build/ria_tpu_torch/`` at the checkout's root, named after its source,
    and renamed by an edit of its source."""
    libraries = {"ria_native": (native._SRC, native._CXX_FLAGS),
                 **{n: (src, (*cuda_kernels.NVCC_FLAGS, *defines))
                    for n, (src, defines) in cuda_kernels.LIBRARIES.items()}}
    source, flags = libraries[name]
    path = native_build.library_path(source, flags)
    assert path.parent == native_build.BUILD_DIR == ROOT / "build" / "ria_tpu_torch"
    assert path.name.startswith(f"{name}_") and path.suffix == ".so"
    assert path not in {native_build.library_path(*lib) for n, lib in libraries.items()
                        if n != name}
    edited = tmp_path / source.name
    edited.write_bytes(source.read_bytes() + b"\n// edit\n")
    assert native_build.library_path(edited, flags) != path
    if name == "ria_native":
        assert native.available() and native.build().path == path and path.exists()
    else:
        assert cuda_kernels.library_path(source) == path


def test_library_names_keep_their_recipe():
    """Each library's file name is ``<stem>_<sha256 of the source's bytes, the
    bytes of the header it includes, if any, and its flags joined by spaces,
    16 hex digits>.so``, with today's flags, so that a library built before
    keeps its name and an edit of the shared header renames every library
    that includes it."""
    nvcc = ("-gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC "
            "-Xptxas -v")
    want = {name: (src, " ".join((nvcc, *defines)))
            for name, (src, defines) in cuda_kernels.LIBRARIES.items()}
    assert len(want) == 9
    header = (ROOT / "ria_tpu_torch" / "csrc" / "aten_order.cuh").read_bytes()
    for name, (src, flags) in want.items():
        headers = header if name in ("sc_search", "chirp_fine", "lts_search") else b""
        digest = hashlib.sha256(src.read_bytes() + headers + flags.encode()).hexdigest()[:16]
        assert cuda_kernels.library_path(src, cuda_kernels.LIBRARIES[name][1]) == (
            ROOT / "build" / "ria_tpu_torch" / f"{src.stem}_{digest}.so"), name
    src = ROOT / "native" / "ria_native.cpp"
    digest = hashlib.sha256(src.read_bytes() + b"-O2 -shared -fPIC -std=c++17").hexdigest()[:16]
    assert native_build.library_path(native._SRC, native._CXX_FLAGS) == (
        ROOT / "build" / "ria_tpu_torch" / f"ria_native_{digest}.so")


def test_launch_counters_lose_no_increment(monkeypatch):
    """Eight threads count 20,000 launches each of every decoder build
    through the launch helper, with the interpreter switching threads every
    microsecond: no increment is lost.  (CPython 3.12 switches threads only
    at calls and backward jumps, so an unguarded ``+=`` would hold too; the
    lock keeps the count for an interpreter that switches between the read
    and the write.)"""
    kernels = list(ldpc_kernel._DECODERS.values())
    for kernel in kernels:
        monkeypatch.setattr(kernel, "_fn", lambda *args: 0)
    monkeypatch.setattr(cuda_kernels, "_LAUNCHES", dict.fromkeys(cuda_kernels._LAUNCHES, 0))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 0, raising=False)
    x = torch.zeros(1)
    calls, threads_n = 20000, 8
    barrier = threading.Barrier(threads_n)

    def worker():
        barrier.wait()
        for _ in range(calls):
            for kernel in kernels:
                cuda_kernels.launch(kernel, x, 1)

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
    for name in ("ldpc_bp_decode", "ldpc_bp_bf16_decode", "ldpc_bp_v1_decode",
                 "ldpc_bp_v1_bf16_decode"):
        assert cuda_kernels.launches(name) == calls * threads_n, name
    assert cuda_kernels.launches("zoom_front") == 0
    cuda_kernels.reset_launches()
    assert cuda_kernels.launches("ldpc_bp_decode") == 0
    with pytest.raises(KeyError):
        cuda_kernels.launches("no_such_kernel")
