"""Compile a source into a shared library on first use.

The port's one home for running a compiler: ``runtime/native.py`` builds the
host runtime (``native/ria_native.cpp``) with ``g++`` through it, and
``utils/cuda_kernels.py`` the CUDA kernels with ``nvcc``.

A library is ``<stem>_<hash>.so`` under ``build/ria_tpu_torch/`` at the root of
the checkout, where ``<hash>`` is the first 16 hex digits of the sha256 of the
source's bytes, those of each header it includes by a quoted name (found
beside it, each once, in the order met), and its flags joined by spaces, so an
edited source or header or another flag builds anew; deleting the directory
forces a rebuild.  One
:func:`compile_libraries` call runs at a time in a process (two threads whose
first use lands together must not compile one library twice); it starts one
compiler per missing library, all at once.  Each compile writes
``<library>.<pid>.<thread id>.tmp.so`` and moves it into place, so processes
that build one library at once each leave it whole.
"""

from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import NamedTuple

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ria_tpu_torch"
_LOCK = threading.Lock()


class Build(NamedTuple):
    path: Path
    log: str         # the compiler's output; empty when the library was already built
    seconds: float   # wall time of the compile; 0 when already built


_QUOTED_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def _source_bytes(source: Path, seen: set[Path]) -> bytes:
    """``source``'s bytes, then those of each header it includes by a quoted
    name, found beside it, in the order met and each once."""
    seen.add(source)
    text = source.read_bytes()
    out = [text]
    for name in _QUOTED_INCLUDE.findall(text):
        header = source.parent / name.decode()
        if header not in seen:
            out.append(_source_bytes(header, seen))
    return b"".join(out)


def library_path(source: Path, flags: tuple[str, ...]) -> Path:
    """Where ``source`` built with ``flags`` lives."""
    digest = hashlib.sha256(_source_bytes(source, set()) + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"{source.stem}_{digest[:16]}.so"


def find_compiler(name: str) -> str:
    """The path of ``name`` (``"g++"`` or ``"nvcc"``, the latter the CUDA
    toolkit's that PyTorch finds); raises RuntimeError when there is none."""
    if name == "nvcc":
        from torch.utils.cpp_extension import CUDA_HOME

        path = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else shutil.which("nvcc")
        if path and os.path.exists(path):
            return path
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")
    path = shutil.which(name)
    if path is None:
        raise RuntimeError(f"{name} not found: the native runtime library needs a C++ compiler")
    return path


def compile_libraries(compiler: str, libraries: dict[str, tuple[Path, tuple[str, ...]]],
                      timeout: float | None = None) -> dict[str, Build]:
    """Compile each ``name: (source, flags)`` of ``libraries`` whose library
    is missing with ``compiler`` (a name for :func:`find_compiler`, looked up
    only when one is missing), all at once, each given ``timeout`` seconds.
    Returns ``{name: Build}``; raises RuntimeError with the compiler's output
    when a compile fails."""
    with _LOCK:
        results, procs = {}, {}
        missing = [name for name, (src, flags) in libraries.items()
                   if not library_path(src, flags).exists()]
        path = find_compiler(compiler) if missing else ""
        for name, (source, flags) in libraries.items():
            out = library_path(source, flags)
            if name not in missing:
                results[name] = Build(out, "", 0.0)
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
            proc = subprocess.Popen([path, *flags, "-o", str(tmp), str(source)],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            procs[name] = (proc, tmp, out, time.perf_counter())
        failed = []
        for name, (proc, tmp, out, t0) in procs.items():
            try:
                log = proc.communicate(timeout=timeout)[0]
            except subprocess.TimeoutExpired:
                proc.kill()
                log = proc.communicate()[0] + f"\n(stopped after {timeout} s)"
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failed.append(f"{compiler} failed on {libraries[name][0].name} "
                              f"({proc.returncode}):\n{log}")
                continue
            os.replace(tmp, out)
            results[name] = Build(out, log, time.perf_counter() - t0)
        if failed:
            raise RuntimeError("\n".join(failed))
        return results
