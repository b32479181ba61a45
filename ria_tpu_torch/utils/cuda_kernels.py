"""The port's CUDA libraries: their table, their build, their C entry points
and the one launch of them.

Each library of :data:`LIBRARIES` is a source under ``csrc/`` compiled with
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface, on
first use (``utils/native_build.py``: under ``build/ria_tpu_torch/``, named by a
hash of the source and the flags).  :func:`load` compiles the one library it
is asked for, if it is missing, and loads it with ``ctypes``; :func:`build`
compiles every missing library at once, one ``nvcc`` each.

A binding module declares each C entry point it launches as a
:class:`Kernel` (its library, its name, its pointer and int arguments) and
launches it with :func:`launch`: on PyTorch's current stream, with the
tensor's card current, raising on a failed launch.  Every launch is counted
by entry point: :func:`launches`, :func:`reset_launches`.  So a new kernel
touches its ``.cu`` file, one line of :data:`LIBRARIES`, its binding module
and its tests.

Nothing here runs at import time: this module imports on a host with no
CUDA toolkit and no card.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from ria_tpu_torch.utils import native_build
from ria_tpu_torch.utils.native_build import Build

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Each library: (source, extra nvcc flags).  ``zoom_front``, ``sc_search``,
# ``ofdm_demap``, ``chirp_fine`` and ``lts_search`` link the shared CUDA runtime, the one
# PyTorch has loaded: their kernels open or fill the chains' spans'
# device-side ranges in a profile, and a profile taken late in a process
# missed launches made through a runtime linked into the library itself
# (torch 2.11, an NVIDIA H100).
LIBRARIES = {
    "ldpc_bp": (_CSRC / "ldpc_bp.cu", ()),
    "ldpc_bp_bf16": (_CSRC / "ldpc_bp_bf16.cu", ()),
    "ldpc_bp_v1": (_CSRC / "ldpc_bp_v1.cu", ()),
    "ldpc_bp_v1_bf16": (_CSRC / "ldpc_bp_v1_bf16.cu", ()),
    "zoom_front": (_CSRC / "zoom_front.cu", ("-cudart", "shared")),
    "sc_search": (_CSRC / "sc_search.cu", ("-cudart", "shared")),
    "ofdm_demap": (_CSRC / "ofdm_demap.cu", ("-cudart", "shared")),
    "chirp_fine": (_CSRC / "chirp_fine.cu", ("-cudart", "shared")),
    "lts_search": (_CSRC / "lts_search.cu", ("-cudart", "shared")),
}

_LOAD_LOCK = threading.Lock()
_LOADED: dict[str, ctypes.CDLL] = {}
# Launches by entry point since start-up (or since a caller last reset
# them).  Stations decode and search from threads of their own
# (``sim/continuous.py``), so the counts move under one lock.
_COUNT_LOCK = threading.Lock()
_LAUNCHES: dict[str, int] = {}


def library_path(source: Path, defines: tuple[str, ...] = ()) -> Path:
    """Where ``source`` built with :data:`NVCC_FLAGS` and ``defines`` lives."""
    return native_build.library_path(source, (*NVCC_FLAGS, *defines))


def compile_libraries(libraries: dict[str, tuple[Path, tuple[str, ...]]]) -> dict[str, Build]:
    """Compile each ``name: (source, defines)`` whose library is missing,
    one ``nvcc`` each, all at once (``native_build.compile_libraries``)."""
    return native_build.compile_libraries(
        "nvcc", {name: (src, (*NVCC_FLAGS, *defines)) for name, (src, defines) in libraries.items()})


def build() -> dict[str, Build]:
    """Compile every library of :data:`LIBRARIES` that is missing, all at
    once: ``{"ldpc_bp": Build, ...}``."""
    return compile_libraries(LIBRARIES)


def loaded(name: str) -> bool:
    """Whether library ``name`` is loaded in this process."""
    return name in _LOADED


def load(name: str) -> ctypes.CDLL:
    """Library ``name`` of :data:`LIBRARIES`, compiled first if it is
    missing (that library alone) and loaded once."""
    lib = _LOADED.get(name)
    if lib is None:
        with _LOAD_LOCK:
            if name not in _LOADED:
                path = compile_libraries({name: LIBRARIES[name]})[name].path
                _LOADED[name] = ctypes.CDLL(str(path))
            lib = _LOADED[name]
    return lib


class Kernel:
    """The C entry point ``ria_<name>`` of library ``library``: ``ptrs``
    pointer arguments, then ``ints`` ints, then the stream; it returns the
    launch's ``cudaError_t``.  Bound on its first launch (:func:`load`) and
    looked up with no lock after."""

    def __init__(self, library: str, name: str, ptrs: int, ints: int):
        self.library, self.name, self.ptrs, self.ints = library, name, ptrs, ints
        self._fn = None
        with _COUNT_LOCK:
            _LAUNCHES.setdefault(name, 0)

    def typed(self, lib):
        """This entry point of ``lib``, with its argument and result types."""
        fn = getattr(lib, f"ria_{self.name}")
        fn.argtypes = [ctypes.c_void_p] * self.ptrs + [ctypes.c_int] * self.ints + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        return fn

    def fn(self):
        """The bound entry point, its library loaded on the first call."""
        if self._fn is None:
            self._fn = self.typed(load(self.library))
        return self._fn

    def on(self, lib: ctypes.CDLL) -> Kernel:
        """This entry point bound now in ``lib``, a library built from
        another source (``tools/kernel_compare.py``)."""
        kernel = Kernel(self.library, self.name, self.ptrs, self.ints)
        kernel._fn = self.typed(lib)
        return kernel


def check(err: int, what: str) -> None:
    """Raise RuntimeError naming ``what`` on a non-zero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err}")


def launch(kernel: Kernel, *args) -> None:
    """Launch ``kernel`` on ``args`` (a tensor by its data pointer, an int as
    it is) and the current stream of the first argument's card, with that
    card current; raise on a failed launch, and count it."""
    fn = kernel.fn()
    dev = args[0].device
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    # The stream's raw handle, as PyTorch's own kernel launchers ask for it:
    # ``torch.cuda.current_stream`` builds a Stream object, 2.9-5.7 us a call
    # on an H100 host, and a Schmidl-Cox search launches five kernels.
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    if dev.index == torch.cuda.current_device():
        err = fn(*c_args, stream)
    else:
        with torch.cuda.device(dev):
            err = fn(*c_args, stream)
    check(err, f"ria_{kernel.name} launch")
    with _COUNT_LOCK:
        _LAUNCHES[kernel.name] += 1


def launches(name: str) -> int:
    """Launches of entry point ``ria_<name>`` since start-up or the last
    :func:`reset_launches`; raises KeyError for a name no :class:`Kernel`
    declares."""
    with _COUNT_LOCK:
        if name not in _LAUNCHES:
            raise KeyError(f"no kernel declares the entry point ria_{name}")
        return _LAUNCHES[name]


def reset_launches() -> None:
    """Every entry point's launch count set to 0."""
    with _COUNT_LOCK:
        for name in _LAUNCHES:
            _LAUNCHES[name] = 0
