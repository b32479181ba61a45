"""LDPC min-sum belief-propagation kernels in CUDA C++, bound with ctypes.

- K1 (``csrc/ldpc_bp.cu``, :func:`bp_decode`) replaces the Pallas TPU kernel
  ``ria_tpu/fec/ldpc_pallas.py::make_pallas_decoder``;
- K2 (``csrc/ldpc_bp_v1.cu``, :func:`bp_decode_v1`) replaces
  ``ria_tpu/fec/ldpc_pallas.py::make_pallas_decoder_v1``.

Each source is compiled with ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, on first use, under ``build/ria_tpu_torch/``
at the root of the checkout; :func:`build` starts one ``nvcc`` per missing
library, all at once.  A library's name carries a hash of its source and the
flags, so an edited source rebuilds; deleting the directory forces a rebuild.
The libraries are loaded with ``ctypes`` and launch on PyTorch's current
stream.

Nothing here runs at import time: this module imports on a host with no
CUDA toolkit and no card.  Both wrappers take CUDA tensors only; the plain
PyTorch decoders for CPU tensors are in ``ria_tpu_torch.fec.ldpc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

# Kernel launches since start-up (or since a caller last reset them).  Counted
# only where each kernel is launched, so a run can show that it went through
# K1 (LAUNCHES) or K2 (LAUNCHES_V1).
LAUNCHES = 0
LAUNCHES_V1 = 0

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_SOURCE = _CSRC / "ldpc_bp.cu"
_SOURCE_V1 = _CSRC / "ldpc_bp_v1.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ria_tpu_torch"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def csc_tables(row_idx: np.ndarray, row_mask: np.ndarray,
               n: int) -> tuple[np.ndarray, np.ndarray]:
    """Variable->edge lists in CSC form for the kernel's scatter.

    Returns ``col_ptr [n + 1]`` and ``col_edge [E]`` (int32): the edge slots
    ``e = check * D + d`` of variable ``v`` are
    ``col_edge[col_ptr[v]:col_ptr[v + 1]]``, in ascending order.  A variable
    with no edges has an empty list.
    """
    edges = np.flatnonzero(np.asarray(row_mask).reshape(-1))
    var = np.asarray(row_idx).reshape(-1)[edges]
    order = np.argsort(var, kind="stable")
    col_edge = edges[order].astype(np.int32)
    col_ptr = np.zeros(n + 1, np.int32)
    col_ptr[1:] = np.cumsum(np.bincount(var, minlength=n))
    return col_ptr, col_edge


def slot_tables(row_idx: np.ndarray, row_mask: np.ndarray,
                n: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-slot variable->check lists for K2's slot-major scatter.

    Returns ``slot_ptr [D, n + 1]`` and ``slot_chk [E]`` (int32): the checks
    whose edge slot ``d`` holds variable ``v`` are
    ``slot_chk[slot_ptr[d, v]:slot_ptr[d, v + 1]]``, in ascending order.
    Offsets are absolute, so ``slot_ptr[d, n] == slot_ptr[d + 1, 0]``.  A
    variable with no edge in slot ``d`` has an empty list there.
    """
    row_idx = np.asarray(row_idx)
    D = row_idx.shape[1]
    chk, slot = np.nonzero(np.asarray(row_mask))
    var = row_idx[chk, slot]
    order = np.lexsort((chk, var, slot))  # by slot, then variable, then check
    slot_chk = chk[order].astype(np.int32)
    ptr = np.zeros(D * n + 1, np.int64)
    ptr[1:] = np.cumsum(np.bincount(slot * n + var, minlength=D * n))
    slot_ptr = np.stack([ptr[d * n : d * n + n + 1] for d in range(D)]).astype(np.int32)
    return slot_ptr, slot_chk


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else shutil.which("nvcc")
    if not nvcc or not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the LDPC kernels need the CUDA toolkit to build")
    return nvcc


def library_path(source: Path | None = None) -> Path:
    """Path of the built library for ``source`` (default K1's) and the flags."""
    source = _SOURCE if source is None else source
    digest = hashlib.sha256(source.read_bytes() + " ".join(_NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}_{digest.hexdigest()[:16]}.so"


class Build(NamedTuple):
    path: Path
    log: str         # nvcc's output; empty when the library was already built
    seconds: float   # wall time of the compile; 0 when already built


def build() -> dict[str, Build]:
    """Compile every kernel whose library is missing, one ``nvcc`` per
    source, all started together.  Returns ``{"ldpc_bp": ..., "ldpc_bp_v1":
    ...}``.  Raises with nvcc's output when a compile fails."""
    results, procs = {}, {}
    missing = [s for s in (_SOURCE, _SOURCE_V1) if not library_path(s).exists()]
    nvcc = _nvcc() if missing else ""
    for source in (_SOURCE, _SOURCE_V1):
        out = library_path(source)
        if source not in missing:
            results[source.stem] = Build(out, "", 0.0)
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.Popen([nvcc, *_NVCC_FLAGS, "-o", str(tmp), str(source)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        procs[source.stem] = (proc, tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed on {name}.cu ({proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        results[name] = Build(out, log, time.perf_counter() - t0)
    if failed:
        raise RuntimeError("\n".join(failed))
    return results


@functools.cache
def _entry(name: str):
    fn = getattr(ctypes.CDLL(str(build()[name].path)), f"ria_{name}_decode")
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def bp_decode(llrs: torch.Tensor, factors: torch.Tensor, row_idx: torch.Tensor,
              row_mask: torch.Tensor, col_ptr: torch.Tensor, col_edge: torch.Tensor,
              k: int, max_iters: int):
    """Launch K1 on CUDA tensors: (info_bits, success, iterations, llr_total).

    llrs [B, n] f32, factors [B] f32; row_idx [m, D] int32, row_mask [m, D]
    bool, col_ptr [n + 1] and col_edge [E] int32 (:func:`csc_tables`), all on
    one CUDA device and contiguous.  Outputs: info_bits [B, k] uint8,
    success [B] bool, iterations [B] int32, llr_total [B, n] f32.
    """
    global LAUNCHES
    _check_inputs("K1", llrs, factors, row_idx, row_mask)
    _check(col_ptr, "col_ptr", torch.int32, (llrs.shape[1] + 1,), llrs.device)
    _check(col_edge, "col_edge", torch.int32, (col_edge.shape[0],), llrs.device)
    out = _launch("ldpc_bp", llrs, factors, row_idx, row_mask, col_ptr, col_edge,
                  k, max_iters)
    if llrs.shape[0]:  # an empty batch launches nothing
        LAUNCHES += 1
    return out


def bp_decode_v1(llrs: torch.Tensor, factors: torch.Tensor, row_idx: torch.Tensor,
                 row_mask: torch.Tensor, slot_ptr: torch.Tensor, slot_chk: torch.Tensor,
                 k: int, max_iters: int):
    """Launch K2 on CUDA tensors: (info_bits, success, iterations, llr_total).

    As :func:`bp_decode`, with the per-slot lists ``slot_ptr [D, n + 1]`` and
    ``slot_chk [E]`` (int32, :func:`slot_tables`) in place of the CSC lists.
    """
    global LAUNCHES_V1
    _check_inputs("K2", llrs, factors, row_idx, row_mask)
    D, n = row_idx.shape[1], llrs.shape[1]
    _check(slot_ptr, "slot_ptr", torch.int32, (D, n + 1), llrs.device)
    _check(slot_chk, "slot_chk", torch.int32, (slot_chk.shape[0],), llrs.device)
    out = _launch("ldpc_bp_v1", llrs, factors, row_idx, row_mask, slot_ptr, slot_chk,
                  k, max_iters)
    if llrs.shape[0]:
        LAUNCHES_V1 += 1
    return out


def _check_inputs(kernel: str, llrs: torch.Tensor, factors: torch.Tensor,
                  row_idx: torch.Tensor, row_mask: torch.Tensor) -> None:
    if llrs.device.type != "cuda":
        raise ValueError(f"{kernel} takes CUDA tensors, got {llrs.device}")
    if llrs.dim() != 2:
        raise ValueError(f"llrs must be [B, n], got {tuple(llrs.shape)}")
    dev = llrs.device
    B, n = llrs.shape
    m, D = row_idx.shape
    _check(llrs, "llrs", torch.float32, (B, n), dev)
    _check(factors, "factors", torch.float32, (B,), dev)
    _check(row_idx, "row_idx", torch.int32, (m, D), dev)
    _check(row_mask, "row_mask", torch.bool, (m, D), dev)


def _launch(name: str, llrs: torch.Tensor, factors: torch.Tensor, row_idx: torch.Tensor,
            row_mask: torch.Tensor, var_ptr: torch.Tensor, var_list: torch.Tensor,
            k: int, max_iters: int):
    """Allocate the outputs and launch kernel ``name`` on the current stream
    (nothing for an empty batch); raises when the launch is refused."""
    dev = llrs.device
    B, n = llrs.shape
    m, D = row_idx.shape
    llr_total = torch.empty_like(llrs)
    info = torch.empty((B, k), dtype=torch.uint8, device=dev)
    success = torch.empty(B, dtype=torch.bool, device=dev)
    iters = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return info, success, iters, llr_total
    fn = _entry(name)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(llrs.data_ptr(), factors.data_ptr(), row_idx.data_ptr(),
                 row_mask.data_ptr(), var_ptr.data_ptr(), var_list.data_ptr(),
                 llr_total.data_ptr(), info.data_ptr(), success.data_ptr(),
                 iters.data_ptr(), B, n, m, k, D, max_iters, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    return info, success, iters, llr_total
