"""LDPC min-sum belief-propagation kernels in CUDA C++, bound with ctypes.

- K1 (``csrc/ldpc_bp.cu``, :func:`bp_decode`) replaces the Pallas TPU kernel
  ``ria_tpu/fec/ldpc_pallas.py::make_pallas_decoder``, in two builds of one
  source: float32 (the default) and, with ``-DRIA_BF16_OPERANDS``, the
  TPU kernel's own rounding of its matmul operands to bfloat16
  (``precision="bf16"``);
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
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

# Kernel launches since start-up (or since a caller last reset them).  Counted
# only where each kernel is launched, so a run can show that it went through
# K1's float32 build (LAUNCHES), its bf16-operand build (LAUNCHES_BF16) or K2
# (LAUNCHES_V1).  Stations decode from threads of their own
# (``sim/continuous.py``), so each count moves under ``_COUNT_LOCK``.
LAUNCHES = 0
LAUNCHES_BF16 = 0
LAUNCHES_V1 = 0
_COUNT_LOCK = threading.Lock()
# One build at a time in a process, and one library load: two threads whose
# first decode lands together must not start two compiles of one library.
_BUILD_LOCK = threading.Lock()
_LOAD_LOCK = threading.Lock()
_LIBRARIES: dict[str, ctypes.CDLL] = {}
_ENTRIES: dict = {}

K1_THREADS = 512  # threads per K1 block: kThreads in csrc/ldpc_bp.cu
K2_THREADS = 512  # threads per K2 block: kThreads in csrc/ldpc_bp_v1.cu

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_SOURCE = _CSRC / "ldpc_bp.cu"
_SOURCE_V1 = _CSRC / "ldpc_bp_v1.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ria_tpu_torch"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Each library: (source, extra nvcc flags).  The C entry points are named
# after the source (``ria_<stem>_decode``).
LIBRARIES = {
    "ldpc_bp": (_SOURCE, ()),
    "ldpc_bp_bf16": (_SOURCE, ("-DRIA_BF16_OPERANDS",)),
    "ldpc_bp_v1": (_SOURCE_V1, ()),
}
# K1's library for each precision.
K1_LIBRARY = {"f32": "ldpc_bp", "bf16": "ldpc_bp_bf16"}


def csc_tables(row_idx: np.ndarray, row_mask: np.ndarray,
               n: int) -> tuple[np.ndarray, np.ndarray]:
    """Variable->edge lists in CSC form.

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


def edge_positions(row_idx: np.ndarray, row_mask: np.ndarray, n: int) -> np.ndarray:
    """``edge_pos [m, D]`` int32: the position of edge ``(c, d)`` in
    :func:`csc_tables`' ``col_edge`` (its inverse), -1 on a masked slot."""
    m, D = np.asarray(row_idx).shape
    col_edge = csc_tables(row_idx, row_mask, n)[1]
    pos = np.full(m * D, -1, np.int32)
    pos[col_edge] = np.arange(len(col_edge), dtype=np.int32)
    return pos.reshape(m, D)


class K1Layout(NamedTuple):
    """K1's host-built tables for one code (numpy), see :func:`k1_layout`."""
    row: np.ndarray    # [D, m] int16: variable on slot d of thread c's check; n if none
    epos: np.ndarray   # [D, m] int16: that edge's slot in the message array; slots if none
    jobs: np.ndarray   # [2, K1_THREADS] int32: packed variable jobs of each thread; -1 none
    slots: int         # length of the message array (a multiple of 4)
    stride: int        # cells between a job's consecutive 4-slot cells


def unpack_job(job: int) -> tuple[int, int, int]:
    """(variable, first 4-slot cell, cell count) of a packed K1 job; cell q
    of the job is cell ``first + q * stride`` of the message array."""
    return job & 1023, (job >> 15) & 8191, (job >> 10) & 31


def k1_layout(row_idx: np.ndarray, row_mask: np.ndarray, n: int) -> K1Layout:
    """K1's tables: messages in a padded, cell-interleaved CSC order, a
    balanced variable pass, and each check's edges spread over the D slots
    to keep shared-memory bank conflicts low.

    Variables are dealt to the K1_THREADS threads by descending degree; the
    ``n - K1_THREADS`` lightest go, as second jobs, to the threads whose
    first job is lightest, so a thread's chain of shared loads per iteration
    (one per 4-slot cell) stays below the heaviest variable's degree (4
    loads for 13 edges at R1_4).  A variable's messages, in ascending edge
    order (the order of :func:`csc_tables`), fill 4-slot cells, the last
    one padded with zero slots; a variable of 1 to 3 edges starts at lane
    ``(first // 8) % 4`` of its cell, as far as the cell holds it, so that
    neighbouring cells' messages sit on different banks (the zero lanes
    before it leave its sum as it is).  The ``stride`` threads whose first
    job spans several cells come first; cell q of thread t's first job is
    cell ``q * stride + t``; the one-cell jobs follow, one cell per thread
    in thread order.  So the threads of a warp load neighbouring cells and
    the kernel sums a variable with 128-bit loads that do not conflict.  A
    job packs ``v | cells << 10 | first << 15``.

    Each check's edges may sit on any of its D slots (the min-sum update
    does not depend on their order): they are placed greedily so that the
    32 checks of a warp gather ``post[v]`` and store to ``epos`` on as
    few addresses per shared-memory bank as the code allows.  A slot with
    no edge holds the sentinel variable ``n`` and message slot ``slots``,
    which the kernel keeps at +inf and never sums.
    """
    row_idx, row_mask = np.asarray(row_idx), np.asarray(row_mask)
    m, D = row_idx.shape
    T = K1_THREADS
    if n > 1023 or m > T:  # a job packs v in 10 bits; one thread per check
        raise ValueError(f"K1 takes n <= 1023 variables and m <= {T} checks")
    col_ptr, _ = csc_tables(row_idx, row_mask, n)
    deg = np.diff(col_ptr)
    cells = (deg + 3) // 4
    job_of, first, stride, n_cells = _deal_jobs(cells, T, "K1")
    lead = np.where((deg > 0) & (deg < 4), (first // 8) % 4 % (5 - np.minimum(deg, 4)), 0)
    slots = 4 * n_cells
    if cells.max(initial=0) > 31 or slots > 16380:  # byte offsets of slots fit 16 bits
        raise ValueError(f"K1's message array of {slots} slots is too long")
    jobs = np.full((2, T), -1, np.int64)
    jobs[job_of[:, 0], job_of[:, 1]] = np.arange(n) | (cells << 10) | (first << 15)

    e_rank = edge_positions(row_idx, row_mask, n) - col_ptr[np.where(row_mask, row_idx, 0)]
    e_rank = e_rank + lead[row_idx]
    edge_slot = 4 * (first[row_idx] + (e_rank // 4) * stride) + e_rank % 4
    row, epos = _place_edges(row_idx, row_mask, edge_slot, n, slots)
    return K1Layout(row, epos, jobs.astype(np.int32), slots, stride)


def _deal_jobs(cells: np.ndarray, T: int, name: str) -> tuple[np.ndarray, np.ndarray, int, int]:
    """Deal the variables to T threads by descending ``cells`` (4-slot cells
    each) and place their cells.  The T heaviest are first jobs; the rest,
    which must fit one cell, go as second jobs to the threads whose first
    job is lightest.  Cell q of a multi-cell (first) job on thread t is cell
    ``q * stride + t``; the one-cell jobs follow, one cell each in (job row,
    thread) order.  Returns (job_of [n, 2]: job row and thread of each
    variable, first cell [n], stride, cells in all)."""
    n = len(cells)
    order = np.argsort(-cells, kind="stable")
    job_of = np.zeros((n, 2), np.int64)
    job_of[order[:T], 0], job_of[order[:T], 1] = 0, np.arange(min(n, T))
    rest = order[T:]
    job_of[rest, 0], job_of[rest, 1] = 1, T - 1 - np.arange(len(rest))
    multi = (job_of[:, 0] == 0) & (cells > 1)
    stride = int(multi.sum())
    if np.any(cells[job_of[:, 0] == 1] > 1) or np.any(job_of[multi, 1] >= stride):
        raise ValueError(f"{name}'s layout needs the multi-cell variables first")
    single = ~multi & (cells > 0)
    key = job_of[:, 0] * T + job_of[:, 1]
    rank = np.argsort(np.argsort(np.where(single, key, 2 * T)))
    top = stride * cells[multi].max(initial=0)
    first = np.where(multi, job_of[:, 1], top + rank)
    first = np.where(cells > 0, first, 0)
    return job_of, first, stride, top + int(single.sum())


def _place_edges(row_idx: np.ndarray, row_mask: np.ndarray, edge_slot: np.ndarray, n: int,
                 slots: int) -> tuple[np.ndarray, np.ndarray]:
    """Each check's edges on its D table slots, placed greedily so that the
    32 checks of a warp gather ``post[v]`` and store to their message slots
    on as few addresses per shared-memory bank as the code allows (the
    check update does not depend on the order of a check's edges).  Returns
    ``row`` and ``epos`` [D, m] int16: the variable and message slot
    (``edge_slot [m, D]``) of each table slot; ``n`` and ``slots`` where a
    check has no edge."""
    m, D = row_idx.shape
    row = np.full((D, m), n, np.int64)
    epos = np.full((D, m), slots, np.int64)
    taken = {}  # (warp, slot, bank, gather or store) -> addresses
    for c in range(m):
        free = list(range(D))
        for d in np.flatnonzero(row_mask[c]):
            v, e = int(row_idx[c, d]), int(edge_slot[c, d])

            def cost(s, v=v, e=e):
                g = taken.get((c // 32, s, v % 32, 0), set())
                st = taken.get((c // 32, s, e % 32, 1), set())
                return len(g - {v}) + len(st), s

            s = min(free, key=cost)
            free.remove(s)
            taken.setdefault((c // 32, s, v % 32, 0), set()).add(v)
            taken.setdefault((c // 32, s, e % 32, 1), set()).add(e)
            row[s, c], epos[s, c] = v, e
    return row.astype(np.int16), epos.astype(np.int16)


class K1Tables(NamedTuple):
    """K1's tables on one device, checked once by :func:`k1_tables`."""
    row: torch.Tensor
    epos: torch.Tensor
    jobs: torch.Tensor
    slots: int
    stride: int
    n: int


def k1_tables(layout: K1Layout, row: torch.Tensor, epos: torch.Tensor,
              jobs: torch.Tensor, n: int) -> K1Tables:
    """Check the device copies of a :class:`K1Layout` once, so that
    :func:`bp_decode` need not on every call."""
    _check_tables(layout, row, epos, jobs, K1_THREADS)
    return K1Tables(row, epos, jobs, layout.slots, layout.stride, n)


def _check_tables(layout, row: torch.Tensor, epos: torch.Tensor, jobs: torch.Tensor,
                  threads: int) -> None:
    D, m = layout.row.shape
    dev = row.device
    _check(row, "row", torch.int16, (D, m), dev)
    _check(epos, "epos", torch.int16, (D, m), dev)
    _check(jobs, "jobs", torch.int32, (2, threads), dev)


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


class K2Layout(NamedTuple):
    """K2's host-built tables for one code (numpy), see :func:`k2_layout`."""
    row: np.ndarray    # [D, m] int16: variable on table slot d of thread c's check; n if none
    epos: np.ndarray   # [D, m] int16: that edge's slot in the message array; slots if none
    jobs: np.ndarray   # [2, K2_THREADS] int32: packed variable jobs of each thread; -1 none
    slots: int         # length of the message array (a multiple of 4)
    stride: int        # cells between a job's consecutive 4-slot cells


def unpack_k2_job(job: int) -> tuple[int, int, int]:
    """(variable, first 4-slot cell, group ends) of a packed K2 job: cell q
    of the job is cell ``first + q * stride`` of the message array, bit q of
    ``ends`` is set where cell q ends one of the variable's slot groups, and
    the job has as many cells as ``ends`` has bits up to its highest set one."""
    return job & 1023, (job >> 10) & 8191, (job >> 23) & 255


def k2_layout(row_idx: np.ndarray, row_mask: np.ndarray, n: int) -> K2Layout:
    """K2's tables: messages in the order K2 sums them, a balanced variable
    pass, and each check's edges spread over the D table slots.

    K2's posterior is ``llr + (((0 + s_0) + s_1) + ... + s_{D-1})``, where
    ``s_d`` sums, from 0.0 and in ascending check order, the messages that
    reach the variable through edge slot d: the order of
    :func:`slot_tables`.  A variable's messages are stored in that order,
    variable-major, then slot, then ascending check, and each non-empty slot
    group starts a fresh 4-slot cell, padded with zero slots after it, so
    that the kernel closes a group (adds its sum to the posterior's) only
    at the end of a cell.  A group of 1 to 3 messages starts at lane
    ``(cell // 8) % 4`` of its cell, as far as the cell holds it, to spread
    neighbouring cells' stores over the banks.  Zero slots before, inside
    or after a group change no bit of its sum, which starts from +0.0 and
    so is never -0.0.

    Variables are dealt to the K2_THREADS threads as in :func:`k1_layout`,
    by descending cell count, so no thread's chain of 128-bit loads per
    iteration is longer than the heaviest variable's cells (7 at R1_4).  A
    job packs ``v | first << 10 | ends << 23`` (:func:`unpack_k2_job`).

    The table slots: K2's check update does not depend on the order of a
    check's edges either, so they are placed as K1's are.  A slot with no
    edge holds the sentinel variable ``n`` and message slot ``slots``.
    """
    row_idx, row_mask = np.asarray(row_idx), np.asarray(row_mask)
    m, D = row_idx.shape
    T = K2_THREADS
    if n > 1023 or m > T:  # a job packs v in 10 bits; one thread per check
        raise ValueError(f"K2 takes n <= 1023 variables and m <= {T} checks")
    slot_ptr, _ = slot_tables(row_idx, row_mask, n)
    size = np.diff(slot_ptr, axis=1).T.astype(np.int64)   # [n, D] messages per slot group
    gcells = (size + 3) // 4
    cells = gcells.sum(axis=1)
    job_of, first, stride, n_cells = _deal_jobs(cells, T, "K2")
    slots = 4 * n_cells
    # The kernel addresses the messages by byte offsets from the start of
    # its shared memory (posteriors [n + 4], then the messages [slots + 4]).
    if cells.max(initial=0) > 8 or (n + slots + 8) * 4 > 65535 or (n + 4) // 4 + n_cells > 8191:
        raise ValueError(f"K2's message array of {slots} slots is too long")
    q0 = np.cumsum(gcells, axis=1) - gcells                # first job cell of each group
    ends = np.zeros(n, np.int64)
    for d in range(D):
        ends |= np.where(size[:, d] > 0, 1 << np.maximum(q0[:, d] + gcells[:, d] - 1, 0), 0)
    jobs = np.full((2, T), -1, np.int64)
    jobs[job_of[:, 0], job_of[:, 1]] = np.arange(n) | (first << 10) | (ends << 23)

    chk, slot = np.nonzero(row_mask)
    var = row_idx[chk, slot]
    rank = np.empty(len(chk), np.int64)                    # place in slot_tables' order
    rank[np.lexsort((chk, var, slot))] = np.arange(len(chk))
    i = rank - slot_ptr[slot, var]                         # place within its group
    g = size[var, slot]
    q = q0[var, slot] + np.where(g < 4, 0, i // 4)
    cell = first[var] + q * stride
    lane = np.where(g < 4, (cell // 8) % 4 % (5 - np.minimum(g, 4)) + i, i % 4)
    edge_slot = np.full((m, D), -1, np.int64)
    edge_slot[chk, slot] = 4 * cell + lane
    row, epos = _place_edges(row_idx, row_mask, edge_slot, n, slots)
    return K2Layout(row, epos, jobs.astype(np.int32), slots, stride)


class K2Tables(NamedTuple):
    """K2's tables on one device, checked once by :func:`k2_tables`."""
    row: torch.Tensor
    epos: torch.Tensor
    jobs: torch.Tensor
    slots: int
    stride: int
    n: int


def k2_tables(layout: K2Layout, row: torch.Tensor, epos: torch.Tensor,
              jobs: torch.Tensor, n: int) -> K2Tables:
    """Check the device copies of a :class:`K2Layout` once, so that
    :func:`bp_decode_v1` need not on every call."""
    _check_tables(layout, row, epos, jobs, K2_THREADS)
    return K2Tables(row, epos, jobs, layout.slots, layout.stride, n)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else shutil.which("nvcc")
    if not nvcc or not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the LDPC kernels need the CUDA toolkit to build")
    return nvcc


def library_path(source: Path | None = None, defines: tuple[str, ...] = ()) -> Path:
    """Path of the built library for ``source`` (default K1's), the flags and
    any extra ``defines`` (``-DNAME=VALUE``)."""
    source = _SOURCE if source is None else source
    flags = " ".join((*_NVCC_FLAGS, *defines))
    digest = hashlib.sha256(source.read_bytes() + flags.encode())
    return BUILD_DIR / f"{source.stem}_{digest.hexdigest()[:16]}.so"


class Build(NamedTuple):
    path: Path
    log: str         # nvcc's output; empty when the library was already built
    seconds: float   # wall time of the compile; 0 when already built


def compile_libraries(sources: dict[str, tuple[Path, tuple[str, ...]]]) -> dict[str, Build]:
    """Compile each ``name: (source, defines)`` whose library is missing, one
    ``nvcc`` per library, all started together.  Raises with nvcc's output
    when a compile fails.  One call at a time in a process; each compile
    writes a temporary named by process and thread and moves it into place,
    so processes building the same library at once each leave it whole."""
    with _BUILD_LOCK:
        return _compile_missing(sources)


def _compile_missing(sources: dict[str, tuple[Path, tuple[str, ...]]]) -> dict[str, Build]:
    results, procs = {}, {}
    missing = {name for name, (src, defs) in sources.items()
               if not library_path(src, defs).exists()}
    nvcc = _nvcc() if missing else ""
    for name, (source, defines) in sources.items():
        out = library_path(source, defines)
        if name not in missing:
            results[name] = Build(out, "", 0.0)
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
        proc = subprocess.Popen([nvcc, *_NVCC_FLAGS, *defines, "-o", str(tmp), str(source)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        procs[name] = (proc, tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed on {sources[name][0].name} ({proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        results[name] = Build(out, log, time.perf_counter() - t0)
    if failed:
        raise RuntimeError("\n".join(failed))
    return results


def build() -> dict[str, Build]:
    """Compile every library of :data:`LIBRARIES` that is missing, all at
    once.  Returns ``{"ldpc_bp": ..., "ldpc_bp_bf16": ..., "ldpc_bp_v1": ...}``."""
    return compile_libraries(dict(LIBRARIES))


# Pointer and int arguments of each C entry point (then the stream).
_ARGS = {"ldpc_bp": (9, 8), "ldpc_bp_v1": (9, 8)}


def _library(name: str) -> ctypes.CDLL:
    with _LOAD_LOCK:
        if name not in _LIBRARIES:
            _LIBRARIES[name] = ctypes.CDLL(str(build()[name].path))
        return _LIBRARIES[name]


def entry_point(lib: ctypes.CDLL, name: str):
    """Kernel ``name``'s C entry point in ``lib``, with its argument types."""
    fn = getattr(lib, f"ria_{name}_decode")
    ptrs, ints = _ARGS[name]
    fn.argtypes = [ctypes.c_void_p] * ptrs + [ctypes.c_int] * ints + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _entry(name: str):
    lib = _library(name)
    with _LOAD_LOCK:
        if name not in _ENTRIES:
            _ENTRIES[name] = entry_point(lib, LIBRARIES[name][0].stem)
        return _ENTRIES[name]


def resources(lib: ctypes.CDLL, name: str, n: int, slots: int) -> dict[str, int]:
    """What kernel ``name`` of ``lib`` uses on the current card for a code of
    n variables and ``slots`` message slots: registers and local (spill)
    bytes per thread, shared bytes per block and blocks resident per SM,
    from the CUDA runtime."""
    fn = getattr(lib, f"ria_{name}_resources")
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 4)()
    err = fn(n, slots, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"ria_{name}_resources failed: CUDA error {err}")
    return dict(zip(("registers", "local_bytes", "shared_bytes", "blocks_per_sm"), out))


def k1_library(precision: str) -> str:
    """K1's library for ``precision`` (``"f32"`` or ``"bf16"``)."""
    if precision not in K1_LIBRARY:
        raise ValueError(f"K1 has no build for precision {precision!r}")
    return K1_LIBRARY[precision]


def k1_resources(n: int, slots: int, precision: str = "f32") -> dict[str, int]:
    """:func:`resources` of K1's build of ``precision``."""
    return resources(_library(k1_library(precision)), "ldpc_bp", n, slots)


def k2_resources(n: int, slots: int) -> dict[str, int]:
    """:func:`resources` of the built K2."""
    return resources(_library("ldpc_bp_v1"), "ldpc_bp_v1", n, slots)


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


def bp_decode(llrs: torch.Tensor, factors: torch.Tensor, tables: K1Tables,
              k: int, max_iters: int, precision: str = "f32"):
    """Launch K1 on CUDA tensors: (info_bits, success, iterations, llr_total).

    llrs [B, n] f32 and factors [B] f32, contiguous, on the device of
    ``tables`` (:func:`k1_tables`).  Outputs: info_bits [B, k] uint8,
    success [B] bool, iterations [B] int32, llr_total [B, n] f32.
    ``precision`` picks the build: ``"f32"`` (counted in ``LAUNCHES``) or
    ``"bf16"``, bfloat16 operands (``LAUNCHES_BF16``).
    """
    global LAUNCHES, LAUNCHES_BF16
    lib = k1_library(precision)
    name = "K1" if precision == "f32" else "K1 bf16"
    out, launched = launch(lambda: _entry(lib), name, llrs, factors, tables, k, max_iters)
    with _COUNT_LOCK:
        if precision == "f32":
            LAUNCHES += launched
        else:
            LAUNCHES_BF16 += launched
    return out


def bp_decode_v1(llrs: torch.Tensor, factors: torch.Tensor, tables: K2Tables,
                 k: int, max_iters: int):
    """Launch K2 on CUDA tensors: (info_bits, success, iterations, llr_total).

    Arguments and outputs as :func:`bp_decode`, with K2's tables
    (:func:`k2_tables`).
    """
    global LAUNCHES_V1
    out, launched = launch(lambda: _entry("ldpc_bp_v1"), "K2", llrs, factors, tables, k,
                           max_iters)
    with _COUNT_LOCK:
        LAUNCHES_V1 += launched
    return out


def launch(entry, kernel: str, llrs: torch.Tensor, factors: torch.Tensor,
           tables: K1Tables | K2Tables, k: int, max_iters: int):
    """Check ``llrs`` and ``factors`` and launch the C entry point that
    ``entry()`` returns (:func:`entry_point`; asked for only once the inputs
    passed, so a CPU tensor raises before anything is built) on them with
    ``tables``.  Returns the outputs and the number of launches (0 for an
    empty batch).  Counts nothing: the wrappers of the port's kernels do."""
    if llrs.device.type != "cuda":
        raise ValueError(f"{kernel} takes CUDA tensors, got {llrs.device}")
    dev = tables.row.device
    _check(llrs, "llrs", torch.float32, (llrs.shape[0], tables.n), dev)
    _check(factors, "factors", torch.float32, (llrs.shape[0],), dev)
    if llrs.data_ptr() % 16:  # the kernel copies each row with one bulk copy
        llrs = llrs.clone()
    B, n = llrs.shape
    D, m = tables.row.shape
    out = _outputs(llrs, k)
    if not B:  # an empty batch launches nothing
        return out, 0
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (llrs.data_ptr(), factors.data_ptr(), tables.row.data_ptr(), tables.epos.data_ptr(),
            tables.jobs.data_ptr(), *_out_ptrs(out), B, n, m, k, D, tables.slots,
            tables.stride, max_iters, stream)
    fn = entry()
    if dev.index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(dev):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err}")
    return out, 1


def _outputs(llrs: torch.Tensor, k: int):
    """Empty (info_bits, success, iterations, llr_total) for a batch."""
    dev = llrs.device
    B = llrs.shape[0]
    return (torch.empty((B, k), dtype=torch.uint8, device=dev),
            torch.empty(B, dtype=torch.bool, device=dev),
            torch.empty(B, dtype=torch.int32, device=dev),
            torch.empty_like(llrs))


def _out_ptrs(out) -> tuple[int, int, int, int]:
    """The outputs' pointers in the C entry points' order: llr_total,
    info_bits, success, iterations."""
    info, success, iters, llr_total = out
    return llr_total.data_ptr(), info.data_ptr(), success.data_ptr(), iters.data_ptr()
