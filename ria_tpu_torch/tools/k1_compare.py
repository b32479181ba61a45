"""Hold kernel K1 against an earlier K1 source, bit for bit, and time both.

The earlier source is one with K1's CSC-list interface: C entry point
``ria_ldpc_bp_decode(llr, factors, row_idx, row_mask, col_ptr, col_edge,
llr_out, info_out, ok_out, iters_out, B, n, m, k, D, max_iters, stream)``
with ``row_idx`` int32 and ``row_mask`` bool [m, D], ``col_ptr``/``col_edge``
int32 from ``ldpc_kernel.csc_tables``.  That is
``ria_tpu_torch/csrc/ldpc_bp.cu`` as it stood before K1 took its packed
CSC-ordered tables.  Run from the root of a checkout, on a CUDA host:

    git show <commit>:ria_tpu_torch/csrc/ldpc_bp.cu > build/ldpc_bp_before.cu
    python -m ria_tpu_torch.tools.k1_compare build/ldpc_bp_before.cu

The earlier source is built with the flags of ``ldpc_kernel.build`` (ptxas'
resource lines are printed).  Both kernels decode the same LLRs, at the
rate's iteration count and the per-row factor ladder of ``chip_smoke.py``:
every rate at B = 8 and 256, the mixed R1/4 batch (B = 512), and the A/B
point (``ldpc_bench``: R1/4, B = 512, -1 dB, factor 0.75).  A line per batch
gives the rows on which any output differs (success, iterations, info bits,
or posterior bits: ``torch.equal``, no tolerance) and the largest posterior
difference.  Then the device time per launch (torch.profiler, 20 launches)
of each, in turns (before, after, after, before), at R1/4 B = 256 and 10 dB
(one iteration, as on the main path) and at the A/B point.  Exits 1 if any
row differs.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ria_tpu_torch.fec import ldpc_kernel
from ria_tpu_torch.fec.ldpc import DecodeResult, ldpc_decoder
from ria_tpu_torch.fec.ldpc_matrix import CODE_PARAMS, encode_np, get_code
from ria_tpu_torch.tools import ldpc_bench
from ria_tpu_torch.utils.timing import device_us

FACTORS = np.array([0.9375, 0.875, 0.75, 0.625, 0.5], np.float32)
SIGMA = {"R1_4": 2.4, "R1_2": 1.8, "R2_3": 1.5, "R3_4": 1.4, "R5_6": 1.4}


def _build_before(source: Path) -> ctypes.CDLL:
    out = ldpc_kernel.library_path(source)
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        proc = subprocess.run([ldpc_kernel._nvcc(), *ldpc_kernel._NVCC_FLAGS, "-o", str(out),
                               str(source)], capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {source}:\n{proc.stdout}{proc.stderr}")
        print(f"built {source} in {time.perf_counter() - t0:.2f} s")
        for line in (proc.stdout + proc.stderr).splitlines():
            if "registers" in line or "bytes stack" in line:
                print(f"  ptxas: {line.strip()}")
    return ctypes.CDLL(str(out))


def _before_decoder(lib: ctypes.CDLL, rate: str, dev: torch.device):
    fn = lib.ria_ldpc_bp_decode
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dec = ldpc_decoder(rate, None, dev)
    code = get_code(rate)
    col_ptr, col_edge = ldpc_kernel.csc_tables(code.row_idx, code.row_mask, code.n)
    tables = [torch.as_tensor(t, device=dev) for t in (code.row_idx, code.row_mask,
                                                        col_ptr, col_edge)]

    def decode(x: torch.Tensor, f: torch.Tensor) -> DecodeResult:
        info, success, iters, post = ldpc_kernel._outputs(x, dec.k)
        err = fn(x.data_ptr(), f.data_ptr(), *(t.data_ptr() for t in tables),
                 post.data_ptr(), info.data_ptr(), success.data_ptr(), iters.data_ptr(),
                 x.shape[0], dec.n, dec.m, dec.k, dec.D, dec.max_iters,
                 torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"earlier K1 launch failed: CUDA error {err}")
        return DecodeResult(info, success, iters, post)

    return decode


def _batch(rate: str, B: int, rng: np.random.Generator, mixed: bool = False):
    info = rng.integers(0, 2, (B, get_code(rate).k))
    llr = (1.0 - 2.0 * encode_np(info, rate).astype(np.float32)) * 4.0
    noise = rng.normal(0, 1.0 if mixed else SIGMA[rate], llr.shape).astype(np.float32)
    if mixed:
        noise[B // 2 :] = rng.normal(0, 2.6, (B - B // 2, llr.shape[1])).astype(np.float32)
    return llr + noise, np.resize(FACTORS, B)


def _differing(a: DecodeResult, b: DecodeResult) -> tuple[int, float]:
    bad = a.success != b.success
    bad |= a.iterations != b.iterations
    bad |= (a.info_bits != b.info_bits).any(dim=1)
    diff = (a.llr_total - b.llr_total).abs()
    bad |= (a.llr_total.view(torch.int32) != b.llr_total.view(torch.int32)).any(dim=1)
    return int(bad.sum()), float(diff.max())


def run(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print(__doc__)
        return 2
    dev = torch.device("cuda", 0)
    lib = _build_before(Path(argv[0]))
    ldpc_kernel.build()
    rng = np.random.default_rng(1234)
    cases = [(rate, B, False) for rate in CODE_PARAMS for B in (8, 256)]
    cases.append(("R1_4", 512, True))
    total = 0
    batches = []
    for rate, B, mixed in cases:
        llr, fac = _batch(rate, B, rng, mixed)
        batches.append((f"{rate} B={B}{' mixed' if mixed else ''}", rate, llr, fac))
    ab = ldpc_bench.make_llrs("R1_4", 512, -1.0)[1]
    batches.append(("R1_4 B=512 A/B -1 dB", "R1_4", ab, np.full(512, 0.75, np.float32)))
    for tag, rate, llr, fac in batches:
        x, f = torch.as_tensor(llr, device=dev), torch.as_tensor(fac, device=dev)
        before = _before_decoder(lib, rate, dev)(x, f)
        after = ldpc_decoder(rate, None, dev)(x, f)
        torch.cuda.synchronize()
        n_bad, err = _differing(before, after)
        total += n_bad
        print(f"{tag}: mean iterations {after.iterations.float().mean():.2f}, "
              f"rows differing {n_bad}, max |posterior difference| {err:.3g}")
    print(f"bit-identical: {'yes' if total == 0 else 'NO'} ({total} rows differ)")

    main = ldpc_bench.make_llrs("R1_4", 256, 10.0)[1]
    for tag, llr in (("R1_4 B=256 10 dB", main), ("R1_4 B=512 A/B -1 dB", ab)):
        x = torch.as_tensor(llr, device=dev)
        f = torch.full((x.shape[0],), 0.75, device=dev)
        fns = {"before": (lambda d=_before_decoder(lib, "R1_4", dev): d(x, f)),
               "after": (lambda d=ldpc_decoder("R1_4", None, dev): d(x, f))}
        for fn in fns.values():
            for _ in range(3):
                fn()
        us = [(name, device_us(fns[name], "ldpc_bp_kernel"))
              for name in ("before", "after", "after", "before")]
        b = [t for name, t in us if name == "before"]
        a = [t for name, t in us if name == "after"]
        print(f"{tag}: device us per launch, in turns: "
              + ", ".join(f"{name} {t:.2f}" for name, t in us)
              + f"; after/before {sum(a) / sum(b):.4f}")
    return 1 if total else 0


if __name__ == "__main__":
    sys.exit(run())
