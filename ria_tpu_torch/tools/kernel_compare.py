"""Hold kernel K1 or K2 against an earlier source of the same kernel, bit for bit, and time both.

Run from the root of a checkout, on a CUDA host:

    git show <commit>:ria_tpu_torch/csrc/ldpc_bp.cu > build/ldpc_bp_before.cu
    python -m ria_tpu_torch.tools.kernel_compare --kernel k1 build/ldpc_bp_before.cu
    git show <commit>:ria_tpu_torch/csrc/ldpc_bp_v1.cu > build/ldpc_bp_v1_before.cu
    python -m ria_tpu_torch.tools.kernel_compare --kernel k2 build/ldpc_bp_v1_before.cu
    python -m ria_tpu_torch.tools.kernel_compare --kernel k1 --interface tables \
        --precision bf16 build/ldpc_bp_before.cu

The earlier source has one of two interfaces.  ``--interface lists`` (the
default) is the one both kernels had before they took their packed tables:
C entry point ``ria_ldpc_bp_decode`` (k1) or ``ria_ldpc_bp_v1_decode`` (k2)
``(llr, factors, row_idx, row_mask, a, b, llr_out, info_out, ok_out,
iters_out, B, n, m, k, D, max_iters, stream)`` with ``row_idx`` int32 and
``row_mask`` bool [m, D], and ``a``/``b`` int32: ``col_ptr``/``col_edge``
from ``ldpc_kernel.csc_tables`` for k1, ``slot_ptr``/``slot_chk`` from
``ldpc_kernel.slot_tables`` for k2.  That is ``ria_tpu_torch/csrc/ldpc_bp.cu``
and ``ldpc_bp_v1.cu`` at commit 5fb6243.  ``--interface tables`` is today's
(the same names, taking the float32 tables of ``ldpc_kernel.k1_layout`` or
``k2_layout``), that of those files from commit 24697e0 (k1) or 71b0fa9
(k2) on.

``--precision bf16`` holds the bf16 builds: the earlier source built with
``-DRIA_BF16_OPERANDS`` on the float32 tables, as K1's and K2's bf16
builds were made up to commit 137700e (it needs ``--interface tables``),
against the checkout's bf16 source
(``ldpc_kernel.K1_LIBRARY["bf16"]`` or ``K2_LIBRARY["bf16"]``) on its own
tables.  Each computes the plain bf16 decoder, so the two must agree bit
for bit.

The later kernel is the checkout's.  ``--define NAME=VALUE`` (repeatable)
builds it with those macros, in a library of its own: the ``K2_*``
switches of ``csrc/ldpc_bp_v1.cu`` each turn one lever of its design off.
Every library is built with the flags of ``ldpc_kernel.build`` (ptxas'
resource lines are printed), and each kernel's registers, spill, shared
bytes and blocks per SM as the CUDA runtime reports them (the earlier one's
where its library has the entry point).  Where the toolkit has
``cuobjdump``, it prints whether the two libraries' SASS is the same,
instruction for instruction (the kernels' names aside): an unchanged
source's builds are.

Both kernels decode the same LLRs, at the rate's iteration count and the
per-row factor ladder of ``chip_smoke.py``: every rate at B = 8 and 256, the
mixed R1/4 batch (B = 512), and the A/B point (``ldpc_bench``: R1/4, B =
512, -1 dB, factor 0.75).  A line per batch gives the rows on which any
output differs (success, iterations, info bits, or posterior bits:
``torch.equal``, no tolerance) and the largest posterior difference.  Then
the device time per launch (torch.profiler, 20 launches) of each, in turns
(before, after, after, before), at R1/4 B = 256 and 10 dB (``ldpc_bench``'s
LLRs, few iterations, as on the main path), at the A/B point, and at the
serial floor: B = 1 on the first A/B row that runs all 50 iterations.  The last line is a JSON
summary.  Exits 1 if any row differs.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ria_tpu_torch.fec import ldpc_kernel
from ria_tpu_torch.fec.ldpc import DecodeResult, ldpc_decoder
from ria_tpu_torch.fec.ldpc_matrix import CODE_PARAMS, encode_np, get_code
from ria_tpu_torch.tools import ldpc_bench
from ria_tpu_torch.utils.timing import kernel_us

FACTORS = np.array([0.9375, 0.875, 0.75, 0.625, 0.5], np.float32)
SIGMA = {"R1_4": 2.4, "R1_2": 1.8, "R2_3": 1.5, "R3_4": 1.4, "R5_6": 1.4}
# Per kernel (also the attribute of LDPCDecoder that holds its tables): the
# stem of its earlier source's entry points, its libraries by precision, and
# the earlier list interface's host lists.
KERNELS = {
    "k1": ("ldpc_bp", ldpc_kernel.K1_LIBRARY, ldpc_kernel.csc_tables),
    "k2": ("ldpc_bp_v1", ldpc_kernel.K2_LIBRARY, ldpc_kernel.slot_tables),
}
INTERFACES = ("lists", "tables")
# What the earlier source is built with, by precision.
BEFORE_DEFINES = {"f32": (), "bf16": ("-DRIA_BF16_OPERANDS",)}


def _print_ptxas(tag: str, b: ldpc_kernel.Build) -> None:
    if b.log:
        print(f"built {tag} in {b.seconds:.2f} s")
    for line in b.log.splitlines():
        if "registers" in line or "bytes stack" in line:
            print(f"  ptxas: {line.strip()}")


def _before_decoder(lib: ctypes.CDLL, kernel: str, interface: str, rate: str,
                    dev: torch.device):
    """The earlier kernel of ``lib`` on ``rate``: through its list interface,
    or through today's on the float32 tables."""
    name, _, lists = KERNELS[kernel]
    if interface == "tables":
        return _table_decoder(ldpc_kernel.entry_point(lib, name), kernel, rate, "f32", dev)
    fn = getattr(lib, f"ria_{name}_decode")
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dec = ldpc_decoder(rate, None, dev)
    code = get_code(rate)
    tables = [torch.as_tensor(t, device=dev)
              for t in (code.row_idx, code.row_mask, *lists(code.row_idx, code.row_mask, code.n))]

    def decode(x: torch.Tensor, f: torch.Tensor) -> DecodeResult:
        info, success, iters, post = ldpc_kernel._outputs(x, dec.k)
        err = fn(x.data_ptr(), f.data_ptr(), *(t.data_ptr() for t in tables),
                 post.data_ptr(), info.data_ptr(), success.data_ptr(), iters.data_ptr(),
                 x.shape[0], dec.n, dec.m, dec.k, dec.D, dec.max_iters,
                 torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"earlier {kernel} launch failed: CUDA error {err}")
        return DecodeResult(info, success, iters, post)

    return decode


def _table_decoder(fn, kernel: str, rate: str, precision: str, dev: torch.device):
    """A kernel of today's interface, its C entry point ``fn``, on the tables
    of ``precision``."""
    dec = ldpc_decoder(rate, None, dev, precision)
    tables = getattr(dec, kernel)

    def decode(x: torch.Tensor, f: torch.Tensor) -> DecodeResult:
        return DecodeResult(*ldpc_kernel.launch(lambda: fn, kernel.upper(), x, f, tables,
                                                dec.k, dec.max_iters, precision)[0])

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


def sass(path: Path) -> list[str] | None:
    """The SASS instructions of a library (``cuobjdump -sass``), without its
    functions' names; None where the toolkit has no cuobjdump."""
    from torch.utils.cpp_extension import CUDA_HOME

    tool = Path(CUDA_HOME or "/nonexistent", "bin", "cuobjdump")
    tool = str(tool) if tool.exists() else shutil.which("cuobjdump")
    if not tool:
        return None
    out = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True,
                         check=True).stdout
    return instructions(out)


def instructions(listing: str) -> list[str]:
    """The instruction lines (``/*0000*/ ...``) of a ``cuobjdump -sass``
    listing, stripped."""
    return [line.strip() for line in listing.splitlines()
            if re.match(r"\s*/\*[0-9a-f]{4}\*/", line)]


def _parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", required=True, choices=sorted(KERNELS))
    ap.add_argument("--interface", choices=INTERFACES, default="lists",
                    help="the earlier source's: 5fb6243's lists (default) or today's tables")
    ap.add_argument("--precision", choices=tuple(BEFORE_DEFINES), default="f32",
                    help="the builds compared: float32 (default) or bf16")
    ap.add_argument("--define", action="append", default=[], metavar="NAME=VALUE",
                    help="a macro for the checkout's kernel (repeatable)")
    ap.add_argument("before", type=Path, help="the earlier source")
    args = ap.parse_args(argv)
    if args.precision == "bf16" and args.interface != "tables":
        ap.error("--precision bf16 needs --interface tables (the list interface had no "
                 "bf16 build)")
    return args


def run(argv=None) -> int:
    args = _parse(sys.argv[1:] if argv is None else argv)
    kernel, precision = args.kernel, args.precision
    name, libraries, _ = KERNELS[kernel]
    source, defines = ldpc_kernel.LIBRARIES[libraries[precision]]
    defines = (*defines, *(f"-D{d}" for d in args.define))
    after_name = source.stem
    dev = torch.device("cuda", 0)
    builds = ldpc_kernel.compile_libraries({"before": (args.before, BEFORE_DEFINES[precision]),
                                            "after": (source, defines)})
    for tag, b in builds.items():
        _print_ptxas(tag, b)
    lib_before, lib_after = (ctypes.CDLL(str(builds[t].path)) for t in ("before", "after"))
    dec = ldpc_decoder("R1_4", None, dev)
    dec_after = ldpc_decoder("R1_4", None, dev, precision)
    res = {"after": ldpc_kernel.resources(lib_after, after_name, dec.n,
                                          getattr(dec_after, kernel).slots)}
    if hasattr(lib_before, f"ria_{name}_resources"):
        res["before"] = ldpc_kernel.resources(lib_before, name, dec.n,
                                              getattr(dec, kernel).slots)
    for which, r in res.items():
        built = " ".join(defines) if which == "after" and defines else "(as built)"
        print(f"{kernel} {precision} {which} {built} at R1_4: {r}")
    listings = [sass(builds[t].path) for t in ("before", "after")]
    same_sass = None if None in listings else listings[0] == listings[1]
    if same_sass is not None:
        print(f"SASS of the two libraries: {'identical' if same_sass else 'different'} "
              f"({len(listings[0])} and {len(listings[1])} instructions)")

    def before_decoder(rate):
        return _before_decoder(lib_before, kernel, args.interface, rate, dev)

    def after_decoder(rate):
        return _table_decoder(ldpc_kernel.entry_point(lib_after, after_name), kernel, rate,
                              precision, dev)

    rng = np.random.default_rng(1234)
    batches = []
    for rate, B, mixed in [(rate, B, False) for rate in CODE_PARAMS for B in (8, 256)] + [
            ("R1_4", 512, True)]:
        llr, fac = _batch(rate, B, rng, mixed)
        batches.append((f"{rate} B={B}{' mixed' if mixed else ''}", rate, llr, fac))
    ab = ldpc_bench.make_llrs("R1_4", 512, -1.0)[1]
    batches.append(("R1_4 B=512 A/B -1 dB", "R1_4", ab, np.full(512, 0.75, np.float32)))
    total = 0
    for tag, rate, llr, fac in batches:
        x, f = torch.as_tensor(llr, device=dev), torch.as_tensor(fac, device=dev)
        before = before_decoder(rate)(x, f)
        after = after_decoder(rate)(x, f)
        torch.cuda.synchronize()
        n_bad, err = _differing(before, after)
        total += n_bad
        print(f"{tag}: mean iterations {after.iterations.float().mean():.2f}, "
              f"rows differing {n_bad}, max |posterior difference| {err:.3g}")
    print(f"bit-identical: {'yes' if total == 0 else 'NO'} ({total} rows differ)")

    x_ab = torch.as_tensor(ab, device=dev)
    f_ab = torch.full((512,), 0.75, device=dev)
    ab_after = after_decoder("R1_4")(x_ab, f_ab)
    row = int(torch.nonzero((ab_after.iterations == 50) & ~ab_after.success)[0])
    main = torch.as_tensor(ldpc_bench.make_llrs("R1_4", 256, 10.0)[1], device=dev)
    symbols = {"before": f"{name}_kernel", "after": f"{after_name}_kernel"}
    times = {}
    for tag, x in (("R1_4 B=256 10 dB", main), ("R1_4 B=512 A/B -1 dB", x_ab),
                   (f"serial floor B=1 A/B row {row}", x_ab[row : row + 1])):
        f = torch.full((x.shape[0],), 0.75, device=dev)
        fns = {"before": (lambda d=before_decoder("R1_4"): d(x, f)),
               "after": (lambda d=after_decoder("R1_4"): d(x, f))}
        for fn in fns.values():
            for _ in range(3):
                fn()
        iters = float(fns["after"]().iterations.float().mean())
        us = [(which, kernel_us(fns[which], symbols[which])[0])
              for which in ("before", "after", "after", "before")]
        b = [t for which, t in us if which == "before"]
        a = [t for which, t in us if which == "after"]
        times[tag] = {"before": b, "after": a, "mean_iterations": iters}
        print(f"{tag} (mean iterations {iters:.2f}): device us per launch, in turns: "
              + ", ".join(f"{which} {t:.2f}" for which, t in us)
              + f"; after/before {sum(a) / sum(b):.4f}")
    print(json.dumps({"kernel": kernel, "precision": precision, "interface": args.interface,
                      "defines": list(args.define), "rows_differing": total,
                      "resources": res, "sass_identical": same_sass,
                      "device": torch.cuda.get_device_name(0), "device_us": times}))
    return 1 if total else 0


if __name__ == "__main__":
    sys.exit(run())
