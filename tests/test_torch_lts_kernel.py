"""The light preamble's LTS search's CUDA kernels on a host without a card:
the CPU path never reaches them, their wrapper refuses what they do not take
before anything is built or counted, their C entry points are bound as the
source declares them, ATen's scan geometry is formed for the cell's shapes
as ATen forms it, the search's scalars come from one place and are formed
as ATen forms them, each search launches each kernel once, and the kernels'
search nests ``sync.coarse`` and ``sync.fine`` inside ``rx.sync`` with
kernels of ``rx.sync``'s own before and after them.  (The kernels themselves
run in ``tests/test_torch_lts_kernel_cuda.py``, on a card; the plain search's
spans are held in ``tests/test_torch_ofdm_light_pipeline.py``.)
"""

from __future__ import annotations

import ast
import ctypes
import inspect
import re
import textwrap
import types

import numpy as np
import pytest
import torch

from ria_tpu_torch.sync import lts_kernel, sc_kernel
from ria_tpu_torch.utils import cuda_kernels
from ria_tpu_torch.wave import ofdm

CFG = ofdm.OFDMConfig(modulation="DQPSK", use_pilots=True, pilot_spacing=10)
N = 48000
ENTRIES = ("lts_pad", "lts_front", "lts_pick", "lts_decide")
SOURCE = cuda_kernels.LIBRARIES["lts_search"][0]


def _window(B: int, n: int = N, seed: int = 0) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 0.3, (B, n)).astype(np.float32)
    f = ofdm.tx_frame(rng.integers(0, 2, 4 * 648), CFG, "lts")
    x[:, 700 : 700 + len(f)] += f[: n - 700]
    return torch.as_tensor(x)


def _refuse(*args, **kwargs):
    raise AssertionError("the CUDA kernels were reached from a CPU tensor")


def _launches() -> list[int]:
    return [cuda_kernels.launches(name) for name in ENTRIES]


def test_cpu_tensor_never_reaches_the_kernels(monkeypatch):
    """On the CPU the detector neither loads nor launches the kernels, and
    their launch counts stay as they were."""
    monkeypatch.setattr(lts_kernel, "load", _refuse)
    monkeypatch.setattr(lts_kernel, "search", _refuse)
    monkeypatch.setattr(cuda_kernels, "load", _refuse)
    monkeypatch.setattr(cuda_kernels, "launch", _refuse)
    before = _launches()
    det = ofdm.LTSDetector(CFG, N, 0.5, "cpu")
    res = det(_window(2))
    assert bool(res.detected.all()) and all(abs(s - 700) <= 16 for s in res.lts_start.tolist())
    assert ofdm.lts_search(_window(1)[0], CFG).lts_start.shape == ()
    assert _launches() == before


def test_search_refuses_another_device_without_counting(monkeypatch):
    """``lts_kernel.search`` raises before anything is built, launched or
    counted when x is not on the detector's device: it has no path that
    falls back to the plain search."""
    monkeypatch.setattr(cuda_kernels, "load", _refuse)
    monkeypatch.setattr(cuda_kernels, "launch", _refuse)
    det = ofdm.LTSDetector(CFG, N, 0.5, "cpu")
    before = _launches()
    with pytest.raises(ValueError, match="the detector is on cpu, x on meta"):
        lts_kernel.search(det, torch.zeros(2, N, device="meta"))
    assert _launches() == before


def _signatures(source: str) -> dict[str, list[str]]:
    """Each ``extern "C" int ria_<entry>(...)`` of the source: its parameters."""
    return {name: [p.strip() for p in params.split(",")]
            for name, params in re.findall(r'extern "C" int ria_(\w+)\(([^)]*)\)', source)}


def test_lts_search_is_a_library_of_the_table_and_typed():
    """``lts_search`` is a library of ``cuda_kernels.LIBRARIES``, linked to the
    runtime PyTorch has loaded, and each of its C entry points, as
    ``lts_kernel`` declares it and bound on a stand-in library (no nvcc
    here), takes a pointer for each pointer of the source's signature and
    for the stream, an int for each int, in the source's order."""
    source, flags = cuda_kernels.LIBRARIES["lts_search"]
    assert source.name == "lts_search.cu" and source.is_file()
    assert flags == ("-cudart", "shared")
    text = source.read_text()
    assert '#include "aten_order.cuh"' in text
    sigs = _signatures(text)
    assert sorted(sigs) == sorted(ENTRIES) == sorted(lts_kernel._KERNELS)
    lib = types.SimpleNamespace(**{f"ria_{name}": types.SimpleNamespace() for name in ENTRIES})
    for name, params in sigs.items():
        kinds = ["ptr" if "*" in p else "int" for p in params]
        assert params[-1] == "void* stream", name
        n_ptr = kinds.index("int")
        assert kinds == ["ptr"] * n_ptr + ["int"] * (len(kinds) - n_ptr - 1) + ["ptr"], name
        fn = lts_kernel._KERNELS[name].typed(lib)
        assert fn.argtypes == ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * (len(kinds) - n_ptr - 1)
                               + [ctypes.c_void_p]), name
        assert fn.restype is ctypes.c_int


def test_the_kernels_are_loaded_from_their_library(monkeypatch):
    """``lts_kernel.load`` and every launch bind an entry of ``lts_search``."""
    seen = []

    class StandIn:
        def __getattr__(self, name):
            fn = types.SimpleNamespace()
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(cuda_kernels, "load", lambda library: seen.append(library) or StandIn())
    for kernel in lts_kernel._KERNELS.values():
        monkeypatch.setattr(kernel, "_fn", None)
    lts_kernel.load()
    assert seen == ["lts_search"] * len(ENTRIES)
    assert all(k.library == "lts_search" and k.fn() is not None
               for k in lts_kernel._KERNELS.values())
    assert seen == ["lts_search"] * len(ENTRIES)  # bound once


@pytest.mark.parametrize("B,n,log_x", [(1024, N, 7), (256, N, 8), (64, N, 9), (8, N, 9),
                                       (1, N, 9), (1, 2304, 9), (2, 120000, 9)])
def test_the_scan_geometry_is_atens_for_the_windows(B, n, log_x):
    """The wrapper scans B rows of n squares in ATen's chunks for B rows of
    n (``get_log_num_threads_x_inner_scan``; the cell's 1,024 windows in
    chunks of 256, a few windows or one in chunks of 1,024)."""
    plan = lts_kernel._plan(B, n, CFG.symbol_samples, 227 * 1024)
    assert plan.log_x == log_x == sc_kernel.scan_log_threads(B, n)


def test_the_cells_row_fits_in_a_block_and_a_long_one_takes_the_scratch():
    """``lts_front``'s row at the cell (the squares and the scan's chains)
    fits in a block's shared memory; a 120,000-sample window's does not and
    takes the global scratch.  e's rows start on 16-byte boundaries."""
    limit = 227 * 1024 - sc_kernel._SMEM_SLACK
    L = CFG.symbol_samples
    cell = lts_kernel._plan(1024, N, L, limit)
    assert cell.smem == cell.row_bytes == lts_kernel.front_bytes(N, 7) < limit
    assert lts_kernel._plan(1, N, L, limit).smem > 0
    long = lts_kernel._plan(6, 120000, L, limit)
    assert long.smem == 0 and long.row_bytes > limit
    for plan, n in ((cell, N), (long, 120000)):
        assert plan.lde % 4 == 0 and n - L <= plan.lde < n - L + 4


def _enum_consts() -> list[str]:
    body = re.search(r"enum Const \{(.*?)\};", SOURCE.read_text(), re.S).group(1)
    return re.findall(r"^\s*(k\w+)", body, re.M)


def test_consts_are_the_plain_search_scalars():
    """The kernels' constants, in the order of the source's ``enum Const``,
    are the float32 values ATen makes of the plain search's Python scalars;
    the first-tap refinement's spans are its integers."""
    det = ofdm.LTSDetector(CFG, N, 0.5, "cpu")
    c = det.lts_consts
    f32 = np.float32
    want = {"kFloorRatio": 1e-6, "kRefEnergy": det.ref_energy, "kEMin": 1e-12,
            "kPrevRatio": 0.92, "kTapRatio": 0.6, "kRepeatRatio": 0.5, "kThreshold": 0.5,
            "kFs": 48000.0, "kInvTwoPiSym": f32(1) / f32(2 * np.pi * CFG.symbol_samples),
            "kScale": 2.0 ** -16}
    assert _enum_consts() == [*want, "kNumConsts"]
    assert c.dtype == torch.float32 and c.shape == (len(want),)
    for i, (name, v) in enumerate(want.items()):
        assert c[i].item() == float(f32(v)), name
    assert det.nfft == 1 << 16 and det.refine_lags == (48, 12)
    # ATen rounds a Python scalar that meets a float32 tensor to float32 once,
    # and ``_rdiv`` multiplies by the float32 reciprocal.
    x = torch.tensor([0.7318], dtype=torch.float32)
    assert (x * 0.92).item() == (x * float(c[3])).item()
    assert ofdm._rdiv(x, 2.0 * np.pi * CFG.symbol_samples).item() == (x * float(c[8])).item()


@pytest.mark.parametrize("name,index,value", [
    ("_LTS_FLOOR", 0, 3e-5), ("_LTS_E_MIN", 2, 1e-10), ("_LTS_PREV", 3, 0.9),
    ("_LTS_TAP", 4, 0.55), ("_LTS_REPEAT", 5, 0.45), ("_LTS_ECHO", None, 40),
    ("_LTS_LOBE", None, 10)])
def test_a_scalar_reaches_both_searches(name, index, value, monkeypatch):
    """Each of the search's scalars lives in ``wave/ofdm.py`` once: the plain
    search reads it by name, and the kernels' constants follow it."""
    assert name in ofdm.LTSDetector.search_plain.__code__.co_names
    monkeypatch.setattr(ofdm, name, value)
    det = ofdm.LTSDetector(CFG, N, 0.5, "cpu")
    if index is None:
        assert value in det.refine_lags
    else:
        assert det.lts_consts[index].item() == float(np.float32(value))


def test_the_threshold_reaches_both_searches():
    """The detector's threshold: the plain search reads ``self.threshold``,
    the kernels its float32 value."""
    assert "threshold" in ofdm.LTSDetector.search_plain.__code__.co_names
    det = ofdm.LTSDetector(CFG, N, 0.37, "cpu")
    assert det.lts_consts[6].item() == float(np.float32(0.37))


def test_the_plain_search_keeps_no_scalar_of_its_own():
    """Beside the module's named scalars, the plain search writes only small
    whole numbers (indices, repeats, factors of a symbol), so that no
    constant of the search can change in one path alone."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(ofdm.LTSDetector.search_plain)))
    numbers = {node.value for node in ast.walk(tree)
               if isinstance(node, ast.Constant) and type(node.value) in (int, float)}
    assert numbers <= {0, 1, 2, 3}, numbers


class _Recorder:
    """Records the spans the search opens and the kernels it launches."""

    def __init__(self):
        self.events: list[str] = []

    def span(self, name):
        rec = self

        class _Span:
            def __enter__(self):
                rec.events.append(f"+{name}")

            def __exit__(self, *exc):
                rec.events.append(f"-{name}")

        return _Span()

    def call(self, entry, *args):
        self.events.append(entry)


def test_the_kernel_search_nests_its_spans(monkeypatch):
    """The kernels' search, its launches stubbed (no card): ``lts_pad``
    before ``sync.coarse``, ``lts_front`` and the FFT pair inside it,
    ``lts_pick`` inside ``sync.fine``, and ``lts_decide`` after it, so that
    the caller's ``rx.sync`` holds kernels of its own before and after."""
    det = ofdm.LTSDetector(CFG, N, 0.5, "cpu")
    rec = _Recorder()
    monkeypatch.setattr(lts_kernel, "span", rec.span)
    monkeypatch.setattr(lts_kernel, "_call", rec.call)
    monkeypatch.setattr(lts_kernel, "_smem_limit", lambda index: 227 * 1024)
    out = lts_kernel.search(det, torch.zeros(3, N))
    assert rec.events == ["lts_pad", "+sync.coarse", "lts_front", "-sync.coarse", "+sync.fine",
                          "lts_pick", "-sync.fine", "lts_decide"]
    assert [t.dtype for t in out] == [torch.bool, torch.int32, torch.float32, torch.float32,
                                      torch.int32]
    assert [t.shape for t in out] == [(3,)] * 5


def test_each_kernel_launches_once_a_search(monkeypatch):
    """Through the one launch helper, bound to stand-ins that take every
    launch: one launch of each kernel a search, none for an empty batch."""
    for kernel in lts_kernel._KERNELS.values():
        monkeypatch.setattr(kernel, "_fn", lambda *args: 0)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 0, raising=False)
    monkeypatch.setattr(lts_kernel, "_smem_limit", lambda index: 227 * 1024)
    det = ofdm.LTSDetector(CFG, N, 0.5, "cpu")
    before = _launches()
    lts_kernel.search(det, torch.zeros(2, N))
    assert _launches() == [b + 1 for b in before]
    lts_kernel.search(det, torch.zeros(0, N))
    assert _launches() == [b + 1 for b in before]
