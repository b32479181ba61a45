"""The Schmidl-Cox search's CUDA kernels on a host without a card: the CPU
path never reaches them, their wrapper refuses what they do not take before
anything is built or counted, their C entry points are bound as the source
declares them, ATen's scan geometry is the installed ATen's and is formed as
ATen forms it, the search's scalars come from one place and are formed as
ATen forms them, and both searches, the plain one and the kernels', nest
``sync.coarse`` and ``sync.fine`` inside ``rx.sync`` with work of
``rx.sync``'s own before and after them.  (The kernels themselves run in
``tests/test_torch_sc_cuda.py``, on a card.)
"""

from __future__ import annotations

import ast
import ctypes
import hashlib
import inspect
import re
import textwrap
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from ria_tpu_torch.sync import sc_kernel
from ria_tpu_torch.utils import cuda_kernels
from ria_tpu_torch.wave import ofdm

QAM64 = ofdm.OFDMConfig(modulation="QAM64", use_pilots=True, pilot_spacing=8)
DQPSK = ofdm.OFDMConfig(modulation="DQPSK")
CONFIGS = {"qam64": (QAM64, 26160), "dqpsk": (DQPSK, 42720)}
ENTRIES = ("sc_pad", "sc_coarse", "sc_slice", "sc_pick", "sc_decide")


def _window(cfg: ofdm.OFDMConfig, B: int, n: int, seed: int = 0) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 0.3, (B, n)).astype(np.float32)
    f = ofdm.tx_frame(rng.integers(0, 2, 4 * 648), cfg, "cox")
    x[:, 500 : 500 + len(f)] += f[: n - 500]
    return torch.as_tensor(x)


def _refuse(*args, **kwargs):
    raise AssertionError("the CUDA kernels were reached from a CPU tensor")


@pytest.mark.parametrize("cell", sorted(CONFIGS))
def test_cpu_tensor_never_reaches_the_kernels(cell, monkeypatch):
    """On the CPU the detector neither loads nor launches the kernels, and
    their launch count stays as it was."""
    cfg, n = CONFIGS[cell]
    monkeypatch.setattr(sc_kernel, "load", _refuse)
    monkeypatch.setattr(sc_kernel, "search", _refuse)
    monkeypatch.setattr(cuda_kernels, "load", _refuse)
    monkeypatch.setattr(cuda_kernels, "launch", _refuse)
    before = cuda_kernels.launches("sc_coarse")
    det = ofdm.SchmidlCoxDetector(cfg, n, "cpu")
    res = det(_window(cfg, 2, n))
    assert bool(res.detected.all())
    assert ofdm.schmidl_cox_search(_window(cfg, 1, n)[0], cfg).lts_start.shape == ()
    assert cuda_kernels.launches("sc_coarse") == before


@pytest.mark.parametrize("x,err,match", [
    (torch.zeros(2, 26160), ValueError, "CUDA tensors"),
    (torch.zeros(2, 26160, dtype=torch.float64), TypeError, "float32"),
    (torch.zeros(26160), TypeError, "2-D"),
    (torch.zeros(2, 26161), ValueError, "26160"),
], ids=["cpu", "float64", "1-D", "other-window"])
def test_search_refuses_without_counting(x, err, match, monkeypatch):
    """``sc_kernel.search`` raises before anything is built, launched or
    counted: it has no path that falls back to the plain search."""
    monkeypatch.setattr(cuda_kernels, "load", _refuse)
    monkeypatch.setattr(cuda_kernels, "launch", _refuse)
    det = ofdm.SchmidlCoxDetector(QAM64, 26160, "cpu")
    before = cuda_kernels.launches("sc_coarse")
    with pytest.raises(err, match=match):
        sc_kernel.search(det, x)
    assert cuda_kernels.launches("sc_coarse") == before


def _signatures(source: str) -> dict[str, list[str]]:
    """Each ``extern "C" int ria_<entry>(...)`` of the source: its parameters."""
    return {name: [p.strip() for p in params.split(",")]
            for name, params in re.findall(r'extern "C" int ria_(\w+)\(([^)]*)\)', source)}


def test_sc_search_is_a_library_of_the_table_and_typed():
    """``sc_search`` is a library of ``cuda_kernels.LIBRARIES``, linked to the
    runtime PyTorch has loaded, and each of its C entry points, as
    ``sc_kernel`` declares it and bound on a stand-in library (no nvcc
    here), takes a pointer for each pointer of the source's signature and
    for the stream, an int for each int, in the source's order."""
    source, flags = cuda_kernels.LIBRARIES["sc_search"]
    assert source.name == "sc_search.cu" and source.is_file()
    assert flags == ("-cudart", "shared")
    sigs = _signatures(source.read_text())
    assert sorted(sigs) == sorted(ENTRIES) == sorted(sc_kernel._KERNELS)

    class StandIn:
        pass

    lib = StandIn()
    for name in ENTRIES:
        setattr(lib, f"ria_{name}", types.SimpleNamespace())
    for name, params in sigs.items():
        kinds = ["ptr" if "*" in p else "int" for p in params]
        assert params[-1] == "void* stream", name
        n_ptr = kinds.index("int")
        assert kinds == ["ptr"] * n_ptr + ["int"] * (len(kinds) - n_ptr - 1) + ["ptr"], name
        fn = sc_kernel._KERNELS[name].typed(lib)
        assert fn.argtypes == ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * (len(kinds) - n_ptr - 1)
                               + [ctypes.c_void_p]), name
        assert fn.restype is ctypes.c_int


def test_the_kernels_are_loaded_from_their_library(monkeypatch):
    """``sc_kernel.load`` and every launch bind an entry of ``sc_search``."""
    seen = []

    class StandIn:
        def __getattr__(self, name):
            fn = types.SimpleNamespace()
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(cuda_kernels, "load", lambda library: seen.append(library) or StandIn())
    for kernel in sc_kernel._KERNELS.values():
        monkeypatch.setattr(kernel, "_fn", None)
    sc_kernel.load()
    assert seen == ["sc_search"] * len(ENTRIES)
    assert all(k.library == "sc_search" and k.fn() is not None
               for k in sc_kernel._KERNELS.values())
    assert seen == ["sc_search"] * len(ENTRIES)  # bound once


@pytest.mark.parametrize("num_rows,row_size,want", [
    (2048, 3206, 5), (2048, 3270, 5), (1024, 5276, 6), (1024, 5340, 6), (2048, 6168, 5),
    (1024, 6168, 6), (64, 3206, 7), (4, 3206, 9), (1, 26160, 9), (2, 2, 4), (1, 1, 4),
    (1 << 22, 4096, 9), (1 << 14, 4096, 4), (1 << 13, 4096, 4)])
def test_scan_geometry_is_atens(num_rows, row_size, want):
    """The threads along a row of ATen's innermost scan: ceil(log2) of the
    row's length and the rows' count, their difference halved about 9 in
    uint32 arithmetic (so a far larger count wraps back to 9), kept in
    [4, 9]."""
    assert sc_kernel.scan_log_threads(num_rows, row_size) == want


@pytest.mark.parametrize("cell", sorted(CONFIGS))
def test_consts_are_the_plain_search_scalars(cell):
    """The kernels' constants are the float32 values ATen makes of the plain
    search's Python scalars."""
    cfg, n = CONFIGS[cell]
    det = ofdm.SchmidlCoxDetector(cfg, n, "cpu")
    c = det.sc_consts
    assert c.dtype == torch.float32 and c.shape == (18,)
    f32 = np.float32
    N, sym, fs = cfg.fft_size, cfg.symbol_samples, cfg.sample_rate
    want = {2: fs, 3: f32(1) / f32(np.pi * N), 4: fs / N, 5: 1e-6, 6: 1e-20,
            7: det.ref_energy, 8: 1e-12, 9: 0.92, 12: fs / sym, 13: f32(1) / f32(2 * np.pi),
            14: f32(1) / f32(fs / sym), 15: 1e-12, 16: cfg.sync_threshold, 17: 0.05}
    for i, v in want.items():
        assert c[i].item() == float(f32(v)), i
    # The rotations by the mix's whole turns: 1 at these configurations.
    assert c[0].item() == 1.0 and c[1].item() == 0.0 and c[10].item() == 1.0 and c[11].item() == 0.0
    # A multiply by the half-symbol rotation as ATen makes it of the Python
    # complex: each part rounded to float32.
    rot = complex(np.exp(2j * np.pi * 0.3))
    got = torch.tensor([1 + 0j], dtype=torch.complex64) * rot
    assert got.real.item() == float(f32(rot.real)) and got.imag.item() == float(f32(rot.imag))


# ATen's innermost-dimension scan (ATen/native/cuda/ScanUtils.cuh), whose
# order the kernels' prefix sums follow: the sha256 of each function's text
# without comments and with its white space collapsed, in torch 2.11 (the
# card's, where the kernels were probed) and 2.13 alike.
SCAN_TEXT = {"get_log_num_threads_x_inner_scan": "23a2d1ce87ee7705",
             "tensor_kernel_scan_innermost_dim_impl": "bc6995bf94f74377",
             "scan_innermost_dim": "cffd5ea8baa9a803"}


@pytest.mark.parametrize("name", sorted(SCAN_TEXT))
def test_the_scan_followed_is_the_installed_atens(name):
    """The installed torch's scan is the one the kernels follow: a torch that
    changes it fails here (and the kernels then need probing on a card)."""
    header = Path(torch.__file__).parent / "include/ATen/native/cuda/ScanUtils.cuh"
    src = header.read_text()
    m = re.search(rf"\b{name}\s*\(", src)
    depth, end = 0, src.index("{", m.end())
    for end in range(end, len(src)):
        depth += {"{": 1, "}": -1}.get(src[end], 0)
        if depth == 0:
            break
    text = " ".join(re.sub(r"//[^\n]*", "", src[m.start() : end + 1]).split())
    assert hashlib.sha256(text.encode()).hexdigest()[:16] == SCAN_TEXT[name], torch.__version__


@pytest.mark.parametrize("name,index,value", [
    ("_SC_FLOOR", 5, 3e-5), ("_SC_RR_MIN", 6, 1e-18), ("_LTS_E_MIN", 8, 1e-10),
    ("_LTS_PREV", 9, 0.9), ("_LTS_R_MIN", 15, 1e-9), ("_lts_threshold", 17, 0.125)])
def test_a_scalar_reaches_both_searches(name, index, value, monkeypatch):
    """Each of the search's scalars lives in ``wave/ofdm.py`` once: the plain
    search reads it by name, and the kernels' constants follow it."""
    assert name in ofdm.SchmidlCoxDetector.search_plain.__code__.co_names
    new = (lambda cfg: value) if callable(getattr(ofdm, name)) else value
    monkeypatch.setattr(ofdm, name, new)
    c = ofdm.SchmidlCoxDetector(QAM64, 26160, "cpu").sc_consts
    assert c[index].item() == float(np.float32(value))


def test_the_plain_search_keeps_no_scalar_of_its_own():
    """Beside the module's named scalars, the plain search writes only small
    whole numbers (indices, factors of a symbol, a -1 for masked lags), so
    that no constant of the search can change in one path alone."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(ofdm.SchmidlCoxDetector.search_plain)))
    numbers = {node.value for node in ast.walk(tree)
               if isinstance(node, ast.Constant) and type(node.value) in (int, float)}
    assert numbers <= {0, 1, 2, 4}, numbers


@pytest.mark.parametrize("center_freq", [1500.0, 1234.5, 1800.25])
def test_the_kernels_turns_are_the_plain_searchs(center_freq):
    """The rotations that undo the mix's turns in the lag-N/2 and lag-symbol
    products are the plain search's Python complex as ATen rounds it to
    complex64 in its multiply."""
    cfg = ofdm.OFDMConfig(modulation="DQPSK", center_freq=center_freq)
    c = ofdm.sc_consts(cfg, 1.0)
    one = torch.tensor([1 + 0j], dtype=torch.complex64)
    for lag, (re_i, im_i) in ((cfg.fft_size // 2, (0, 1)), (cfg.symbol_samples, (10, 11))):
        got = one * ofdm._turns(cfg, lag)
        assert (c[re_i], c[im_i]) == (np.float32(got.real.item()), np.float32(got.imag.item()))
    assert center_freq == 1500.0 or c[1] != 0.0


def test_coarse_layout_fits_the_cells():
    """A row of each cell's coarse search fits in a block's shared memory
    (the QAM64 cell's three to an SM); a long window's does not and takes the
    global scratch."""
    assert sc_kernel.coarse_layout(2048, 26160, 64)[-1] < 76 * 1024
    assert sc_kernel.coarse_layout(1024, 42720, 64)[-1] < 113 * 1024
    assert sc_kernel.coarse_layout(6, 120000, 64)[-1] > 227 * 1024


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


@pytest.mark.parametrize("cell", sorted(CONFIGS))
def test_the_kernel_search_nests_its_spans(cell, monkeypatch):
    """The kernels' search, its launches stubbed (no card): ``sc_pad`` before
    ``sync.coarse``, ``sc_coarse`` inside it, the slice, the FFTs and the
    pick inside ``sync.fine``, and ``sc_decide`` after it, so that the
    caller's ``rx.sync`` holds kernels of its own before and after."""
    cfg, n = CONFIGS[cell]
    det = ofdm.SchmidlCoxDetector(cfg, n, "cpu")
    rec = _Recorder()
    monkeypatch.setattr(sc_kernel, "span", rec.span)
    monkeypatch.setattr(sc_kernel, "_call", rec.call)
    monkeypatch.setattr(sc_kernel, "_smem_limit", lambda index: 227 * 1024)
    out = sc_kernel._search(det, torch.zeros(3, n))
    assert rec.events == ["sc_pad", "+sync.coarse", "sc_coarse", "-sync.coarse", "+sync.fine",
                          "sc_slice", "sc_pick", "-sync.fine", "sc_decide"]
    assert [t.dtype for t in out] == [torch.bool, torch.int32, torch.float32, torch.float32,
                                      torch.float32]


@pytest.mark.parametrize("cell", sorted(CONFIGS))
def test_the_plain_search_nests_its_spans(cell):
    """The served OFDM chain on the CPU: one ``sync.coarse`` and one
    ``sync.fine`` inside ``rx.sync``, and operators of ``rx.sync``'s own
    before the first and after the second (the profiler's host events)."""
    from torch.profiler import ProfilerActivity, profile

    from ria_tpu_torch.phy.pipeline import make_ofdm_rx_pipeline

    cfg, n = CONFIGS[cell]
    rx = make_ofdm_rx_pipeline(cfg, "R1_4" if cfg.modulation == "DQPSK" else "R3_4", n,
                               device="cpu")
    x = _window(cfg, 2, n)
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        rx.soft_bits(x)
    ev = sorted(((e.time_range.start, e.time_range.end, e.name) for e in prof.events()),
                key=lambda t: (t[0], -t[1]))
    spans = {name: [(s, e) for s, e, nm in ev if nm == name]
             for name in ("rx.sync", "sync.coarse", "sync.fine")}
    assert [len(v) for v in spans.values()] == [1, 1, 1]
    (s0, e0), (c0, c1), (f0, f1) = (v[0] for v in spans.values())
    assert s0 <= c0 < c1 <= f0 < f1 <= e0
    ops = [(s, e) for s, e, nm in ev if nm.startswith("aten::") and s0 <= s and e <= e0]
    assert any(e <= c0 for s, e in ops), "no operator of rx.sync's own before sync.coarse"
    assert any(s >= f1 for s, e in ops), "no operator of rx.sync's own after sync.fine"
