"""The chirp search's fine-stage CUDA kernels on a host without a card: the
CPU path never reaches them, their wrappers refuse what they do not take
before anything is built or counted, the route to them is the tensor's
device alone, their C entry points are bound as the source declares them,
the plain path is the expressions it replaced, its scalars reach the kernels
from one place, the shared header renames both libraries that include it,
and the zoom search nests ``sync.coarse`` and ``sync.fine`` inside ``rx.sync``
with work of ``rx.sync``'s own before and after them.  (The kernels
themselves run in ``tests/test_torch_chirp_fine_cuda.py``, on a card.)
"""

from __future__ import annotations

import ctypes
import re
import types

import numpy as np
import pytest
import torch

from ria_tpu_torch.sync import chirp, fine_kernel
from ria_tpu_torch.utils import cuda_kernels, native_build
from ria_tpu_torch.utils.device import wide_cumsum

torch.set_num_threads(1)

ENTRIES = ("chirp_refine_front", "chirp_refine_pick", "median_select")
TINY = chirp.ChirpConfig(duration_ms=10.0, gap_ms=2.0)
R = chirp._ZOOM_REFINE


def _refuse(*args, **kwargs):
    raise AssertionError("the CUDA kernels were reached from a CPU tensor")


def _counts() -> list[int]:
    return [cuda_kernels.launches(e) for e in ENTRIES]


def _window(cfg: chirp.ChirpConfig, B: int, n: int, lead: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 0.05, (B, n)).astype(np.float32)
    seq = chirp.generate(cfg, 2.0)
    x[:, lead : lead + len(seq)] += seq[: n - lead]
    return torch.as_tensor(x)


@pytest.mark.parametrize("branch", ["zoom", "full-rate"])
def test_cpu_tensor_never_reaches_the_kernels(branch, monkeypatch):
    """On the CPU the detector, either branch, neither loads nor launches the
    fine stage's kernels, and their launch counts stay as they were."""
    for name in ("load", "refine_front", "refine_pick", "median_select"):
        monkeypatch.setattr(fine_kernel, name, _refuse)
    monkeypatch.setattr(cuda_kernels, "load", _refuse)
    monkeypatch.setattr(cuda_kernels, "launch", _refuse)
    before = _counts()
    cfg, n = (chirp.ChirpConfig(), 207328) if branch == "zoom" else (TINY, 3000)
    det = chirp.ChirpDetector(cfg, n, "cpu")
    assert det.zoom == (branch == "zoom")
    res = det(_window(cfg, 2, n, 400, seed=3))
    assert bool(res.detected.all())
    assert _counts() == before


@pytest.mark.parametrize("call,err,match", [
    (lambda: fine_kernel.refine_front(torch.zeros(2, 30000), torch.zeros(2, dtype=torch.int32),
                                      24000, R), ValueError, "CUDA tensors"),
    (lambda: fine_kernel.refine_front(torch.zeros(2, 30000, dtype=torch.float64),
                                      torch.zeros(2, dtype=torch.int32), 24000, R),
     TypeError, "float32"),
    (lambda: fine_kernel.refine_front(torch.zeros(30000), torch.zeros(1, dtype=torch.int32),
                                      24000, R), TypeError, "2-D"),
    (lambda: fine_kernel.refine_front(torch.zeros(2, 30000), torch.zeros(2, dtype=torch.int64),
                                      24000, R), TypeError, "int32"),
    (lambda: fine_kernel.refine_front(torch.zeros(2, 30000), torch.zeros(3, dtype=torch.int32),
                                      24000, R), ValueError, r"\[2\]"),
    (lambda: fine_kernel.refine_front(torch.zeros(2, 24000), torch.zeros(2, dtype=torch.int32),
                                      24000, R), ValueError, "windows of 24000"),
    (lambda: fine_kernel.refine_pick(*[torch.zeros(2, 49)] * 3, torch.zeros(2, dtype=torch.int32),
                                     1.0, 1e-6, 1e-20), ValueError, "CUDA tensors"),
    (lambda: fine_kernel.refine_pick(torch.zeros(2, 49), torch.zeros(2, 48), torch.zeros(2, 49),
                                     torch.zeros(2, dtype=torch.int32), 1.0, 1e-6, 1e-20),
     ValueError, r"\[2, 49\]"),
    (lambda: fine_kernel.refine_pick(*[torch.zeros(2, 49, dtype=torch.float16)] * 3,
                                     torch.zeros(2, dtype=torch.int32), 1.0, 1e-6, 1e-20),
     TypeError, "float32"),
    (lambda: fine_kernel.median_select(torch.zeros(2, 11458)), ValueError, "CUDA tensors"),
    (lambda: fine_kernel.median_select(torch.zeros(2, 5, dtype=torch.float64)), TypeError,
     "float32"),
    (lambda: fine_kernel.median_select(torch.zeros(2, 3, 5)), TypeError, "2-D"),
    (lambda: fine_kernel.median_select(torch.zeros(2, 0)), ValueError, "empty"),
], ids=["front-cpu", "front-float64", "front-1-D", "front-int64-peaks", "front-peaks-shape",
        "front-short-window", "pick-cpu", "pick-shape", "pick-float16", "median-cpu",
        "median-float64", "median-3-D", "median-empty"])
def test_wrappers_refuse_without_counting(call, err, match, monkeypatch):
    """Each wrapper raises before anything is built, launched or counted: it
    has no path that falls back to the plain version."""
    monkeypatch.setattr(cuda_kernels, "load", _refuse)
    monkeypatch.setattr(cuda_kernels, "launch", _refuse)
    before = _counts()
    with pytest.raises(err, match=match):
        call()
    assert _counts() == before


def test_the_route_is_the_device(monkeypatch):
    """``refine_front``, ``refine_pick`` and ``_median`` take the kernels for
    any tensor off the CPU (here on the meta device, which computes
    nothing), with the plain path's scalars, and the plain path on the CPU."""
    seen = []
    for name in ("refine_front", "refine_pick", "median_select"):
        monkeypatch.setattr(fine_kernel, name,
                            lambda *args, name=name: seen.append((name, args[len(args) - 2:])))
    meta = dict(device="meta")
    chirp.refine_front(torch.empty(2, 30000, **meta), torch.empty(2, dtype=torch.int32, **meta),
                       24000, R)
    chirp.refine_pick(*[torch.empty(2, 49, **meta)] * 3, torch.empty(2, dtype=torch.int32, **meta),
                      12000.0)
    chirp._median(torch.empty(2, 11458, **meta))
    assert [s[0] for s in seen] == ["refine_front", "refine_pick", "median_select"]
    assert seen[1][1] == (chirp._REFINE_FLOOR, chirp._REFINE_DENOM_MIN)
    x = torch.rand(3, 11)
    assert torch.equal(chirp._median(x), chirp.median_plain(x)) and len(seen) == 3


def _signatures(source: str) -> dict[str, list[str]]:
    """Each ``extern "C" int ria_<entry>(...)`` of the source: its parameters."""
    return {name: [p.strip() for p in params.split(",")]
            for name, params in re.findall(r'extern "C" int ria_(\w+)\(([^)]*)\)', source)}


def test_chirp_fine_is_a_library_of_the_table_and_typed():
    """``chirp_fine`` is a library of ``cuda_kernels.LIBRARIES``, linked to the
    runtime PyTorch has loaded, built with the shared ATen-order header, and
    each of its C entry points, as ``fine_kernel`` declares it and bound on a
    stand-in library (no nvcc here), takes a pointer for each pointer of the
    source's signature and for the stream, an int for each int, in order."""
    source, flags = cuda_kernels.LIBRARIES["chirp_fine"]
    assert source.name == "chirp_fine.cu" and source.is_file()
    assert flags == ("-cudart", "shared")
    text = source.read_text()
    assert '#include "aten_order.cuh"' in text
    sigs = _signatures(text)
    assert sorted(sigs) == sorted(ENTRIES) == sorted(fine_kernel._KERNELS)
    lib = types.SimpleNamespace(**{f"ria_{name}": types.SimpleNamespace() for name in ENTRIES})
    for name, params in sigs.items():
        kinds = ["ptr" if "*" in p else "int" for p in params]
        assert params[-1] == "void* stream", name
        n_ptr = kinds.index("int")
        assert kinds == ["ptr"] * n_ptr + ["int"] * (len(kinds) - n_ptr - 1) + ["ptr"], name
        kernel = fine_kernel._KERNELS[name]
        assert (kernel.library, kernel.ptrs, kernel.ints) == ("chirp_fine", n_ptr,
                                                              len(kinds) - n_ptr - 1), name
        fn = kernel.typed(lib)
        assert fn.argtypes == ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * kernel.ints
                               + [ctypes.c_void_p]), name
        assert fn.restype is ctypes.c_int


def test_the_kernels_are_loaded_from_their_library(monkeypatch):
    """``fine_kernel.load`` binds every entry of ``chirp_fine``, once."""
    seen = []

    class StandIn:
        def __getattr__(self, name):
            fn = types.SimpleNamespace()
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(cuda_kernels, "load", lambda library: seen.append(library) or StandIn())
    for kernel in fine_kernel._KERNELS.values():
        monkeypatch.setattr(kernel, "_fn", None)
    fine_kernel.load()
    fine_kernel.load()
    assert seen == ["chirp_fine"] * len(ENTRIES)


def test_the_detector_loads_the_library_in_set_up(monkeypatch):
    """A detector on a card loads the fine stage's library when it is built,
    on either branch (both take the median), so that the first call compiles
    nothing; on the CPU it loads none.  (A stand-in card: the buffers stay
    on the host.)"""
    loaded = []
    monkeypatch.setattr(fine_kernel, "load", lambda: loaded.append("fine"))
    monkeypatch.setattr(chirp.zoom_kernel, "load", lambda: loaded.append("zoom"))
    for cfg, n in ((TINY, 3000), (chirp.ChirpConfig(), 207328)):
        chirp.ChirpDetector(cfg, n, "cpu")
    assert loaded == []
    as_tensor = torch.as_tensor
    monkeypatch.setattr(chirp, "resolve_device", lambda device: types.SimpleNamespace(type="cuda"))
    monkeypatch.setattr(chirp.torch, "as_tensor", lambda arr, device=None: as_tensor(arr))
    for cfg, n in ((TINY, 3000), (chirp.ChirpConfig(), 207328)):
        det = chirp.ChirpDetector(cfg, n, "cuda")
        loaded.append(f"built {'zoom' if det.zoom else 'full-rate'}")
    assert loaded == ["fine", "built full-rate", "zoom", "fine", "built zoom"]


def _refine_inline(x, coarse_pos, Mr, Mi, chirp_len, energy):
    """``ChirpDetector._refine_peak`` as it was written before its fine stage
    became kernels on the card: the plain path must stay these expressions."""
    n = x.shape[-1]
    L = chirp_len + 2 * R
    start = torch.clamp(coarse_pos - R, 0, n - L)
    y = chirp.window_slice(x, start, L)
    cr = y @ Mr
    ci = y @ Mi
    mag2 = cr * cr + ci * ci
    zero = torch.zeros(y.shape[:-1] + (1,), dtype=y.dtype, device=y.device)
    csum = torch.cat([zero, wide_cumsum(y * y, dim=-1)], dim=-1)
    win = csum[..., chirp_len : chirp_len + 2 * R + 1] - csum[..., : 2 * R + 1]
    win_floor = 1e-6 * torch.amax(win, dim=-1, keepdim=True)
    corr2 = mag2 / torch.clamp_min(torch.maximum(win, win_floor) * energy, 1e-20)
    j = torch.argmax(corr2, dim=-1)
    val = torch.sqrt(torch.gather(corr2, 1, j[:, None])[:, 0])
    return (start + j).to(torch.int32), val


@pytest.mark.parametrize("seed", [0, 1])
def test_the_plain_path_is_the_inline_expressions(seed):
    """On the CPU the refinement equals the expressions it replaced bit for
    bit, on noise, at peaks clamped at both ends, and on an all-zero slice;
    and the median is the sort's."""
    n = 60000
    det = chirp.ChirpDetector(chirp.ChirpConfig(), n, "cpu")
    assert det.zoom
    L = det.chirp_len + 2 * R
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.normal(0, 0.35, (5, n)).astype(np.float32))
    x[2, 9000:40000] = 0.0
    pos = torch.tensor([0, n, 9024, 16 * int(rng.integers(0, 2000)), 20000], dtype=torch.int32)
    for Mr, Mi in ((det.up_mr, det.up_mi), (det.down_mr, det.down_mi)):
        got = det._refine_peak(x, pos, Mr, Mi)
        want = _refine_inline(x, pos, Mr, Mi, det.chirp_len, det.energy)
        assert all(torch.equal(g.view(torch.int32), w.view(torch.int32)) for g, w in zip(got, want))
        assert 0 <= int(got[0][0]) <= 2 * R and n - L <= int(got[0][1]) <= n - L + 2 * R
        assert int(got[0][2]) == 9000 and float(got[1][2]) == 0.0
    v = x[:, :11458]
    s = torch.sort(v, dim=-1).values
    assert torch.equal(chirp._median(v), 0.5 * (s[:, 5728] + s[:, 5729]))


def test_the_plain_pick_keeps_no_scalar_of_its_own():
    """The pick's floor and least denominator are the module's named
    scalars, which the kernels' route passes on."""
    import ast
    import inspect
    import textwrap

    tree = ast.parse(textwrap.dedent(inspect.getsource(chirp.refine_pick_plain)))
    numbers = {node.value for node in ast.walk(tree)
               if isinstance(node, ast.Constant) and type(node.value) in (int, float)}
    assert numbers <= {0, 1}, numbers
    names = chirp.refine_pick_plain.__code__.co_names
    assert "_REFINE_FLOOR" in names and "_REFINE_DENOM_MIN" in names
    assert (chirp._REFINE_FLOOR, chirp._REFINE_DENOM_MIN) == (1e-6, 1e-20)


@pytest.mark.parametrize("v", [1e-6, 1e-20, 12000.0, 11999.999999, 0.1])
def test_scalars_reach_the_kernel_as_aten_rounds_them(v):
    """A Python scalar that meets a float32 tensor is rounded to float32
    once; the kernel gets that float32's bits."""
    bits = fine_kernel._f32_bits(v)
    assert bits == int(np.array([v], np.float32).view(np.int32)[0])
    assert (torch.ones(1) * v).view(torch.int32).item() == bits


def test_shared_memory_fits_the_cells():
    """The refinement's row (squares and chains) fits two blocks an SM at
    both cells' batches; a median row of either cell stages in a block."""
    from ria_tpu_torch.sync.sc_kernel import scan_log_threads

    L = chirp.ChirpConfig().chirp_samples + 2 * R
    for B in (256, 128, 1):
        assert fine_kernel.front_smem_bytes(L, scan_log_threads(B, L)) < 113 * 1024
    assert 4 * 36418 + fine_kernel._SELECT_STATIC < 227 * 1024 - 1024


def test_an_edit_of_the_shared_header_renames_both_libraries(tmp_path):
    """A library's name hashes the header its source includes: an edit of
    ``aten_order.cuh`` renames ``sc_search``'s library and ``chirp_fine``'s,
    and no other."""
    csrc = cuda_kernels.LIBRARIES["chirp_fine"][0].parent
    for name in ("sc_search.cu", "chirp_fine.cu", "zoom_front.cu", "aten_order.cuh"):
        (tmp_path / name).write_bytes((csrc / name).read_bytes())
    flags = cuda_kernels.NVCC_FLAGS
    names = ("sc_search.cu", "chirp_fine.cu", "zoom_front.cu")
    before = {n: native_build.library_path(tmp_path / n, flags) for n in names}
    assert before == {n: native_build.library_path(csrc / n, flags) for n in names}
    header = tmp_path / "aten_order.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edit\n")
    after = {n: native_build.library_path(tmp_path / n, flags) for n in names}
    assert [after[n] != before[n] for n in names] == [True, True, False]


class _Recorder:
    """Records the spans the zoom search opens and the stages it runs."""

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

    def stage(self, name, fn):
        def run(*args):
            self.events.append(name)
            return fn(*args)
        return run


def test_the_zoom_search_nests_its_fine_stage(monkeypatch):
    """The zoom search with its stages recorded: the window pass before
    ``sync.coarse``, and inside ``sync.fine`` both refinements' fronts and
    picks and the median between them, so that on the card the fine stage's
    kernels fall inside ``sync.fine``."""
    rec = _Recorder()
    monkeypatch.setattr(chirp, "span", rec.span)
    for name in ("zoom_front", "refine_front", "refine_pick", "_median"):
        monkeypatch.setattr(chirp, name, rec.stage(name, getattr(chirp, name)))
    det = chirp.ChirpDetector(chirp.ChirpConfig(), 207328, "cpu")
    det(_window(chirp.ChirpConfig(), 2, 207328, 4000, seed=1))
    assert rec.events == ["zoom_front", "+sync.coarse", "-sync.coarse", "+sync.fine",
                          "refine_front", "refine_pick", "_median", "refine_front",
                          "refine_pick", "-sync.fine"]


def test_the_plain_chain_nests_its_spans():
    """The served MC-DPSK chain on the CPU: one ``sync.coarse`` and one
    ``sync.fine`` inside ``rx.sync``, and operators of ``rx.sync``'s own
    before the first and after the second (the profiler's host events)."""
    from torch.profiler import ProfilerActivity, profile

    from ria_tpu_torch.phy.pipeline import make_rx_pipeline
    from ria_tpu_torch.wave.mc_dpsk import MCDPSKConfig

    n = 207328
    rx = make_rx_pipeline(MCDPSKConfig(), "R1_4", 4, n, device="cpu")
    x = _window(chirp.ChirpConfig(), 2, n, 4000, seed=2)
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
    assert any(f0 <= s and e <= f1 and nm == "aten::mm" for s, e, nm in ev), "no matmul in sync.fine"
