"""The OFDM demodulator's demap kernel on a host without a card: the CPU path
never reaches it, ``from_bins`` takes it for DQPSK and QAM64 on the
symbol-parallel paths only (never on the adaptive or D8PSK ones), its wrapper
refuses what it does not take before anything is built or counted and packs
what it takes as the source reads it, its C entry point is bound as the
source declares it, its scalars are the plain path's, and ``demod.demap``
still nests inside ``rx.demod`` with ``rx.demod``'s own work before and
after it on the kernel's route.  (The kernel itself runs in
``tests/test_torch_demap_cuda.py``, on a card.)
"""

from __future__ import annotations

import ctypes
import inspect
import re
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from ria_tpu_torch.utils import cuda_kernels
from ria_tpu_torch.wave import demap_kernel, ofdm

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SOURCE = cuda_kernels.LIBRARIES["ofdm_demap"][0]
PATHS = ("pilot_tracking", "common_phase", "adaptive", "d8psk")
# Configurations of ``from_bins``: (keywords, its path, whether the kernel's route takes it).
ROUTES = {
    "dqpsk": (dict(modulation="DQPSK"), "common_phase", True),
    "dqpsk-pilots": (dict(modulation="DQPSK", use_pilots=True, pilot_spacing=10),
                     "common_phase", True),
    "qam64-tracking": (dict(modulation="QAM64", use_pilots=True, pilot_spacing=8),
                       "pilot_tracking", True),
    "qam64-no-pilots": (dict(modulation="QAM64"), "common_phase", True),
    "qam64-adaptive": (dict(modulation="QAM64", use_pilots=True, pilot_spacing=8,
                            adaptive_eq=True), "adaptive", False),
    "qam16": (dict(modulation="QAM16", use_pilots=True, pilot_spacing=8), "pilot_tracking",
              False),
    "qpsk": (dict(modulation="QPSK"), "common_phase", False),
    "dbpsk": (dict(modulation="DBPSK"), "common_phase", False),
    "d8psk": (dict(modulation="D8PSK", use_pilots=True, pilot_spacing=10), "d8psk", False),
}


def _refuse(*args, **kwargs):
    raise AssertionError("the demap kernel was reached")


def _bins(cfg: ofdm.OFDMConfig, S: int, B: int = 2, seed: int = 1):
    """(Y_data, Y_pilot) [B, 2 + S, D] / [B, 2 + S, P] complex64 on the CPU."""
    _, data_bins, pilot_bins = ofdm.carrier_layout(cfg)
    rng = np.random.default_rng(seed)

    def bins(n):
        return None if not n else torch.as_tensor(
            (rng.standard_normal((B, 2 + S, n)) + 1j * rng.standard_normal((B, 2 + S, n)))
            .astype(np.complex64))

    return bins(len(data_bins)), bins(len(pilot_bins))


_ROUTE = ofdm.demaps_on_kernel


def _as_if_on_a_card(path: str, mod: str, device: torch.device) -> bool:
    """The kernel's route with the device taken to be a card."""
    return _ROUTE(path, mod, torch.device("cuda"))


@pytest.mark.parametrize("name", ["dqpsk", "qam64-tracking"])
def test_cpu_tensor_never_reaches_the_kernel(name, monkeypatch):
    """On the CPU the demodulator neither loads nor launches the kernel, and
    its launch count stays as it was."""
    cfg = ofdm.OFDMConfig(**ROUTES[name][0])
    for module, attr in ((demap_kernel, "load"), (demap_kernel, "demap"),
                         (demap_kernel, "_demap"), (cuda_kernels, "load"),
                         (cuda_kernels, "launch")):
        monkeypatch.setattr(module, attr, _refuse)
    before = cuda_kernels.launches("ofdm_demap")
    demod = ofdm.OFDMDemodulator(cfg, 5, 2, "cpu")
    res = demod.from_bins(*_bins(cfg, 5))
    assert res.soft_bits.shape == (2, 5 * cfg.bits_per_ofdm_symbol())
    assert cuda_kernels.launches("ofdm_demap") == before


@pytest.mark.parametrize("mod", sorted(ofdm.BITS_PER_SYMBOL))
def test_the_route_is_dqpsk_and_qam64_on_a_card_only(mod):
    """The kernel's route: a card, a symbol-parallel path, and one of the
    kernel's two modulations; never the adaptive or D8PSK paths."""
    for path in PATHS:
        for device, on_card in ((torch.device("cuda"), True), (torch.device("cuda", 1), True),
                                (torch.device("cpu"), False), (torch.device("meta"), False)):
            want = on_card and mod in ("DQPSK", "QAM64") and path in PATHS[:2]
            assert ofdm.demaps_on_kernel(path, mod, device) is want, (path, device)


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_from_bins_takes_the_route(name, monkeypatch):
    """``from_bins`` with the route taken as on a card and the kernel stood
    in for by the plain version: DQPSK and QAM64 on the symbol-parallel paths
    call the kernel once a call with the equaliser's own tensors (the common
    phase's noise variance broadcast over the symbols, not copied), and the
    result is the plain path's; every other configuration never calls it."""
    kw, path, takes = ROUTES[name]
    cfg = ofdm.OFDMConfig(**kw)
    S = 6
    demod = ofdm.OFDMDemodulator(cfg, S, 2, "cpu")
    bins = _bins(cfg, S)
    want = demod.from_bins(*bins)
    calls = []

    def stand_in(eq, carrier_nv, ce_margin, mod):
        calls.append((eq, carrier_nv, ce_margin, mod))
        return demod.demap_plain(eq, carrier_nv, ce_margin)

    monkeypatch.setattr(ofdm, "demaps_on_kernel", _as_if_on_a_card)
    monkeypatch.setattr(demap_kernel, "demap", stand_in)
    before = ofdm.EQ_PATHS.copy()
    got = demod.from_bins(*bins)
    assert dict(ofdm.EQ_PATHS - before) == {path: 1}
    assert len(calls) == int(takes)
    for field in ofdm.OFDMDemodResult._fields:
        assert torch.equal(getattr(got, field), getattr(want, field)), field
    if takes:
        eq, nv, ce, mod = calls[0]
        assert mod == cfg.modulation and ce == ofdm.CE_MARGIN[mod]
        assert eq is got.symbols and eq.dtype == torch.complex64 and nv.shape == eq.shape
        assert nv.dtype == torch.float32
        assert (nv.stride(-2) == 0) == (path == "common_phase")


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_a_card_demodulator_loads_the_kernel_on_its_route(name, monkeypatch):
    """``OFDMDemodulator.__init__`` loads the kernel's library where its
    calls will take the kernel (the route taken as on a card), so that a
    first compile lands in set-up, and nowhere else."""
    kw, _, takes = ROUTES[name]
    loads = []
    monkeypatch.setattr(ofdm, "demaps_on_kernel", _as_if_on_a_card)
    monkeypatch.setattr(demap_kernel, "load", lambda: loads.append(1))
    ofdm.OFDMDemodulator(ofdm.OFDMConfig(**kw), 4, 2, "cpu")
    assert len(loads) == int(takes)


def _inputs(shape=(2, 3, 5), dtype=torch.complex64, nv_dtype=torch.float32, nv_shape=None):
    eq = torch.zeros(shape, dtype=dtype)
    return eq, torch.ones(shape if nv_shape is None else nv_shape, dtype=nv_dtype)


@pytest.mark.parametrize("args,err,match", [
    ((*_inputs(), 1.0, "QAM16"), ValueError, "not QAM16"),
    ((*_inputs(), 1.0, "D8PSK"), ValueError, "not D8PSK"),
    ((*_inputs(dtype=torch.complex128), 1.0, "DQPSK"), TypeError, "complex64"),
    ((*_inputs(dtype=torch.float32), 1.0, "DQPSK"), TypeError, "complex64"),
    ((*_inputs(shape=(5,), nv_shape=(5,)), 1.0, "DQPSK"), TypeError, r"\[\.\.\., S, D\]"),
    ((*_inputs(nv_dtype=torch.float64), 1.8, "QAM64"), ValueError, "carrier_nv"),
    ((*_inputs(nv_shape=(2, 1, 5)), 1.8, "QAM64"), ValueError, "carrier_nv"),
    ((torch.zeros(2, 3, 5, dtype=torch.complex64),
      torch.ones(2, 3, 5, device="meta"), 1.8, "QAM64"), ValueError, "carrier_nv"),
    ((*_inputs(), 1.8, "QAM64"), ValueError, "CUDA tensors"),
], ids=["qam16", "d8psk", "complex128", "float32", "1-D", "nv-float64", "nv-unexpanded",
        "nv-elsewhere", "cpu"])
def test_demap_refuses_without_counting(args, err, match, monkeypatch):
    """``demap_kernel.demap`` raises before anything is built, launched or
    counted: it has no path that falls back to the plain version."""
    monkeypatch.setattr(cuda_kernels, "load", _refuse)
    monkeypatch.setattr(cuda_kernels, "launch", _refuse)
    before = cuda_kernels.launches("ofdm_demap")
    with pytest.raises(err, match=match):
        demap_kernel.demap(*args)
    assert cuda_kernels.launches("ofdm_demap") == before


@pytest.mark.parametrize("mod,lead,broadcast", [
    ("DQPSK", (4,), True), ("QAM64", (4,), False), ("QAM64", (2, 3), True), ("DQPSK", (), False)],
    ids=["dqpsk-common-phase", "qam64-tracking", "two-lead-axes", "one-frame"])
def test_the_launch_takes_what_the_source_reads(mod, lead, broadcast, monkeypatch):
    """Past the checks (stubbed launch, no card): the tensors, then rows, S
    and D, eq's and carrier_nv's strides in elements (0 along the symbols
    where the noise variance is broadcast), the modulation's code and the
    margin's float32 bits; soft is [..., S D bps], contiguous."""
    S, D = 7, 11
    eq = torch.zeros((*lead, S, D), dtype=torch.complex64)
    nv = torch.ones((*lead, 1 if broadcast else S, D)).expand(eq.shape)
    seen = []
    monkeypatch.setattr(cuda_kernels, "launch", lambda kernel, *args: seen.append((kernel, args)))
    ce = ofdm.CE_MARGIN[mod]
    soft = demap_kernel._demap(eq, nv, ce, mod)
    code, bps = demap_kernel.MODULATIONS[mod]
    assert soft.shape == (*lead, S * D * bps) and soft.is_contiguous()
    ((kernel, args),) = seen
    assert kernel is demap_kernel._KERNEL
    rows = int(np.prod(lead))
    assert args[0].shape == (rows, S, D) and args[0].data_ptr() == eq.data_ptr()
    assert args[1].data_ptr() == nv.data_ptr() and args[2] is soft
    assert args[3:] == (rows, S, D, S * D, D, 1, D if broadcast else S * D,
                        0 if broadcast else D, 1, code,
                        int(np.float32(ce).view(np.int32)))
    assert np.int32(args[-1]).view(np.float32) == np.float32(ce)


def test_an_empty_batch_launches_nothing(monkeypatch):
    monkeypatch.setattr(cuda_kernels, "launch", _refuse)
    eq = torch.zeros(0, 9, 51, dtype=torch.complex64)
    soft = demap_kernel._demap(eq, torch.ones(0, 9, 51), 1.8, "QAM64")
    assert soft.shape == (0, 9 * 51 * 6)


def test_ofdm_demap_is_a_library_of_the_table_and_typed():
    """``ofdm_demap`` is a library of ``cuda_kernels.LIBRARIES``, linked to
    the runtime PyTorch has loaded, and its C entry point, as
    ``demap_kernel`` declares it and bound on a stand-in library (no nvcc
    here), takes a pointer for each pointer of the source's signature and for
    the stream, an int for each int, in the source's order."""
    source, flags = cuda_kernels.LIBRARIES["ofdm_demap"]
    assert source.name == "ofdm_demap.cu" and source.is_file()
    assert flags == ("-cudart", "shared")
    sigs = dict(re.findall(r'extern "C" int ria_(\w+)\(([^)]*)\)', source.read_text()))
    assert list(sigs) == ["ofdm_demap"]
    params = [p.strip() for p in sigs["ofdm_demap"].split(",")]
    kinds = ["ptr" if "*" in p else "int" for p in params]
    assert params[-1] == "void* stream"
    assert kinds == ["ptr"] * 3 + ["int"] * 11 + ["ptr"]
    lib = types.SimpleNamespace(ria_ofdm_demap=types.SimpleNamespace())
    fn = demap_kernel._KERNEL.typed(lib)
    assert fn.argtypes == [ctypes.c_void_p] * 3 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    assert fn.restype is ctypes.c_int


def test_the_kernel_is_loaded_from_its_library(monkeypatch):
    """``demap_kernel.load`` binds the entry point of ``ofdm_demap``, once."""
    seen = []
    monkeypatch.setattr(cuda_kernels, "load", lambda library: seen.append(library)
                        or types.SimpleNamespace(ria_ofdm_demap=types.SimpleNamespace()))
    monkeypatch.setattr(demap_kernel._KERNEL, "_fn", None)
    demap_kernel.load()
    demap_kernel.load()
    assert seen == ["ofdm_demap"]


def _source_floats() -> dict[str, np.float32]:
    return {name: np.float32(value) for name, value in
            re.findall(r"constexpr float (k\w+) = ([0-9.e+-]+)f;", SOURCE.read_text())}


def test_the_kernels_scalars_are_the_plain_paths():
    """Each scalar of the source is the float32 that ATen makes of the plain
    path's Python scalar: the module's named ones, and the literals of
    ``_demap`` and ``demap_plain``."""
    f32 = np.float32
    want = {"kAlpha": f32(ofdm.MAG_EMA_ALPHA), "kDecay": f32(1.0 - ofdm.MAG_EMA_ALPHA),
            "kAdaptiveK": f32(ofdm.CARRIER_ADAPTIVE_K), "kMaxLlr": f32(ofdm.MAX_LLR),
            "kMinLlrMag": f32(ofdm.MIN_LLR_MAG), "kEmaSqMin": f32(1e-6), "kWeakMag": f32(1e-6),
            "kMagMin": f32(1e-9), "kQuarterPi": f32(np.pi / 4),
            "kQam64D4": f32(4 / np.sqrt(42)), "kQam64D2": f32(2 / np.sqrt(42))}
    assert _source_floats() == want
    plain = inspect.getsource(ofdm._demap) + inspect.getsource(ofdm.OFDMDemodulator.demap_plain)
    for literal in ("1e-6", "1e-9", "np.pi / 4", "4 / np.sqrt(42)", "2 / np.sqrt(42)"):
        assert literal in plain, literal


def test_the_modulation_codes_are_the_sources():
    """``MODULATIONS`` holds the source's ``enum Mod`` codes and each
    modulation's bits a carrier."""
    enum = re.search(r"enum Mod \{ kDqpsk = (\d), kQam64 = (\d) \};", SOURCE.read_text())
    assert demap_kernel.MODULATIONS == {"DQPSK": (int(enum[1]), 2), "QAM64": (int(enum[2]), 6)}
    assert all(ofdm.BITS_PER_SYMBOL[m] == bps for m, (_, bps) in demap_kernel.MODULATIONS.items())


def _annotations(prof, name):
    kr = prof.profiler.kineto_results
    return sorted((e.start_ns(), e.end_ns()) for e in kr.events() if e.name() == name)


@pytest.mark.parametrize("cell", ["ofdm_qam64_r34.gw2048_awgn25", "ofdm_dqpsk_r14.gw1024_awgn10"])
def test_demap_nests_in_rx_demod_on_the_kernels_route(cell, monkeypatch):
    """The served chain on the CPU with the route taken as on a card and the
    launch stood in for: ``demod.demap`` still nests inside ``rx.demod``, which
    keeps operators of its own before it and after it (the deinterleave
    gathers), so that ``rx.demod``'s device-side range covers the stage."""
    from torch.profiler import ProfilerActivity, profile

    from benchmark import harness

    c = harness.load_cell(ROOT, cell)
    c.traffic = dict(c.traffic, channels=2, pool=1)
    program = c.entry.Program(c.config, c.traffic, torch.device("cpu"))
    pool, _ = c.generator.make_pool(c.config, c.traffic, 5, torch.device("cpu"))
    launched = []

    def stand_in(eq, carrier_nv, ce_margin, mod):
        launched.append(mod)
        return torch.zeros(eq.shape[:-2] + (eq.shape[-2] * eq.shape[-1]
                                            * ofdm.BITS_PER_SYMBOL[mod],))

    monkeypatch.setattr(ofdm, "demaps_on_kernel", _as_if_on_a_card)
    monkeypatch.setattr(demap_kernel, "demap", stand_in)
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        program(pool[0])
    assert len(launched) == 1
    (demod,) = _annotations(prof, "rx.demod")
    (demap,) = _annotations(prof, "demod.demap")
    assert demod[0] <= demap[0] <= demap[1] <= demod[1]
    ops = [e.start_ns() for e in prof.profiler.kineto_results.events()
           if e.name().startswith("aten::") and demod[0] <= e.start_ns() <= demod[1]]
    assert any(t < demap[0] for t in ops) and any(t > demap[1] for t in ops)
