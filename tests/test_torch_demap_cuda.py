"""The OFDM demodulator's demap kernel (``csrc/ofdm_demap.cu``, wrapper
``wave/demap_kernel.py``) on the card (needs a GPU; every test skips without
one).  Imports no JAX:

    python -m pytest -q -m cuda tests/test_torch_demap_cuda.py

The kernel against the plain version (``OFDMDemodulator.demap_plain``, run on
the card), bit for bit: at both OFDM cells' shapes (DQPSK with the noise
variance broadcast over the symbols, QAM64 with a full one), on rows built to
reach every branch (an all-zero symbol and an all-zero row, LLRs past the clip
and under the least magnitude, each carrier's noise variance at its floor and
its ceiling, the EMA's floor); at one frame and without a batch axis; at frame
lengths in and past the kernel's registers; the launch count, one a
``from_bins`` call of DQPSK or QAM64 and none for the other modulations and
paths; and each served OFDM chain of the benchmark with the kernel against the
same chain with the plain demap, on its cell's pool at two seeds.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from ria_tpu_torch.utils import cuda_kernels
from ria_tpu_torch.wave import demap_kernel, ofdm

ROOT = Path(__file__).resolve().parents[1]
DQPSK = ofdm.OFDMConfig(modulation="DQPSK")
QAM64 = ofdm.OFDMConfig(modulation="QAM64", use_pilots=True, pilot_spacing=8)
CONFIGS = {"dqpsk": DQPSK, "qam64": QAM64}
# Each cell's demap: (config, B, S, noise variance broadcast over the symbols).
CELLS = {"dqpsk": (DQPSK, 1024, 22, True), "qam64": (QAM64, 2048, 9, False)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the demap stage's kernel is a CUDA kernel")
    return torch.device("cuda", 0)


def inputs(cfg: ofdm.OFDMConfig, B: int, S: int, broadcast: bool, dev: torch.device,
           seed: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """(eq [B, S, D] complex64, carrier_nv float32 of its shape) on the card:
    the constellation's points (DQPSK's as its differential phases) under
    noise, each carrier's noise variance drawn in [1e-3, 0.05] and broadcast
    over the symbols or drawn a symbol; then, where B allows, rows that reach
    each branch: 0 an all-zero symbol (symbol 1, or 0), 1 the noise
    variance's floor (LLRs past the clip), 2 its ceiling and small symbols
    (LLRs under the least magnitude), 3 exact zeros and exact thresholds
    (QAM64's 4 / sqrt(42) on Q), 4 all zeros, 5 symbols of 1e-4 (the EMA's
    floor), 6 a jump of 1,000x half way (a large instability ratio)."""
    rng = np.random.default_rng(seed)
    D = cfg.num_data_carriers
    table = ofdm.constellation_table(cfg.modulation)
    pts = table[rng.integers(0, len(table), (B, S, D))]
    if cfg.modulation in ofdm.DIFFERENTIAL:
        pts = np.cumprod(pts, axis=1)
    eq = pts + (rng.standard_normal((B, S, D)) + 1j * rng.standard_normal((B, S, D))) * 0.1
    nv = rng.uniform(1e-3, 0.05, (B, 1 if broadcast else S, D))
    if B > 6:
        eq[0, min(1, S - 1)] = 0
        nv[1] = ofdm.MIN_CARRIER_NOISE_VAR
        nv[2, :, ::2] = ofdm.MAX_CARRIER_NOISE_VAR
        eq[2, :, ::2] *= 1e-3
        eq[3, :, ::3] = 1j * np.float32(4 / np.sqrt(42))
        eq[3, :, 1::3] = eq[3, :, 1::3].real
        eq[4] = 0
        eq[5] *= 1e-4
        eq[6, S // 2 :] *= 1e3
    return (torch.as_tensor(eq.astype(np.complex64), device=dev),
            torch.as_tensor(nv.astype(np.float32), device=dev).expand(B, S, D))


def assert_equal(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    """Bit for bit: zero signs and NaNs included."""
    assert got.dtype == want.dtype == torch.float32 and got.shape == want.shape, what
    same = got.view(torch.int32) == want.view(torch.int32)
    if not bool(same.all()):
        idx = torch.nonzero(~same.reshape(-1)).reshape(-1)[:8]
        raise AssertionError(f"{what}: {int((~same).sum())} of {got.numel()} LLRs differ, e.g. "
                             f"at {idx.tolist()}: {got.reshape(-1)[idx].tolist()} against "
                             f"{want.reshape(-1)[idx].tolist()}")


def _demod(cfg: ofdm.OFDMConfig, S: int, dev: torch.device) -> ofdm.OFDMDemodulator:
    return ofdm.ofdm_demodulator(cfg, S, 2, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_kernel_equals_plain_at_the_cells_shapes(cell, cuda_device):
    cfg, B, S, broadcast = CELLS[cell]
    mod, ce = cfg.modulation, ofdm.CE_MARGIN[cfg.modulation]
    eq, nv = inputs(cfg, B, S, broadcast, cuda_device, seed=3)
    assert (nv.stride(1) == 0) == broadcast
    before = cuda_kernels.launches("ofdm_demap")
    got = demap_kernel.demap(eq, nv, ce, mod)
    assert cuda_kernels.launches("ofdm_demap") == before + 1
    want = _demod(cfg, S, cuda_device).demap_plain(eq, nv, ce)
    assert_equal(got, want, cell)
    # The rows reach their branches: LLRs at the clip, at the least
    # magnitude, and (DQPSK) the weak carriers' zeros.
    llr = got.reshape(B, S, -1)
    assert bool((llr[1].abs() == ofdm.MAX_LLR).any())
    assert bool((llr.abs() == np.float32(ofdm.MIN_LLR_MAG)).any())
    if mod == "DQPSK":
        assert bool((llr[4] == 0).all()) and bool((llr[0, 1] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("S", [1, 2, 16, 17, 32, 33, 48, 1000])
def test_kernel_equals_plain_at_each_frame_length(name, S, cuda_device):
    """The chains in registers up to 16 and 32 symbols, past 32 in the
    output's own slots; with each kind of noise variance."""
    cfg = CONFIGS[name]
    mod, ce = cfg.modulation, ofdm.CE_MARGIN[cfg.modulation]
    demod = _demod(cfg, S, cuda_device)
    for broadcast in (True, False):
        eq, nv = inputs(cfg, 8, S, broadcast, cuda_device, seed=S)
        assert_equal(demap_kernel.demap(eq, nv, ce, mod), demod.demap_plain(eq, nv, ce),
                     f"{name} S={S} broadcast={broadcast}")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_kernel_equals_plain_at_one_frame_and_other_leads(name, cuda_device):
    """B = 1, a frame without a batch axis, two lead axes, and a conjugated
    view (the kernel reads what the values are, not the bits under them)."""
    cfg = CONFIGS[name]
    mod, ce = cfg.modulation, ofdm.CE_MARGIN[cfg.modulation]
    S = 9
    demod = _demod(cfg, S, cuda_device)
    eq, nv = inputs(cfg, 12, S, False, cuda_device, seed=7)
    cases = {"B=1": (eq[:1], nv[:1]), "no batch axis": (eq[0], nv[0]),
             "two lead axes": (eq.reshape(3, 4, S, -1), nv.reshape(3, 4, S, -1)),
             "conjugated": (eq.conj(), nv)}
    for what, (e, n) in cases.items():
        got = demap_kernel.demap(e, n, ce, mod)
        assert got.shape == e.shape[:-2] + (S * e.shape[-1] * ofdm.BITS_PER_SYMBOL[mod],)
        assert_equal(got, demod.demap_plain(e, n, ce), f"{name} {what}")


@pytest.mark.cuda
def test_refuses_a_noise_variance_on_another_device(cuda_device):
    eq, nv = inputs(QAM64, 2, 9, False, cuda_device)
    with pytest.raises(ValueError, match="carrier_nv"):
        demap_kernel.demap(eq, nv.cpu(), 1.8, "QAM64")


@pytest.mark.cuda
@pytest.mark.parametrize("kw,launches", [
    (dict(modulation="DQPSK"), 1),
    (dict(modulation="DQPSK", use_pilots=True, pilot_spacing=10), 1),
    (dict(modulation="QAM64", use_pilots=True, pilot_spacing=8), 1),
    (dict(modulation="QAM64"), 1),
    (dict(modulation="QAM64", use_pilots=True, pilot_spacing=8, adaptive_eq=True), 0),
    (dict(modulation="QAM16", use_pilots=True, pilot_spacing=8), 0),
    (dict(modulation="QPSK"), 0),
    (dict(modulation="D8PSK", use_pilots=True, pilot_spacing=10), 0),
], ids=["dqpsk", "dqpsk-pilots", "qam64-tracking", "qam64-common-phase", "qam64-adaptive",
        "qam16", "qpsk", "d8psk"])
def test_one_launch_a_call_for_dqpsk_and_qam64_only(kw, launches, cuda_device):
    cfg = ofdm.OFDMConfig(**kw)
    _, data_bins, pilot_bins = ofdm.carrier_layout(cfg)
    rng = np.random.default_rng(2)

    def bins(n):
        return None if not n else torch.as_tensor(
            (rng.standard_normal((4, 7, n)) + 1j * rng.standard_normal((4, 7, n)))
            .astype(np.complex64), device=cuda_device)

    Y = bins(len(data_bins)), bins(len(pilot_bins))
    demod = _demod(cfg, 5, cuda_device)
    before = cuda_kernels.launches("ofdm_demap")
    for calls in (1, 2, 3):
        demod.from_bins(*Y)
        assert cuda_kernels.launches("ofdm_demap") == before + calls * launches
    eq = demod.from_bins(*Y).symbols
    demod.demap_plain(eq, torch.ones(eq.shape, device=cuda_device), 1.0)
    assert cuda_kernels.launches("ofdm_demap") == before + 4 * launches


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["ofdm_qam64_r34.gw2048_awgn25", "ofdm_dqpsk_r14.gw1024_awgn10"])
@pytest.mark.parametrize("seed", [1, 2718281828])
def test_cell_chain_equals_the_plain_demap(cell, seed, cuda_device, monkeypatch):
    """Each served OFDM chain of the benchmark, on its cell's pool: every
    output with the kernel equal to the chain's with the plain demap."""
    from benchmark.harness import load_cell

    c = load_cell(ROOT, cell)
    pool, _ = c.generator.make_pool(c.config, c.traffic, seed, cuda_device)
    program = c.entry.Program(c.config, c.traffic, cuda_device)
    with torch.no_grad():
        before = cuda_kernels.launches("ofdm_demap")
        got = [program(batch.to(cuda_device)) for batch in pool]
        assert cuda_kernels.launches("ofdm_demap") == before + len(pool)
        with monkeypatch.context() as m:
            m.setattr(ofdm, "demaps_on_kernel", lambda path, mod, device: False)
            want = [program(batch.to(cuda_device)) for batch in pool]
        assert cuda_kernels.launches("ofdm_demap") == before + len(pool)
    for g, w in zip(got, want):
        assert bool(g["detected"].any())
        for name in w:
            gb, wb = (t.view(torch.int32) if t.dtype == torch.float32 else t
                      for t in (g[name], w[name]))
            assert torch.equal(gb, wb), name
