"""The OFDM chain behind the light preamble (``make_ofdm_rx_pipeline(...,
preamble="lts")``, config #3: DQPSK R1/2 on 53 data + 6 pilot carriers) on
the CPU.

- Against the JAX package's own composition of the same stages, jitted as
  its chains are: ``ria_tpu.wave.ofdm.lts_search``, the frame slice,
  ``demodulate_presynced``, the frame and channel deinterleave and
  ``ria_tpu.fec.ldpc.make_decoder``, on light frames from the port's
  ``tx_frame(..., preamble="lts")`` at B = 4 in a 48,000-sample window at
  15 dB: ``detected``, ``lts_start``, ``cw_success``, ``iterations`` and the
  info bits of every decoded codeword equal, ``cfo_hz`` and ``snr_db``
  within 1e-3 (``test_torch_ofdm_pipeline.py``'s tolerances: the JAX search
  sums its energies in float32, the port's in float64).
- ``preamble="cox"`` unchanged: the default chain and the benchmark's frozen
  Schmidl-Cox chain agree with it on every output, bit for bit.
- A layout whose LTS differs from the control profile's, and an unknown
  preamble, are refused.
- The LTS search's spans nest in ``rx.sync`` with operators of ``rx.sync``'s
  own before and after them, and ``LTS_SEARCHES`` counts one search and B
  windows a call without reading a value back.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ria_tpu.fec.interleave import channel_perm as j_channel_perm
from ria_tpu.fec.interleave import frame_perm as j_frame_perm
from ria_tpu.fec.ldpc import make_decoder as j_make_decoder
from ria_tpu.wave import ofdm as J
from ria_tpu_torch.phy.frame_v2 import encode_fixed_frame
from ria_tpu_torch.phy.pipeline import OFDMRxPipeline, make_ofdm_rx_pipeline
from ria_tpu_torch.utils import trace
from ria_tpu_torch.utils.bits import bytes_to_bits
from ria_tpu_torch.wave import ofdm
from ria_tpu_torch.wave.api import WaveformMode, create_waveform

torch.set_num_threads(1)

RATE, WINDOW, CI_BITS = "R1_2", 48000, 106
CFG = ofdm.OFDMConfig(modulation="DQPSK", use_pilots=True, pilot_spacing=10)
S = CFG.num_symbols_for_bits(4 * 648)
NEED = (2 + S) * CFG.symbol_samples
FIELDS = ("detected", "lts_start", "cfo_hz", "cw_success", "info_bits", "iterations", "snr_db")


def _light_batch(batch: int, seed: int, snr_db: float = 15.0):
    """Light frames (two LTS, then a fixed 4-codeword data frame) of random
    payloads at random leads in [0, 16000), under full-band white noise:
    (audio [batch, WINDOW], info bits [batch, 4, k], leads)."""
    rng = np.random.default_rng(seed)
    k, bpc = 324, 324 // 8
    audio = np.zeros((batch, WINDOW), np.float32)
    info = np.zeros((batch, 4, k), np.uint8)
    leads = rng.integers(0, 16000, batch)
    power = []
    for b in range(batch):
        payload = rng.integers(0, 256, 4 * bpc).astype(np.uint8)
        tx = ofdm.tx_frame(encode_fixed_frame(payload.tobytes(), RATE, CI_BITS), CFG,
                           preamble="lts")
        assert len(tx) == NEED
        audio[b, leads[b] : leads[b] + NEED] = tx
        power.append(np.mean(tx.astype(np.float64) ** 2))
        info[b, :, : 8 * bpc] = bytes_to_bits(payload).reshape(4, 8 * bpc)
    sigma = np.sqrt(np.mean(power)) * 10 ** (-snr_db / 20)
    audio += rng.normal(0, sigma, audio.shape).astype(np.float32)
    return torch.as_tensor(audio), info, leads


def _jax_light_chain():
    """The JAX package's stages composed as ``make_ofdm_rx_pipeline``
    composes them, with ``lts_search`` in the Schmidl-Cox search's place."""
    jc = J.OFDMConfig(**dataclasses.asdict(CFG))
    decoder = j_make_decoder(RATE, 80, 0.9375)
    fidx, cidx = j_frame_perm(), j_channel_perm(CI_BITS)

    @jax.jit
    def rx(audio):
        B = audio.shape[0]
        sync = J.lts_search(audio, jc)
        start = jnp.clip(jnp.where(sync.detected, sync.lts_start, 0), 0, WINDOW - NEED)
        frames = jax.vmap(lambda a, s: jax.lax.dynamic_slice(a, (s,), (NEED,)))(audio, start)
        demod = J.demodulate_presynced(frames, sync.cfo_hz, jc, S, 2)
        soft = demod.soft_bits[..., : 4 * 648][..., jnp.asarray(fidx)]
        cw = soft.reshape(B, 4, 648)[..., jnp.asarray(cidx)]
        dec = decoder(cw.reshape(B * 4, 648))
        return {"detected": sync.detected, "lts_start": sync.lts_start, "cfo_hz": sync.cfo_hz,
                "cw_success": dec.success.reshape(B, 4) & sync.detected[:, None],
                "info_bits": dec.info_bits.reshape(B, 4, -1),
                "iterations": dec.iterations.reshape(B, 4), "snr_db": demod.snr_db}

    return rx


def _light_rx():
    return make_ofdm_rx_pipeline(CFG, RATE, WINDOW, CI_BITS, device="cpu", preamble="lts")


def test_the_configuration_is_the_waveforms():
    """The chain's layout is the one ``OFDM_CHIRP`` builds for DQPSK R1/2,
    and its light frame is the waveform's ``tx_frame(..., light=True)``."""
    wf = create_waveform(WaveformMode.OFDM_CHIRP, "DQPSK", "R1_2", device="cpu")
    assert wf.cfg == CFG and wf._ci_bits == CI_BITS and wf.search_window(light=True) == WINDOW
    assert (CFG.num_data_carriers, len(ofdm.carrier_layout(CFG)[2]), S) == (53, 6, 25)
    assert wf.frame_samples(4) - wf.preamble_samples() == NEED == 30240


@pytest.mark.parametrize("case", ["frames", "noisy_and_empty"])
def test_light_chain_matches_jax(case):
    if case == "frames":
        audio, info, leads = _light_batch(4, seed=3)
    else:
        # At 0 dB BP iterates; the last window is noise alone (undetected:
        # sliced from 0, success masked).
        audio, info, leads = _light_batch(4, seed=4, snr_db=0.0)
        audio[3] = torch.as_tensor(np.random.default_rng(5).normal(0, 0.5, WINDOW)
                                   .astype(np.float32))
    got = _light_rx()(audio)
    want = _jax_light_chain()(jnp.asarray(audio.numpy()))
    for name in ("detected", "lts_start", "cw_success", "iterations", "info_bits"):
        g, w = getattr(got, name).numpy(), np.asarray(want[name])
        if name == "info_bits":
            ok = got.cw_success.numpy()
            g, w = g[ok], w[ok]
        assert g.shape == w.shape and np.array_equal(g, w), name
    for name in ("cfo_hz", "snr_db"):
        assert np.allclose(getattr(got, name).numpy(), np.asarray(want[name]), rtol=0,
                           atol=1e-3), name
    if case == "frames":
        assert got.detected.all() and got.cw_success.all()
        assert np.array_equal(got.lts_start.numpy(), leads)
        assert np.array_equal(got.info_bits.numpy(), info)
    else:
        assert got.detected[:3].all() and not got.detected[3]
        assert int(got.lts_start[3]) == -1 and not got.cw_success[3].any()
        assert (got.iterations[:3] > 1).any()


def test_cox_chain_unchanged():
    """``preamble="cox"`` is the chain the benchmark froze before the light
    preamble came, and the default."""
    from benchmark.reference import chains
    from benchmark.reference import ofdm as frozen
    from ria_tpu_torch.entry import _make_ofdm_batch, ofdm_geometry

    geom = ofdm_geometry(3)
    audio, _ = _make_ofdm_batch(geom, 2, seed=6, device="cpu")
    audio += torch.as_tensor(np.random.default_rng(7).normal(0, 0.25, audio.shape)
                             .astype(np.float32))
    args = (geom.cfg, geom.rate, geom.window, geom.ci_bits)
    cox = make_ofdm_rx_pipeline(*args, device="cpu", preamble="cox")
    assert isinstance(cox.sync, ofdm.SchmidlCoxDetector)
    got = cox(audio)
    default = make_ofdm_rx_pipeline(*args, device="cpu")(audio)
    want = chains.OfdmChain(frozen.OFDMConfig(**dataclasses.asdict(geom.cfg)), geom.rate,
                            geom.window, geom.ci_bits, 0.9375, torch.device("cpu"))(audio)
    assert (got.iterations > 1).any()
    for name in FIELDS:
        assert torch.equal(getattr(got, name), getattr(default, name)), name
        assert torch.equal(getattr(got, name), want["start" if name == "lts_start" else name]), \
            name


@pytest.mark.parametrize("kw", [
    {"modulation": "QAM16", "use_pilots": True, "pilot_spacing": 5},
    {"modulation": "DQPSK", "use_pilots": False},
    {"modulation": "DQPSK", "use_pilots": True, "pilot_spacing": 15},
])
def test_a_layout_whose_lts_differs_from_the_controls_is_refused(kw):
    cfg = ofdm.OFDMConfig(**kw)
    with pytest.raises(ValueError, match="control profile"):
        make_ofdm_rx_pipeline(cfg, "R1_2", WINDOW, None, device="cpu", preamble="lts")
    # The Schmidl-Cox chain takes the same layout.
    assert isinstance(make_ofdm_rx_pipeline(cfg, "R1_2", 42720, None, device="cpu").sync,
                      ofdm.SchmidlCoxDetector)


def test_an_unknown_preamble_is_refused():
    with pytest.raises(ValueError, match="preamble"):
        OFDMRxPipeline(CFG, RATE, WINDOW, CI_BITS, device="cpu", preamble="chirp")


def _annotations(prof, name):
    kr = prof.profiler.kineto_results
    return sorted((e.start_ns(), e.end_ns()) for e in kr.events() if e.name() == name)


def test_sync_parts_nest_in_rx_sync():
    trace.reset()
    rx = _light_rx()
    audio, _, _ = _light_batch(1, seed=8)
    rx(audio)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rx(audio)
    (sync,) = _annotations(prof, "rx.sync")
    (coarse,) = _annotations(prof, "sync.coarse")
    (fine,) = _annotations(prof, "sync.fine")
    (demod,) = _annotations(prof, "rx.demod")
    assert sync[0] <= coarse[0] <= coarse[1] <= fine[0] <= fine[1] <= sync[1] <= demod[0]
    # ``rx.sync`` keeps a device-side range over the whole search only if
    # kernels of its own open and close it: the squares, the decision.
    own = sorted((e.start_ns(), e.end_ns(), e.name())
                 for e in prof.profiler.kineto_results.events()
                 if e.name() in ("aten::square", "aten::pow", "aten::where", "aten::_to_copy")
                 and sync[0] <= e.start_ns() <= sync[1]
                 and not coarse[0] <= e.start_ns() <= coarse[1]
                 and not fine[0] <= e.start_ns() <= fine[1])
    assert own[0][1] <= coarse[0] and own[-1][0] >= fine[1], own
    assert trace.count("sync.coarse") == trace.count("sync.fine") == trace.count("rx.sync") == 2
    trace.reset()


def test_lts_searches_counts_without_a_read_back(monkeypatch):
    """One search and B windows a call; the count is the host's shape, and
    the search reads no value back (every way to a host scalar refused)."""
    rx = _light_rx()
    audio, _, _ = _light_batch(3, seed=9)
    ofdm.LTS_SEARCHES.clear()

    def refused(*a, **kw):
        raise AssertionError("a value read back to the host")

    for name in ("item", "tolist", "numpy", "__bool__", "__int__", "__float__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, refused)
    for _ in range(2):
        res = rx.sync(audio)
    monkeypatch.undo()
    assert dict(ofdm.LTS_SEARCHES) == {"searches": 2, "windows": 6}
    assert res.detected.all()
    rx(audio)
    assert dict(ofdm.LTS_SEARCHES) == {"searches": 3, "windows": 9}
    # A window too short for two LTS symbols dispatches no search.
    ofdm.LTSDetector(CFG, 2000, device="cpu")(torch.zeros(2, 2000))
    assert ofdm.LTS_SEARCHES["searches"] == 3
