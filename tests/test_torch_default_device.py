"""The port's public entry points run on the card unless asked for the CPU.

Each entry point is called with no ``device``.  Without a card the call
must raise instead of running on the host; with one, its result must lie on
the card.  Whether a card is present is decided inside the test.
"""

import numpy as np
import pytest
import torch

from ria_tpu_torch.entry import (RATE, _make_ofdm_batch, bench_batches, entry, geometry,
                                 ofdm_geometry)
from ria_tpu_torch.fec import ldpc as T
from ria_tpu_torch.fec import ldpc_kernel
from ria_tpu_torch.phy import frame_v2
from ria_tpu_torch.phy.pipeline import make_ofdm_rx_pipeline, make_rx_pipeline, make_tx_pipeline
from ria_tpu_torch.sync import css, zc
from ria_tpu_torch.tools import waveform_paths
from ria_tpu_torch.wave import dpsk, mfsk, ofdm, otfs

torch.set_num_threads(1)


def _rx_pipeline():
    cfg, ncw, _, window = geometry()
    return make_rx_pipeline(cfg, RATE, ncw, window).decoder.row_idx


def _tx_pipeline():
    cfg, ncw, _, _ = geometry()
    return make_tx_pipeline(cfg, ncw).synth_t


def _ofdm_rx_pipeline():
    g = ofdm_geometry(4)
    return make_ofdm_rx_pipeline(g.cfg, g.rate, g.window, g.ci_bits).frame_idx


def _decode_fixed_frame():
    rate = "R1_2"
    bits = frame_v2.encode_fixed_frame(b"hello", rate, 118)
    return frame_v2.decode_fixed_frame((1.0 - 2.0 * bits) * 4.0, rate, 118)[0]


CFG3 = ofdm.OFDMConfig()

CALLS = {
    "entry": lambda: entry()[1][0],
    "make_rx_pipeline": _rx_pipeline,
    "make_tx_pipeline": _tx_pipeline,
    "LDPCCodec": lambda: T.LDPCCodec("R1_2").device,
    "make_decoder": lambda: T.make_decoder("R1_2")(
        torch.zeros((1, 648), device="cuda")).llr_total,
    "decode_batch": lambda: T.decode_batch(np.zeros((2, 648), np.float32),
                                           np.full(2, 0.75, np.float32), "R1_2").success,
    "make_ofdm_rx_pipeline": _ofdm_rx_pipeline,
    "_make_ofdm_batch": lambda: _make_ofdm_batch(ofdm_geometry(3), 1)[0],
    "SchmidlCoxDetector": lambda: ofdm.SchmidlCoxDetector(CFG3, 20000).lts_fft,
    "LTSDetector": lambda: ofdm.LTSDetector(CFG3, 9000).lts_fft,
    "OFDMDemodulator": lambda: ofdm.OFDMDemodulator(CFG3, 4).t,
    "decode_fixed_frame": _decode_fixed_frame,
    "decode_codewords": lambda: frame_v2.decode_codewords(np.zeros((1, 648), np.float32))[0],
    "bench_batches": lambda: bench_batches().ldpc.variants[0],
    "ZCDetector": lambda: zc.ZCDetector(zc.ZCConfig(), 9000).tmpl_fft,
    "zc_detector": lambda: zc.zc_detector(zc.ZCConfig(), 9000).t,
    "CSSDetector": lambda: css.CSSDetector(css.CSSConfig(), 60000).tmpl_fft,
    "BarkerDetector": lambda: dpsk.BarkerDetector(dpsk.DPSKConfig(), 90000).mixer,
    "DPSKDemodulator": lambda: dpsk.DPSKDemodulator(dpsk.DPSKConfig(), 64).mixer,
    "MFSKPreambleDetector": lambda: mfsk.MFSKPreambleDetector(mfsk.MFSKConfig(), 40000).bank,
    "MFSKDemodulator": lambda: mfsk.MFSKDemodulator(mfsk.MFSKConfig(), 48).bank,
    "OTFSDemodulator": lambda: otfs.OTFSDemodulator(otfs.OTFSConfig()).t,
    "make_path_batch": lambda: waveform_paths.make_path_batch("otfs_eq", 1).inputs[0],
}


@pytest.mark.parametrize("name", list(CALLS))
def test_default_device_is_the_card(name):
    if torch.cuda.is_available():
        before = ldpc_kernel.LAUNCHES
        got = CALLS[name]()
        if isinstance(got, np.ndarray):  # a host result: decoded by K1 on the card
            assert ldpc_kernel.LAUNCHES > before
            return
        assert (got if isinstance(got, torch.device) else got.device).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            CALLS[name]()
