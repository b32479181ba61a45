"""The port's public entry points run on the card unless asked for the CPU.

Each entry point is called with no ``device``.  Without a card the call
must raise instead of running on the host; with one, its result must lie on
the card.  Whether a card is present is decided inside the test.
"""

import numpy as np
import pytest
import torch

from ria_tpu_torch.entry import RATE, entry, geometry
from ria_tpu_torch.fec import ldpc as T
from ria_tpu_torch.phy.pipeline import make_rx_pipeline, make_tx_pipeline

torch.set_num_threads(1)


def _rx_pipeline():
    cfg, ncw, _, window = geometry()
    return make_rx_pipeline(cfg, RATE, ncw, window).decoder.row_idx


def _tx_pipeline():
    cfg, ncw, _, _ = geometry()
    return make_tx_pipeline(cfg, ncw).synth_t


CALLS = {
    "entry": lambda: entry()[1][0],
    "make_rx_pipeline": _rx_pipeline,
    "make_tx_pipeline": _tx_pipeline,
    "LDPCCodec": lambda: T.LDPCCodec("R1_2").device,
    "make_decoder": lambda: T.make_decoder("R1_2")(
        torch.zeros((1, 648), device="cuda")).llr_total,
    "decode_batch": lambda: T.decode_batch(np.zeros((2, 648), np.float32),
                                           np.full(2, 0.75, np.float32), "R1_2").success,
}


@pytest.mark.parametrize("name", list(CALLS))
def test_default_device_is_the_card(name):
    if torch.cuda.is_available():
        got = CALLS[name]()
        assert (got if isinstance(got, torch.device) else got.device).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            CALLS[name]()
