"""The OFDM RX chain of a configuration whose data frames ride the light
preamble, called as a gateway calls it:
``make_ofdm_rx_pipeline(..., preamble="lts")(audio)`` on audio [channels,
window], with the waveform built with the configuration's ``pilot_spacing``
(``deploy_pilots.py``).

Its outputs and its check are ``rx_chain.py``'s: the six numbers against the
frozen plain light chain (``reference/light.py``) and against what was sent.
The control is ``rx_chain.py``'s on this reference: its matmuls in TF32
(``"tf32"``), and its input audio rounded to bfloat16 as well (``"bf16"``).
"""

from __future__ import annotations

import torch

from benchmark import deploy_pilots
from benchmark.entries import rx_chain
from benchmark.reference import light, ofdm

work = rx_chain.work
compare = rx_chain.compare


class Program(rx_chain.Program):
    def __init__(self, cfg: dict, traffic: dict, device: torch.device):
        from ria_tpu_torch.phy.pipeline import make_ofdm_rx_pipeline
        from ria_tpu_torch.wave.ofdm import OFDMConfig

        self.rx = make_ofdm_rx_pipeline(OFDMConfig(**deploy_pilots.ofdm_kwargs(cfg)),
                                        cfg["rate"], cfg["window_samples"],
                                        cfg["channel_interleave_bits"],
                                        batch_hint=traffic["channels"],
                                        min_sum_factor=cfg["min_sum_factor"], device=device,
                                        preamble=cfg["preamble"])
        self.start = "lts_start"


def reference(cfg: dict, traffic: dict, device: torch.device) -> light.LightChain:
    if cfg["waveform"] != "ofdm" or cfg["preamble"] != "lts":
        raise ValueError(f"{cfg['name']}: rx_chain_light takes OFDM behind the light preamble")
    return light.LightChain(ofdm.OFDMConfig(**deploy_pilots.ofdm_kwargs(cfg)), cfg["rate"],
                            cfg["window_samples"], cfg["channel_interleave_bits"],
                            cfg["min_sum_factor"], device)


def control(cfg: dict, traffic: dict, device: torch.device, precision: str):
    ref = reference(cfg, traffic, device)

    def call(audio: torch.Tensor) -> dict[str, torch.Tensor]:
        if precision == "bf16":
            audio = audio.to(torch.bfloat16).float()
        before = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return ref(audio)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = before

    return call
