"""The OFDM RX chain of a configuration with pilots, called as a gateway
calls it: ``make_ofdm_rx_pipeline(...)(audio)`` on audio [channels, window],
as in ``rx_chain.py``, with the waveform built with the configuration's
``pilot_spacing`` (``deploy_pilots.py``).

Outputs handed to the host: ``rx_chain.py``'s, and ``evm`` [channels]
float32, each channel's error vector magnitude of its equalised data
symbols (the demodulator's ``symbols``, [channels, S, D], read by a forward
hook on the chain's demodulator, which runs once a call): the mean of
|eq - q(eq)|^2 over the mean of |q(eq)|^2, where q is the nearest point of
the configuration's square constellation, taken axis by axis.  It is what
a gateway's link adaptation reads, and the one output that sees the
equaliser at an SNR where every LLR sits at its clip.  It runs over the
carriers that hold the frame's bits, the first ceil(bits / bits a carrier)
in symbol order: the TX sends nothing on the rest of the last symbol (27
of its 51 carriers at QAM64 R3/4), where eq is noise and its distance to
the nearest point would be most of the sum.

The check is ``rx_chain.py``'s six numbers and a seventh:

- ``evm_gap``: the widest |evm_program / evm_reference - 1| over the
  channels both detected.
"""

from __future__ import annotations

import torch
from torch import nn

from benchmark import deploy_pilots
from benchmark.entries import rx_chain
from benchmark.reference import chains, ofdm

work = rx_chain.work


class Evm:
    """The EVM of the first ``carriers`` symbols (in symbol order) that
    ``demod`` returned last, on the square constellation of ``modulation``:
    its levels are those of the frozen table, spaced ``step`` apart on each
    axis, the outermost at ``top``."""

    def __init__(self, demod: nn.Module, modulation: str, carriers: int):
        table = ofdm.constellation_table(modulation)
        levels = sorted({round(float(v), 6) for v in table.real})
        imag = sorted({round(float(v), 6) for v in table.imag})
        if levels != imag or len(levels) ** 2 != len(table):
            raise ValueError(f"{modulation} is no square constellation")
        self.step = levels[1] - levels[0]
        self.top = levels[-1]
        self.carriers = carriers
        self.symbols = None
        demod.register_forward_hook(self._keep)

    def _keep(self, module, args, out) -> None:
        self.symbols = out.symbols

    def _nearest(self, x: torch.Tensor) -> torch.Tensor:
        grid = (torch.floor(x / self.step) + 0.5) * self.step
        return torch.clamp(grid, -self.top, self.top)

    def read(self) -> torch.Tensor:
        eq = self.symbols.flatten(-2)[..., : self.carriers]
        q = torch.complex(self._nearest(eq.real), self._nearest(eq.imag))
        return torch.square(torch.abs(eq - q)).sum(-1) / torch.square(torch.abs(q)).sum(-1)


def frame_evm(demod: nn.Module, cfg: dict) -> Evm:
    """The :class:`Evm` of a configuration's frame on ``demod``."""
    bits = cfg["codewords_per_frame"] * chains.LDPC_BITS
    per_carrier = ofdm.BITS_PER_SYMBOL[cfg["modulation"]]
    return Evm(demod, cfg["modulation"], -(-bits // per_carrier))


class Program(rx_chain.Program):
    def __init__(self, cfg: dict, traffic: dict, device: torch.device):
        from ria_tpu_torch.phy.pipeline import make_ofdm_rx_pipeline
        from ria_tpu_torch.wave.ofdm import OFDMConfig

        self.rx = make_ofdm_rx_pipeline(OFDMConfig(**deploy_pilots.ofdm_kwargs(cfg)),
                                        cfg["rate"], cfg["window_samples"],
                                        cfg["channel_interleave_bits"],
                                        batch_hint=traffic["channels"],
                                        min_sum_factor=cfg["min_sum_factor"], device=device)
        self.start = "lts_start"
        self.evm = frame_evm(self.rx.demod, cfg)

    def __call__(self, audio: torch.Tensor) -> dict[str, torch.Tensor]:
        return {**super().__call__(audio), "evm": self.evm.read()}


class Reference:
    """The frozen plain chain (``reference/chains.py``) on the configuration's
    pilot layout, with the same EVM of its demodulator's symbols."""

    def __init__(self, cfg: dict, device: torch.device):
        wf = ofdm.OFDMConfig(**deploy_pilots.ofdm_kwargs(cfg))
        self.chain = chains.OfdmChain(wf, cfg["rate"], cfg["window_samples"],
                                      cfg["channel_interleave_bits"], cfg["min_sum_factor"],
                                      device)
        self.evm = frame_evm(self.chain.demod, cfg)

    def __call__(self, audio: torch.Tensor) -> dict[str, torch.Tensor]:
        return {**self.chain(audio), "evm": self.evm.read()}


def reference(cfg: dict, traffic: dict, device: torch.device) -> Reference:
    if cfg["waveform"] != "ofdm" or not cfg["use_pilots"]:
        raise ValueError(f"{cfg['name']}: rx_chain_pilots takes OFDM with pilots")
    return Reference(cfg, device)


def control(cfg: dict, traffic: dict, device: torch.device, precision: str):
    """``rx_chain.control`` on this reference: its matmuls in TF32
    (``"tf32"``), and its input audio rounded to bfloat16 as well
    (``"bf16"``)."""
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


def compare(got: list[dict], want: list[dict], sent: list[dict]) -> dict[str, float]:
    evm = 0.0
    for g, w in zip(got, want):
        both = g["detected"] & w["detected"]
        if bool(both.any()):
            evm = max(evm, float((g["evm"][both] / w["evm"][both] - 1).abs().max()))
    return {**rx_chain.compare(got, want, sent), "evm_gap": evm}
