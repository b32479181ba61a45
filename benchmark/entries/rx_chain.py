"""The RX chain that a configuration names, called as a gateway calls it:
``ria_tpu_torch.phy.pipeline.make_rx_pipeline(...)(audio)`` for MC-DPSK,
``make_ofdm_rx_pipeline(...)(audio)`` for OFDM, on audio [channels, window].

Outputs handed to the host: ``detected``, ``start`` (the chirp start, or
the first LTS symbol's), ``cfo_hz`` and ``snr_db`` per channel;
``cw_success``, ``info_bits`` and ``iterations`` per codeword.

The check compares them with the frozen plain chain (``reference/chains.py``)
on the same audio, and with what was sent, six numbers:

- ``sync_mismatch``: channels whose ``detected`` differs, or whose start
  differs where both detected;
- ``cfo_gap_hz`` and ``snr_gap_db``: the widest gap of a CFO and of an SNR
  estimate, over the channels both detected;
- ``cw_mismatch``: codewords whose success, info bits or iteration count
  differ;
- ``sent_start_gap``: the widest gap, in samples, between a start that the
  program detected and the sent one;
- ``sent_cw_wrong``: codewords that the program reports decoded whose info
  bits are not the sent ones.
"""

from __future__ import annotations

import torch

from benchmark import deploy
from benchmark.reference import chains, chirp, mc_dpsk, ofdm


class Program:
    def __init__(self, cfg: dict, traffic: dict, device: torch.device):
        from ria_tpu_torch.phy.pipeline import make_ofdm_rx_pipeline, make_rx_pipeline
        from ria_tpu_torch.sync.chirp import ChirpConfig
        from ria_tpu_torch.wave.mc_dpsk import MCDPSKConfig
        from ria_tpu_torch.wave.ofdm import OFDMConfig

        B = traffic["channels"]
        if cfg["waveform"] == "mcdpsk":
            wf = MCDPSKConfig(**deploy.mcdpsk_kwargs(cfg),
                              chirp=ChirpConfig(**deploy.chirp_kwargs(cfg)))
            self.rx = make_rx_pipeline(wf, cfg["rate"], cfg["codewords_per_frame"],
                                       cfg["window_samples"], cfg["min_sum_factor"],
                                       batch_hint=B, device=device)
            self.start = "start"
        else:
            wf = OFDMConfig(**deploy.ofdm_kwargs(cfg))
            self.rx = make_ofdm_rx_pipeline(wf, cfg["rate"], cfg["window_samples"],
                                            cfg["channel_interleave_bits"], batch_hint=B,
                                            min_sum_factor=cfg["min_sum_factor"],
                                            device=device)
            self.start = "lts_start"

    def __call__(self, audio: torch.Tensor) -> dict[str, torch.Tensor]:
        r = self.rx(audio)
        return {"detected": r.detected, "start": getattr(r, self.start), "cfo_hz": r.cfo_hz,
                "snr_db": r.snr_db, "cw_success": r.cw_success, "info_bits": r.info_bits,
                "iterations": r.iterations}


def work(cfg: dict, traffic: dict) -> dict:
    B = traffic["channels"]
    return {"samples": B * cfg["window_samples"], "codewords": B * cfg["codewords_per_frame"]}


def reference(cfg: dict, traffic: dict, device: torch.device):
    """The frozen plain chain of the configuration's waveform."""
    if cfg["waveform"] == "mcdpsk":
        wf = mc_dpsk.MCDPSKConfig(**deploy.mcdpsk_kwargs(cfg),
                                  chirp=chirp.ChirpConfig(**deploy.chirp_kwargs(cfg)))
        return chains.McdpskChain(wf, cfg["rate"], cfg["codewords_per_frame"],
                                  cfg["window_samples"], cfg["min_sum_factor"], device)
    wf = ofdm.OFDMConfig(**deploy.ofdm_kwargs(cfg))
    return chains.OfdmChain(wf, cfg["rate"], cfg["window_samples"],
                            cfg["channel_interleave_bits"], cfg["min_sum_factor"], device)


def control(cfg: dict, traffic: dict, device: torch.device, precision: str):
    """The reference in a precision below the configuration's float32 with
    TF32 off: ``"tf32"``, its matmuls in TF32; ``"bf16"``, its input audio
    rounded to bfloat16 as well (the step of an upload in bfloat16)."""
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
    sync = cw = gap = wrong = 0
    cfo = snr = 0.0
    for g, w in zip(got, want):
        both = g["detected"] & w["detected"]
        sync += int((g["detected"] != w["detected"]).sum())
        sync += int((both & (g["start"] != w["start"])).sum())
        if bool(both.any()):
            cfo = max(cfo, float((g["cfo_hz"] - w["cfo_hz"]).abs()[both].max()))
            snr = max(snr, float((g["snr_db"] - w["snr_db"]).abs()[both].max()))
        differ = ((g["cw_success"] != w["cw_success"])
                  | (g["iterations"] != w["iterations"])
                  | (g["info_bits"] != w["info_bits"]).any(dim=-1))
        cw += int(differ.sum())
    for g, s in zip(got, sent):
        det = g["detected"]
        if bool(det.any()):
            gap = max(gap, int((g["start"].long() - s["start"].long()).abs()[det].max()))
        wrong += int((g["cw_success"] & (g["info_bits"] != s["info_bits"]).any(dim=-1)).sum())
    return {"sync_mismatch": sync, "cfo_gap_hz": cfo, "snr_gap_db": snr, "cw_mismatch": cw,
            "sent_start_gap": gap, "sent_cw_wrong": wrong}
