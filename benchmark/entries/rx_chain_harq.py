"""One HARQ round with chase combining, called as a gateway calls it:
``ria_tpu_torch.phy.pipeline.make_harq_rx_pipeline(...)(audio)`` on audio
[channels, copies, window], each channel's transmissions of one MC-DPSK
frame in arrival order.

Outputs handed to the host: ``detected``, ``start``, ``cfo_hz`` and
``snr_db`` of every copy [channels, copies]; the round's ``cw_success``,
``info_bits``, ``iterations`` and ``source`` (the walk position that
decoded the codeword, -1 none) per codeword.

The check compares them with the plain round (``reference/harq.py``) on
the same audio, and with what was sent, six numbers:

- ``sync_mismatch``: copies whose ``detected`` differs, or whose start
  differs where both detected;
- ``cfo_gap_hz`` and ``snr_gap_db``: the widest gap of a CFO and of an SNR
  estimate, over the copies both detected;
- ``cw_mismatch``: codewords whose final success, info bits, iteration
  count or ``source`` differ;
- ``sent_start_gap``: the widest gap, in samples, between a start that the
  program detected and the copy's sent one;
- ``sent_cw_wrong_excess``: the codewords that the program reports decoded
  to other bits than the sent, less those of the reference.  At the edge a
  decode converges to a neighbouring codeword now and then, the reference's
  as well, so what was sent holds the program only to the reference's count.
"""

from __future__ import annotations

import torch

from benchmark import deploy
from benchmark.reference import chirp, harq, mc_dpsk


def _waveform(cfg: dict, chirp_cls, mcdpsk_cls):
    return mcdpsk_cls(**deploy.mcdpsk_kwargs(cfg), chirp=chirp_cls(**deploy.chirp_kwargs(cfg)))


class Program:
    def __init__(self, cfg: dict, traffic: dict, device: torch.device):
        from ria_tpu_torch.phy.pipeline import make_harq_rx_pipeline
        from ria_tpu_torch.sync.chirp import ChirpConfig
        from ria_tpu_torch.wave.mc_dpsk import MCDPSKConfig

        self.rx = make_harq_rx_pipeline(_waveform(cfg, ChirpConfig, MCDPSKConfig), cfg["rate"],
                                        cfg["codewords_per_frame"], cfg["window_samples"],
                                        traffic["copies"], cfg["min_sum_factor"], device=device)

    def __call__(self, audio: torch.Tensor) -> dict[str, torch.Tensor]:
        r = self.rx(audio)
        return {"detected": r.detected, "start": r.start, "cfo_hz": r.cfo_hz,
                "snr_db": r.snr_db, "cw_success": r.cw_success, "info_bits": r.info_bits,
                "iterations": r.iterations, "source": r.source}


def work(cfg: dict, traffic: dict) -> dict:
    B = traffic["channels"]
    return {"samples": B * traffic["copies"] * cfg["window_samples"],
            "codewords": B * cfg["codewords_per_frame"]}


def reference(cfg: dict, traffic: dict, device: torch.device) -> harq.HarqChain:
    if cfg["waveform"] != "mcdpsk":
        raise ValueError(f"{cfg['name']}: rx_chain_harq takes MC-DPSK")
    return harq.HarqChain(_waveform(cfg, chirp.ChirpConfig, mc_dpsk.MCDPSKConfig), cfg["rate"],
                          cfg["codewords_per_frame"], cfg["window_samples"], traffic["copies"],
                          cfg["min_sum_factor"], device)


def control(cfg: dict, traffic: dict, device: torch.device, precision: str):
    """The reference in a precision below the configuration's float32 with
    TF32 off: ``"tf32"``, its matmuls in TF32."""
    if precision != "tf32":
        raise ValueError(f"no {precision!r} control; tf32")
    ref = reference(cfg, traffic, device)

    def call(audio: torch.Tensor) -> dict[str, torch.Tensor]:
        before = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return ref(audio)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = before

    return call


def _wrong(out: dict, sent: dict) -> int:
    return int((out["cw_success"] & (out["info_bits"] != sent["info_bits"]).any(dim=-1)).sum())


def compare(got: list[dict], want: list[dict], sent: list[dict]) -> dict[str, float]:
    sync = cw = gap = wrong = 0
    cfo = snr = 0.0
    for g, w, s in zip(got, want, sent):
        both = g["detected"] & w["detected"]
        sync += int((g["detected"] != w["detected"]).sum())
        sync += int((both & (g["start"] != w["start"])).sum())
        if bool(both.any()):
            cfo = max(cfo, float((g["cfo_hz"] - w["cfo_hz"]).abs()[both].max()))
            snr = max(snr, float((g["snr_db"] - w["snr_db"]).abs()[both].max()))
        differ = ((g["cw_success"] != w["cw_success"])
                  | (g["iterations"] != w["iterations"])
                  | (g["source"] != w["source"])
                  | (g["info_bits"] != w["info_bits"]).any(dim=-1))
        cw += int(differ.sum())
        det = g["detected"]
        if bool(det.any()):
            gap = max(gap, int((g["start"].long() - s["start"].long()).abs()[det].max()))
        wrong += _wrong(g, s) - _wrong(w, s)
    return {"sync_mismatch": sync, "cfo_gap_hz": cfo, "snr_gap_db": snr, "cw_mismatch": cw,
            "sent_start_gap": gap, "sent_cw_wrong_excess": wrong}
