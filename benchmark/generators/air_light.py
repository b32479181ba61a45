"""Connected-mode data frames on the air: every channel of a call holds one
fixed 4-codeword OFDM frame behind the light preamble, two LTS symbols and
no guard or STS (the frozen ``ofdm.tx_frame(..., preamble="lts")``, what
both OFDM waveforms send before every data frame once a link is
connected), at a random lead, under white Gaussian noise.  The waveform
carries the configuration's pilots (``deploy_pilots.py``): the pilot
sequence in the pilot bins of both LTS symbols and of every data symbol.

Traffic parameters, the draws from ``seed`` and what is kept for the check
are ``air.py``'s.  The sync places a frame at its first LTS symbol, which is
the frame's first sample, so the sent ``start`` is the lead itself.  This
module runs a copy of ``air.py`` of its own, as ``air_pilots.py`` does,
whose OFDM TX is :func:`_light_tx`.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import deploy, deploy_pilots
from benchmark.generators import air_pilots
from benchmark.reference import interleave, ofdm


def _light_tx(cfg: dict, coded: np.ndarray, device: torch.device) -> torch.Tensor:
    """[B, 4, 648] coded bits -> [B, frame samples] float32 audio: the frozen
    ``ofdm.tx_frame(..., preamble="lts", training_count=2)`` over the whole
    batch at once, the IFFTs and the upmix on the device."""
    wf = ofdm.OFDMConfig(**deploy_pilots.ofdm_kwargs(cfg))
    cw = interleave.apply_perm(coded, interleave.channel_perm(cfg["channel_interleave_bits"]))
    frames = interleave.frame_interleave(cw)
    B, nbits = frames.shape
    bpc = ofdm.BITS_PER_SYMBOL[wf.modulation]
    D = wf.num_data_carriers
    S = wf.num_symbols_for_bits(nbits)
    padded = np.zeros((B, S * D * bpc), np.int64)
    padded[:, :nbits] = frames
    grouped = padded.reshape(B, S, D, bpc)
    vals = np.zeros((B, S, D), np.int64)
    for b in range(bpc):
        vals = (vals << 1) | grouped[..., b]
    sym = ofdm.constellation_table(wf.modulation)[vals]
    if wf.modulation in ofdm.DIFFERENTIAL:
        sym = np.cumprod(sym, axis=1)       # differential from the all-ones reference
    # A carrier whose first bit lies past the data sends nothing.
    active = (np.arange(S)[:, None] * D + np.arange(D)[None, :]) * bpc < nbits
    sym = np.where(active, sym, 0).astype(np.complex64)
    _, data_bins, pilot_bins = ofdm.carrier_layout(wf)
    freq = torch.zeros((B, S, wf.fft_size), dtype=torch.complex64, device=device)
    freq[:, :, torch.as_tensor(data_bins, device=device)] = torch.as_tensor(sym, device=device)
    freq[:, :, torch.as_tensor(pilot_bins, device=device)] = torch.as_tensor(
        ofdm.pilot_sequence(wf), device=device)
    td = torch.fft.ifft(freq, dim=-1)
    parts = [td[..., -wf.cp_len:], td]
    if wf.symbol_guard:
        parts.append(td.new_zeros((B, S, wf.symbol_guard)))
    data = torch.cat(parts, dim=-1).reshape(B, -1)
    pre = torch.as_tensor(np.tile(ofdm._lts_symbol(wf), 2), device=device)
    stream = torch.cat([pre.expand(B, -1), data], dim=-1)
    t = torch.arange(stream.shape[-1], dtype=torch.float64, device=device)
    carrier = torch.exp(2j * np.pi * wf.center_freq * t / wf.sample_rate)
    deploy.check_window(cfg, (2 + S) * wf.symbol_samples)
    return ((stream.to(torch.complex128) * carrier).real * wf.output_scale).float()


AIR = air_pilots._air()
AIR._ofdm_tx = _light_tx
AIR._start_offset = lambda cfg: 0


def make_pool(cfg: dict, traffic: dict, seed: int,
              device: torch.device) -> tuple[list[torch.Tensor], list[dict]]:
    if cfg["waveform"] != "ofdm" or cfg["preamble"] != "lts" or not cfg["use_pilots"]:
        raise ValueError(f"{cfg['name']}: air_light takes OFDM with pilots behind the "
                         "light preamble")
    return AIR.make_pool(cfg, traffic, seed, device)
