"""Frames on the air: every channel of a call holds one frame of the
configuration's waveform at a random lead, under white Gaussian noise.

Traffic parameters: ``channels`` a call, ``pool`` distinct calls, ``snr_db``
(noise power against the mean power of the call's frames), ``max_lead``
(leads uniform in [0, max_lead)).  From ``seed``: a numpy generator draws
the info bits of every codeword and every lead, a generator on the device
draws the noise.  Each codeword is encoded by the frozen LDPC encoder, and
each frame built by the frozen TX of its waveform (``reference/``):
MC-DPSK's chirp, training, reference symbol and data (the symbols' phases
summed on the host, synthesised on the device); OFDM's fixed 4-codeword
frame, channel- and frame-interleaved, behind a Schmidl-Cox preamble (the
frozen ``tx_frame`` over the batch, its IFFTs on the device).  The
pool lies in pinned host memory.

Beside each call it keeps what was sent, for the check: every codeword's
``info_bits`` [channels, codewords, k] and each channel's ``start``, the
sample at which the sync should place it (the chirp's first sample; the
first LTS symbol's, behind the guard and the four STS symbols).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import deploy
from benchmark.reference import chirp, interleave, ldpc_matrix, mc_dpsk, ofdm


def _mcdpsk_tx(cfg: dict, coded: np.ndarray, device: torch.device) -> torch.Tensor:
    """[B, ncw * 648] coded bits -> [B, frame samples] float32 audio."""
    wf = mc_dpsk.MCDPSKConfig(**deploy.mcdpsk_kwargs(cfg),
                              chirp=chirp.ChirpConfig(**deploy.chirp_kwargs(cfg)))
    B, nbits = coded.shape
    n_sym = wf.num_data_symbols(nbits)
    bits = np.zeros((B, n_sym * wf.bits_per_mc_symbol), np.int64)
    bits[:, :nbits] = coded
    grouped = bits.reshape(B, n_sym, wf.num_carriers, wf.bits_per_symbol)
    if wf.bits_per_symbol == 2:
        dphi = mc_dpsk.DQPSK_PHASES[grouped[..., 0] * 2 + grouped[..., 1]]
    else:
        dphi = grouped[..., 0] * np.pi
    # Differential from the all-ones reference symbol.
    symbols = np.exp(1j * np.cumsum(dphi, axis=1)).astype(np.complex64)
    sym = torch.repeat_interleave(torch.as_tensor(symbols, device=device), wf.spreading, dim=1)
    synth = torch.as_tensor(mc_dpsk._synth_matrix(wf), device=device)
    body = ((sym @ synth.T).real / wf.num_carriers).reshape(B, -1)
    pre = torch.as_tensor(mc_dpsk.preamble(wf), device=device)
    deploy.check_window(cfg, wf.frame_samples(nbits))
    return torch.cat([pre.expand(B, -1), body], dim=-1)


def _ofdm_tx(cfg: dict, coded: np.ndarray, device: torch.device) -> torch.Tensor:
    """[B, 4, 648] coded bits -> [B, frame samples] float32 audio: the frozen
    ``ofdm.tx_frame`` (``preamble="cox"``) over the whole batch at once, the
    IFFTs and the upmix on the device."""
    wf = ofdm.OFDMConfig(**deploy.ofdm_kwargs(cfg))
    if cfg["preamble"] != "cox":
        raise ValueError(f"no {cfg['preamble']!r} preamble; cox")
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
    if len(pilot_bins):
        freq[:, :, torch.as_tensor(pilot_bins, device=device)] = torch.as_tensor(
            ofdm.pilot_sequence(wf), device=device)
    td = torch.fft.ifft(freq, dim=-1)
    parts = [td[..., -wf.cp_len:], td]
    if wf.symbol_guard:
        parts.append(td.new_zeros((B, S, wf.symbol_guard)))
    data = torch.cat(parts, dim=-1).reshape(B, -1)
    pre = np.concatenate([np.tile(ofdm._sts_symbol(wf), 4), np.tile(ofdm._lts_symbol(wf), 2)])
    stream = torch.cat([torch.as_tensor(pre, device=device).expand(B, -1), data], dim=-1)
    t = torch.arange(stream.shape[-1], dtype=torch.float64, device=device)
    carrier = torch.exp(2j * np.pi * wf.center_freq * t / wf.sample_rate)
    body = ((stream.to(torch.complex128) * carrier).real * wf.output_scale).float()
    deploy.check_window(cfg, wf.preamble_samples + (2 + S) * wf.symbol_samples)
    return torch.cat([body.new_zeros((B, wf.fft_size + wf.cp_len)), body], dim=-1)


def _start_offset(cfg: dict) -> int:
    """Samples from a frame's first sample to the start that the sync reports."""
    if cfg["waveform"] == "mcdpsk":
        return 0
    wf = ofdm.OFDMConfig(**deploy.ofdm_kwargs(cfg))
    return wf.fft_size + wf.cp_len + 4 * len(ofdm._sts_symbol(wf))


def make_pool(cfg: dict, traffic: dict, seed: int,
              device: torch.device) -> tuple[list[torch.Tensor], list[dict]]:
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    B, ncw = traffic["channels"], cfg["codewords_per_frame"]
    window = cfg["window_samples"]
    code = ldpc_matrix.get_code(cfg["rate"])
    tx_of = {"mcdpsk": _mcdpsk_tx, "ofdm": _ofdm_tx}[cfg["waveform"]]
    pool, sent = [], []
    for _ in range(traffic["pool"]):
        info = rng.integers(0, 2, (B * ncw, code.k), dtype=np.uint8)
        coded = ldpc_matrix.encode_np(info, cfg["rate"])
        shape = (B, ncw * code.n) if cfg["waveform"] == "mcdpsk" else (B, ncw, code.n)
        tx = tx_of(cfg, coded.reshape(shape), device)
        leads = rng.integers(0, traffic["max_lead"], B)
        if int(leads.max()) + tx.shape[1] > window:
            raise ValueError(f"a frame at lead {int(leads.max())} overruns the window")
        idx = torch.as_tensor(leads, device=device)[:, None] + torch.arange(tx.shape[1],
                                                                            device=device)
        audio = torch.zeros((B, window), dtype=torch.float32, device=device)
        audio.scatter_(1, idx, tx)
        sigma = float(torch.sqrt(torch.mean(tx * tx))) * 10 ** (-traffic["snr_db"] / 20)
        audio += sigma * torch.randn((B, window), generator=gen, device=device)
        pool.append(audio.cpu().pin_memory() if device.type == "cuda" else audio)
        sent.append({"info_bits": torch.from_numpy(info.reshape(B, ncw, code.k)),
                     "start": torch.as_tensor(leads + _start_offset(cfg))})
    return pool, sent
