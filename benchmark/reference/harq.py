"""One HARQ round of chase combining in plain torch: each channel's copies
of one frame through the frozen MC-DPSK chain's sync and demod
(``chains.McdpskChain``), each copy decoded alone by the plain decoder, the
LLRs of the copies that failed summed and decoded, and each codeword's
outcome picked as a gateway's chase cache picks it (the host cache of
``src/fec/chase_cache.hpp``: a failed codeword's LLRs are added to those of
its earlier failed copies, at most four combines, and a codeword stops
combining once it decodes).  It imports nothing of the port.

The walk of a codeword: copy 1 alone; then, for r = 2..R, copy r alone,
then the sum of the copies received up to r where copy r was received and
the sum holds two or more; the first decode that succeeds gives the outcome,
else the last one tried (copy 1 alone where none was).  A copy whose sync
missed was not received: it is no decode and adds nothing.  Sums add in
float32 left to right in arrival order, the first term copied.  ``source``
is the decode's place in that order: 0 copy 1, 1 copy 2, 2 the sum of 1-2,
3 copy 3, 4 the sum of 1-3, 5 copy 4, 6 the sum of 1-4; -1 where no decode
succeeded.

Here the walk runs codeword by codeword on the host, over decodes made at
full width (every channel's sum at each r, whether the walk reaches it or
not: a codeword's decode does not depend on the other rows of its batch).
"""

from __future__ import annotations

import torch
from torch import nn

from .chains import LDPC_BITS, McdpskChain
from .chirp import window_slice
from .mc_dpsk import MCDPSKConfig

MAX_COMBINES = 4      # chase_cache.hpp's MAX_COMBINES


class HarqChain(nn.Module):
    """audio [B, R, window] -> the round's outputs: ``detected``, ``start``,
    ``cfo_hz``, ``snr_db`` [B, R] of every copy; ``cw_success``,
    ``info_bits``, ``iterations``, ``source`` [B, NCW] of the outcome."""

    def __init__(self, cfg: MCDPSKConfig, rate: str, num_codewords: int,
                 window_samples: int, copies: int, min_sum_factor: float,
                 device: torch.device):
        super().__init__()
        if not 1 <= copies <= MAX_COMBINES:
            raise ValueError(f"{copies} copies; a codeword combines at most {MAX_COMBINES}")
        self.chain = McdpskChain(cfg, rate, num_codewords, window_samples, min_sum_factor,
                                 device)
        self.copies = copies

    def _decode(self, llrs: torch.Tensor):
        factors = torch.full((llrs.shape[0],), self.chain.min_sum_factor,
                             dtype=torch.float32, device=llrs.device)
        return self.chain.decoder(llrs, factors)

    def forward(self, audio: torch.Tensor) -> dict[str, torch.Tensor]:
        c = self.chain
        B, R, window = audio.shape
        if R != self.copies:
            raise ValueError(f"audio holds {R} copies a channel, the round {self.copies}")
        x = audio.reshape(B * R, window)
        sync = c.sync(x)
        start = torch.clamp(sync.start + c.cfg.chirp.total_samples, 0,
                            max(c.window_samples - c.frame_need, 0))
        demod = c.demod(window_slice(x.float(), start, c.frame_need), sync.cfo_hz)
        ncw = c.num_codewords
        soft = demod.soft_bits[..., : c.num_bits].reshape(B, R, ncw, LDPC_BITS)
        received = sync.detected.reshape(B, R).cpu().tolist()

        # decodes[b][r]: copy r of channel b alone; sums[b][r]: its sum up to r, or None
        alone = _rows(self._decode(soft.reshape(-1, LDPC_BITS).contiguous()), B * R * ncw)
        decodes = [[alone[(b * R + r) * ncw: (b * R + r + 1) * ncw] for r in range(R)]
                   for b in range(B)]
        sums: list[list] = [[None] * R for _ in range(B)]
        acc: list = [None] * B
        held = [0] * B
        for r in range(R):
            rows, tried = [], []
            for b in range(B):
                if received[b][r]:
                    acc[b] = soft[b, r].clone() if acc[b] is None else acc[b] + soft[b, r]
                    held[b] += 1
                use = r > 0 and received[b][r] and held[b] >= 2
                tried.append(use)
                rows.append(acc[b] if use else torch.zeros_like(soft[b, r]))
            if r > 0:
                dec = _rows(self._decode(torch.stack(rows).reshape(-1, LDPC_BITS)), B * ncw)
                for b in range(B):
                    if tried[b]:
                        sums[b][r] = dec[b * ncw: (b + 1) * ncw]

        success, bits, iters, source = [], [], [], []
        for b in range(B):
            for i in range(ncw):
                steps = []
                for r in range(R):
                    if received[b][r]:
                        steps.append((max(2 * r - 1, 0), decodes[b][r][i]))
                    if sums[b][r] is not None:
                        steps.append((2 * r, sums[b][r][i]))
                pick = (-1, (False,) + decodes[b][0][i][1:])
                for pos, d in steps:
                    pick = (pos if d[0] else -1, d)
                    if d[0]:
                        break
                success.append(pick[1][0])
                bits.append(pick[1][1])
                iters.append(pick[1][2])
                source.append(pick[0])
        dev = audio.device
        return {
            "detected": sync.detected.reshape(B, R),
            "start": sync.start.reshape(B, R),
            "cfo_hz": sync.cfo_hz.reshape(B, R),
            "snr_db": demod.snr_estimate_db.reshape(B, R),
            "cw_success": torch.tensor(success, device=dev).reshape(B, ncw),
            "info_bits": torch.stack(bits).to(dev).reshape(B, ncw, -1),
            "iterations": torch.tensor(iters, dtype=torch.int32, device=dev).reshape(B, ncw),
            "source": torch.tensor(source, dtype=torch.int8, device=dev).reshape(B, ncw),
        }


def _rows(dec, n: int) -> list[tuple]:
    """A decode's rows on the host: (success, info bits, iterations) each."""
    ok = dec.success.cpu().tolist()
    its = dec.iterations.cpu().tolist()
    bits = dec.info_bits.cpu()
    return [(ok[j], bits[j], its[j]) for j in range(n)]
