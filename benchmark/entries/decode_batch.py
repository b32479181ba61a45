"""The serving decode, called as a gateway's retry path calls it:
``ria_tpu_torch.fec.ldpc.decode_batch(llrs, factors, rate)`` on channel
LLRs [codewords, 648] with one min-sum factor a row (K1's float32 build).

Outputs handed to the host: ``cw_success``, ``info_bits``, ``iterations``
and the posteriors ``llr_total`` per codeword.

The check compares them with the frozen plain min-sum decoder in K1's
summation order (``reference/ldpc_plain.py``) on the same LLRs, and with
what was sent:

- ``cw_mismatch``: codewords whose success, info bits or iteration count
  differ;
- ``posterior_gap``: the widest gap of a posterior LLR.

What was sent is not compared: the R1/4 code holds codewords 13 bits
apart, so at -1 dB some 3% of the codewords that BP reports decoded are
not the sent ones, in the reference as in the program.
"""

from __future__ import annotations

import torch

from benchmark.reference import ldpc_matrix, ldpc_plain


def _factors(traffic: dict, device: torch.device) -> torch.Tensor:
    return torch.full((traffic["codewords"],), traffic["min_sum_factor"], dtype=torch.float32,
                      device=device)


def _outputs(r) -> dict[str, torch.Tensor]:
    return {"cw_success": r.success, "info_bits": r.info_bits, "iterations": r.iterations,
            "llr_total": r.llr_total}


class Program:
    def __init__(self, cfg: dict, traffic: dict, device: torch.device):
        from ria_tpu_torch.fec.ldpc import decode_batch

        self.decode = decode_batch
        self.rate = cfg["rate"]
        self.factors = _factors(traffic, device)

    def __call__(self, llrs: torch.Tensor) -> dict[str, torch.Tensor]:
        return _outputs(self.decode(llrs, self.factors, self.rate))


def work(cfg: dict, traffic: dict) -> dict:
    code = ldpc_matrix.get_code(cfg["rate"])
    return {"codewords": traffic["codewords"], "n": code.n, "k": code.k, "m": code.m,
            "edges": int(code.row_mask.sum())}


def reference(cfg: dict, traffic: dict, device: torch.device):
    dec = ldpc_plain.PlainDecoder(ldpc_matrix.get_code(cfg["rate"]), cfg["max_iterations"],
                                  device)
    factors = _factors(traffic, device)

    return lambda llrs: _outputs(dec(llrs, factors))


def control(cfg: dict, traffic: dict, device: torch.device, precision: str):
    """The program's own path in bfloat16: K1's bf16-operand build."""
    if precision != "bf16":
        raise ValueError(f"no {precision!r} control for the decoder; bf16")
    from ria_tpu_torch.fec.ldpc import ldpc_decoder

    dec = ldpc_decoder(cfg["rate"], cfg["max_iterations"], device, "bf16")
    factors = _factors(traffic, device)

    return lambda llrs: _outputs(dec(llrs, factors))


def compare(got: list[dict], want: list[dict], sent: list[dict]) -> dict[str, float]:
    cw = 0
    gap = 0.0
    for g, w in zip(got, want):
        differ = ((g["cw_success"] != w["cw_success"])
                  | (g["iterations"] != w["iterations"])
                  | (g["info_bits"] != w["info_bits"]).any(dim=-1))
        cw += int(differ.sum())
        gap = max(gap, float((g["llr_total"] - w["llr_total"]).abs().max()))
    return {"cw_mismatch": cw, "posterior_gap": gap}
