"""Batched LDPC encode / normalized min-sum decode in PyTorch.

Port of ``ria_tpu/fec/ldpc.py``: encoder, per-row-factor decoder,
fixed-factor decoder, and the serving layer (``decode_batch``,
``make_tile_decoder``, ``decode_chunked``, the retry ladder, the CRC-aided
candidate probes and ``LDPCCodec``).  Three decoders compute the same thing:

- the plain PyTorch decoder (:meth:`LDPCDecoder.plain`, returned by
  :func:`make_decoder_vf`) mirrors the JAX reference: messages in a dense
  ``[B, m, D]`` tensor, the gather an f32 matmul with the one-hot edge
  matrix ``code.gather``, and one global loop over iterations with a
  per-codeword freeze; each variable sums its messages in ascending edge
  order, as K1 does, so the two agree bit for bit (the reference scatters
  through a matmul, whose order of summation is the library's);
- kernel K1 (``csrc/ldpc_bp.cu``, bound in :mod:`ria_tpu_torch.fec.ldpc_kernel`)
  runs the whole loop per codeword in shared memory;
- :meth:`LDPCDecoder.plain_v1` is the plain PyTorch version of kernel K2
  (``csrc/ldpc_bp_v1.cu``, reached through :mod:`ria_tpu_torch.fec.ldpc_cuda`):
  the same BP in the per-degree-slot form of the TPU kernel
  ``make_pallas_decoder_v1``.  Only the tests and ``chip_smoke.py`` call it.

:class:`LDPCDecoder` launches K1 for a CUDA tensor and uses the plain decoder
only for a CPU tensor; there is no fallback from one to the other.  Every
entry point here runs on the card unless it is given ``device="cpu"``;
without a card, the default raises instead of running on the host.

Numeric contract (as the reference): normalized min-sum with a per-row
factor, message clamp +/-50, hard-decision parity check after every
iteration with a per-codeword freeze, positive LLR => bit 0.

``precision`` (the reference's argument): ``"f32"``, the default, keeps
everything float32; ``"bf16"`` rounds the operands of the reference's
gather and scatter matmuls to bfloat16 (round to nearest even) and sums in
float32, which is also what the TPU kernel ``make_pallas_decoder`` computes.
K1 has a build of each (``ldpc_kernel.bp_decode``'s ``precision``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ria_tpu_torch.fec import ldpc_kernel
from ria_tpu_torch.fec.ldpc_matrix import (
    LLR_CLAMP,
    MIN_SUM_FACTOR,
    RECOMMENDED_ITERS,
    LDPCCode,
    encode_np,
    get_code,
)
from ria_tpu_torch.utils.bits import bits_to_bytes, bytes_to_bits
from ria_tpu_torch.utils.device import resolve_device


PRECISIONS = ("f32", "bf16")


def _check_precision(precision: str) -> str:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    return precision


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16 (nearest even, as ``astype(jnp.bfloat16)``)
    and back to float32."""
    return x.to(torch.bfloat16).float()


class DecodeResult(NamedTuple):
    info_bits: torch.Tensor   # [B, k] uint8
    success: torch.Tensor     # [B] bool
    iterations: torch.Tensor  # [B] int32
    llr_total: torch.Tensor   # [B, n] float32 (posterior LLRs)


class LDPCDecoder(nn.Module):
    """Batched decoder for one code: (llrs [B, n], factors [B]) -> DecodeResult.

    The code's tables are buffers, built once here: ``gather`` (one-hot
    [m*D, n], plain decoders), ``row_idx``/``row_mask`` ([m, D]), K1's
    ``k1_row``/``k1_epos``/``k1_jobs`` (:func:`ldpc_kernel.k1_layout`,
    checked once into ``self.k1``) and K2's ``k2_row``/``k2_epos``/``k2_jobs``
    (:func:`ldpc_kernel.k2_layout`, checked once into ``self.k2``).
    ``precision`` picks the plain decoder's rounding and K1's build; K2 and
    :meth:`plain_v1` are float32 only.
    """

    def __init__(self, code: LDPCCode, max_iters: int | None = None,
                 device: str | torch.device = "cuda", precision: str = "f32"):
        super().__init__()
        dev = resolve_device(device)
        self.precision = _check_precision(precision)
        self.k, self.m, self.n, self.D = code.k, code.m, code.n, code.max_degree
        self.max_iters = RECOMMENDED_ITERS[code.rate] if max_iters is None else max_iters
        self.register_buffer("gather", torch.as_tensor(code.gather, device=dev))
        self.register_buffer("row_idx", torch.as_tensor(code.row_idx, device=dev))
        self.register_buffer("row_mask", torch.as_tensor(code.row_mask, device=dev))
        self.register_buffer("var_edges", torch.as_tensor(
            _var_edges(code.row_idx, code.row_mask, code.n), device=dev))
        layout = ldpc_kernel.k1_layout(code.row_idx, code.row_mask, code.n)
        self.register_buffer("k1_row", torch.as_tensor(layout.row, device=dev))
        self.register_buffer("k1_epos", torch.as_tensor(layout.epos, device=dev))
        self.register_buffer("k1_jobs", torch.as_tensor(layout.jobs, device=dev))
        self.k1 = ldpc_kernel.k1_tables(layout, self.k1_row, self.k1_epos, self.k1_jobs,
                                        code.n)
        layout2 = ldpc_kernel.k2_layout(code.row_idx, code.row_mask, code.n)
        self.register_buffer("k2_row", torch.as_tensor(layout2.row, device=dev))
        self.register_buffer("k2_epos", torch.as_tensor(layout2.epos, device=dev))
        self.register_buffer("k2_jobs", torch.as_tensor(layout2.jobs, device=dev))
        self.k2 = ldpc_kernel.k2_tables(layout2, self.k2_row, self.k2_epos, self.k2_jobs,
                                        code.n)

    def forward(self, llrs: torch.Tensor, factors: torch.Tensor) -> DecodeResult:
        if llrs.device.type == "cuda":
            return DecodeResult(*ldpc_kernel.bp_decode(
                llrs.float().contiguous(), factors.float().contiguous(), self.k1,
                self.k, self.max_iters, self.precision))
        if llrs.device.type == "cpu":
            return self.plain(llrs, factors)
        raise ValueError(f"unsupported device {llrs.device}")

    def _check_update(self, v2c: torch.Tensor, factors: torch.Tensor) -> torch.Tensor:
        """Per-check two-min + sign-product, excluding self (min-sum)."""
        mask = self.row_mask
        sgn = torch.where(v2c < 0, -1.0, 1.0)
        sgn = torch.where(mask, sgn, 1.0)
        sign_prod = torch.prod(sgn, dim=-1, keepdim=True)
        absv = torch.where(mask, torch.abs(v2c), torch.inf)
        is_min = nn.functional.one_hot(torch.argmin(absv, dim=-1), self.D).bool()
        min1 = torch.amin(absv, dim=-1, keepdim=True)
        min2 = torch.amin(torch.where(is_min, torch.inf, absv), dim=-1, keepdim=True)
        excl_min = torch.where(is_min, min2, min1)
        c2v = sign_prod * sgn * excl_min * factors[:, None, None]
        return torch.where(mask, c2v, 0.0)

    def _variable_sum(self, c2v: torch.Tensor) -> torch.Tensor:
        """[B, n]: each variable's check messages summed in ascending edge
        order from 0.0, K1's order.  A float32 sum's rounding depends on its
        order, and near the decoding threshold BP doubles a difference about
        every three iterations, so another order can change a row's outcome
        after 50 or more."""
        B = c2v.shape[0]
        flat = torch.cat([c2v.reshape(B, -1), c2v.new_zeros(B, 1)], dim=1)
        msgs = flat[:, self.var_edges]  # [B, n, max degree], zeros past a degree
        s = torch.zeros_like(msgs[:, :, 0])
        for j in range(msgs.shape[-1]):
            s = s + msgs[:, :, j]
        return s

    def plain(self, llrs: torch.Tensor, factors: torch.Tensor) -> DecodeResult:
        """The plain PyTorch decoder (``make_decoder_vf`` of the reference),
        bit-identical to K1's build of the same precision.

        With ``"bf16"`` three operands are rounded to bfloat16 where the
        reference's matmuls take them: the channel LLRs at the first gather,
        the posteriors at each gather, and each check message before the
        variable sum.  The sums, ``edge - c2v`` (the rounded gather less the
        float32 message), the clamp and the factor stay float32.  The parity
        check reads the float32 posteriors' signs, as the reference's bf16
        mode does; the TPU kernel reads the rounded gather's, which differs
        only for |LLR| below bfloat16's smallest subnormal (2**-133)."""
        B = llrs.shape[0]
        m, D, g = self.m, self.D, self.gather
        bf16 = self.precision == "bf16"
        rnd = _bf16 if bf16 else (lambda x: x)
        llr_in = llrs.float()
        factors = factors.float()
        v2c = (rnd(llr_in) @ g.T).reshape(B, m, D)
        llr_total = llr_in
        done = torch.zeros(B, dtype=torch.bool, device=llrs.device)
        iters = torch.zeros(B, dtype=torch.int32, device=llrs.device)
        it = 0
        while it < self.max_iters and not bool(done.all()):
            c2v = self._check_update(v2c, factors)
            llr_new = llr_in + self._variable_sum(rnd(c2v))
            # One gather serves both the next v2c and the parity check.
            edge = (rnd(llr_new) @ g.T).reshape(B, m, D)
            v2c_new = torch.clamp(edge - c2v, -LLR_CLAMP, LLR_CLAMP)
            hard = (llr_new[:, self.row_idx] < 0) if bf16 else (edge < 0)
            edge_bits = torch.where(self.row_mask, hard.float(), 0.0)
            ok = torch.all(torch.sum(edge_bits, dim=-1) % 2.0 == 0.0, dim=-1)
            upd = ~done
            llr_total = torch.where(upd[:, None], llr_new, llr_total)
            v2c = torch.where(upd[:, None, None], v2c_new, v2c)
            iters = iters + upd.int()
            done = done | ok
            it += 1
        info_bits = (llr_total[:, : self.k] < 0).to(torch.uint8)
        return DecodeResult(info_bits, done, iters, llr_total)

    @staticmethod
    def _check_update_v1(v2c: torch.Tensor, mask: torch.Tensor,
                         factors: torch.Tensor) -> torch.Tensor:
        """K2's two-pass check update on slot-major messages [B, D, m].

        Pass 1: min1 and the sign parity over the D slots.  Pass 2: ``ties``,
        the number of slots equal to min1, and min2 over the slots not equal
        to min1.  A slot equal to min1 gets min1 when ties > 1, else min2;
        every other slot gets min1.  ``mask [D, m]`` marks the real edges.
        """
        absv = torch.where(mask, torch.abs(v2c), torch.inf)
        neg = mask & (v2c < 0)
        sign_prod = 1.0 - 2.0 * (neg.sum(dim=1, keepdim=True) % 2).float()
        min1 = torch.amin(absv, dim=1, keepdim=True)
        is_min = absv == min1
        ties = is_min.sum(dim=1, keepdim=True)
        min2 = torch.amin(torch.where(is_min, torch.inf, absv), dim=1, keepdim=True)
        excl = torch.where(is_min, torch.where(ties > 1, min1, min2), min1)
        sgn = torch.where(neg, -1.0, 1.0)
        c2v = sign_prod * sgn * excl * factors[:, None, None]
        return torch.where(mask, c2v, 0.0)

    def plain_v1(self, llrs: torch.Tensor, factors: torch.Tensor) -> DecodeResult:
        """The plain PyTorch version of K2: the BP of :meth:`plain` in the
        TPU kernel ``make_pallas_decoder_v1``'s own form, in f32.

        Messages are slot-major ``[B, D, m]``; the check update is the
        two-pass tie-count form (:meth:`_check_update_v1`); the posterior is
        ``llr_in + sum_d scatter_d(c2v[:, d])`` with slot 0 first, each
        ``scatter_d`` a product with slot d's one-hot ``[m, n]``.  Same loop,
        freeze and early exit as :meth:`plain`.
        """
        B = llrs.shape[0]
        m, D, n = self.m, self.D, self.n
        idx, mask = self.row_idx.T, self.row_mask.T            # [D, m]
        slots = self.gather.view(m, D, n)                      # slot d: [:, d] is [m, n]
        llr_in = llrs.float()
        factors = factors.float()

        def gather(x):                                         # [B, n] -> [B, D, m]
            return torch.where(mask, x[:, idx], 0.0)

        v2c = gather(llr_in)
        llr_total = llr_in
        done = torch.zeros(B, dtype=torch.bool, device=llrs.device)
        iters = torch.zeros(B, dtype=torch.int32, device=llrs.device)
        it = 0
        while it < self.max_iters and not bool(done.all()):
            c2v = self._check_update_v1(v2c, mask, factors)
            acc = c2v[:, 0] @ slots[:, 0]
            for d in range(1, D):
                acc = acc + c2v[:, d] @ slots[:, d]
            llr_new = llr_in + acc
            g = gather(llr_new)
            v2c_new = torch.clamp(g - c2v, -LLR_CLAMP, LLR_CLAMP)
            ok = torch.all((mask & (g < 0)).sum(dim=1) % 2 == 0, dim=-1)
            upd = ~done
            llr_total = torch.where(upd[:, None], llr_new, llr_total)
            v2c = torch.where(upd[:, None, None], v2c_new, v2c)
            iters = iters + upd.int()
            done = done | ok
            it += 1
        info_bits = (llr_total[:, : self.k] < 0).to(torch.uint8)
        return DecodeResult(info_bits, done, iters, llr_total)


def _var_edges(row_idx: np.ndarray, row_mask: np.ndarray, n: int) -> np.ndarray:
    """[n, max degree] int64: each variable's edges ``e = check * D + d`` in
    ascending order, padded with ``m * D`` (a message slot held at 0)."""
    m, D = np.asarray(row_idx).shape
    col_ptr, col_edge = ldpc_kernel.csc_tables(row_idx, row_mask, n)
    deg = np.diff(col_ptr)
    out = np.full((n, max(int(deg.max(initial=0)), 1)), m * D, np.int64)
    for v in range(n):
        out[v, : deg[v]] = col_edge[col_ptr[v] : col_ptr[v + 1]]
    return out


@functools.lru_cache(maxsize=None)
def ldpc_decoder(rate: str, max_iters: int | None = None,
                 device: str | torch.device = "cuda", precision: str = "f32") -> LDPCDecoder:
    """Cached :class:`LDPCDecoder` for a rate and precision on a device."""
    return LDPCDecoder(get_code(rate), max_iters, device, precision)


def make_decoder_vf(rate: str, max_iters: int | None = None, precision: str = "f32",
                    device: str | torch.device = "cuda"):
    """The plain PyTorch decoder with per-row factors:
    (llrs [B, 648], factors [B]) -> DecodeResult, on any device, in
    ``precision`` (``"f32"`` or ``"bf16"``, the reference's argument).  The
    yardstick K1 is held against; nothing on the main path calls it when a
    card is present."""
    return ldpc_decoder(rate, max_iters, device, precision).plain


def make_decoder(rate: str, max_iters: int | None = None,
                 min_sum_factor: float = MIN_SUM_FACTOR, precision: str = "f32",
                 device: str | torch.device = "cuda"):
    """Fixed-factor decoder llrs [B, 648] -> DecodeResult: K1's build of
    ``precision`` for CUDA tensors, the plain decoder for CPU tensors."""
    dec = ldpc_decoder(rate, max_iters, device, precision)

    def decode(llrs: torch.Tensor) -> DecodeResult:
        factors = torch.full((llrs.shape[0],), min_sum_factor, dtype=torch.float32,
                             device=llrs.device)
        return dec(llrs, factors)

    return decode


def _on_device(x, device: str | torch.device | None) -> torch.Tensor:
    """``x`` as an f32 tensor: a tensor keeps its device (and raises if
    ``device`` names another), anything else goes to ``device`` (default
    the card; without one that raises).  Work never moves between devices
    on its own."""
    if isinstance(x, torch.Tensor):
        want = None if device is None else resolve_device(device)
        if want is not None and (x.device.type != want.type or
                                 want.index not in (None, x.device.index)):
            raise ValueError(f"tensor on {x.device}, but device={device} was asked for")
        return x.float()
    return torch.as_tensor(np.asarray(x, np.float32),
                           device=resolve_device("cuda" if device is None else device))


def decode_batch(llrs, factors, rate: str, max_iters: int | None = None,
                 device: str | torch.device | None = None) -> DecodeResult:
    """Serving-path decode with per-row min-sum factors.

    K1 for CUDA (no padding: the kernel exits per codeword), the plain
    decoder for the CPU -- the port of the backend gate of
    ``ria_tpu.fec.ldpc.decode_batch``.  A tensor keeps its device; a numpy
    array goes to ``device`` (default ``cuda``; pass ``device="cpu"`` for
    the plain decoder on the host).
    """
    llrs = _on_device(llrs, device)
    factors = torch.as_tensor(factors, dtype=torch.float32, device=llrs.device)
    return ldpc_decoder(rate, max_iters, llrs.device)(llrs, factors)


def make_tile_decoder(rate: str, max_iters: int | None = None,
                      min_sum_factor: float = MIN_SUM_FACTOR,
                      device: str | torch.device = "cuda"):
    """(decoder_fn, pad_to) for the sharded/replicated RX paths: K1 on CUDA,
    the plain decoder on the CPU.  ``pad_to`` is always None: K1 exits per
    codeword and needs no tile padding, so the reference's
    ``pallas_interpret`` option has no counterpart."""
    return make_decoder(rate, max_iters, min_sum_factor, device=device), None


def make_encoder(rate: str, device: str | torch.device = "cuda"):
    """Batched systematic encoder: info_bits [B, k] -> codeword [B, 648] uint8."""
    h_data_t = torch.as_tensor(np.ascontiguousarray(get_code(rate).h_data.T),
                               device=resolve_device(device))

    def encode(info_bits: torch.Tensor) -> torch.Tensor:
        info_f = info_bits.float()
        parity = (info_f @ h_data_t) % 2.0
        return torch.cat([info_f, parity], dim=-1).to(torch.uint8)

    return encode


def decode_chunked(llrs, rate: str, chunk: int = 512, max_iters: int | None = None,
                   min_sum_factor: float = MIN_SUM_FACTOR,
                   device: str | torch.device | None = None) -> DecodeResult:
    """Decode a large batch in fixed-size chunks of zero-padded rows, as
    ``ria_tpu.fec.ldpc.decode_chunked`` does.  The plain decoder's loop exits
    only when every row of a call converged, so chunking bounds a
    straggler's reach; K1 exits per codeword anyway.  Device rule as
    :func:`decode_batch`."""
    llrs = _on_device(llrs, device)
    dec = make_decoder(rate, max_iters, min_sum_factor, device=llrs.device)
    B = llrs.shape[0]
    if B <= chunk:
        return dec(llrs)
    pad = torch.zeros(((-B) % chunk, llrs.shape[1]), device=llrs.device)
    outs = [dec(x) for x in torch.cat([llrs, pad]).split(chunk)]
    return DecodeResult(*(torch.cat(parts)[:B] for parts in zip(*outs)))


def decode_with_retries(llrs, rate: str, max_iters: int | None = None,
                        base_factor: float = 0.9375,
                        device: str | torch.device = "cuda") -> DecodeResult:
    """Decode with the fixed-frame retry ladder in at most 2 decode dispatches.

    Port of ``ria_tpu.fec.ldpc.decode_with_retries``: the primary batch at
    ``base_factor``, then, for the codewords that failed, the whole ladder
    (clean factor diversity first, then every perturbed/clipped/scaled
    variant at every retry factor) as ONE stacked batch with per-row
    factors; row order encodes the retry priority and the first successful
    row per codeword wins.  The perturbations are drawn on the host with
    numpy from the reference's seed and in its order, so the stacked rows
    equal the reference's bit for bit.  ``llrs`` is a host array; the
    result lies on ``device``.  On CUDA that is at most two K1 launches, and
    the only reads back to the host are the two ``success`` vectors.
    """
    llrs = np.asarray(llrs, np.float32)
    dev = resolve_device(device)
    B = llrs.shape[0]
    result = decode_batch(llrs, np.full(B, base_factor, np.float32), rate, max_iters, dev)
    success = result.success.cpu().numpy()
    if success.all():
        return result

    fidx = np.flatnonzero(~success)
    base = llrs[fidx]
    F = base.shape[0]

    rng = np.random.default_rng(0x5EED)
    rows: list[np.ndarray] = []
    facs: list[float] = []
    # Phase 0: factor diversity on unmodified LLRs (highest priority).
    for factor in (0.875, 0.75, 0.625, 0.5):
        rows.append(base)
        facs.append(factor)
    # Phases 1-4 condensed: perturbation ladder x factor diversity.
    variants = ([("raw", s) for s in (0.3, 0.7, 1.0, 1.5, 2.5)]
                + [("clip10", s) for s in (0.3, 1.5, 4.0)]
                + [("scale", s) for s in (0.5, 3.0)])
    for factor in (0.75, 0.625, 0.875):
        for kind, sigma in variants:
            v = base.copy()
            if kind == "clip10":
                v = np.clip(v, -10, 10)
            elif kind == "scale":
                v = v * 0.5
            v = v + rng.normal(0, sigma, v.shape).astype(np.float32)
            rows.append(v)
            facs.append(factor)

    V = len(rows)
    stacked = np.concatenate(rows, axis=0)                       # [V*F, n]
    factors = np.repeat(np.asarray(facs, np.float32), F)
    r = decode_batch(stacked, factors, rate, max_iters, dev)
    s = r.success.cpu().numpy().reshape(V, F)
    won = np.flatnonzero(s.any(axis=0))
    first = np.argmax(s, axis=0)                                 # priority order
    # Copy each rescued codeword's winning row in place, on the device.
    src = torch.as_tensor(first[won] * F + won, device=dev)
    dst = torch.as_tensor(fidx[won], device=dev)
    out = [t.clone() for t in result]
    for t, new in zip(out, r):
        t[dst] = new[src]
    return DecodeResult(*out)


def candidate_plan(num_failed: int) -> list[tuple[str, float]]:
    """(variant kind, min-sum factor) rows per codeword for
    :func:`decode_candidates`, scaled by how many codewords failed the
    primary decode (copied from ``ria_tpu.fec.ldpc.candidate_plan``).
    Factor diversity concentrates on the unmodified LLRs; perturbation
    probes carry one or two factors each."""
    ladder = (0.9375, 0.875, 0.75, 0.625, 0.5)
    plan = [("base", f) for f in ladder]
    plan += [("clip", 0.9375), ("half", 0.9375)]
    for k in (16, 32, 64):
        plan += [(f"erase{k}", 0.9375), (f"erase{k}", 0.75)]
    n_noise = 4 * max(1, min(num_failed, 4))
    sigmas = (0.3, 0.7, 1.2, 2.0)
    for j in range(n_noise):
        plan.append((f"noise{j}:{sigmas[j % 4]}", 0.9375))
    return plan


def decode_candidates(llrs, rate: str, max_iters: int | None = None,
                      max_per_cw: int = 4, num_failed: int = 4,
                      device: str | torch.device = "cuda"):
    """CRC-aided list decoding support: distinct candidate codewords per CW.

    Port of ``ria_tpu.fec.ldpc.decode_candidates``: one batched decode of
    perturbed/scaled LLR variants per codeword (per-row min-sum factors,
    :func:`candidate_plan`), returning for each codeword up to
    ``max_per_cw`` DISTINCT successful codewords as ``(metric, info_bits)``
    sorted by descending correlation ``sum(llr * (1 - 2 * coded))``.  The
    probes are drawn on the host with numpy from the reference's seed and in
    its order; the decode runs on ``device``; the re-encode and the metric
    are host numpy, as in the reference.
    """
    llrs = np.asarray(llrs, np.float32)
    B = llrs.shape[0]
    rng = np.random.default_rng(0xC0DE)
    order = np.argsort(np.abs(llrs), axis=1)
    plan = candidate_plan(num_failed)
    rows = np.empty((len(plan), B, llrs.shape[1]), np.float32)
    factors = np.empty(len(plan) * B, np.float32)
    for i, (kind, f) in enumerate(plan):
        if kind == "base":
            v = llrs
        elif kind == "clip":
            v = np.clip(llrs, -10, 10)
        elif kind == "half":
            v = llrs * 0.5
        elif kind.startswith("erase"):
            k = int(kind[5:])
            v = llrs.copy()
            # Zero the k least-reliable bits so BP resolves them from
            # parity alone -- deterministic probes of the ambiguity region.
            v[np.repeat(np.arange(B), k), order[:, :k].reshape(-1)] = 0.0
        else:  # noise probe
            sigma = float(kind.split(":")[1])
            v = llrs + rng.normal(0, sigma, llrs.shape).astype(np.float32)
        rows[i] = v
        factors[i * B : (i + 1) * B] = f
    full = rows.reshape(len(plan) * B, llrs.shape[1])
    cands: list[dict] = [dict() for _ in range(B)]
    r = decode_batch(full, factors, rate, max_iters, device)
    s = r.success.cpu().numpy()
    if s.any():
        info = r.info_bits[torch.as_tensor(s, device=r.success.device)].cpu().numpy()
        coded = encode_np(info, rate).astype(np.int32)
        for row, inf, cd in zip(np.flatnonzero(s), info, coded):
            b = row % B
            key = cd.tobytes()
            if key not in cands[b]:
                m = float(np.sum(llrs[b] * (1 - 2 * cd)))
                cands[b][key] = (m, inf)
    return [sorted(c.values(), key=lambda t: -t[0])[:max_per_cw] for c in cands]


class LDPCCodec:
    """Host-facing codec with the reference's multi-block byte semantics.

    Port of ``ria_tpu.fec.ldpc.LDPCCodec``: input bits are consumed k at a
    time (zero-padded at the tail), each block emits n coded bits, and
    decoded info bits are concatenated before the single final byte-pack,
    so a non-byte-aligned k (R3/4, k = 486) stays bit-exact across blocks.
    Encoding and decoding run on ``device`` (K1 on CUDA); bytes and LLRs
    come and go as host values.
    """

    def __init__(self, rate: str, max_iters: int | None = None,
                 device: str | torch.device = "cuda"):
        self.rate = rate
        self.code = get_code(rate)
        self.max_iters = max_iters or RECOMMENDED_ITERS[rate]
        self.device = resolve_device(device)
        self._encode = make_encoder(rate, self.device)
        self._decode = make_decoder(rate, self.max_iters, device=self.device)
        self.last_success = False
        self.last_iters = 0

    @property
    def k(self) -> int:
        return self.code.k

    @property
    def n(self) -> int:
        return self.code.n

    def coded_size(self, input_size: int) -> int:
        blocks = -(-(input_size * 8) // self.k)
        return -(-(blocks * self.n) // 8)

    def encode(self, data: bytes) -> bytes:
        bits = bytes_to_bits(data)
        blocks = -(-len(bits) // self.k)
        padded = np.zeros(blocks * self.k, dtype=np.uint8)
        padded[: len(bits)] = bits
        coded = self._encode(torch.as_tensor(padded.reshape(blocks, self.k),
                                             device=self.device))
        return bits_to_bytes(coded.cpu().numpy().reshape(-1))

    def decode_soft(self, llrs) -> tuple[bool, bytes]:
        """LLRs (positive => bit 0) -> (all_blocks_ok, decoded bytes)."""
        llrs = np.asarray(llrs, dtype=np.float32).reshape(-1)
        if llrs.size == 0:
            self.last_success = False
            return False, b""
        blocks = -(-llrs.size // self.n)
        padded = np.zeros(blocks * self.n, dtype=np.float32)
        padded[: llrs.size] = llrs
        result = self._decode(torch.as_tensor(padded.reshape(blocks, self.n),
                                              device=self.device))
        ok = bool(result.success.all())
        self.last_success = ok
        self.last_iters = int(result.iterations.max())
        return ok, bits_to_bytes(result.info_bits.cpu().numpy().reshape(-1))

    def decode_hard(self, coded: bytes) -> tuple[bool, bytes]:
        bits = bytes_to_bits(coded).astype(np.float32)
        return self.decode_soft(np.where(bits > 0.5, -6.0, 6.0))
