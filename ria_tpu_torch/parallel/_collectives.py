"""The collectives that ``ria_tpu.parallel`` runs inside ``shard_map``, on
``torch.distributed`` over one axis of a :class:`~.distributed.Mesh`.

- :func:`from_right` / :func:`from_left`: ``jax.lax.ppermute`` by one rank
  along an axis; the rank that receives nothing gets zeros, as in JAX;
- :func:`all_gather` and :func:`gather_fields`: ``jax.lax.all_gather`` of
  small tensors (bools carried as uint8; several fields of any dtype packed
  into one byte buffer, so a result costs one collective);
- :func:`psum`: ``jax.lax.psum`` of complex64, as a sum of its float32
  real and imaginary parts.

Each has one transport per backend, chosen here and nowhere else.  NCCL
takes the device's tensors (point to point through ``batch_isend_irecv``).
gloo takes CUDA tensors for ``all_gather`` and ``all_reduce`` (it copies
them through the host itself), but its point to point writes from the
tensor's address as if it were host memory: on an H100 with torch 2.11 a
CUDA ``isend`` aborted the rank (``writev ... Bad address``;
``python -m ria_tpu_torch.tools.parallel_paths --probe-gloo``).  So under
gloo the halo exchange copies CUDA tensors to the host and back here.  A
mesh of one rank along the axis moves nothing.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ria_tpu_torch.parallel.distributed import Mesh


def _shift(x: torch.Tensor, mesh: Mesh, axis: str, step: int) -> torch.Tensor:
    """Rank i of the axis receives rank (i - step)'s ``x``; the edge rank
    that has no such peer receives zeros."""
    n, i = mesh.size(axis), mesh.index(axis)
    if n == 1:
        return torch.zeros_like(x)
    send = x.contiguous()
    if mesh.backend == "gloo":  # gloo's point to point reads host memory only
        send = send.cpu()
    recv = torch.zeros_like(send)
    ops = []
    if 0 <= i + step < n:
        ops.append(dist.P2POp(dist.isend, send, mesh.peer(axis, i + step)))
    if 0 <= i - step < n:
        ops.append(dist.P2POp(dist.irecv, recv, mesh.peer(axis, i - step)))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv.to(x.device)


def from_right(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Rank i gets rank i+1's ``x`` (the last rank zeros): the halo that
    extends a block past its right edge."""
    return _shift(x, mesh, axis, -1)


def from_left(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Rank i gets rank i-1's ``x`` (the first rank zeros): the tail that
    an overlap-save filter prepends."""
    return _shift(x, mesh, axis, 1)


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str | None = None) -> torch.Tensor:
    """[n, *x.shape]: every rank's ``x`` along ``axis`` (all ranks for
    None), in coordinate order, on every rank."""
    group = mesh.group(axis)
    if group is None:
        return x[None]
    flag = x.dtype == torch.bool
    send = (x.to(torch.uint8) if flag else x).contiguous()
    parts = [torch.empty_like(send) for _ in range(mesh.size(axis))]
    dist.all_gather(parts, send, group=group)
    out = torch.stack(parts)
    return out.bool() if flag else out


def gather_fields(fields, mesh: Mesh, axis: str | None = None) -> list[torch.Tensor]:
    """:func:`all_gather` of several tensors at once: their bytes packed
    into one uint8 buffer, gathered, and unpacked to [n, *shape] of each
    field's dtype.  Every rank passes fields of the same shapes and dtypes."""
    flat = [f.contiguous().reshape(-1) for f in fields]
    raw = [(f.to(torch.uint8) if f.dtype == torch.bool else f).view(torch.uint8)
           for f in flat]
    got = all_gather(torch.cat(raw), mesh, axis)
    out, at = [], 0
    for f, r in zip(fields, raw):
        # A copy of its own (offset 0), so that view() may reinterpret it.
        part = got[:, at : at + r.numel()].reshape(-1).clone()
        at += r.numel()
        if f.dtype == torch.bool:
            part = part != 0
        else:
            part = part.view(f.dtype)
        out.append(part.reshape((got.shape[0],) + tuple(f.shape)))
    return out


def psum(x: torch.Tensor, mesh: Mesh, axis: str | None = None) -> torch.Tensor:
    """The sum of every rank's complex64 ``x`` along ``axis``, on every
    rank.  Where each element is written by one rank and zero on the others
    (the stream RX's slabs), the sum is exact in any order."""
    group = mesh.group(axis)
    if group is None:
        return x
    buf = torch.view_as_real(x.contiguous()).clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return torch.view_as_complex(buf)
