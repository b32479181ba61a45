"""Frozen copy of ``ria_tpu_torch/utils/device.py``, held by the benchmark as its plain
reference; it imports nothing of the port.  Trimmed to ``resolve_device``
and ``wide_cumsum``.

Device selection: explicit, and never silently on the CPU."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for and
    no card is visible, instead of carrying on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but torch.cuda.is_available() is False")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def wide_cumsum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``torch.cumsum`` with the CPU's rounding on every device: the prefixes
    accumulate in double (complex128 for complex input) and each is rounded
    to the input's precision, which is what ``torch.cumsum`` of float32 does
    on the CPU.  The card's float32 scan adds tile totals in another order,
    so its prefixes over a run of zeros are not constant: a sliding energy
    (a difference of prefixes) over the zero-padded tail of a search window
    then reads a few ulps of the window's total instead of 0, passes the
    -60 dB validity floor, and moves the sync detectors' noise floors."""
    wide = torch.complex128 if x.is_complex() else torch.float64
    return torch.cumsum(x.to(wide), dim=dim).to(x.dtype)
