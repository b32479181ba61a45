"""Device selection for the port: explicit, and never silently on the CPU."""

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


def full_fp32_matmul() -> None:
    """Keep float32 and complex64 matmuls (mixer banks, tone banks, chirp
    refinement, TX synthesis) in full precision on the card: TF32 keeps ~3
    decimal digits and would cost the soft bits their parity with the
    reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
