"""PyTorch/CUDA port of the ``repro`` serving stack (counterpart: ``src/repro``).

The package imports ``torch`` and ``numpy`` only. Entry points run on the
GPU by default; the CPU is used only when a caller passes ``device="cpu"``
(the parity tests do). Attention goes through hand-written CUDA kernels for
tensors on the card and through their plain PyTorch versions for tensors on
the CPU.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """Resolve ``device`` for an entry point: ``"cuda"`` (the default of every
    entry point) raises when no card is visible instead of quietly running on
    the CPU; ``"cpu"`` must be asked for explicitly."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}: expected cuda or cpu")
    return dev
