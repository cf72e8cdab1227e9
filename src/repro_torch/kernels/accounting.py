"""What a kernel launch reports to a step counter (``core/damov.py``
``analyze_step``).

A step counter watches PyTorch's ops; it cannot see a kernel that a
wrapper launches through ctypes, and on the CPU it would see the plain
version's ops instead (the full score matrix that the attention kernels
never write). So every kernel entry runs under :func:`launch`: with a
counter active, the entry reports the work its function defines (FLOPs,
bytes read and written) once per launch, and the counter ignores the ops
run inside. Without a counter, :func:`launch` does nothing.

On the ``meta`` device there is nothing to launch: under an active counter
an entry given ``meta`` tensors returns empty outputs of the right shapes
and dtypes (:func:`meta_outputs`), so a full-width model can be counted
without memory; outside a counter it raises as for any device without a
kernel.

The counter is process-wide, not per thread: the autograd engine runs a
CUDA backward on a thread of its own.
"""
from __future__ import annotations

import contextlib
from typing import List, Sequence, Tuple

import torch

# the active counters, innermost last: objects with ``kernel_report(name,
# flops, nbytes)`` and ``paused()`` (core.damov's step counter)
_COUNTERS: List = []


def active():
    """The innermost active counter, or None."""
    return _COUNTERS[-1] if _COUNTERS else None


@contextlib.contextmanager
def counting(counter):
    """Make ``counter`` the active one for the block."""
    _COUNTERS.append(counter)
    try:
        yield counter
    finally:
        _COUNTERS.remove(counter)


def nbytes(*ts: Optional[torch.Tensor]) -> int:
    """Bytes of the tensors' elements (a view: the elements it shows)."""
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


@contextlib.contextmanager
def launch(name: str, flops: float, moved: int):
    """One launch of kernel ``name``: report ``flops`` and ``moved`` bytes
    to the active counter and hide the ops of the block from it."""
    counter = active()
    if counter is None:
        yield
        return
    counter.kernel_report(name, float(flops), float(moved))
    with counter.paused():
        yield


def takes(t: torch.Tensor) -> bool:
    """Whether a kernel entry takes ``t``'s device: the card, or ``meta``
    under an active counter (checked as the card's tensors are, then
    answered by :func:`meta_outputs`)."""
    return t.device.type == "cuda" or (t.device.type == "meta"
                                       and active() is not None)


def meta_outputs(shapes: Sequence[Tuple[Tuple[int, ...], torch.dtype]]
                 ) -> Tuple[torch.Tensor, ...]:
    """Empty ``meta`` tensors of ``shapes`` ((shape, dtype) pairs)."""
    return tuple(torch.empty(s, dtype=dt, device="meta") for s, dt in shapes)
