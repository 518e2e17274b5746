"""Where the port runs: ``None`` means the card.

Every public entry point (``Dataset``, ``Engine``, ``PlanExecutor``,
``DistributedExecutor``, ``ExecutionContext``) resolves its ``device``
argument here, so a caller who names no device gets ``"cuda"`` and an
error on a machine without one, never a silent run on the CPU.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means ``"cuda"``, which
    raises when no CUDA device is present — the port never carries on
    silently on the CPU.  Pass ``device="cpu"`` to run there."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev
