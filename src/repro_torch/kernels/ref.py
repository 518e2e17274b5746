"""Plain PyTorch versions of the port's kernels.

These define the exact semantics the hand-written kernels must match:
the CPU path of every wrapper in :mod:`repro_torch.kernels.ops`, and the
yardstick each kernel is held against on the card.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["join_probe_ref"]


def join_probe_ref(probe: torch.Tensor, build_sorted: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lo, cnt): lower-bound index and match count of each probe key in
    the ascending build column — the two arrays the sort-merge join
    expansion needs.  int32 in, int32 out."""
    lo = torch.searchsorted(build_sorted, probe, out_int32=True)
    hi = torch.searchsorted(build_sorted, probe, right=True, out_int32=True)
    return lo, hi - lo
