"""Production meshes and the card's roofline constants.

A mesh here is its shape and axis names, ``(shape, axis_names)``, as
``models/sharding.py`` reads it: single-pod = (16, 16) ("data",
"model") = 256 ranks; multi-pod adds a leading "pod" = 2 axis (512).  The
S2RDF engine's query mesh is one "data" axis over every rank.  These are
the JAX package's shapes; :func:`require_ranks` refuses a mesh larger
than the ranks a run has (one card, or a ``torch.distributed`` world).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

__all__ = ["HW", "make_production_mesh", "make_query_mesh",
           "require_ranks"]

Mesh = Tuple[Tuple[int, ...], Tuple[str, ...]]


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_query_mesh(n_shards: Optional[int] = None, *,
                    multi_pod: bool = False) -> Mesh:
    """1-D mesh for the S2RDF engine: relational plans have no 'model'
    dimension, so queries flatten every rank onto a single 'data' axis."""
    n = n_shards or (512 if multi_pod else 256)
    return (n,), ("data",)


def require_ranks(mesh: Mesh, ranks: int) -> None:
    """Raise unless ``ranks`` ranks can hold ``mesh``."""
    shape, axes = mesh
    need = math.prod(shape)
    if ranks < need:
        raise RuntimeError(
            f"mesh {dict(zip(axes, shape))} needs {need} ranks; this run "
            f"has {ranks} (placing shards across cards is not built yet: "
            f"use --mesh auto)")


class HW:
    """Roofline constants of one NVIDIA H100 80GB HBM3 (SXM) at its 700 W
    power limit: NVIDIA's data-sheet figures (dense rates, no sparsity),
    not measurements.  A card set below 700 W runs slower under load.
    ``NVLINK_BW`` is the divisor of the dry run's collective term (the
    JAX package divides by its TPU's ICI link rate there)."""

    PEAK_FLOPS_BF16 = 989e12      # FLOP/s, dense bf16 tensor cores
    HBM_BW = 3.35e12              # B/s
    HBM_BYTES = 80 * 2**30        # 80 GiB
    NVLINK_BW = 450e9             # B/s a direction, NVLink 4 (900 GB/s both)
