"""Carry a model's parameters across from plain arrays.

:func:`params_from_arrays` builds the port's parameter tree from a nested
dict of numpy arrays — the JAX package's parameters written out with
``jax.tree.map(np.asarray, params)``, or any other source of the same
tree — checking every leaf's name and shape against the port's own
``init_params`` for the config.  It is the counterpart, for models, of
:func:`repro_torch.convert.catalog_from_arrays`.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.models.api import Model
from repro_torch.models.config import ArchConfig

__all__ = ["params_from_arrays"]


def _carry(want: Any, got: Any, path: str, device):
    if isinstance(want, dict):
        if not isinstance(got, Mapping):
            raise ValueError(f"{path or 'params'}: expected a dict of "
                             f"{sorted(want)}, got {type(got).__name__}")
        if set(want) != set(got):
            raise ValueError(
                f"{path or 'params'}: leaves {sorted(got)} differ from "
                f"{sorted(want)} (missing {sorted(set(want) - set(got))}, "
                f"extra {sorted(set(got) - set(want))})")
        return {k: _carry(want[k], got[k], f"{path}/{k}", device)
                for k in want}
    arr = np.asarray(got)
    if tuple(arr.shape) != tuple(want.shape):
        raise ValueError(f"{path}: shape {tuple(arr.shape)} differs from "
                         f"{tuple(want.shape)}")
    return torch.from_numpy(np.array(arr, order="C")).to(device)


def params_from_arrays(cfg: ArchConfig, tree: Mapping[str, Any],
                       device) -> Dict[str, Any]:
    """The port's parameter tree for ``cfg`` on ``device``, from a nested
    dict of numpy arrays with the same leaf names and shapes; dtypes are
    kept as given.  Raises ``ValueError`` on any difference of names or
    shapes."""
    want = Model(cfg).init(None, device="meta")
    return _carry(want, tree, "", device)
