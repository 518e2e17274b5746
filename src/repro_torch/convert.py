"""Carry a catalog across from plain arrays.

:func:`catalog_from_arrays` builds the port's
:class:`~repro_torch.core.stats.Catalog` from numpy arrays and Python
scalars only — the triples table, the dictionary's terms and float64
values, every VP table, every materialized ExtVP table, the SF and size
maps, τ, the kinds and the distinct/second-moment statistics.  Any
catalog that can be written out as those arrays (another build of the
same data, a file on disk) can be queried by this package with the very
same rows; it is the counterpart of carrying a model's weights across.
Tables are taken as given: their rows must already be sorted by
(s, o), as every catalog build leaves them.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.stats import Catalog
from repro_torch.core.table import Table
from repro_torch.core.vp import ExtVPBuild, KINDS
from repro_torch.rdf.dictionary import Dictionary

__all__ = ["catalog_from_arrays"]

Key = Tuple[str, int, int]


def catalog_from_arrays(
    tt: np.ndarray,
    terms: Sequence[str],
    values: np.ndarray,
    vp: Mapping[int, np.ndarray],
    extvp: Mapping[Key, np.ndarray],
    sf: Mapping[Key, float],
    sizes: Mapping[Key, int],
    threshold: float,
    kinds: Sequence[str] = KINDS,
    distinct_s: Optional[Mapping[int, int]] = None,
    distinct_o: Optional[Mapping[int, int]] = None,
    m2_s: Optional[Mapping[int, int]] = None,
    m2_o: Optional[Mapping[int, int]] = None,
    with_extvp: bool = True,
    n_semijoins: int = 0,
) -> Catalog:
    """A :class:`Catalog` over the given arrays (copied into int32 /
    float64 numpy arrays; nothing else is shared with the caller)."""

    def table(rows) -> Table:
        return Table(np.array(rows, dtype=np.int32).reshape(-1, 2))

    def ints(m):
        return None if m is None else {int(k): int(v) for k, v in m.items()}

    def key(k) -> Key:
        return (str(k[0]), int(k[1]), int(k[2]))

    dictionary = Dictionary.from_terms(
        [str(t) for t in terms], np.array(values, dtype=np.float64))
    ext = ExtVPBuild(
        tables={key(k): table(r) for k, r in extvp.items()},
        sf={key(k): float(v) for k, v in sf.items()},
        sizes={key(k): int(v) for k, v in sizes.items()},
        threshold=float(threshold), n_semijoins=int(n_semijoins),
        kinds=tuple(str(k) for k in kinds))
    return Catalog(tt=np.array(tt, dtype=np.int32).reshape(-1, 3),
                   vp={int(p): table(r) for p, r in vp.items()},
                   extvp=ext, dictionary=dictionary,
                   with_extvp=bool(with_extvp),
                   distinct_s=ints(distinct_s), distinct_o=ints(distinct_o),
                   m2_s=ints(m2_s), m2_o=ints(m2_o))
