"""Query instances from a query set (``s2bench/querysets/<name>.json``).

A query set holds template texts with ``%placeholder%`` tokens and, for
each token in the order the generator draws them, the term format, the
first index and the entity block (or a number) that bounds the draw.
:func:`instantiate` is a frozen copy of the port's
``repro_torch.rdf.workloads.instantiate``: every instance draws every
placeholder, used or not, so a stream of instances matches the port's
draw for draw.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

QUERYSETS = Path(__file__).resolve().parents[1] / "querysets"


def load_queryset(name: str) -> dict:
    path = QUERYSETS / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no query set {name!r} at {path}")
    return json.loads(path.read_text())


def instantiate(template: str, queryset: dict, counts: Dict[str, int],
                rng: np.random.Generator,
                rename: Optional[Dict[str, np.ndarray]] = None) -> str:
    """``template`` with each placeholder replaced by an entity drawn from
    ``rng`` (all placeholders drawn, in the query set's order).  With
    ``rename`` (:func:`s2bench.inputs.watdiv.renaming`), an entity drawn
    from a block is then renamed as the relabelled graph renames it."""
    subs = []
    for ph in queryset["placeholders"]:
        block = ph["count"]
        n = counts[block] if isinstance(block, str) else int(block)
        lo = int(ph["lo"])
        i = int(rng.integers(lo, lo + n))
        if rename is not None and isinstance(block, str):
            i = lo + int(rename[block][i - lo])
        subs.append((ph["token"], ph["format"].format(i)))
    out = template
    for token, value in subs:
        out = out.replace(token, value)
    return out


def instances(queryset: dict, counts: Dict[str, int], seed,
              n_instances: int) -> Dict[str, List[str]]:
    """``n_instances`` of every template of the set, template by template
    from one generator seeded with ``seed`` (the port's
    ``basic_queries``)."""
    rng = np.random.default_rng(seed)
    return {name: [instantiate(t, queryset, counts, rng)
                   for _ in range(n_instances)]
            for name, t in queryset["templates"].items()}
