"""Collective-byte accounting for the dry run's roofline.

The counterpart of the JAX package's ``repro/launch/hlo.py``.  There the
collectives are read from a compiled program's HLO text; the port runs
eagerly and has no program to read, so it records the collectives it
issues: every collective call site of the port reports to
:func:`repro_torch.obs.counters.note`, and a :func:`record` block
collects one entry per call (both re-exported here).  This module turns
the entries into the JAX package's dict.  The JAX package's async
``-start`` / ``-done`` pairs have no counterpart: an eager call is one
entry.
"""

from __future__ import annotations

from typing import Dict, Iterable

from repro_torch.obs.counters import note, record

__all__ = ["COLLECTIVE_OPS", "WEIGHTS", "record", "note",
           "collective_bytes"]

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")

#: ring-cost factors of the ``weighted`` figure: an all-reduce moves about
#: twice its payload (2(n-1)/n), the others about once
WEIGHTS = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
           "all-to-all": 1.0, "collective-permute": 1.0}


def collective_bytes(entries: Iterable[Dict[str, object]]
                     ) -> Dict[str, float]:
    """Operand bytes per collective kind, plus ``total`` and ``weighted``
    (:data:`WEIGHTS`): the dict ``repro.launch.hlo.collective_bytes``
    returns, with only the kinds that occur."""
    out: Dict[str, float] = {}
    for e in entries:
        kind = e["kind"]
        if kind not in WEIGHTS:
            raise ValueError(f"unknown collective kind {kind!r}")
        out[kind] = out.get(kind, 0.0) + float(e["bytes"])
    total = sum(out.values())
    weighted = sum(v * WEIGHTS[k] for k, v in out.items())
    out["total"] = total
    out["weighted"] = weighted
    return out
