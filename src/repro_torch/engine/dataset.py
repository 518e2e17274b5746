"""The ``Dataset`` facade: one object owning the storage stack.

S2RDF's data layer is a pipeline — dictionary-encode the triples, build
VP tables, semi-join-reduce them into ExtVP with selectivity statistics
(paper §5).  ``Dataset`` owns that pipeline and hands out
:class:`~repro_torch.engine.engine.Engine` instances.

    # threshold is the paper's SF-threshold τ; 0.25 is the recommended
    # production trade-off (§7.4), 1.0 materializes every reduction.
    ds = Dataset.watdiv(scale=1.0, seed=0, threshold=0.25)   # on "cuda"
    eng = ds.engine()
    res = eng.query("SELECT * WHERE { ?u wsdbm:follows ?v }")
    res.to_terms()

The catalog is built on the host (the ``"numpy"`` build); the engines
upload the tables each template scans to their device.  A dataset's
``device`` is the default device of its engines; ``device=None`` means
``"cuda"`` and raises when no CUDA device is present.  Tests pass
``device="cpu"``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, Tuple

import torch

from repro_torch.core.stats import Catalog, build_catalog
from repro_torch.core.vp import KINDS
from repro_torch.engine.engine import Engine, resolve_device

__all__ = ["Dataset"]


@dataclass
class Dataset:
    """A loaded RDF graph: dictionary + TT + VP + ExtVP(τ) + statistics,
    and the device its engines run on by default."""

    catalog: Catalog
    dictionary: object = None          # repro_torch.rdf.Dictionary
    schema: object = None              # Optional[WatDivSchema]
    device: torch.device = None
    _engines: Dict[tuple, Engine] = field(default_factory=dict, repr=False)

    def __post_init__(self) -> None:
        if self.dictionary is None:
            self.dictionary = self.catalog.dictionary
        self.device = resolve_device(self.device)

    # -- constructors ---------------------------------------------------------
    @classmethod
    def from_triples(cls, triples: Iterable[Tuple[str, str, str]],
                     threshold: float = 1.0,
                     kinds: Tuple[str, ...] = KINDS,
                     with_extvp: bool = True,
                     device=None) -> "Dataset":
        """Build the full store from (s, p, o) string triples."""
        from repro_torch.rdf.dictionary import Dictionary
        device = resolve_device(device)
        d = Dictionary()
        tt = d.encode_triples(list(triples))
        cat = build_catalog(tt, d, threshold=threshold, kinds=kinds,
                            with_extvp=with_extvp)
        return cls(catalog=cat, dictionary=d, device=device)

    @classmethod
    def watdiv(cls, scale: float = 1.0, seed: int = 0,
               threshold: float = 1.0,
               kinds: Tuple[str, ...] = KINDS,
               with_extvp: bool = True,
               device=None) -> "Dataset":
        """Generate a WatDiv-like graph (paper §7) and build its store."""
        from repro_torch.rdf.generator import WatDivConfig, generate_watdiv
        device = resolve_device(device)
        tt, d, sch = generate_watdiv(WatDivConfig(scale_factor=scale,
                                                  seed=seed))
        cat = build_catalog(tt, d, threshold=threshold, kinds=kinds,
                            with_extvp=with_extvp)
        return cls(catalog=cat, dictionary=d, schema=sch, device=device)

    # -- engines --------------------------------------------------------------
    def engine(self, backend: str = "torch", device=None,
               planner: str = "greedy",
               plan_cache_size: int = 512) -> Engine:
        """An :class:`Engine` over this dataset, cached per configuration
        so repeated calls share plan caches.  ``device=None`` means the
        dataset's device."""
        dev = resolve_device(self.device if device is None else device)
        key = (backend, str(dev), planner, plan_cache_size)
        eng = self._engines.get(key)
        if eng is None:
            eng = Engine(self, backend=backend, device=dev,
                         planner=planner, plan_cache_size=plan_cache_size)
            self._engines[key] = eng
        return eng

    @property
    def n_triples(self) -> int:
        return self.catalog.n_triples

    def storage_report(self) -> Dict[str, float]:
        return self.catalog.storage_report()
