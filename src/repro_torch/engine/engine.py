"""The query engine: template LRU cache over the torch backend.

``Engine`` is the public execution surface.  It owns

* a bounded LRU plan cache keyed on ``planner::signature`` — each entry
  holds the backend's :class:`~repro_torch.engine.backends.PreparedQuery`
  (parsed template, compiled plan, executor with its device-resident
  tables), so a repeated templated query is served with zero parsing and
  zero compilation: its constants re-bind as runtime inputs;
* the statistics short-circuit (provably-empty plans and constants
  missing from the dictionary are answered without touching data);
* ``query_batch``: same-template requests grouped by signature and run
  through one batched launch per chunk of at most ``MAX_BATCH``;
* a small ``metrics`` dict (``queries``, ``device_fallbacks``).

S2RDF notes that repeated Virtuoso queries benefit from caching while its
own runtimes are stable: here we cache *compilation*, never results.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.engine.backends import (
    ExecutionContext, PreparedQuery, TorchBackend,
)
from repro_torch.engine.result import Result
from repro_torch.engine.template import (
    QueryTemplate, _normalize, template_signature,
)

__all__ = ["Engine", "PlanCache", "resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means ``"cuda"``, which
    raises when no CUDA device is present — the port never carries on
    silently on the CPU.  Pass ``device="cpu"`` to run there."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev


class PlanCache:
    """Bounded LRU: cache key -> PreparedQuery."""

    def __init__(self, capacity: int = 512):
        self.capacity = max(1, int(capacity))
        self._data: "OrderedDict[str, PreparedQuery]" = OrderedDict()
        self.evictions = 0

    def get(self, key: str) -> Optional[PreparedQuery]:
        hit = self._data.get(key)
        if hit is not None:
            self._data.move_to_end(key)
        return hit

    def put(self, key: str, prepared: PreparedQuery) -> None:
        self._data[key] = prepared
        self._data.move_to_end(key)
        while len(self._data) > self.capacity:
            self._data.popitem(last=False)
            self.evictions += 1

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def keys(self):
        return self._data.keys()


class Engine:
    """Execute SPARQL text over a Dataset on one device.

    ``backend`` is ``"torch"`` (the only backend of this package);
    ``device`` is where the executors run — ``None`` means ``"cuda"``.
    """

    #: Most requests of one template in one batched launch.  Nothing is
    #: padded: the executor runs each binding of a launch in turn, so a
    #: padded slot would cost a whole query and buy no fixed shape.
    MAX_BATCH: int = 32

    def __init__(self, dataset, backend: str = "torch", device=None,
                 planner: str = "greedy", plan_cache_size: int = 512):
        if backend != TorchBackend.name:
            raise ValueError(f"unknown backend {backend!r}; available: "
                             f"['{TorchBackend.name}']")
        self.device = resolve_device(device)
        self.dataset = dataset
        self.planner = planner
        self._backend = TorchBackend()
        self.ctx = ExecutionContext(catalog=dataset.catalog,
                                    dictionary=dataset.dictionary,
                                    planner=planner,
                                    device=self.device)
        self.cache = PlanCache(plan_cache_size)
        self.metrics: Dict[str, int] = {"queries": 0, "device_fallbacks": 0}

    @property
    def backend(self) -> str:
        return self._backend.name

    # -- compilation ----------------------------------------------------------
    def _cache_key(self, sig: str) -> str:
        return f"{self.planner}::{sig}"

    def _lookup(self, qtext: str, sig: str) -> Optional[PreparedQuery]:
        prepared = self.cache.get(self._cache_key(sig))
        if prepared is not None:
            return prepared
        # Non-rebindable templates (e.g. a constant in predicate position)
        # are cached under the exact normalized text instead.
        return self.cache.get(self._cache_key("=" + _normalize(qtext)))

    def _build(self, qtext: str, sig: str) -> PreparedQuery:
        try:
            template = QueryTemplate(qtext, self.ctx.dictionary)
        except ValueError:
            # template substitution produced unparseable text; fall back
            # to the concrete query (a malformed query raises from there)
            template = None
        if template is None or not template.rebindable:
            template = QueryTemplate.concrete(qtext, self.ctx.dictionary)
        try:
            prepared = self._backend.prepare(template, self.ctx)
        except NotImplementedError:
            # the reference would serve this template on its host engine;
            # the port has none, so the request fails and is counted
            self.metrics["device_fallbacks"] += 1
            raise
        key = sig if template.rebindable else "=" + _normalize(qtext)
        self.cache.put(self._cache_key(key), prepared)
        return prepared

    def prepare(self, qtext: str) -> PreparedQuery:
        """Prepared form of ``qtext``'s template, from cache if present."""
        sig = template_signature(qtext)
        return self._lookup(qtext, sig) or self._build(qtext, sig)

    # -- execution ------------------------------------------------------------
    def query(self, qtext: str) -> Result:
        prepared = self.prepare(qtext)
        binding = prepared.template.binding_for(qtext) \
            if prepared.template.rebindable else None
        res = prepared.run(binding)
        self.metrics["queries"] += 1
        return res

    def _run_group(self, prepared: PreparedQuery,
                   bindings: List[Optional[object]]) -> List[Result]:
        """Same-template bindings through ``run_batch``, in chunks of at
        most ``MAX_BATCH``."""
        out: List[Result] = []
        for start in range(0, len(bindings), self.MAX_BATCH):
            out.extend(prepared.run_batch(
                bindings[start: start + self.MAX_BATCH]))
        return out

    def query_batch(self, qtexts: List[str]) -> List[Result]:
        """Execute a list of queries: requests sharing a template signature
        run through one batched launch; results come back in submission
        order."""
        results: List[Optional[Result]] = [None] * len(qtexts)
        sig_groups: "OrderedDict[str, List[int]]" = OrderedDict()
        for i, qtext in enumerate(qtexts):
            sig_groups.setdefault(template_signature(qtext), []).append(i)
        for sig, idxs in sig_groups.items():
            groups: "OrderedDict[int, Tuple[PreparedQuery, List[int]]]" = \
                OrderedDict()
            for i in idxs:
                prepared = self._lookup(qtexts[i], sig) or \
                    self._build(qtexts[i], sig)
                groups.setdefault(id(prepared), (prepared, []))[1].append(i)
            for prepared, sub in groups.values():
                bindings = [prepared.template.binding_for(qtexts[i])
                            if prepared.template.rebindable else None
                            for i in sub]
                for i, res in zip(sub, self._run_group(prepared, bindings)):
                    results[i] = res
                    self.metrics["queries"] += 1
        return results  # type: ignore[return-value]
