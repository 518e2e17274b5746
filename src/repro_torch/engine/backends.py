"""The execution backend: a template in, a prepared query out.

A backend turns a :class:`~repro_torch.engine.template.QueryTemplate`
into a :class:`PreparedQuery` — the template-level artifact (parsed tree,
compiled plan, executor with its device-resident tables) — and a
prepared query runs any constant instantiation via a
:class:`~repro_torch.engine.template.ConstantBinding` without
re-parsing or re-compiling.

This package has two backends: ``"torch"``, the static-capacity
executor of :mod:`repro_torch.core.jexec` on the engine's device, and
``"distributed"``, the executor of :mod:`repro_torch.core.distributed`
over the ranks of a ``torch.distributed`` process group.  Both compile
for the ``"extvp"``, ``"vp"`` and ``"tt"`` layouts.  Neither has a host
engine to fall back on, so a template they cannot serve (the host-only
``"pt"`` layout, a dictionary whose numeric keys defeat the
double-single encoding) raises NotImplementedError at prepare time.

A sampled request's :class:`~repro_torch.obs.tracer.TraceContext`
rides along by argument (``run(binding, trace)``): the prepared query
opens ``decode`` / ``demux`` spans and marks statistics short-circuits,
and the executor opens one ``device.launch`` span per attempt.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.compiler import Plan, compile_core
from repro_torch.core.distributed import DistributedExecutor
from repro_torch.core.jexec import PlanExecutor
from repro_torch.core.modifiers import peel_spine
from repro_torch.core.stats import Catalog
from repro_torch.device import resolve_device
from repro_torch.engine.result import Bindings, Result
from repro_torch.engine.template import (
    ConstantBinding, QueryTemplate, node_vars, rebind_plan,
)

__all__ = ["ExecutionContext", "PreparedQuery", "TorchBackend",
           "DistributedBackend"]

_NO_BINDING = ConstantBinding(mapping={}, missing=False)


@dataclass
class ExecutionContext:
    """Everything a backend needs to prepare and run queries.  ``layout``
    is the storage schema plans compile for (``"extvp"``, ``"vp"``,
    ``"tt"``); ``device`` ``None`` means ``"cuda"``; ``group`` is the
    ``torch.distributed`` process group of the distributed backend
    (``None``: the default group)."""

    catalog: Catalog
    dictionary: object = None            # Optional[repro_torch.rdf.Dictionary]
    layout: str = "extvp"
    #: join-order planner compiled plans use ("greedy" | "estimate");
    #: the Engine refreshes this before every prepare and keys its plan
    #: cache on it
    planner: str = "greedy"
    device: torch.device = None
    group: object = None

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)


class PreparedQuery:
    """A template compiled for the backend; run any instantiation of it."""

    backend: str = "torch"

    def __init__(self, template: QueryTemplate, ctx: ExecutionContext):
        self.template = template
        self.ctx = ctx
        self.query = template.query

    def run(self, binding: Optional[ConstantBinding] = None,
            trace=None) -> Result:
        """``trace`` is the sampled request's
        :class:`~repro_torch.obs.tracer.TraceContext` (or ``None``, the
        default and the fast path)."""
        raise NotImplementedError

    def run_batch(self, bindings: List[Optional[ConstantBinding]],
                  trace=None) -> List[Result]:
        """One Result per binding, in order (the sequential loop).
        ``trace`` is the chunk's lead trace context; the loop attributes
        it to the first binding."""
        return [self.run(b, trace=trace if i == 0 else None)
                for i, b in enumerate(bindings)]

    @property
    def out_cols(self) -> Tuple[str, ...]:
        if self.query.select is not None:
            return tuple(self.query.select)
        return node_vars(self.query.root)

    def _empty(self) -> Result:
        return Result.empty(self.out_cols, self.ctx.dictionary)


class _EmptyPrepared(PreparedQuery):
    """Statistics-proven empty template: answered without touching data."""

    def __init__(self, template, ctx, backend: str):
        super().__init__(template, ctx)
        self.backend = backend
        self.plan = Plan(empty=True, vars=self.out_cols)

    def run(self, binding: Optional[ConstantBinding] = None,
            trace=None) -> Result:
        if trace is not None:
            trace.event("short_circuit", why="statistics-empty plan")
        return self._empty()


class _VectorizedPrepared(PreparedQuery):
    """The device path: the executor's ``bounds`` input carries the bound
    constants.  ``run`` feeds one bounds vector; ``run_batch`` feeds B of
    them to one batched launch.  Missing-constant bindings (S2RDF's
    statistics-only empty answer) are answered on the host and never
    occupy a batch slot."""

    def __init__(self, template, ctx, executor):
        super().__init__(template, ctx)
        self.executor = executor
        self.plan: Plan = executor.plan

    def _wrap(self, data: np.ndarray, cols: Tuple[str, ...]) -> Result:
        # the executor's spine already applied FILTER, the projection,
        # DISTINCT, ORDER BY and the slice on the device — the host must
        # not re-project or re-dedup (that would destroy the row order)
        return Result(Bindings(cols, data), self.ctx.dictionary)

    def run(self, binding: Optional[ConstantBinding] = None,
            trace=None) -> Result:
        binding = binding or _NO_BINDING
        if binding.missing:
            if trace is not None:
                trace.event("short_circuit", why="constant missing "
                            "from the dictionary")
            return self._empty()
        plan = rebind_plan(self.plan, binding.mapping)
        data, cols = self.executor.run(
            bounds=self.executor.bounds_from_plan(plan),
            fconsts=self.executor.fconsts_from_mapping(binding.mapping),
            trace=trace)
        if trace is None:
            return self._wrap(data, cols)
        sid = trace.start("decode")
        res = self._wrap(data, cols)
        trace.end(sid, rows=len(res))
        return res

    def run_batch(self, bindings: List[Optional[ConstantBinding]],
                  trace=None) -> List[Result]:
        bindings = [b or _NO_BINDING for b in bindings]
        results: List[Optional[Result]] = [None] * len(bindings)
        live: List[int] = []
        bounds: List[np.ndarray] = []
        fconsts: List[np.ndarray] = []
        for i, b in enumerate(bindings):
            if b.missing:
                results[i] = self._empty()
            else:
                live.append(i)
                bounds.append(self.executor.bounds_from_plan(
                    rebind_plan(self.plan, b.mapping)))
                fconsts.append(self.executor.fconsts_from_mapping(b.mapping))
        if live:
            outs = self.executor.run_batch(bounds, fconsts, trace=trace)
            sid = trace.start("demux", batch=len(bindings),
                              live=len(live)) if trace is not None else None
            for i, (data, cols) in zip(live, outs):
                results[i] = self._wrap(data, cols)
            if trace is not None:
                trace.end(sid)
        return results


class TorchBackend:
    """The full graph-pattern fragment — BGP/FILTER/OPTIONAL/UNION cores
    plus unbound-predicate (triples-table) scans, under any modifier
    spine (see :func:`repro_torch.core.modifiers.peel_spine`) — compiles
    via :func:`repro_torch.core.compiler.compile_core` into one
    :class:`~repro_torch.core.jexec.PlanExecutor` per template."""

    name = "torch"

    def prepare(self, template: QueryTemplate,
                ctx: ExecutionContext) -> PreparedQuery:
        if ctx.layout == "pt":
            # the reference serves the property table on its host engine;
            # the port has none yet
            raise NotImplementedError(
                "the 'pt' layout runs on a host engine, which the port "
                "does not have")
        core, spine = peel_spine(template.query)
        cp = compile_core(core, ctx.catalog, ctx.layout, ctx.planner)
        if cp.empty:
            return _EmptyPrepared(template, ctx, self.name)
        return self._prepared(template, ctx, cp, spine)

    def _prepared(self, template, ctx, cp, spine) -> PreparedQuery:
        ex = PlanExecutor(cp, ctx.catalog, spine=spine, device=ctx.device)
        return _VectorizedPrepared(template, ctx, ex)


class _DistributedPrepared(_VectorizedPrepared):
    """The distributed executor over a process group; table shards and
    the per-rank program are template-level state, constants are runtime
    inputs.  Every rank of the group must run the same bindings in the
    same order."""

    backend = "distributed"


class DistributedBackend(TorchBackend):
    """The fragment of :class:`TorchBackend`, compiled into one
    :class:`~repro_torch.core.distributed.DistributedExecutor` per
    template over ``ctx.group``.  ``dual_partition`` adds an
    object-partitioned copy of every table, so object-keyed probes skip
    the exchange."""

    name = "distributed"

    def __init__(self, dual_partition: bool = False):
        self.dual_partition = dual_partition

    def _prepared(self, template, ctx, cp, spine) -> PreparedQuery:
        ex = DistributedExecutor(cp, ctx.catalog, group=ctx.group,
                                 dual_partition=self.dual_partition,
                                 spine=spine, device=ctx.device)
        return _DistributedPrepared(template, ctx, ex)
