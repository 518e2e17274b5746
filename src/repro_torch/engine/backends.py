"""The execution backend: a template in, a prepared query out.

A backend turns a :class:`~repro_torch.engine.template.QueryTemplate`
into a :class:`PreparedQuery` — the template-level artifact (parsed tree,
compiled plan, executor with its device-resident tables) — and a
prepared query runs any constant instantiation via a
:class:`~repro_torch.engine.template.ConstantBinding` without
re-parsing or re-compiling.

This package has one backend, ``"torch"``: the static-capacity executor
of :mod:`repro_torch.core.jexec` on the engine's device.  It has no
host engine to fall back on, so a template it cannot serve (the
``estimate`` planner, a dictionary whose numeric keys defeat the
double-single encoding) raises NotImplementedError at prepare time.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.compiler import Plan, compile_core
from repro_torch.core.jexec import PlanExecutor
from repro_torch.core.modifiers import peel_spine
from repro_torch.core.stats import Catalog
from repro_torch.engine.result import Bindings, Result
from repro_torch.engine.template import (
    ConstantBinding, QueryTemplate, node_vars, rebind_plan,
)

__all__ = ["ExecutionContext", "PreparedQuery", "TorchBackend"]

_NO_BINDING = ConstantBinding(mapping={}, missing=False)


@dataclass
class ExecutionContext:
    """Everything a backend needs to prepare and run queries."""

    catalog: Catalog
    dictionary: object = None            # Optional[repro_torch.rdf.Dictionary]
    planner: str = "greedy"
    device: torch.device = torch.device("cpu")


class PreparedQuery:
    """A template compiled for the backend; run any instantiation of it."""

    backend: str = "torch"

    def __init__(self, template: QueryTemplate, ctx: ExecutionContext):
        self.template = template
        self.ctx = ctx
        self.query = template.query

    def run(self, binding: Optional[ConstantBinding] = None) -> Result:
        raise NotImplementedError

    def run_batch(self, bindings: List[Optional[ConstantBinding]]
                  ) -> List[Result]:
        """One Result per binding, in order (the sequential loop)."""
        return [self.run(b) for b in bindings]

    @property
    def out_cols(self) -> Tuple[str, ...]:
        if self.query.select is not None:
            return tuple(self.query.select)
        return node_vars(self.query.root)

    def _empty(self) -> Result:
        return Result.empty(self.out_cols, self.ctx.dictionary)


class _EmptyPrepared(PreparedQuery):
    """Statistics-proven empty template: answered without touching data."""

    def __init__(self, template, ctx):
        super().__init__(template, ctx)
        self.plan = Plan(empty=True, vars=self.out_cols)

    def run(self, binding: Optional[ConstantBinding] = None) -> Result:
        return self._empty()


class _VectorizedPrepared(PreparedQuery):
    """The device path: the executor's ``bounds`` input carries the bound
    constants.  ``run`` feeds one bounds vector; ``run_batch`` feeds B of
    them to one batched launch.  Missing-constant bindings (S2RDF's
    statistics-only empty answer) are answered on the host and never
    occupy a batch slot."""

    def __init__(self, template, ctx, executor: PlanExecutor):
        super().__init__(template, ctx)
        self.executor = executor
        self.plan: Plan = executor.plan

    def _wrap(self, data: np.ndarray, cols: Tuple[str, ...]) -> Result:
        # the executor's spine already applied FILTER, the projection,
        # DISTINCT, ORDER BY and the slice on the device — the host must
        # not re-project or re-dedup (that would destroy the row order)
        return Result(Bindings(cols, data), self.ctx.dictionary)

    def run(self, binding: Optional[ConstantBinding] = None) -> Result:
        binding = binding or _NO_BINDING
        if binding.missing:
            return self._empty()
        plan = rebind_plan(self.plan, binding.mapping)
        data, cols = self.executor.run(
            bounds=self.executor.bounds_from_plan(plan),
            fconsts=self.executor.fconsts_from_mapping(binding.mapping))
        return self._wrap(data, cols)

    def run_batch(self, bindings: List[Optional[ConstantBinding]]
                  ) -> List[Result]:
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
            outs = self.executor.run_batch(bounds, fconsts)
            for i, (data, cols) in zip(live, outs):
                results[i] = self._wrap(data, cols)
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
        core, spine = peel_spine(template.query)
        cp = compile_core(core, ctx.catalog, planner=ctx.planner)
        if cp.empty:
            return _EmptyPrepared(template, ctx)
        ex = PlanExecutor(cp, ctx.catalog, spine=spine, device=ctx.device)
        return _VectorizedPrepared(template, ctx, ex)
