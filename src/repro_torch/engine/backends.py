"""The execution backend: a template in, a prepared query out.

A backend turns a :class:`~repro_torch.engine.template.QueryTemplate`
into a :class:`PreparedQuery` — the template-level artifact (parsed tree,
compiled plan, executor with its device-resident tables) — and a
prepared query runs any constant instantiation via a
:class:`~repro_torch.engine.template.ConstantBinding` without
re-parsing or re-compiling.

Three backends:

* ``"eager"`` — the host numpy engine (:mod:`repro_torch.core.executor`,
  exact dynamic shapes), which serves every layout including the
  property table (``"pt"``, :mod:`repro_torch.core.pt`);
* ``"torch"`` — the static-capacity executor of
  :mod:`repro_torch.core.jexec` on the engine's device;
* ``"distributed"`` — the executor of :mod:`repro_torch.core.distributed`
  over the ranks of a ``torch.distributed`` process group.

The two device backends compile for the ``"extvp"``, ``"vp"`` and
``"tt"`` layouts.  A template they cannot express — the host-only
``"pt"`` layout, a node kind outside the device fragment, or a
dictionary whose numeric keys defeat the double-single encoding
(``compile_core`` or the executor raises
:class:`~repro_torch.core.compiler.DeviceUnsupported`) — is prepared on
the eager engine instead and
flagged (``PreparedQuery.fallback``), so the Engine counts every request
it serves (``device_fallbacks``).  Those two causes are the only ones:
the fallback is decided at prepare time, and any other error — a CUDA
error, a kernel that fails to build or load — propagates.

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

from repro_torch.core.algebra import BGP
from repro_torch.core.compiler import (
    DeviceUnsupported, Plan, compile_bgp, compile_core,
)
from repro_torch.core.distributed import DistributedExecutor
from repro_torch.core.executor import (
    Bindings, apply_spine_host, execute, execute_plan,
)
from repro_torch.core.jexec import PlanExecutor
from repro_torch.core.modifiers import peel_spine, substitute_spine
from repro_torch.core.stats import Catalog
from repro_torch.device import resolve_device
from repro_torch.engine.result import Result
from repro_torch.engine.template import (
    ConstantBinding, QueryTemplate, node_vars, rebind_plan, substitute_query,
)
from repro_torch.kernels.build import KernelBuildError
from repro_torch.kernels.ops import KernelLaunchError

__all__ = ["ExecutionContext", "PreparedQuery", "EagerBackend",
           "TorchBackend", "DistributedBackend", "is_device_error"]

_NO_BINDING = ConstantBinding(mapping={}, missing=False)


def is_device_error(exc: BaseException) -> bool:
    """Whether ``exc`` is a fault of the card or of a kernel — a CUDA
    error (out of memory included) or a kernel that cannot be built or
    loaded — rather than a template the device path cannot express.
    Such errors always propagate: they never become a host fallback or
    a routing exclusion.  Decided by type: a kernel's own launch error
    (:class:`~repro_torch.kernels.ops.KernelLaunchError`), a build or
    load error, and torch's CUDA errors (``torch.AcceleratorError``
    where this torch has it)."""
    kinds = (KernelBuildError, KernelLaunchError, torch.OutOfMemoryError,
             torch.cuda.CudaError)
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None:
        kinds += (accel,)
    return isinstance(exc, kinds)


@dataclass
class ExecutionContext:
    """Everything a backend needs to prepare and run queries.  ``layout``
    is the storage schema plans compile for (``"extvp"``, ``"vp"``,
    ``"tt"``, or ``"pt"`` on the host engine); ``device`` ``None`` means
    ``"cuda"``; ``group`` is the ``torch.distributed`` process group of
    the distributed backend (``None``: the default group)."""

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
    """A template compiled for a backend; run any instantiation of it."""

    backend: str = "torch"
    #: True when run_batch executes the whole batch as one launch sequence
    #: (padding to a static shape is then worthwhile and the batch-shape
    #: tuner may judge it); the base loop runs padding slots as real
    #: queries, so callers must not pad for it
    vectorized_batch: bool = False
    #: True when a device backend could not compile the template and
    #: prepared it on the eager host engine — the Engine counts these per
    #: request (``device_fallbacks``), so host execution is observable
    fallback: bool = False

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


class _EagerPrepared(PreparedQuery):
    """Host numpy engine.  Queries whose modifier spine sits on a BGP
    core cache the compiled plan + spine and re-bind scan/filter
    constants by id substitution; other operator trees
    (OPTIONAL/UNION/...) cache the parsed tree and re-bind through
    ``substitute_query``."""

    backend = "eager"

    def __init__(self, template, ctx, fallback: bool = False):
        super().__init__(template, ctx)
        self.fallback = fallback
        self.plan: Optional[Plan] = None
        self.spine = None
        core, spine = peel_spine(self.query)
        if isinstance(core, BGP) and ctx.layout != "pt":
            self.plan = compile_bgp(core, ctx.catalog, ctx.layout,
                                    ctx.planner)
            self.spine = spine

    def run(self, binding: Optional[ConstantBinding] = None,
            trace=None) -> Result:
        binding = binding or _NO_BINDING
        if binding.short_circuit:
            return self._empty()
        sid = trace.start("host.execute", backend="eager") \
            if trace is not None else None
        if self.plan is not None:
            if self.plan.empty:
                if trace is not None:
                    trace.end(sid, rows=0, short_circuit=True)
                return self._empty()
            plan = rebind_plan(self.plan, binding.mapping)
            spine = substitute_spine(self.spine, binding.mapping)
            b = apply_spine_host(execute_plan(plan, self.ctx.catalog), spine,
                                 self.ctx.catalog)
            res = Result(b, self.ctx.dictionary)
        else:
            query = substitute_query(self.query, binding.mapping)
            res = Result(execute(query, self.ctx.catalog,
                                 layout=self.ctx.layout),
                         self.ctx.dictionary)
        if trace is not None:
            trace.end(sid, rows=len(res))
        return res


class _VectorizedPrepared(PreparedQuery):
    """The device path: the executor's ``bounds`` input carries the bound
    constants.  ``run`` feeds one bounds vector; ``run_batch`` stacks B
    of them into a leading batch axis and runs the whole micro-batch as
    one launch sequence (:meth:`PlanExecutor.run_batch`), so the Engine
    pads a chunk to its bucket shape and the batch-shape tuner observes
    it.  A binding whose missing constant fills a required slot (S2RDF's
    statistics-only empty answer) is answered on the host and takes no
    slot: the batch is padded back to its shape by repeating a live
    binding.  A constant missing elsewhere (under OPTIONAL, in a UNION
    branch, in a FILTER) is bound as ``MISSING_TERM``, which matches no
    row, and its binding is live like any other."""

    vectorized_batch = True

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
        if binding.short_circuit:
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
            if b.short_circuit:
                results[i] = self._empty()
            else:
                live.append(i)
                bounds.append(self.executor.bounds_from_plan(
                    rebind_plan(self.plan, b.mapping)))
                fconsts.append(self.executor.fconsts_from_mapping(b.mapping))
        if live:
            # pad back to the caller's (bucket-shaped) batch size: a
            # missing binding takes no slot of its own, and a batch that
            # is one launch sequence keeps the shape the engine chose
            while len(bounds) < len(bindings):
                bounds.append(bounds[-1])
                fconsts.append(fconsts[-1])
            outs = self.executor.run_batch(bounds, fconsts, trace=trace)
            sid = trace.start("demux", batch=len(bindings),
                              live=len(live)) if trace is not None else None
            for i, (data, cols) in zip(live, outs):
                results[i] = self._wrap(data, cols)
            if trace is not None:
                trace.end(sid)
        return results


class EagerBackend:
    """The host numpy engine: every template, every layout."""

    name = "eager"

    def prepare(self, template: QueryTemplate,
                ctx: ExecutionContext) -> PreparedQuery:
        return _EagerPrepared(template, ctx)


class TorchBackend:
    """The full graph-pattern fragment — BGP/FILTER/OPTIONAL/UNION cores
    plus unbound-predicate (triples-table) scans, under any modifier
    spine (see :func:`repro_torch.core.modifiers.peel_spine`) — compiles
    via :func:`repro_torch.core.compiler.compile_core` into one
    :class:`~repro_torch.core.jexec.PlanExecutor` per template.  The
    host-only ``pt`` layout, and a :class:`DeviceUnsupported` from
    ``compile_core`` or from building the executor (numeric keys that
    defeat the double-single encoding), prepare a flagged eager
    fallback; every other error propagates."""

    name = "torch"

    def prepare(self, template: QueryTemplate,
                ctx: ExecutionContext) -> PreparedQuery:
        if ctx.layout == "pt":
            return _EagerPrepared(template, ctx, fallback=True)
        core, spine = peel_spine(template.query)
        try:
            cp = compile_core(core, ctx.catalog, ctx.layout, ctx.planner)
            if cp.empty:
                return _EmptyPrepared(template, ctx, self.name)
            return self._prepared(template, ctx, cp, spine)
        except DeviceUnsupported:
            return _EagerPrepared(template, ctx, fallback=True)

    def _prepared(self, template, ctx, cp, spine) -> PreparedQuery:
        ex = PlanExecutor(cp, ctx.catalog, spine=spine, device=ctx.device)
        return _VectorizedPrepared(template, ctx, ex)


class _DistributedPrepared(_VectorizedPrepared):
    """The distributed executor over a process group; table shards and
    the per-rank program are template-level state, constants are runtime
    inputs.  Every rank of the group must run the same bindings in the
    same order.  Its ``run_batch`` runs the whole batch as one launch
    sequence on every rank (the reference's vmapped ``shard_map``
    program), so the Engine pads it to its bucket shape and the tuner
    observes it, as on the torch backend."""

    backend = "distributed"


class DistributedBackend(TorchBackend):
    """The fragment of :class:`TorchBackend` (and its eager fallbacks),
    compiled into one
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
