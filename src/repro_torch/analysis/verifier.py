"""Plan/IR static verifier: pre-execution invariant checks.

The port of :mod:`repro.analysis.verifier`, with its names, checks and
messages, over the port's own compiler, executors and prepared forms.

The compiler (:mod:`repro_torch.core.compiler`) and the static-capacity
executors (:mod:`repro_torch.core.jexec`,
:mod:`repro_torch.core.distributed`) share a set of
invariants that nothing used to *check* — a violated one only surfaced
as a wrong answer in the differential fuzz or a silent
``device_fallbacks`` increment.  This module is the fence: a
non-executing pass over a compiled :class:`~repro_torch.core.compiler.Plan` /
:class:`~repro_torch.core.compiler.CorePlan` (and, at the executor level, the
capacity-slot accounting of a built ``PlanExecutor`` /
``DistributedExecutor``) that turns those runtime fuzz findings into
structured pre-execution failures.

Invariants (rule name → what must hold):

``cross-join``          join order never takes an unforced cross product:
                        a step sharing no variable with the accumulated
                        set is only legal when NO remaining step connects
                        (Algorithm 4's discipline, shared by the estimate
                        enumerator).  Structurally forced cross products
                        (disconnected BGPs, joins of var-disjoint groups)
                        are warnings, not errors.
``sf-zero-step``        an SF=0 scan must have been short-circuited to
                        the statistics-only empty plan, never executed.
``empty-flag``          ``Plan.empty``/``CorePlan.empty`` agree with the
                        tree (an empty plan carries no steps; a CorePlan
                        is empty iff its root collapsed to ``EmptySeg``).
``planner-tag``         ``Plan.planner`` names a real join-order planner.
``sentinel-collision``  bound term ids never collide with the reserved
                        sentinels: valid ids are dense ``[0, n)`` and
                        template placeholders live at
                        ``PLACEHOLDER_BASE - i``; anything in between
                        (UNBOUND = -1, MISSING_TERM = -2, the executor
                        NULL sentinels) must never appear as a bound term.
``table-choice``        a ``ScanStep``'s recorded (kind, p2, sf, size)
                        match the catalog's statistics — stale or
                        fabricated stats would corrupt capacity seeding
                        and join ordering.
``extvp-materialized``  a selected ExtVP table actually exists in the
                        catalog's materialized (SF ≤ τ) set; SF = 0
                        choices are exempt (they short-circuit).
``extvp-partner``       an ExtVP^kind[p|p2] choice has its partner
                        pattern (predicate p2, matching correlation) in
                        the same BGP — a semi-join reduction against an
                        absent partner silently drops rows.
``flat-offset``         ``CorePlan.flat`` is exactly the concatenation of
                        its BGP segments' steps at their recorded
                        ``start`` offsets (what constant re-binding and
                        the runtime bounds array index into).
``cap-slots``           the executor's capacity vector has exactly one
                        slot per flat step, one per ``CombineSeg``
                        (contiguous, behind the flat slots, bijective via
                        ``_comb_index``) and one modifier resize slot iff
                        the spine needs it — the overflow flags the
                        retry protocol reads are positional over this
                        layout.
``modifier-slice``      OFFSET/LIMIT are non-negative.
``filter-var``          (warning) FILTER / OPTIONAL-condition variables
                        are bound by the segment they attach to.  A miss
                        is legal SPARQL — the engines evaluate unbound
                        filter variables as UNBOUND — so this diagnoses
                        rather than rejects.
``projection-var``      (warning) projection / ORDER BY variables exist
                        in the core's output; missing ones are
                        UNBOUND-filled on every engine.

``verify_prepared`` dispatches over the engine's ``PreparedQuery``
shapes (duck-typed, no engine import): executor-backed prepared queries
(the torch and distributed backends) get the full core + cap-slot pass,
eager BGP plans the flat-plan pass, host operator trees (the eager
engine's other cores and the ``pt`` fallback) nothing — they are
interpreted, not compiled.  Wired into ``Engine._build`` behind
``RuntimeConfig(verify_plans=...)`` / ``REPRO_RT_VERIFY_PLANS`` and
surfaced by ``Engine.explain()``.

The catalog is read through host metadata only (``vp_size``, ``sf``,
``size``, ``extvp.threshold``, ``key in extvp.tables``): the pass reads
no device tensor, so it never synchronises with the card, and on a
lazily loaded store it loads no table the plan's compilation did not.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.algebra import correlations
from repro_torch.core.compiler import (
    BGPSeg, CombineSeg, CorePlan, CoreSeg, EmptySeg, FilterSeg, Plan,
    seg_vars,
)
from repro_torch.core.modifiers import ModifierSpine, filter_variables

__all__ = [
    "PlanDiagnostic", "PlanVerificationError", "VerificationReport",
    "verify_plan", "verify_core", "verify_executor", "verify_prepared",
    "ALL_CHECKS",
]

#: ids below this bound are template placeholders (engine/template.py's
#: reserved band); kept as a literal here so the core-level verifier does
#: not import the engine layer (the value is pinned by tests).
PLACEHOLDER_BASE = -1000

ERROR = "error"
WARNING = "warning"

#: every invariant this module can check, in report order
ALL_CHECKS: Tuple[str, ...] = (
    "cross-join", "sf-zero-step", "empty-flag", "planner-tag",
    "sentinel-collision", "table-choice", "extvp-materialized",
    "extvp-partner", "flat-offset", "cap-slots", "modifier-slice",
    "filter-var", "projection-var",
)

_PLANNERS = ("greedy", "estimate")
_EXTVP_KINDS = ("SS", "SO", "OS")


@dataclass(frozen=True)
class PlanDiagnostic:
    """One verifier finding: which invariant, how bad, where."""

    rule: str
    severity: str                # "error" | "warning"
    message: str
    location: str = ""           # e.g. "step 2", "seg@4", "spine"

    def __str__(self) -> str:
        at = f" at {self.location}" if self.location else ""
        return f"[{self.severity}] {self.rule}{at}: {self.message}"


class PlanVerificationError(Exception):
    """Raised by :meth:`VerificationReport.raise_if_failed` when a plan
    violates an error-severity invariant.  Carries the structured
    diagnostics so callers (and tests) can assert on rules, not on
    message strings."""

    def __init__(self, diagnostics: Sequence[PlanDiagnostic]):
        self.diagnostics = tuple(diagnostics)
        super().__init__(
            "plan verification failed:\n"
            + "\n".join(str(d) for d in self.diagnostics))

    def rules(self) -> Tuple[str, ...]:
        return tuple(d.rule for d in self.diagnostics)


@dataclass
class VerificationReport:
    """Outcome of one verification pass: every diagnostic plus the list
    of checks that ran (so "ok" is distinguishable from "unverifiable")."""

    diagnostics: Tuple[PlanDiagnostic, ...] = ()
    checks: Tuple[str, ...] = ()

    @property
    def errors(self) -> Tuple[PlanDiagnostic, ...]:
        return tuple(d for d in self.diagnostics if d.severity == ERROR)

    @property
    def warnings(self) -> Tuple[PlanDiagnostic, ...]:
        return tuple(d for d in self.diagnostics if d.severity == WARNING)

    @property
    def ok(self) -> bool:
        """No error-severity findings (warnings do not fail a plan)."""
        return not self.errors

    def raise_if_failed(self) -> "VerificationReport":
        if not self.ok:
            raise PlanVerificationError(self.errors)
        return self

    def rules(self) -> Tuple[str, ...]:
        return tuple(d.rule for d in self.diagnostics)

    def describe(self) -> str:
        """One ``Engine.explain()`` line."""
        if not self.checks:
            return "verify: skipped (host-interpreted operator tree)"
        if not self.diagnostics:
            return f"verify: ok ({len(self.checks)} checks)"
        if self.ok:
            return (f"verify: ok ({len(self.checks)} checks, "
                    f"{len(self.warnings)} warning(s): "
                    + "; ".join(str(d) for d in self.warnings) + ")")
        return ("verify: FAILED — "
                + "; ".join(str(d) for d in self.errors))


class _Collector:
    def __init__(self) -> None:
        self.diags: List[PlanDiagnostic] = []

    def error(self, rule: str, message: str, location: str = "") -> None:
        self.diags.append(PlanDiagnostic(rule, ERROR, message, location))

    def warn(self, rule: str, message: str, location: str = "") -> None:
        self.diags.append(PlanDiagnostic(rule, WARNING, message, location))


# ---------------------------------------------------------------------------
# Flat-plan checks
# ---------------------------------------------------------------------------

def _sentinel_error(i: int, pos: str, tid: int, c: _Collector) -> None:
    c.error("sentinel-collision",
            f"bound {pos}-term id {tid} collides with the "
            f"reserved sentinel band (-1 > id > {PLACEHOLDER_BASE})",
            f"step {i}")


def _check_plan(plan: Plan, catalog, c: _Collector,
                where: str = "") -> None:
    """Per-step invariants plus the Algorithm 4 join-order discipline.

    This runs on every ``prepare()`` cache miss when ``verify_plans`` is
    on, so the per-step checks are fused into one pass with the variable
    tests inlined (``is_var`` per term plus a helper call per check adds
    up to most of the verifier's cost on small plans):

    * sentinel collisions — a bound term id is a dictionary id (>= 0) or
      a template placeholder (the reserved band below
      ``PLACEHOLDER_BASE``); the sentinel gap in between (UNBOUND,
      MISSING_TERM, the executor NULL keys) must never appear bound;
    * table choice — recorded (kind, p2, sf, size) match the catalog;
    * ExtVP materialization and partner-pattern presence;
    * join order — a cross product is only taken when no remaining
      pattern is join-connected (shared by the estimate enumerator).
    """
    loc = where or "plan"
    if plan.planner not in _PLANNERS:
        c.error("planner-tag",
                f"unknown planner tag {plan.planner!r} (expected one of "
                f"{_PLANNERS})", loc)
    if plan.empty:
        if plan.steps:
            c.error("empty-flag",
                    f"statistics-empty plan carries {len(plan.steps)} "
                    "scan steps", loc)
        return
    steps = plan.steps
    n = len(steps)
    vsets: List[frozenset] = []     # per-step variable sets (join order)
    by_pred: dict = {}              # bound predicate -> [(idx, tp)]
    pending = []                    # ExtVP partner checks, deferred until
                                    # by_pred covers the whole plan
    for i in range(n):
        step = steps[i]
        tp = step.tp
        t_s, t_p, t_o = tp.s, tp.p, tp.o
        vs = []
        # unrolled per-term scan (variable collection + sentinel check):
        # a (pos, term) tuple loop here costs four allocations per step
        if isinstance(t_s, str):
            vs.append(t_s)
        else:
            tid = int(t_s)
            if 0 > tid > PLACEHOLDER_BASE and step.sf != 0.0:
                _sentinel_error(i, "s", tid, c)
        p_var = isinstance(t_p, str)
        if p_var:
            vs.append(t_p)
        else:
            tid = int(t_p)
            if 0 > tid > PLACEHOLDER_BASE and step.sf != 0.0:
                _sentinel_error(i, "p", tid, c)
            by_pred.setdefault(tid, []).append((i, tp))
        if isinstance(t_o, str):
            vs.append(t_o)
        else:
            tid = int(t_o)
            if 0 > tid > PLACEHOLDER_BASE and step.sf != 0.0:
                _sentinel_error(i, "o", tid, c)
        vsets.append(frozenset(vs))
        if step.sf == 0.0:
            c.error("sf-zero-step",
                    "SF=0 scan in a non-empty plan: the statistics prove "
                    "the result empty, the plan must short-circuit",
                    f"step {i}")
            continue
        if step.uses_tt:
            if step.kind is not None or step.p2 is not None:
                c.error("table-choice",
                        "a triples-table step cannot carry an ExtVP "
                        "choice", f"step {i}")
            continue
        if p_var:
            c.error("table-choice",
                    "unbound predicate without uses_tt (no table to scan)",
                    f"step {i}")
            continue
        p = int(tp.p)
        if step.kind is None:
            # VP scan: recorded stats must be the VP table's
            if step.sf != 1.0 or step.size != catalog.vp_size(p):
                c.error("table-choice",
                        f"VP step records sf={step.sf} size={step.size}, "
                        f"catalog has sf=1.0 size={catalog.vp_size(p)}",
                        f"step {i}")
            continue
        if step.kind not in _EXTVP_KINDS or step.p2 is None:
            c.error("table-choice",
                    f"ExtVP kind {step.kind!r} with partner {step.p2!r} "
                    "is not a precomputed correlation (SS/SO/OS + "
                    "partner)", f"step {i}")
            continue
        p2 = int(step.p2)
        cat_sf = catalog.sf(step.kind, p, p2)
        cat_size = catalog.size(step.kind, p, p2)
        if step.sf != cat_sf or step.size != cat_size:
            c.error("table-choice",
                    f"ExtVP^{step.kind}[{p}|{p2}] records sf={step.sf} "
                    f"size={step.size}, catalog has sf={cat_sf} "
                    f"size={cat_size}", f"step {i}")
        if step.sf > 0.0 and (step.kind, p, p2) not in catalog.extvp.tables:
            c.error("extvp-materialized",
                    f"ExtVP^{step.kind}[{p}|{p2}] (sf={step.sf:.3g}) is "
                    f"not in the catalog's materialized set (threshold "
                    f"τ={catalog.extvp.threshold}); the scan would "
                    "silently read the full VP table while the plan "
                    "credits the reduced size", f"step {i}")
        pending.append((i, step, tp, p, p2))
    # the reduction's partner pattern must be in the same BGP, with the
    # matching correlation — otherwise the semi-join filter drops rows
    # the query should produce
    for i, step, tp, p, p2 in pending:
        for j, other_tp in by_pred.get(p2, ()):
            if j != i and step.kind in correlations(tp, other_tp):
                break
        else:
            c.error("extvp-partner",
                    f"ExtVP^{step.kind}[{p}|{p2}] has no partner pattern "
                    f"with predicate {p2} and a {step.kind} correlation "
                    "in the plan", f"step {i}")
    # Algorithm 4 / estimate-enumerator discipline: a cross product is
    # only taken when no remaining pattern is join-connected
    if n > 1:
        acc = set(vsets[0])
        for i in range(1, n):
            vars_i = vsets[i]
            if not (vars_i & acc):
                connected_later = [
                    j for j in range(i + 1, n) if vsets[j] & acc]
                if connected_later:
                    c.error("cross-join",
                            f"step {i} shares no variable with the joined "
                            f"prefix while step(s) {connected_later} do — "
                            "an unforced cross product (planner "
                            f"{plan.planner!r} must prefer connected "
                            "steps)",
                            (where + " " if where else "") + f"step {i}")
                # else: the BGP is genuinely disconnected here — forced,
                # and bounded by the executor's capacity protocol
            acc |= vars_i


def verify_plan(plan: Plan, catalog,
                spine: Optional[ModifierSpine] = None
                ) -> VerificationReport:
    """Verify one flat :class:`Plan` (a single BGP pipeline), optionally
    with the modifier spine that will run over it."""
    c = _Collector()
    _check_plan(plan, catalog, c)
    if spine is not None:
        _check_spine(spine, plan.vars, c)
    return VerificationReport(tuple(c.diags), ALL_CHECKS)


# ---------------------------------------------------------------------------
# Core (segment-tree) checks
# ---------------------------------------------------------------------------

def _walk_bgp_segs(seg: CoreSeg, out: List[BGPSeg]) -> None:
    """BGP segments in flat-offset assignment order (compile_core's
    ``assign`` traversal: depth-first, left before right)."""
    if isinstance(seg, BGPSeg):
        out.append(seg)
    elif isinstance(seg, FilterSeg):
        _walk_bgp_segs(seg.child, out)
    elif isinstance(seg, CombineSeg):
        _walk_bgp_segs(seg.left, out)
        _walk_bgp_segs(seg.right, out)


def _walk_combines(seg: CoreSeg, out: List[CombineSeg]) -> None:
    """Combine segments in evaluation (post-) order — the executor's
    ``seed`` order, which fixes their capacity-slot indices."""
    if isinstance(seg, FilterSeg):
        _walk_combines(seg.child, out)
    elif isinstance(seg, CombineSeg):
        _walk_combines(seg.left, out)
        _walk_combines(seg.right, out)
        out.append(seg)


def _expr_vars(expr) -> Tuple[str, ...]:
    return filter_variables((expr,))


def _tree_vars(seg: CoreSeg, cache: dict) -> frozenset:
    """Bound-variable set of a segment, memoized by node identity —
    ``seg_vars`` recurses from scratch at every call, which turns the
    per-node checks below into O(n²) on deep UNION/OPTIONAL chains."""
    v = cache.get(id(seg))
    if v is None:
        if isinstance(seg, FilterSeg):
            v = _tree_vars(seg.child, cache)
        elif isinstance(seg, CombineSeg):
            v = _tree_vars(seg.left, cache) | _tree_vars(seg.right, cache)
        else:
            v = frozenset(seg_vars(seg))
        cache[id(seg)] = v
    return v


def _check_tree(seg: CoreSeg, c: _Collector, vcache: dict,
                path: str = "root") -> None:
    if isinstance(seg, (EmptySeg, BGPSeg)):
        return
    if isinstance(seg, FilterSeg):
        bound = _tree_vars(seg.child, vcache)
        loose = [v for v in _expr_vars(seg.expr) if v not in bound]
        if loose:
            c.warn("filter-var",
                   f"FILTER references {loose} which the segment below "
                   "never binds; the expression evaluates with UNBOUND "
                   "there (legal SPARQL, usually a query bug)", path)
        _check_tree(seg.child, c, vcache, path + ".child")
        return
    assert isinstance(seg, CombineSeg)
    lv = _tree_vars(seg.left, vcache)
    rv = _tree_vars(seg.right, vcache)
    if seg.kind in ("join", "left") and not (lv & rv) and lv and rv:
        c.warn("cross-join",
               f"{seg.kind} combine of variable-disjoint operands — a "
               "structurally forced cross product (bounded by the "
               "combine's capacity slot)", path)
    if seg.expr is not None:
        bound = lv | rv
        loose = [v for v in _expr_vars(seg.expr) if v not in bound]
        if loose:
            c.warn("filter-var",
                   f"OPTIONAL condition references {loose} which neither "
                   "operand binds; it evaluates with UNBOUND", path)
    _check_tree(seg.left, c, vcache, path + ".left")
    _check_tree(seg.right, c, vcache, path + ".right")


def _check_flat_offsets(core: CorePlan, segs: List[BGPSeg],
                        c: _Collector) -> None:
    offset = 0
    for k, seg in enumerate(segs):
        n = len(seg.plan.steps)
        if seg.start != offset:
            c.error("flat-offset",
                    f"BGP segment {k} records start={seg.start}, "
                    f"traversal order implies {offset}", f"seg@{seg.start}")
        window = core.flat.steps[seg.start: seg.start + n]
        if len(window) != n or any(a is not b for a, b
                                   in zip(window, seg.plan.steps)):
            c.error("flat-offset",
                    f"flat steps [{seg.start}, {seg.start + n}) are not "
                    f"segment {k}'s steps — constant re-binding would "
                    "write the wrong bounds rows", f"seg@{seg.start}")
        offset += n
    if offset != len(core.flat.steps):
        c.error("flat-offset",
                f"flat plan has {len(core.flat.steps)} steps, segments "
                f"account for {offset}")


def _check_spine(spine: ModifierSpine, out_vars: Sequence[str],
                 c: _Collector) -> None:
    if spine.offset < 0 or (spine.limit is not None and spine.limit < 0):
        c.error("modifier-slice",
                f"negative slice window (offset={spine.offset}, "
                f"limit={spine.limit})", "spine")
    bound = set(out_vars)
    loose = [v for v in filter_variables(spine.filters) if v not in bound]
    if loose:
        c.warn("filter-var",
               f"spine FILTER references {loose} which the core never "
               "binds; rows evaluate with UNBOUND there", "spine")
    if spine.project is not None:
        missing = [v for v in spine.project if v not in bound]
        if missing:
            c.warn("projection-var",
                   f"projection selects {missing} which the core never "
                   "binds; those columns are UNBOUND-filled", "spine")
    missing_order = [v for v, _ in spine.order if v not in bound]
    if missing_order:
        c.warn("projection-var",
               f"ORDER BY keys {missing_order} are never bound; they "
               "order nothing (constant keys)", "spine")


def verify_core(core: CorePlan, catalog,
                spine: Optional[ModifierSpine] = None
                ) -> VerificationReport:
    """Verify a :class:`CorePlan` segment tree: per-segment plan checks,
    tree-level variable/connectivity checks, flat-offset layout, and
    (when given) the modifier spine over the core's output."""
    c = _Collector()
    if core.empty != isinstance(core.root, EmptySeg):
        c.error("empty-flag",
                f"CorePlan.empty={core.empty} but root is "
                f"{type(core.root).__name__}")
    if core.flat.empty != core.empty:
        c.error("empty-flag",
                f"flat plan empty={core.flat.empty} disagrees with "
                f"core empty={core.empty}")
    if not core.empty:
        segs: List[BGPSeg] = []
        _walk_bgp_segs(core.root, segs)
        for k, seg in enumerate(segs):
            _check_plan(seg.plan, catalog, c, where=f"seg{k}")
            if seg.plan.empty:
                c.error("empty-flag",
                        f"segment {k} is statistics-empty but was not "
                        "pruned to EmptySeg", f"seg{k}")
        _check_flat_offsets(core, segs, c)
        _check_tree(core.root, c, {})
    if spine is not None:
        _check_spine(spine, core.vars, c)
    return VerificationReport(tuple(c.diags), ALL_CHECKS)


# ---------------------------------------------------------------------------
# Executor-level checks (capacity-slot accounting)
# ---------------------------------------------------------------------------

def verify_executor(ex, catalog=None) -> VerificationReport:
    """Verify a built ``PlanExecutor`` / ``DistributedExecutor``: the
    full core pass plus the capacity-slot protocol both executors share
    — ``caps = [one per flat step] + [one per CombineSeg, post-order] +
    [modifier resize slot iff the spine needs one]``, with the overflow
    flags positional over exactly this layout (``double_caps`` doubles
    ``caps[i]`` because ``ovf[i]`` fired; a missing or duplicated slot
    silently grows the wrong buffer)."""
    catalog = catalog if catalog is not None else ex.catalog
    report = verify_core(ex.core, catalog, spine=ex.spine)
    c = _Collector()
    c.diags.extend(report.diagnostics)

    n_flat = len(ex.plan.steps)
    combines: List[CombineSeg] = []
    _walk_combines(ex.core.root, combines)
    n_comb = len(combines)

    # the distributed executor gathers shards for global modifiers; the
    # single-device executor resizes for DISTINCT/ORDER sorts
    spine = ex.spine
    if hasattr(ex, "gathered"):
        want_resize = bool(spine.needs_global)
    else:
        want_resize = bool(spine.distinct or spine.order)
    if bool(ex._mod_resize) != want_resize:
        c.error("cap-slots",
                f"_mod_resize={ex._mod_resize} but the spine implies "
                f"{want_resize} (distinct={spine.distinct}, "
                f"order={bool(spine.order)}, slice={spine.has_slice})",
                "caps")
    want_len = n_flat + n_comb + (1 if ex._mod_resize else 0)
    if len(ex.caps) != want_len:
        c.error("cap-slots",
                f"{len(ex.caps)} capacity slots for {n_flat} flat steps "
                f"+ {n_comb} combines + "
                f"{1 if ex._mod_resize else 0} modifier slot(s) "
                f"(expected {want_len})", "caps")
    if ex._n_pipeline != n_flat + n_comb:
        c.error("cap-slots",
                f"_n_pipeline={ex._n_pipeline}, expected "
                f"{n_flat + n_comb} (flat + combine slots)", "caps")
    idx = ex._comb_index
    want_ids = {id(s) for s in combines}
    if set(idx.keys()) != want_ids or \
            sorted(idx.values()) != list(range(n_flat, n_flat + n_comb)):
        c.error("cap-slots",
                f"combine slot index maps {len(idx)} segment(s) onto "
                f"slots {sorted(idx.values())}; expected a bijection "
                f"onto [{n_flat}, {n_flat + n_comb})", "caps")
    for i, cap in enumerate(ex.caps):
        if not isinstance(cap, (int,)) or cap < 1:
            c.error("cap-slots",
                    f"capacity slot {i} is {cap!r} (positive int "
                    "required)", "caps")
    return VerificationReport(tuple(c.diags), ALL_CHECKS)


# ---------------------------------------------------------------------------
# PreparedQuery dispatch (duck-typed; no engine import)
# ---------------------------------------------------------------------------

def verify_prepared(prepared, catalog) -> VerificationReport:
    """Verify whatever a backend's ``prepare`` produced.

    * executor-backed (torch/distributed): full core + cap-slot pass;
    * eager with a compiled flat plan: flat-plan + spine pass;
    * statistics-empty: the empty-flag consistency check;
    * host operator trees (no compiled artifact): nothing to verify —
      the report says so instead of claiming "ok".
    """
    ex = getattr(prepared, "executor", None)
    if ex is not None:
        return verify_executor(ex, catalog)
    plan = getattr(prepared, "plan", None)
    if plan is not None:
        spine = getattr(prepared, "spine", None)
        return verify_plan(plan, catalog, spine=spine)
    return VerificationReport((), ())
