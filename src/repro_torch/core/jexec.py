"""Static-capacity executor — the device (GPU) path of the engine.

Every relation is a fixed-capacity buffer ``(data[cap, k], n)`` with PAD
rows past ``n``; every operator returns an overflow flag when a capacity
would have been exceeded, and the host re-runs the plan with doubled
capacities.  Capacities are seeded from the catalog's ExtVP statistics —
the same statistics the paper uses for join ordering — so overflows are
rare, and grown capacities persist on the executor.

This is the PyTorch counterpart of the reference's jitted executor: the
same operators, the same capacity protocol and the same row order, run
eagerly on one device.  Nothing is traced or compiled; the static
capacities remain because they keep every operator free of host syncs —
the host syncs once per launch, for the overflow flags and the row count.

Join algorithm: sort-merge.  The build side is key-sorted (stable), each
probe key finds its lower bound and match count in the sorted build
column through the hand-written join-probe kernel
(:func:`repro_torch.kernels.ops.join_probe`), and match counts expand
into output slots by a rank search over the exclusive prefix sum.

Join keys are single int32 columns (the first shared variable); any
further shared variables are post-filtered after expansion.  Sentinels
keep padded/NULL rows unmatched: probe-side pads → ``A_SENT``,
build-side pads → ``B_SENT`` (distinct, sort-max), UNBOUND values →
per-side negative sentinels.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.algebra import BoolOp, Bound, Cmp, FilterExpr, NotExpr, is_var
from repro_torch.core.compiler import (
    BGPSeg, CombineSeg, CorePlan, CoreSeg, EmptySeg, FilterSeg, Plan,
    ScanStep, core_filter_exprs,
)
from repro_torch.core.modifiers import ModifierSpine, filter_const_slots
from repro_torch.core.stats import Catalog
from repro_torch.core.table import pad_rows, round_up_pow2
from repro_torch.kernels import ops
from repro_torch.rdf.dictionary import PAD, UNBOUND

__all__ = ["JBindings", "PlanExecutor", "device_join", "device_left_join",
           "device_union", "device_scan", "device_scan_tt",
           "device_scan_windowed", "build_key", "bounds_from_plan",
           "device_filter", "device_project", "device_resize",
           "device_distinct", "device_order", "device_slice",
           "numeric_value_keys", "prepare_value_keys", "double_caps"]

A_SENT = 2**31 - 1   # probe-side padded-row key (== PAD)
B_SENT = 2**31 - 2   # build-side padded-row key (sort-max, != A_SENT)
A_NULL = -3          # probe-side UNBOUND key
B_NULL = -5          # build-side UNBOUND key

_I32 = torch.int32


# ---------------------------------------------------------------------------
# Double-single numeric keys
#
# Dictionary values are float64; the device keys are float32 pairs.  Each
# float64 ``v`` is split into ``(hi, lo)`` with ``hi = f32(v)`` (nearest)
# and ``lo = f32(v - f64(hi))``: ``hi`` is monotone in ``v`` and, for equal
# ``hi``, the residual is monotone too, so LEXICOGRAPHIC pair comparison is
# order-equivalent to the float64 comparison whenever the pair mapping is
# injective over the values actually compared.  That injectivity is
# checked ONCE on the host; tables that defeat it raise
# NotImplementedError.
# ---------------------------------------------------------------------------

def _split_f64(v: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    hi = v.astype(np.float32)
    with np.errstate(invalid="ignore"):
        lo = (v - hi.astype(np.float64)).astype(np.float32)
    return hi, np.where(np.isnan(lo), np.float32(0.0), lo)


def _split_scalar(v: float) -> Tuple[np.float32, np.float32]:
    hi = np.float32(v)
    return hi, np.float32(np.float64(v) - np.float64(hi))


def _check_pair_injective(vals: np.ndarray, what: str) -> None:
    """Distinct float64 keys must map to distinct (hi, lo) pairs."""
    u = np.unique(vals[~np.isnan(vals)])
    if len(u) <= 1:
        return
    hi, lo = _split_f64(u)
    if not np.all((np.diff(hi) != 0) | (np.diff(lo) != 0)):
        raise NotImplementedError(
            f"{what} is not double-single distinguishable; numeric "
            "modifiers would diverge from the host engines")


def numeric_value_keys(dictionary) -> np.ndarray:
    """The device numeric-key table: float32 ``(nv, 4)`` of
    ``[cmp_hi, cmp_lo, ord_hi, ord_lo]`` per term id.  The cmp pair is
    NaN for non-numeric terms (comparisons drop those rows); the ord pair
    falls back to the term id (the host ``order_rows`` key).  Cached on
    the dictionary; raises NotImplementedError when the pair encoding
    cannot distinguish the table's keys."""
    if dictionary is None:
        return np.empty((0, 4), dtype=np.float32)
    cached = getattr(dictionary, "_ds_value_keys", None)
    if cached is not None and cached.shape[0] == len(dictionary):
        return cached
    vals = np.asarray(dictionary.values, dtype=np.float64)
    n = len(vals)
    cmp_hi, cmp_lo = _split_f64(vals)
    cmp_hi = np.where(np.isnan(vals), np.float32(np.nan), cmp_hi)
    ord64 = np.where(np.isnan(vals), np.arange(n, dtype=np.float64), vals)
    _check_pair_injective(ord64, "dictionary value/id key table")
    ord_hi, ord_lo = _split_f64(ord64)
    keys = np.stack([cmp_hi, cmp_lo, ord_hi, ord_lo], axis=1) \
        .astype(np.float32)
    try:
        dictionary._ds_value_keys = keys
    except AttributeError:
        pass
    return keys


def _float_literals(exprs: Sequence[FilterExpr]) -> List[float]:
    out: List[float] = []

    def walk(e) -> None:
        if isinstance(e, Cmp):
            for t in (e.lhs, e.rhs):
                if isinstance(t, float):
                    out.append(t)
        elif isinstance(e, BoolOp):
            for a in e.args:
                walk(a)
        elif isinstance(e, NotExpr):
            walk(e.arg)

    for e in exprs:
        walk(e)
    return out


def _exprs_use_values(exprs: Sequence[FilterExpr]) -> bool:
    """True when any filter comparison is numeric (order ops or a float
    literal operand) — i.e. reads the numeric key table."""

    def walk(e) -> bool:
        if isinstance(e, Cmp):
            return e.op in ("<", "<=", ">", ">=") or \
                isinstance(e.lhs, float) or isinstance(e.rhs, float)
        if isinstance(e, BoolOp):
            return any(walk(a) for a in e.args)
        if isinstance(e, NotExpr):
            return walk(e.arg)
        return False

    return any(walk(e) for e in exprs)


def prepare_value_keys(catalog: Optional[Catalog], spine: ModifierSpine,
                       filters: Sequence[FilterExpr]) -> np.ndarray:
    """The numeric key table a program needs — empty when nothing in the
    program reads values (identity-only filters, no ORDER BY), so
    value-free templates never pay the injectivity check."""
    uses = bool(spine.order) or _exprs_use_values(filters)
    if not uses or catalog is None or catalog.dictionary is None:
        return np.empty((0, 4), dtype=np.float32)
    keys = numeric_value_keys(catalog.dictionary)
    lits = _float_literals(list(filters))
    if lits:
        vals = np.asarray(catalog.dictionary.values, dtype=np.float64)
        _check_pair_injective(
            np.concatenate([vals[~np.isnan(vals)],
                            np.asarray(lits, dtype=np.float64)]),
            "filter literal vs dictionary value keys")
    return keys


@dataclass
class JBindings:
    """Static-capacity relation: cols are host metadata, the rest lives
    on the device."""

    cols: Tuple[str, ...]
    data: torch.Tensor       # (cap, k) int32
    n: torch.Tensor          # () int32
    overflow: torch.Tensor   # () bool — sticky across operators

    @property
    def capacity(self) -> int:
        return self.data.shape[0]


def _false(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.bool, device=device)


def _scalar(v: int, device) -> torch.Tensor:
    return torch.tensor(v, dtype=_I32, device=device)


def _valid_mask(cap: int, n: torch.Tensor) -> torch.Tensor:
    return torch.arange(cap, dtype=_I32, device=n.device) < n


def _compact(data: torch.Tensor, keep: torch.Tensor, out_cap: int,
             fill: int = PAD
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Move keep-rows to the front (stable); returns (data, n, overflow).
    A kept row's slot is its rank among the kept rows (an inclusive
    prefix sum), so this is the stable partition of the reference's
    argsort without the sort; rows past ``out_cap`` and dropped rows go
    to a dump row that is cut off."""
    k = data.shape[1]
    n_keep = keep.sum(dtype=_I32)
    pos = torch.cumsum(keep, 0, dtype=_I32) - 1
    dest = torch.where(keep & (pos < out_cap), pos, out_cap)
    out = torch.full((out_cap + 1, k), fill, dtype=data.dtype,
                     device=data.device)
    out[dest] = data
    return out[:out_cap], torch.clamp(n_keep, max=out_cap), n_keep > out_cap


def device_scan(rows: torch.Tensor, n: torch.Tensor, s_bound, o_bound,
                same_var: bool, out_cols: Sequence[int], out_cap: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Select + project one (s, o) table (Algorithm 2, device form).
    ``s_bound``/``o_bound`` are ``None`` (statically unbound) or an int32
    device scalar, so one executor serves every instantiation of a query
    template (constant re-binding)."""
    cap = rows.shape[0]
    keep = _valid_mask(cap, n)
    if s_bound is not None:
        keep &= rows[:, 0] == s_bound
    if o_bound is not None:
        keep &= rows[:, 1] == o_bound
    if same_var:
        keep &= rows[:, 0] == rows[:, 1]
    projected = rows[:, list(out_cols)] if out_cols else rows[:, :0]
    return _compact(projected, keep, out_cap)


def build_key(b: JBindings, key_col: int) -> torch.Tensor:
    """The build-side join-key column with NULL/pad sentinels applied —
    the input of the build-side sort.  Exposed so a batched run can
    presort a *shared* (bounds-independent) build relation once and reuse
    it for every batch element (see ``device_join``'s ``b_presorted``)."""
    kb = b.data[:, key_col]
    kb = torch.where(kb == UNBOUND, B_NULL, kb)
    return torch.where(_valid_mask(b.capacity, b.n), kb, B_SENT)


def _presort(kb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(order_b, kb_sorted): the stable ascending order of a build key
    (equal keys keep their row order, which sets the output row order)."""
    order_b = torch.argsort(kb, stable=True).to(_I32)
    return order_b, kb[order_b]


def device_scan_windowed(rows: torch.Tensor, n: torch.Tensor, s_bound,
                         out_cols: Sequence[int], out_cap: int,
                         s_col: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Bound-subject scan over a subject-sorted table: the matching rows
    are one contiguous window found by binary search and need no compact,
    so the cost is O(log T + out_cap) instead of a full-table mask and
    compact.  PAD rows sort after every valid id, so the search never
    needs the valid count.  Only usable without an object post-filter:
    overflow is the raw window width vs ``out_cap``.  ``s_col`` is the
    table's contiguous subject column (uploaded once with the table);
    without it the column is copied out of ``rows``."""
    cap = rows.shape[0]
    col = rows[:, 0].contiguous() if s_col is None else s_col
    sb = torch.as_tensor(s_bound, dtype=_I32, device=rows.device).reshape(1)
    lo = torch.searchsorted(col, sb, out_int32=True)[0]
    hi = torch.searchsorted(col, sb, right=True, out_int32=True)[0]
    idx = lo + torch.arange(out_cap, dtype=_I32, device=rows.device)
    keep = idx < hi
    g = rows[torch.clamp(idx, 0, cap - 1)]
    projected = g[:, list(out_cols)] if out_cols else g[:, :0]
    data = torch.where(keep[:, None], projected, PAD)
    return data, torch.clamp(hi - lo, max=out_cap), hi - lo > out_cap


def _join_expand(a: JBindings, b: JBindings, out_cap: int,
                 b_presorted: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """Shared expansion machinery of the join family: pair every probe
    row with its build-side matches into ``out_cap`` output slots.

    Returns ``(out_cols, data, a_idx, valid, total, needs_compact)``:
    ``a_idx[j]`` is the probe row that produced slot ``j``, ``valid`` the
    kept-slot mask, ``total`` the true (uncapped) match count.  When
    ``needs_compact`` is False the valid slots are already contiguous at
    the front (``valid == j < total``)."""
    shared = [c for c in a.cols if c in b.cols]
    b_only = [c for c in b.cols if c not in a.cols]
    out_cols = a.cols + tuple(b_only)
    dev = a.data.device

    cap_a, cap_b = a.capacity, b.capacity
    j = torch.arange(out_cap, dtype=_I32, device=dev)
    if not shared:  # cross join (rare; bounded by caps)
        bn = torch.clamp(b.n, min=1)
        a_idx = torch.clamp(j // bn, 0, cap_a - 1)
        b_idx = j % bn
        total = a.n * b.n
        valid = j < total
        data = torch.cat(
            [a.data[a_idx], b.data[torch.clamp(b_idx, 0, cap_b - 1)]], dim=1)
        return out_cols, data, a_idx, valid, total, False

    ka = a.data[:, a.cols.index(shared[0])]
    ka = torch.where(ka == UNBOUND, A_NULL, ka)
    ka = torch.where(_valid_mask(cap_a, a.n), ka, A_SENT)
    if b_presorted is None:
        order_b, kb_sorted = _presort(build_key(b, b.cols.index(shared[0])))
    else:
        order_b, kb_sorted = b_presorted
    lo, cnt = ops.join_probe(ka.contiguous(), kb_sorted.contiguous())
    ends = torch.cumsum(cnt, 0, dtype=_I32)      # inclusive prefix
    prefix = ends - cnt                          # exclusive prefix
    total = ends[-1]

    # rank search: which probe row produced output slot j
    a_idx = torch.searchsorted(ends, j, right=True, out_int32=True)
    a_idx = torch.clamp(a_idx, 0, cap_a - 1)
    off = j - prefix[a_idx]
    b_pos = torch.clamp(lo[a_idx] + off, 0, cap_b - 1)
    b_idx = order_b[b_pos]
    valid = j < total

    left = a.data[a_idx]
    right = b.data[b_idx]

    # post-filter shared columns beyond the key (SQL NULL semantics)
    for c in shared[1:]:
        va = left[:, a.cols.index(c)]
        vb = right[:, b.cols.index(c)]
        valid &= (va == vb) & (va != UNBOUND)

    pieces = [left]
    if b_only:
        pieces.append(right[:, [b.cols.index(c) for c in b_only]])
    data = torch.cat(pieces, dim=1)
    return out_cols, data, a_idx, valid, total, bool(shared[1:])


def device_join(a: JBindings, b: JBindings, out_cap: int,
                b_presorted: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> JBindings:
    """Natural join of two static relations (sort-merge, rank expansion).

    ``b_presorted`` is an optional ``(order_b, kb_sorted)`` pair from
    :func:`build_key` + stable sort, letting a batched run hoist the
    build-side sort out of the batch when ``b`` does not depend on the
    bound constants."""
    out_cols, data, _, valid, total, needs_compact = _join_expand(
        a, b, out_cap, b_presorted)
    if needs_compact:
        data, n, ovf = _compact(data, valid, out_cap)
    else:
        # matches are contiguous at j < total: masking replaces the compact
        data = torch.where(valid[:, None], data, PAD)
        n = torch.clamp(total, max=out_cap).to(_I32)
        ovf = _false(data.device)
    return JBindings(out_cols, data, n,
                     a.overflow | b.overflow | ovf | (total > out_cap))


def device_left_join(a: JBindings, b: JBindings, out_cap: int,
                     expr: Optional[FilterExpr] = None,
                     values: Optional[torch.Tensor] = None,
                     fconsts: Optional[torch.Tensor] = None,
                     ctr: Optional[List[int]] = None) -> JBindings:
    """OPTIONAL: left-outer join.  Inner rows first (probe-major, build
    rows in original order — the natural-join order), then each
    unmatched probe row once, UNBOUND-padded on the build-only columns,
    in probe order — the host ``left_outer_join`` sequence.

    ``expr`` is OPTIONAL's join condition: it filters the INNER rows
    only (a probe row whose matches all fail the condition comes out
    unmatched), with constants riding the shared runtime ``fconsts``."""
    out_cols, data, a_idx, valid, total, _ = _join_expand(a, b, out_cap)
    cap_a = a.capacity
    dev = data.device
    if expr is not None:
        inner = JBindings(out_cols, data, _scalar(out_cap, dev), _false(dev))
        valid = valid & _filter_mask(expr, inner, values, fconsts, ctr)

    # matched set: scatter hit flags through a_idx (invalid slots are
    # routed to a dump slot so clipped indices cannot pollute the flags)
    hit = torch.zeros((cap_a + 1,), dtype=torch.bool, device=dev)
    hit[torch.where(valid, a_idx, cap_a)] = True
    unmatched = _valid_mask(cap_a, a.n) & ~hit[:cap_a]

    k_b = len(out_cols) - len(a.cols)
    tail = a.data if not k_b else torch.cat(
        [a.data, torch.full((cap_a, k_b), UNBOUND, dtype=_I32, device=dev)],
        dim=1)
    buf = torch.cat([data, tail], dim=0)
    keep = torch.cat([valid, unmatched])
    out, n, ovf = _compact(buf, keep, out_cap)
    # total > out_cap also voids the matched-set computation (cut slots
    # never set their hit flag), so the overflow retry covers it
    return JBindings(out_cols, out, n,
                     a.overflow | b.overflow | ovf | (total > out_cap))


def device_union(a: JBindings, b: JBindings, out_cap: int) -> JBindings:
    """UNION: both operands lifted to the column union (UNBOUND fill),
    left rows first then right rows — the host ``union`` sequence —
    via one stable compact over the concatenated buffers."""
    cols = a.cols + tuple(c for c in b.cols if c not in a.cols)

    def lift(x: JBindings) -> torch.Tensor:
        cap = x.capacity
        if not cols:
            return x.data[:, :0]
        arrs = [x.data[:, x.cols.index(c)] if c in x.cols
                else torch.full((cap,), UNBOUND, dtype=_I32,
                                device=x.data.device) for c in cols]
        d = torch.stack(arrs, dim=1)
        return torch.where(_valid_mask(cap, x.n)[:, None], d, PAD)

    buf = torch.cat([lift(a), lift(b)], dim=0)
    keep = torch.cat([_valid_mask(a.capacity, a.n),
                      _valid_mask(b.capacity, b.n)])
    data, n, ovf = _compact(buf, keep, out_cap)
    return JBindings(cols, data, n, a.overflow | b.overflow | ovf)


def device_scan_tt(rows: torch.Tensor, n: torch.Tensor, s_bound, p_bound,
                   o_bound, eqs: Sequence[Tuple[int, int]],
                   take: Sequence[int], out_cap: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Select + project over the (N, 3) triples table — the unbound-
    predicate scan (and the ``layout="tt"`` baseline scan).  Bound s/o
    constants are device scalars like :func:`device_scan`'s; the bound
    predicate of a TT-layout scan is a Python int (predicates are plan
    identity and never template-rebindable).  ``eqs`` carries the
    repeated-variable equality selections of patterns like ``?x ?p ?x``."""
    cap = rows.shape[0]
    keep = _valid_mask(cap, n)
    if s_bound is not None:
        keep &= rows[:, 0] == s_bound
    if p_bound is not None:
        keep &= rows[:, 1] == p_bound
    if o_bound is not None:
        keep &= rows[:, 2] == o_bound
    for i, j in eqs:
        keep &= rows[:, i] == rows[:, j]
    projected = rows[:, list(take)] if take else rows[:, :0]
    return _compact(projected, keep, out_cap)


# ---------------------------------------------------------------------------
# Solution modifiers on device (the spine of repro_torch.core.modifiers)
#
# All five operators keep the JBindings invariant — valid rows occupy
# [0, n) contiguously with PAD rows behind — and none can overflow (a
# modifier never grows the relation), so the per-step overflow/retry
# protocol of the scan/join pipeline is untouched.
# ---------------------------------------------------------------------------

def _filter_operand(b: JBindings, values: torch.Tensor, term, numeric: bool,
                    fconsts: torch.Tensor, ctr: List[int]):
    """(ids, numeric (hi, lo) key pair) for one comparison operand.
    Constant ids are device scalars read from ``fconsts`` (slot order
    fixed by :func:`repro_torch.core.modifiers.filter_const_slots`), so
    re-binding a template constant changes only an input; float literals
    are part of the template text.  A variable the relation does not
    bind is UNBOUND everywhere."""
    cap = b.capacity
    dev = b.data.device
    nv = values.shape[0]
    dt = values.dtype
    nan = torch.tensor(float("nan"), dtype=dt, device=dev)
    if isinstance(term, str):            # variable
        if term in b.cols:
            ids = b.data[:, b.cols.index(term)]
        else:
            ids = torch.full((cap,), UNBOUND, dtype=_I32, device=dev)
        if not numeric:
            return ids, None
        if nv:
            safe = torch.clamp(ids, 0, nv - 1)
            ok = ids >= 0
            hi = torch.where(ok, values[safe, 0], nan)
            lo = torch.where(ok, values[safe, 1], nan)
        else:
            hi = torch.full((cap,), float("nan"), dtype=dt, device=dev)
            lo = hi
        return ids, (hi, lo)
    if isinstance(term, float):          # numeric literal
        fhi, flo = _split_scalar(term)
        return None, (torch.full((cap,), float(fhi), dtype=dt, device=dev),
                      torch.full((cap,), float(flo), dtype=dt, device=dev))
    tid = fconsts[ctr[0]]                # constant id -> runtime slot
    ctr[0] += 1
    ids = tid.expand(cap)
    if not numeric:
        return ids, None
    if nv:
        ok = (tid >= 0) & (tid < nv)
        safe = torch.clamp(tid, 0, nv - 1)
        hi = torch.where(ok, values[safe, 0], nan)
        lo = torch.where(ok, values[safe, 1], nan)
    else:
        hi = nan
        lo = hi
    return ids, (hi.expand(cap), lo.expand(cap))


def _filter_mask(expr: FilterExpr, b: JBindings, values: torch.Tensor,
                 fconsts: torch.Tensor, ctr: List[int]) -> torch.Tensor:
    """Boolean keep-mask over the relation's rows: identity comparison on
    ids, numeric comparison through the dictionary's double-single key
    pairs, UNBOUND/type-error rows dropped.  NaN key pairs make every
    comparison false, matching host NaN semantics."""
    if isinstance(expr, BoolOp):
        masks = [_filter_mask(e, b, values, fconsts, ctr) for e in expr.args]
        out = masks[0]
        for m in masks[1:]:
            out = (out & m) if expr.op == "&&" else (out | m)
        return out
    if isinstance(expr, NotExpr):
        return ~_filter_mask(expr.arg, b, values, fconsts, ctr)
    if isinstance(expr, Bound):
        if expr.var not in b.cols:
            return torch.zeros((b.capacity,), dtype=torch.bool,
                               device=b.data.device)
        return b.data[:, b.cols.index(expr.var)] != UNBOUND
    assert isinstance(expr, Cmp)
    numeric = expr.op in ("<", "<=", ">", ">=") or \
        isinstance(expr.lhs, float) or isinstance(expr.rhs, float)
    lid, lpair = _filter_operand(b, values, expr.lhs, numeric, fconsts, ctr)
    rid, rpair = _filter_operand(b, values, expr.rhs, numeric, fconsts, ctr)
    if numeric:
        lhi, llo = lpair
        rhi, rlo = rpair
        eq = (lhi == rhi) & (llo == rlo)
        lt = (lhi < rhi) | ((lhi == rhi) & (llo < rlo))
        both = ~torch.isnan(lhi) & ~torch.isnan(rhi)
        if expr.op == "=":
            return eq
        if expr.op == "!=":
            return ~eq & both
        if expr.op == "<":
            return lt
        if expr.op == "<=":
            return lt | eq
        if expr.op == ">":
            return ~(lt | eq) & both
        return ~lt & both
    ok = (lid != UNBOUND) & (rid != UNBOUND)
    return ((lid == rid) if expr.op == "=" else (lid != rid)) & ok


def device_filter(b: JBindings, expr: FilterExpr, values: torch.Tensor,
                  fconsts: torch.Tensor, ctr: List[int]) -> JBindings:
    """FILTER: mask + stable compact (kept rows stay in order)."""
    keep = _filter_mask(expr, b, values, fconsts, ctr) & \
        _valid_mask(b.capacity, b.n)
    data, n, _ = _compact(b.data, keep, b.capacity)
    return JBindings(b.cols, data, n, b.overflow)


def device_project(b: JBindings, out_vars: Sequence[str]) -> JBindings:
    """Projection: gather the selected columns (UNBOUND-fill variables
    the pipeline does not produce), re-PAD invalid rows."""
    cap = b.capacity
    if not out_vars:
        return JBindings((), b.data[:, :0], b.n, b.overflow)
    cols = [b.data[:, b.cols.index(v)] if v in b.cols
            else torch.full((cap,), UNBOUND, dtype=_I32, device=b.data.device)
            for v in out_vars]
    data = torch.stack(cols, dim=1)
    data = torch.where(_valid_mask(cap, b.n)[:, None], data, PAD)
    return JBindings(tuple(out_vars), data, b.n, b.overflow)


def device_resize(b: JBindings, out_cap: int
                  ) -> Tuple[JBindings, torch.Tensor]:
    """Re-buffer the relation to ``out_cap`` rows — a pure truncation or
    PAD extension (valid rows are contiguous at the front).  Returns the
    relation and an overflow flag for the retry protocol: DISTINCT/ORDER
    BY sort this buffer, so right-sizing it keeps modifier queries from
    sorting a join-sized buffer of mostly-PAD rows."""
    cap, k = b.data.shape
    if out_cap < cap:
        data = b.data[:out_cap]
    elif out_cap > cap:
        data = torch.cat(
            [b.data, torch.full((out_cap - cap, k), PAD, dtype=b.data.dtype,
                                device=b.data.device)], dim=0)
    else:
        data = b.data
    ovf = b.n > out_cap
    return JBindings(b.cols, data, torch.clamp(b.n, max=out_cap),
                     b.overflow), ovf


def _lexsort(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """``np.lexsort`` order (the LAST key is the primary one) as chained
    stable sorts from the least significant key up."""
    order = torch.argsort(keys[0], stable=True)
    for key in keys[1:]:
        order = order[torch.argsort(key[order], stable=True)]
    return order


def device_distinct(b: JBindings) -> JBindings:
    """DISTINCT: lexsort + adjacent-unique to find duplicates, then a
    stable compact of the FIRST occurrence of each distinct row in the
    original order — the host first-occurrence-stable dedup, so an order
    established before it survives."""
    cap, k = b.data.shape
    if k == 0:   # zero-column relation: dedup of n empty mappings is one
        return JBindings(b.cols, b.data, torch.clamp(b.n, max=1), b.overflow)
    valid = _valid_mask(cap, b.n)
    keys = [b.data[:, j] for j in range(k - 1, -1, -1)]
    keys.append((~valid).to(_I32))                 # valid rows first
    order = _lexsort(keys)
    sdata = b.data[order]
    svalid = valid[order]
    same_prev = torch.cat([
        torch.zeros((1,), dtype=torch.bool, device=b.data.device),
        torch.all(sdata[1:] == sdata[:-1], dim=1)])
    keep = torch.zeros(cap, dtype=torch.bool, device=b.data.device)
    keep[order] = svalid & ~same_prev
    data, n, _ = _compact(b.data, keep, cap)
    return JBindings(b.cols, data, n, b.overflow)


def device_order(b: JBindings, keys: Sequence[Tuple[str, bool]],
                 values: torch.Tensor) -> JBindings:
    """ORDER BY: stable lexsort over the dictionary's double-single
    ``(ord_hi, ord_lo)`` key pairs (numeric literals by value, other
    terms by id — the host ``order_rows`` semantics); UNBOUND sorts last
    ascending and first descending (SQL NULLS LAST under negation); PAD
    rows keep sorting behind every valid row."""
    cap = b.capacity
    dev = b.data.device
    valid = _valid_mask(cap, b.n)
    nv = values.shape[0]
    dt = values.dtype
    ks = []
    for var, asc in reversed(tuple(keys)):
        if var not in b.cols:
            continue                      # unbound key: constant, no-op
        ids = b.data[:, b.cols.index(var)]
        if nv:
            safe = torch.clamp(ids, 0, nv - 1)
            ok = ids >= 0
            hi = torch.where(ok, values[safe, 2], ids.to(dt))
            lo = torch.where(ok, values[safe, 3],
                             torch.zeros((cap,), dtype=dt, device=dev))
        else:
            hi = ids.to(dt)
            lo = torch.zeros((cap,), dtype=dt, device=dev)
        hi = torch.where(ids == UNBOUND,
                         torch.tensor(float("inf"), dtype=dt, device=dev), hi)
        if not asc:
            hi, lo = -hi, -lo
        ks.append(lo)                     # minor half of the pair first
        ks.append(hi)                     # lexsort: later keys dominate
    if not ks:
        return b
    ks.append((~valid).to(_I32))                   # valid rows first
    order = _lexsort(ks)
    return JBindings(b.cols, b.data[order], b.n, b.overflow)


def device_slice(b: JBindings, offset: int, limit: Optional[int]) -> JBindings:
    """OFFSET/LIMIT: static row-window over the compacted relation.  A
    LIMIT below the buffer capacity also *trims the buffer*, so only the
    final ≤ limit rows ever transfer back to the host."""
    cap, k = b.data.shape
    data, n = b.data, b.n
    if offset:
        shift = min(int(offset), cap)
        data = torch.cat(
            [data[shift:], torch.full((shift, k), PAD, dtype=data.dtype,
                                      device=data.device)], dim=0)
        n = torch.clamp(n - offset, min=0)
    if limit is not None:
        n = torch.clamp(n, max=limit)
        if limit < cap:
            data = data[:max(int(limit), 0)]
    return JBindings(b.cols, data, n, b.overflow)


# ---------------------------------------------------------------------------
# Plan executor
# ---------------------------------------------------------------------------

def _step_meta(step: ScanStep) -> Tuple[Optional[int], Optional[int], bool,
                                        Tuple[int, ...], Tuple[str, ...]]:
    tp = step.tp
    s_bound = None if is_var(tp.s) else int(tp.s)
    o_bound = None if is_var(tp.o) else int(tp.o)
    same = is_var(tp.s) and is_var(tp.o) and tp.s == tp.o
    cols: List[str] = []
    take: List[int] = []
    if is_var(tp.s):
        cols.append(tp.s)
        take.append(0)
    if is_var(tp.o) and tp.o not in cols:
        cols.append(tp.o)
        take.append(1)
    return s_bound, o_bound, same, tuple(take), tuple(cols)


def _tt_meta(tp) -> Tuple[Optional[int], Optional[int], Optional[int],
                          Tuple[Tuple[int, int], ...], Tuple[int, ...],
                          Tuple[str, ...]]:
    """Static scan metadata of a triples-table step: per-position bound
    constants (presence is static; s/o VALUES ride the runtime bounds
    array, the predicate is static), repeated-variable equality
    selections, and the projected (s, p, o)-first-seen columns."""
    terms = (tp.s, tp.p, tp.o)
    s_b, p_b, o_b = (None if is_var(t) else int(t) for t in terms)
    cols: List[str] = []
    take: List[int] = []
    eqs: List[Tuple[int, int]] = []
    first: Dict[str, int] = {}
    for i, t in enumerate(terms):
        if not is_var(t):
            continue
        if t in first:
            eqs.append((first[t], i))
        else:
            first[t] = i
            cols.append(t)
            take.append(i)
    return s_b, p_b, o_b, tuple(eqs), tuple(take), tuple(cols)


def _step_cols(step: ScanStep) -> Tuple[str, ...]:
    if step.uses_tt:
        return _tt_meta(step.tp)[5]
    return _step_meta(step)[4]


def bounds_from_plan(plan: Plan) -> np.ndarray:
    """Per-step (s, o) bound-constant values, UNBOUND where the slot is a
    variable — the runtime argument vector of a launch."""
    out = np.full((len(plan.steps), 2), UNBOUND, dtype=np.int32)
    for i, step in enumerate(plan.steps):
        if not is_var(step.tp.s):
            out[i, 0] = int(step.tp.s)
        if not is_var(step.tp.o):
            out[i, 1] = int(step.tp.o)
    return out


def _pipeline_cols(plan: Plan) -> Tuple[str, ...]:
    """Variables the scan/join pipeline produces, first-seen order."""
    cols: List[str] = []
    for step in plan.steps:
        for v in _step_cols(step):
            if v not in cols:
                cols.append(v)
    return tuple(cols)


def _exec_cols(seg: CoreSeg) -> Tuple[str, ...]:
    """Columns the device evaluation of a segment produces, in pipeline
    order (scan order within a BGP; left-then-right-only for combines)."""
    if isinstance(seg, EmptySeg):
        return tuple(seg.vars)
    if isinstance(seg, BGPSeg):
        return _pipeline_cols(seg.plan)
    if isinstance(seg, FilterSeg):
        return _exec_cols(seg.child)
    left = _exec_cols(seg.left)
    return left + tuple(c for c in _exec_cols(seg.right) if c not in left)


def _mod_cap_seed(spine: ModifierSpine, pipeline_cap: int) -> int:
    """Initial capacity of the modifier resize slot: generous around the
    slice window when there is one, a modest constant otherwise; never
    beyond the pipeline buffer and never below 1/32 of it, so the
    overflow-retry loop reaches any true result size within its doubling
    budget."""
    if spine.limit is not None:
        est = max(64, 4 * (spine.offset + spine.limit))
    else:
        est = 4096
    est = max(est, pipeline_cap // 32)
    return min(round_up_pow2(est, 64), round_up_pow2(pipeline_cap, 64))


def double_caps(caps: Tuple[int, ...], ovf, n_steps: int) -> Tuple[int, ...]:
    """One overflow-retry step: double every overflowing capacity.  The
    modifier resize slot (index ``n_steps``, when present) additionally
    keeps pace with the pipeline caps, so the two growth phases do not
    run in series and exhaust the retry budget on explosive joins."""
    new = [c * 2 if ovf[i] else c for i, c in enumerate(caps)]
    if len(new) > n_steps and n_steps:
        pipe_max = max(new[:n_steps])
        new[n_steps] = min(max(new[n_steps], pipe_max // 4),
                           round_up_pow2(pipe_max, 64))
    return tuple(new)


_Shared = Dict[int, Tuple[JBindings,
                          Optional[Tuple[torch.Tensor, torch.Tensor]]]]


@dataclass
class _Inputs:
    """Device-resident inputs of one executor, uploaded once."""

    rows: List[torch.Tensor]         # per step: (cap, 2) int32, PAD tail
    s_cols: List[torch.Tensor]       # per step: contiguous subject column
    ns: List[torch.Tensor]           # per step: () int32 valid count
    tt_rows: torch.Tensor            # (cap, 3) int32 (empty without TT steps)
    tt_n: torch.Tensor
    values: torch.Tensor             # (nv, 4) float32 numeric keys


class PlanExecutor:
    """Runs the static-capacity program of a compiled core on one device.

    Accepts either a flat :class:`Plan` (a single BGP) or a
    :class:`CorePlan` segment tree covering FILTER/OPTIONAL/UNION cores
    and unbound-predicate (TT) scans.

    ``caps[i]`` for ``i < len(plan.steps)`` bounds the output of flat
    step i within its BGP segment (a segment's first step compacts to
    its cap; joins within the segment write at the following caps);
    combine segments (join/left/union) get their own capacity slots
    behind the flat steps, in evaluation (post-) order, and a modifier
    spine that sorts gets one more.  ``run`` retries with doubled caps
    on overflow, per overflowing slot, and the grown caps persist.

    Bound s/o constants enter as a device ``bounds`` array and filter
    constants as a device ``fconsts`` vector, so every instantiation of a
    query template runs through one executor — ``run(bounds=...)``
    re-binds by changing inputs only.
    """

    bounds_from_plan = staticmethod(bounds_from_plan)

    def __init__(self, plan, catalog: Catalog, slack: float = 1.5,
                 spine: Optional[ModifierSpine] = None, device="cpu"):
        if isinstance(plan, CorePlan):
            core = plan
        else:
            core = CorePlan(root=BGPSeg(plan=plan, start=0), flat=plan,
                            empty=plan.empty, vars=plan.vars)
        if core.empty:
            raise ValueError("cannot build executor for statistics-empty plan")
        self.device = torch.device(device)
        self.core = core
        self.plan = core.flat      # what template re-binding operates on
        self.catalog = catalog
        self.spine = spine if spine is not None else ModifierSpine()
        self._pipe_cols = _exec_cols(core.root)
        self._out_vars = tuple(self.spine.project) \
            if self.spine.project is not None else self._pipe_cols
        self._core_filters = core_filter_exprs(core.root)
        self._all_filters = tuple(self._core_filters) + \
            tuple(self.spine.filters)
        self.filter_slots = filter_const_slots(self._all_filters)
        # raises NotImplementedError only for dictionaries whose numeric
        # keys defeat the double-single pairs
        self._value_keys = prepare_value_keys(catalog, self.spine,
                                              self._all_filters)
        # DISTINCT/ORDER BY sort the whole buffer; the spine starts from
        # its own small capacity slot (an overflow-checked resize before
        # the sorts, appended to ``caps`` so the retry protocol grows it)
        self._mod_resize = bool(self.spine.distinct or self.spine.order)
        self.tables = [
            None if step.uses_tt
            else catalog.table(step.kind, int(step.tp.p), step.p2)
            for step in self.plan.steps]
        self._has_tt = any(s.uses_tt for s in self.plan.steps)
        n_flat = len(self.plan.steps)
        flat_caps = [16] * n_flat
        comb_caps: List[int] = []
        self._comb_index: Dict[int, int] = {}

        def seed(seg: CoreSeg) -> float:
            if isinstance(seg, EmptySeg):
                return 1.0
            if isinstance(seg, FilterSeg):
                return seed(seg.child)
            if isinstance(seg, BGPSeg):
                est = 1.0
                for k, step in enumerate(seg.plan.steps):
                    i = seg.start + k
                    size = catalog.n_triples if step.uses_tt \
                        else len(self.tables[i])
                    scan_est = max(1.0, float(size))
                    if step.tp.n_bound() > 1:
                        scan_est = max(1.0, scan_est * 0.01)
                    est = scan_est if k == 0 else \
                        max(est, scan_est, est * 1.25)
                    flat_caps[i] = round_up_pow2(int(est * slack) + 8, 16)
                return est
            le, re_ = seed(seg.left), seed(seg.right)
            if seg.kind == "join":
                est = 1.25 * max(le, re_)
            elif seg.kind == "left":
                # inner rows plus (worst case) every left row unmatched
                est = 1.25 * max(le, re_) + le
            else:
                est = le + re_
            self._comb_index[id(seg)] = n_flat + len(comb_caps)
            comb_caps.append(round_up_pow2(int(est * slack) + 8, 16))
            return est

        seed(core.root)
        self.caps = flat_caps + comb_caps
        self._n_pipeline = len(self.caps)
        if self._mod_resize:
            pipe_cap = max(self.caps) if self.caps else 64
            self.caps.append(_mod_cap_seed(self.spine, pipe_cap))
        self._default_bounds = bounds_from_plan(self.plan)

    def fconsts_from_mapping(self, mapping=None) -> np.ndarray:
        """Runtime filter-constant vector for one binding: template
        placeholder ids resolve through ``mapping``, concrete ids pass
        through — the filter counterpart of ``bounds_from_plan``."""
        m = mapping or {}
        return np.asarray([m.get(c, c) for c in self.filter_slots],
                          dtype=np.int32)

    def _apply_spine(self, b: JBindings, values: torch.Tensor,
                     fconsts: torch.Tensor, caps: Tuple[int, ...],
                     ctr: List[int]
                     ) -> Tuple[JBindings, Optional[torch.Tensor]]:
        """FILTER* → [resize] → ORDER BY → project → DISTINCT →
        OFFSET/LIMIT, the canonical host sequence on the static relation
        (ordering precedes projection so sort keys outside the SELECT
        list work).  ``ctr`` is the fconsts cursor, shared with the
        core's filters (which consume their slots first).  Returns the
        relation and the resize step's overflow flag (None when the spine
        needs no sorts)."""
        sp = self.spine
        for expr in sp.filters:
            b = device_filter(b, expr, values, fconsts, ctr)
        mod_ovf = None
        if self._mod_resize:
            b, mod_ovf = device_resize(b, caps[self._n_pipeline])
        if sp.order:
            b = device_order(b, sp.order, values)
        b = device_project(b, self._out_vars)
        if sp.distinct:
            b = device_distinct(b)
        if sp.has_slice:
            b = device_slice(b, sp.offset, sp.limit)
        return b, mod_ovf

    # -- the program -----------------------------------------------------------
    def _scan_step(self, i: int, step: ScanStep, first: bool, inp: _Inputs,
                   bounds: torch.Tensor, caps: Tuple[int, ...]) -> JBindings:
        """One scan, picking the windowed form when the subject is bound
        (tables are subject-sorted); TT steps scan the shared padded
        triples table.  ``first`` marks the first step of a BGP segment,
        which compacts to its own capacity slot."""
        if step.uses_tt:
            s_b, p_b, o_b, eqs, take, cols = _tt_meta(step.tp)
            out_cap = caps[i] if first else inp.tt_rows.shape[0]
            sb = bounds[i, 0] if s_b is not None else None
            ob = bounds[i, 1] if o_b is not None else None
            data, n, ovf = device_scan_tt(inp.tt_rows, inp.tt_n, sb, p_b, ob,
                                          eqs, take, out_cap)
            return JBindings(cols, data, n, ovf)
        s_bound, o_bound, same, take, cols = _step_meta(step)
        out_cap = caps[i] if first else inp.rows[i].shape[0]
        sb = bounds[i, 0] if s_bound is not None else None
        ob = bounds[i, 1] if o_bound is not None else None
        if s_bound is not None and o_bound is None:
            data, n, ovf = device_scan_windowed(inp.rows[i], inp.ns[i], sb,
                                                take, out_cap, inp.s_cols[i])
        else:
            data, n, ovf = device_scan(inp.rows[i], inp.ns[i], sb, ob,
                                       same, take, out_cap)
        return JBindings(cols, data, n, ovf)

    def _compose_bgp(self, seg: BGPSeg, caps: Tuple[int, ...], inp: _Inputs,
                     bounds: torch.Tensor, ovfs: List[torch.Tensor],
                     shared: _Shared) -> JBindings:
        """The scan/join pipeline of one BGP segment.  Overflow is
        recorded PER STEP into ``ovfs`` (at the step's flat index) so the
        host retry doubles only the capacities that actually overflowed.
        ``shared`` maps flat step index -> precomputed (relation,
        presorted join key) for bounds-independent scans (empty for the
        single-request program)."""
        no = _false(self.device)
        if not seg.plan.steps:
            # empty BGP: the unit relation (one empty solution mapping)
            return JBindings((), torch.zeros((8, 0), dtype=_I32,
                                             device=self.device),
                             _scalar(1, self.device), no)
        acc: Optional[JBindings] = None
        for k, step in enumerate(seg.plan.steps):
            i = seg.start + k
            if i in shared:
                cur, pre = shared[i]
            else:
                cur = self._scan_step(i, step, k == 0, inp, bounds, caps)
                pre = None
            if acc is None:
                acc = cur
                ovfs[i] = cur.overflow
            else:
                # strip sticky input flags: we want this join's OWN overflow
                joined = device_join(
                    JBindings(acc.cols, acc.data, acc.n, no),
                    JBindings(cur.cols, cur.data, cur.n, no), caps[i],
                    b_presorted=pre)
                ovfs[i] = joined.overflow | cur.overflow
                acc = joined
        assert acc is not None
        return JBindings(acc.cols, acc.data, acc.n, no)

    def _eval_seg(self, seg: CoreSeg, caps: Tuple[int, ...], inp: _Inputs,
                  bounds: torch.Tensor, fconsts: torch.Tensor,
                  ctr: List[int], ovfs: List[torch.Tensor],
                  shared: _Shared) -> JBindings:
        """Evaluate the core segment tree to one static relation.  Each
        combine writes its own overflow flag at its capacity index;
        child flags are recorded at the children, so every returned
        relation carries a clean (False) sticky flag."""
        no = _false(self.device)
        if isinstance(seg, EmptySeg):
            k = len(seg.vars)
            return JBindings(tuple(seg.vars),
                             torch.full((8, k), PAD, dtype=_I32,
                                        device=self.device),
                             _scalar(0, self.device), no)
        if isinstance(seg, BGPSeg):
            return self._compose_bgp(seg, caps, inp, bounds, ovfs, shared)
        if isinstance(seg, FilterSeg):
            b = self._eval_seg(seg.child, caps, inp, bounds, fconsts, ctr,
                               ovfs, shared)
            return device_filter(b, seg.expr, inp.values, fconsts, ctr)
        left = self._eval_seg(seg.left, caps, inp, bounds, fconsts, ctr,
                              ovfs, shared)
        right = self._eval_seg(seg.right, caps, inp, bounds, fconsts, ctr,
                               ovfs, shared)
        ci = self._comb_index[id(seg)]
        if seg.kind == "join":
            out = device_join(left, right, caps[ci])
        elif seg.kind == "left":
            out = device_left_join(left, right, caps[ci], seg.expr,
                                   inp.values, fconsts, ctr)
        else:
            out = device_union(left, right, caps[ci])
        ovfs[ci] = out.overflow
        return JBindings(out.cols, out.data, out.n, no)

    def _program(self, caps: Tuple[int, ...], inp: _Inputs,
                 bounds: torch.Tensor, fconsts: torch.Tensor,
                 shared: _Shared
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One binding, end to end on the device: (data, n, overflow
        flags per capacity slot)."""
        ctr = [0]
        ovfs: List[torch.Tensor] = [_false(self.device)] * self._n_pipeline
        b = self._eval_seg(self.core.root, caps, inp, bounds, fconsts, ctr,
                           ovfs, shared)
        b, mod_ovf = self._apply_spine(b, inp.values, fconsts, caps, ctr)
        if mod_ovf is not None:
            ovfs = ovfs + [mod_ovf]
        stacked = torch.stack(ovfs) if ovfs else \
            torch.zeros((0,), dtype=torch.bool, device=self.device)
        return b.data, b.n, stacked

    @functools.cached_property
    def _device_inputs(self) -> _Inputs:
        """Device-resident padded tables, their subject columns, the
        (optional) padded triples table and the numeric key table,
        uploaded ONCE per executor — a launch must not re-pad and
        re-transfer O(table) bytes."""
        dev = self.device
        rows, s_cols, ns = [], [], []
        for t in self.tables:
            if t is None:
                r = torch.zeros((0, 2), dtype=_I32, device=dev)
            else:
                r = torch.from_numpy(
                    pad_rows(t.rows, round_up_pow2(len(t)))).to(dev)
            rows.append(r)
            s_cols.append(r[:, 0].contiguous())
            ns.append(_scalar(0 if t is None else len(t), dev))
        if self._has_tt:
            tt = np.asarray(self.catalog.tt, dtype=np.int32)
            tt_rows = torch.from_numpy(
                pad_rows(tt, round_up_pow2(max(len(tt), 1)))).to(dev)
            tt_n = _scalar(len(tt), dev)
        else:
            tt_rows = torch.zeros((0, 3), dtype=_I32, device=dev)
            tt_n = _scalar(0, dev)
        values = torch.from_numpy(self._value_keys).to(dev)
        return _Inputs(rows, s_cols, ns, tt_rows, tt_n, values)

    def _hoist(self, inp: _Inputs) -> _Shared:
        """The shared phase of a batched launch: bounds-independent scans
        (constants only enter scan selection values, so a step whose
        pattern binds no constant gives every batch element the same
        relation) and the build-side presort of the joins that consume
        them, computed once per launch."""
        shared: _Shared = {}

        def hoist(seg: CoreSeg) -> None:
            if isinstance(seg, FilterSeg):
                hoist(seg.child)
                return
            if isinstance(seg, CombineSeg):
                hoist(seg.left)
                hoist(seg.right)
                return
            if not isinstance(seg, BGPSeg):
                return
            acc_cols: List[str] = []
            for k, step in enumerate(seg.plan.steps):
                i = seg.start + k
                if step.uses_tt:
                    s_b, p_b, o_b, eqs, take, cols = _tt_meta(step.tp)
                    indep = k > 0 and s_b is None and o_b is None
                    if indep:
                        data, n, ovf = device_scan_tt(
                            inp.tt_rows, inp.tt_n, None, p_b, None, eqs,
                            take, inp.tt_rows.shape[0])
                        cur = JBindings(cols, data, n, ovf)
                else:
                    s_bound, o_bound, same, take, cols = _step_meta(step)
                    indep = k > 0 and s_bound is None and o_bound is None
                    if indep:
                        data, n, ovf = device_scan(
                            inp.rows[i], inp.ns[i], None, None, same,
                            take, inp.rows[i].shape[0])
                        cur = JBindings(cols, data, n, ovf)
                if indep:
                    # the join key device_join will pick: first
                    # accumulated column present on the build side
                    key = next((c for c in acc_cols if c in cols), None)
                    pre = None
                    if key is not None:
                        pre = _presort(build_key(cur, cols.index(key)))
                    shared[i] = (cur, pre)
                for c in cols:
                    if c not in acc_cols:
                        acc_cols.append(c)

        hoist(self.core.root)
        return shared

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def run(self, max_retries: int = 16,
            bounds: Optional[np.ndarray] = None,
            fconsts: Optional[np.ndarray] = None
            ) -> Tuple[np.ndarray, Tuple[str, ...]]:
        """Execute one binding; returns the result rows (host numpy) and
        their columns.  The host syncs once per launch, for the row
        count and the overflow flags, then copies the rows back."""
        inp = self._device_inputs
        b = self._default_bounds if bounds is None else \
            np.asarray(bounds, dtype=np.int32).reshape(self._default_bounds.shape)
        fc = self.fconsts_from_mapping(None) if fconsts is None else \
            np.asarray(fconsts, dtype=np.int32).reshape(len(self.filter_slots))
        bj, fj = self._to_device(b), self._to_device(fc)
        caps = tuple(self.caps)
        for _ in range(max_retries):
            data, n, ovf = self._program(caps, inp, bj, fj, {})
            head = torch.cat([n.reshape(1), ovf.to(_I32)]).cpu().numpy()
            if not head[1:].any():
                # keep grown caps: a hot template must not pay the
                # overflow->retry double-launch on every request
                self.caps = list(caps)
                return data[:int(head[0])].cpu().numpy(), self._final_cols()
            caps = double_caps(caps, head[1:].astype(bool), self._n_pipeline)
        raise RuntimeError("join capacity overflow after retries")

    def run_batch(self, bounds_batch: Sequence[np.ndarray],
                  fconsts_batch: Optional[Sequence[np.ndarray]] = None,
                  max_retries: int = 16
                  ) -> List[Tuple[np.ndarray, Tuple[str, ...]]]:
        """Execute B constant-bindings of this template in one launch:
        the bounds-independent scans and their build-side presorts run
        once (:meth:`_hoist`), then each binding's constant-dependent
        work runs in turn on the same stream, and the host syncs once at
        the end.  Overflow on *any* batch element retries the whole
        batch with doubled caps — the batch shares one cap vector."""
        if not bounds_batch:
            return []
        inp = self._device_inputs
        shape = self._default_bounds.shape
        bb = np.stack([np.asarray(b, dtype=np.int32).reshape(shape)
                       for b in bounds_batch])
        n_fc = len(self.filter_slots)
        if fconsts_batch is None:
            fb = np.tile(self.fconsts_from_mapping(None), (len(bb), 1))
        else:
            fb = np.stack([np.asarray(f, dtype=np.int32).reshape(n_fc)
                           for f in fconsts_batch])
        bj, fj = self._to_device(bb), self._to_device(fb)
        caps = tuple(self.caps)
        for _ in range(max_retries):
            shared = self._hoist(inp)
            outs = [self._program(caps, inp, bj[i], fj[i], shared)
                    for i in range(len(bb))]
            head = torch.stack([torch.cat([n.reshape(1), ovf.to(_I32)])
                                for _, n, ovf in outs]).cpu().numpy()
            ovf_any = head[:, 1:].any(axis=0)
            if not ovf_any.any():
                self.caps = list(caps)
                cols = self._final_cols()
                return [(data[:int(head[i, 0])].cpu().numpy(), cols)
                        for i, (data, _, _) in enumerate(outs)]
            caps = double_caps(caps, ovf_any, self._n_pipeline)
        raise RuntimeError("join capacity overflow after retries (batched)")

    def _final_cols(self) -> Tuple[str, ...]:
        return self._out_vars
