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

Every operator carries a leading batch axis: a relation is ``data[B,
cap, k]``, ``n[B]``, ``overflow[B]``, one row per constant-binding of a
query template, so B bindings run as one launch sequence — the
reference's ``jax.vmap`` over its program, written out with explicit
batch indices.  A single request is a batch of one.

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
    BGPSeg, CombineSeg, CorePlan, CoreSeg, DeviceUnsupported, EmptySeg,
    FilterSeg, Plan, ScanStep, core_filter_exprs,
)
from repro_torch.core.modifiers import ModifierSpine, filter_const_slots
from repro_torch.core.stats import Catalog
from repro_torch.core.table import pad_rows, round_up_pow2
from repro_torch.device import resolve_device
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
# DeviceUnsupported.
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
        raise DeviceUnsupported(
            f"{what} is not double-single distinguishable; numeric "
            "modifiers would diverge from the host engines")


def numeric_value_keys(dictionary) -> np.ndarray:
    """The device numeric-key table: float32 ``(nv, 4)`` of
    ``[cmp_hi, cmp_lo, ord_hi, ord_lo]`` per term id.  The cmp pair is
    NaN for non-numeric terms (comparisons drop those rows); the ord pair
    falls back to the term id (the host ``order_rows`` key).  Cached on
    the dictionary; raises DeviceUnsupported when the pair encoding
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
    """Static-capacity relations of a batch of B bindings: cols are host
    metadata, the rest lives on the device.  Row b of ``data`` is binding
    b's relation: its valid rows at ``[0, n[b])``, PAD rows behind."""

    cols: Tuple[str, ...]
    data: torch.Tensor       # (B, cap, k) int32
    n: torch.Tensor          # (B,) int32
    overflow: torch.Tensor   # (B,) bool — sticky across operators

    @property
    def capacity(self) -> int:
        return self.data.shape[1]

    @property
    def batch(self) -> int:
        return self.data.shape[0]


def _false(device, *shape) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.bool, device=device)


def _scalar(v: int, device, *shape) -> torch.Tensor:
    return torch.full(shape, v, dtype=_I32, device=device)


def _valid_mask(cap: int, n: torch.Tensor) -> torch.Tensor:
    """``(..., cap)``: row i is valid iff ``i < n`` (``n`` () or (B,))."""
    return torch.arange(cap, dtype=_I32, device=n.device) < n.unsqueeze(-1)


@functools.lru_cache(maxsize=64)
def _rows(batch: int, device) -> torch.Tensor:
    """(B, 1) batch index: the first index of a per-binding gather (one
    per batch size and device, made once: a query's operators would
    otherwise launch one each)."""
    return torch.arange(batch, device=device)[:, None]


def _broadcast(b: JBindings, batch: int) -> JBindings:
    """A relation every binding shares (a scan that binds no constant is
    one relation, batch 1) as a batch of ``batch`` rows: views, no copy."""
    if b.batch == batch:
        return b
    return JBindings(b.cols, b.data.expand(batch, -1, -1),
                     b.n.expand(batch), b.overflow.expand(batch))


def _cumsum_rows(x: torch.Tensor) -> torch.Tensor:
    """Inclusive int32 prefix sum along each row of a ``(B, N)`` tensor.
    A batch is one scan over the flattened rows less each row's base, not
    a scan along the last dimension: on the card torch scans a last
    dimension with one block for up to 32 rows, so a few long rows would
    leave the device idle, while the flat scan runs device-wide.  The
    flat sums are int64 unless ``x`` is a mask whose sum fits int32."""
    batch, n = x.shape
    if batch == 1 or n == 0:
        return torch.cumsum(x, 1, dtype=_I32)
    wide = x.dtype != torch.bool or batch * n > 2**31 - 1
    flat = torch.cumsum(x.reshape(-1), 0,
                        dtype=torch.int64 if wide else _I32).view(batch, n)
    flat -= torch.cat([flat.new_zeros(1), flat[:-1, -1]])[:, None]
    return flat.to(_I32)


def _compact(data: torch.Tensor, keep: torch.Tensor, out_cap: int,
             fill: int = PAD
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Move each binding's keep-rows to its front (stable); returns
    ``(data (B, out_cap, k), n (B,), overflow (B,))``.  ``keep`` is
    ``(B, R)``; ``data`` is ``(B, R, k)``, or ``(R, k)`` when every
    binding selects from one table.  A kept row's slot is its rank among
    its binding's kept rows (an inclusive prefix sum along the row), so
    this is the stable partition of the reference's argsort without the
    sort; dropped rows and rows past ``out_cap`` go to a dump slot that
    is cut off.  Rows are scattered to their slots; when B bindings
    select from one table the scatter writes row numbers instead, and
    one gather fetches the kept rows, so the table is never copied B
    times."""
    batch, r = keep.shape
    k = data.shape[-1]
    dev = keep.device
    n_keep = keep.sum(1, dtype=_I32)
    pos = _cumsum_rows(keep) - 1
    dest = torch.where(keep & (pos < out_cap), pos, out_cap)
    if batch > 1:
        # flat slots: int64 once the batch's buffer passes int32
        flat = torch.int64 if batch * (out_cap + 1) > 2**31 - 1 else _I32
        dest = dest.to(flat) + torch.arange(
            0, batch * (out_cap + 1), out_cap + 1, dtype=flat,
            device=dev)[:, None]
    if data.dim() == 3 or batch == 1 or r == 0:
        out = torch.full((batch * (out_cap + 1), k), fill, dtype=data.dtype,
                         device=dev)
        out[dest.reshape(-1)] = data.reshape(batch * r, k) \
            if data.dim() == 3 else data
    else:
        src = torch.full((batch * (out_cap + 1),), r, dtype=_I32,
                         device=dev)
        src[dest.reshape(-1)] = torch.arange(r, dtype=_I32,
                                             device=dev).repeat(batch)
        live = src < r
        out = torch.where(live[:, None], data[torch.where(live, src, 0)],
                          fill)
    out = out.view(batch, out_cap + 1, k)[:, :out_cap]
    return out, torch.clamp(n_keep, max=out_cap), n_keep > out_cap


def _selected(rows: torch.Tensor, n: torch.Tensor,
              eqs_to: Sequence[Tuple[int, torch.Tensor]]) -> torch.Tensor:
    """``(B', cap)`` keep-mask of a table scan: valid rows whose column
    ``c`` equals the binding's constant for each ``(c, consts)`` of
    ``eqs_to`` (``consts`` a (B,) column, or a scalar for a batch of
    one); B' is 1 when no constant is bound."""
    keep = _valid_mask(rows.shape[0], n)[None]
    for c, consts in eqs_to:
        keep = keep & (rows[:, c] == consts.reshape(-1, 1))
    return keep


def device_scan(rows: torch.Tensor, n: torch.Tensor, s_bound, o_bound,
                same_var: bool, out_cols: Sequence[int], out_cap: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Select + project one (s, o) table (Algorithm 2, device form) for
    every binding of a batch.  ``s_bound``/``o_bound`` are ``None``
    (statically unbound) or the batch's (B,) int32 device column of
    constants, so one executor serves every instantiation of a query
    template (constant re-binding).  Returns ``(data, n, overflow)`` of
    batch B, or of batch 1 when no constant is bound (every binding
    selects the same rows)."""
    keep = _selected(rows, n, [(c, v) for c, v in ((0, s_bound),
                                                    (1, o_bound))
                               if v is not None])
    if same_var:
        keep = keep & (rows[:, 0] == rows[:, 1])
    projected = rows[:, list(out_cols)] if out_cols else rows[:, :0]
    return _compact(projected, keep, out_cap)


def build_key(b: JBindings, key_col: int) -> torch.Tensor:
    """The build-side join-key column ``(B, cap)`` with NULL/pad
    sentinels applied — the input of the build-side sort.  Exposed so a
    batched run can presort a *shared* (bounds-independent) build
    relation once and reuse it for every batch element (see
    ``device_join``'s ``b_presorted``)."""
    kb = b.data[:, :, key_col]
    kb = torch.where(kb == UNBOUND, B_NULL, kb)
    return torch.where(_valid_mask(b.capacity, b.n), kb, B_SENT)


def _presort(kb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(order_b, kb_sorted): the stable ascending order of a build key
    along its last axis (equal keys keep their row order, which sets the
    output row order): ``(cap,)`` for a build every binding shares,
    ``(B, cap)`` for one build a binding."""
    order = torch.argsort(kb, dim=-1, stable=True)
    return order.to(_I32), torch.gather(kb, -1, order)


def device_scan_windowed(rows: torch.Tensor, n: torch.Tensor, s_bound,
                         out_cols: Sequence[int], out_cap: int,
                         s_col: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Bound-subject scan over a subject-sorted table: each binding's
    matching rows are one contiguous window found by binary search and
    need no compact, so the cost is O(B log T + B out_cap) instead of a
    full-table mask and compact.  ``s_bound`` holds the batch's subjects
    ((B,), or a scalar for a batch of one).  PAD rows sort after every
    valid id, so the search never needs the valid count.  Only usable
    without an object post-filter: overflow is the raw window width vs
    ``out_cap``.  ``s_col`` is the table's contiguous subject column
    (uploaded once with the table); without it the column is copied out
    of ``rows``."""
    cap = rows.shape[0]
    dev = rows.device
    col = rows[:, 0].contiguous() if s_col is None else s_col
    sb = torch.as_tensor(s_bound, dtype=_I32, device=dev).reshape(-1) \
        .contiguous()
    lo = torch.searchsorted(col, sb, out_int32=True)
    hi = torch.searchsorted(col, sb, right=True, out_int32=True)
    idx = lo[:, None] + torch.arange(out_cap, dtype=_I32, device=dev)
    keep = idx < hi[:, None]
    g = rows[torch.clamp(idx, 0, cap - 1)]
    projected = g[..., list(out_cols)] if out_cols else g[..., :0]
    data = torch.where(keep[..., None], projected, PAD)
    return data, torch.clamp(hi - lo, max=out_cap), hi - lo > out_cap


def _join_expand(a: JBindings, b: JBindings, out_cap: int,
                 b_presorted: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """Shared expansion machinery of the join family: pair every probe
    row with its build-side matches into ``out_cap`` output slots, in
    each binding of the batch.

    Returns ``(out_cols, data, a_idx, valid, total, needs_compact)``:
    ``a_idx[b, j]`` is the probe row that produced slot ``j`` of binding
    ``b``, ``valid`` the kept-slot mask, ``total`` the true (uncapped)
    match count per binding.  When ``needs_compact`` is False the valid
    slots are already contiguous at the front (``valid == j < total``).
    A ``b_presorted`` build key of shape ``(cap_b,)`` is one build every
    binding shares: the probe then takes one build for the batch."""
    shared = [c for c in a.cols if c in b.cols]
    b_only = [c for c in b.cols if c not in a.cols]
    out_cols = a.cols + tuple(b_only)
    dev = a.data.device
    rows = _rows(a.batch, dev)

    cap_a, cap_b = a.capacity, b.capacity
    j = torch.arange(out_cap, dtype=_I32, device=dev)
    if not shared:  # cross join (rare; bounded by caps)
        bn = torch.clamp(b.n, min=1)[:, None]
        a_idx = torch.clamp(j // bn, 0, cap_a - 1)
        b_idx = torch.clamp(j % bn, 0, cap_b - 1)
        total = a.n * b.n
        valid = j < total[:, None]
        data = torch.cat([a.data[rows, a_idx], b.data[rows, b_idx]], dim=2)
        return out_cols, data, a_idx, valid, total, False

    ka = a.data[:, :, a.cols.index(shared[0])]
    ka = torch.where(ka == UNBOUND, A_NULL, ka)
    ka = torch.where(_valid_mask(cap_a, a.n), ka, A_SENT)
    if b_presorted is None:
        order_b, kb_sorted = _presort(build_key(b, b.cols.index(shared[0])))
    else:
        order_b, kb_sorted = b_presorted
    lo, cnt = ops.join_probe(ka.contiguous(), kb_sorted.contiguous())
    ends = _cumsum_rows(cnt)                     # inclusive prefix
    prefix = ends - cnt                          # exclusive prefix
    total = ends[:, -1]

    # rank search: which probe row produced output slot j
    a_idx = torch.searchsorted(ends, j.expand(a.batch, out_cap).contiguous(),
                               right=True, out_int32=True)
    a_idx = torch.clamp(a_idx, 0, cap_a - 1)
    off = j - prefix[rows, a_idx]
    b_pos = torch.clamp(lo[rows, a_idx] + off, 0, cap_b - 1)
    b_idx = order_b[b_pos] if order_b.dim() == 1 else order_b[rows, b_pos]
    valid = j < total[:, None]

    # the probe rows, and of the build rows only the columns the join
    # reads: the shared ones beyond the key, then the build-only ones
    data = a.data[rows, a_idx]
    need = [b.cols.index(c) for c in shared[1:] + b_only]
    right = b.data[rows[..., None], b_idx[..., None],
                   torch.tensor(need, device=dev)] if need else None

    # post-filter shared columns beyond the key (SQL NULL semantics)
    for i, c in enumerate(shared[1:]):
        va = data[..., a.cols.index(c)]
        valid &= (va == right[..., i]) & (va != UNBOUND)

    if b_only:
        data = torch.cat([data, right[..., len(shared) - 1:]], dim=2)
    return out_cols, data, a_idx, valid, total, bool(shared[1:])


def device_join(a: JBindings, b: JBindings, out_cap: int,
                b_presorted: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> JBindings:
    """Natural join of two static relations (sort-merge, rank expansion),
    binding by binding.

    ``b_presorted`` is an optional ``(order_b, kb_sorted)`` pair from
    :func:`build_key` + stable sort, letting a batched run hoist the
    build-side sort out of the batch when ``b`` does not depend on the
    bound constants."""
    out_cols, data, _, valid, total, needs_compact = _join_expand(
        a, b, out_cap, b_presorted)
    if needs_compact:
        data, n, ovf = _compact(data, valid, out_cap)
    else:
        # matches are contiguous at j < total: masking replaces the
        # compact (in place: ``data`` is the expansion's own buffer)
        data.masked_fill_(~valid[..., None], PAD)
        n = torch.clamp(total, max=out_cap).to(_I32)
        ovf = _false(data.device, a.batch)
    return JBindings(out_cols, data, n,
                     a.overflow | b.overflow | ovf | (total > out_cap))


def device_left_join(a: JBindings, b: JBindings, out_cap: int,
                     expr: Optional[FilterExpr] = None,
                     values: Optional[torch.Tensor] = None,
                     fconsts: Optional[torch.Tensor] = None,
                     ctr: Optional[List[int]] = None,
                     b_presorted: Optional[Tuple[torch.Tensor, torch.Tensor]]
                     = None) -> JBindings:
    """OPTIONAL: left-outer join.  In each binding, inner rows first
    (probe-major, build rows in original order — the natural-join
    order), then each unmatched probe row once, UNBOUND-padded on the
    build-only columns, in probe order — the host ``left_outer_join``
    sequence.

    ``expr`` is OPTIONAL's join condition: it filters the INNER rows
    only (a probe row whose matches all fail the condition comes out
    unmatched), with constants riding the shared runtime ``fconsts``.
    ``b_presorted`` is :func:`device_join`'s: a build every binding
    shares, sorted once."""
    out_cols, data, a_idx, valid, total, _ = _join_expand(a, b, out_cap,
                                                          b_presorted)
    batch, cap_a = a.batch, a.capacity
    dev = data.device
    if expr is not None:
        inner = JBindings(out_cols, data, _scalar(out_cap, dev, batch),
                          _false(dev, batch))
        valid = valid & _filter_mask(expr, inner, values, fconsts, ctr)

    # matched set: scatter hit flags through a_idx (invalid slots are
    # routed to a dump slot so clipped indices cannot pollute the flags)
    hit = torch.zeros((batch, cap_a + 1), dtype=torch.bool, device=dev)
    hit[_rows(batch, dev), torch.where(valid, a_idx, cap_a)] = True
    unmatched = _valid_mask(cap_a, a.n) & ~hit[:, :cap_a]

    k_b = len(out_cols) - len(a.cols)
    tail = a.data if not k_b else torch.cat(
        [a.data, torch.full((batch, cap_a, k_b), UNBOUND, dtype=_I32,
                            device=dev)], dim=2)
    buf = torch.cat([data, tail], dim=1)
    keep = torch.cat([valid, unmatched], dim=1)
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
            return x.data[:, :, :0]
        arrs = [x.data[:, :, x.cols.index(c)] if c in x.cols
                else torch.full((x.batch, cap), UNBOUND, dtype=_I32,
                                device=x.data.device) for c in cols]
        d = torch.stack(arrs, dim=2)
        return torch.where(_valid_mask(cap, x.n)[..., None], d, PAD)

    buf = torch.cat([lift(a), lift(b)], dim=1)
    keep = torch.cat([_valid_mask(a.capacity, a.n),
                      _valid_mask(b.capacity, b.n)], dim=1)
    data, n, ovf = _compact(buf, keep, out_cap)
    return JBindings(cols, data, n, a.overflow | b.overflow | ovf)


def device_scan_tt(rows: torch.Tensor, n: torch.Tensor, s_bound, p_bound,
                   o_bound, eqs: Sequence[Tuple[int, int]],
                   take: Sequence[int], out_cap: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Select + project over the (N, 3) triples table — the unbound-
    predicate scan (and the ``layout="tt"`` baseline scan).  Bound s/o
    constants are (B,) device columns like :func:`device_scan`'s (and
    give batch 1 when neither is bound); the bound predicate of a
    TT-layout scan is a Python int (predicates are plan identity and
    never template-rebindable).  ``eqs`` carries the repeated-variable
    equality selections of patterns like ``?x ?p ?x``."""
    keep = _selected(rows, n, [(c, v) for c, v in ((0, s_bound),
                                                    (2, o_bound))
                               if v is not None])
    if p_bound is not None:
        keep = keep & (rows[:, 1] == p_bound)
    for i, j in eqs:
        keep = keep & (rows[:, i] == rows[:, j])
    projected = rows[:, list(take)] if take else rows[:, :0]
    return _compact(projected, keep, out_cap)


# ---------------------------------------------------------------------------
# Solution modifiers on device (the spine of repro_torch.core.modifiers)
#
# All five operators keep the JBindings invariant — in each binding,
# valid rows occupy [0, n) contiguously with PAD rows behind — and none
# can overflow (a modifier never grows the relation), so the per-step
# overflow/retry protocol of the scan/join pipeline is untouched.
# ---------------------------------------------------------------------------

def _filter_operand(b: JBindings, values: torch.Tensor, term, numeric: bool,
                    fconsts: torch.Tensor, ctr: List[int]):
    """(ids, numeric (hi, lo) key pair) for one comparison operand, each
    ``(B, cap)``.  Constant ids are read from column ``ctr`` of the
    batch's ``(B, n_fc)`` ``fconsts`` (slot order fixed by
    :func:`repro_torch.core.modifiers.filter_const_slots`), so re-binding
    a template constant changes only an input; float literals are part
    of the template text.  A variable the relation does not bind is
    UNBOUND everywhere."""
    batch, cap = b.batch, b.capacity
    dev = b.data.device
    nv = values.shape[0]
    dt = values.dtype
    nan = torch.tensor(float("nan"), dtype=dt, device=dev)
    if isinstance(term, str):            # variable
        if term in b.cols:
            ids = b.data[:, :, b.cols.index(term)]
        else:
            ids = torch.full((batch, cap), UNBOUND, dtype=_I32, device=dev)
        if not numeric:
            return ids, None
        if nv:
            safe = torch.clamp(ids, 0, nv - 1)
            ok = ids >= 0
            hi = torch.where(ok, values[safe, 0], nan)
            lo = torch.where(ok, values[safe, 1], nan)
        else:
            hi = torch.full((batch, cap), float("nan"), dtype=dt, device=dev)
            lo = hi
        return ids, (hi, lo)
    if isinstance(term, float):          # numeric literal
        fhi, flo = _split_scalar(term)
        return None, (
            torch.full((batch, cap), float(fhi), dtype=dt, device=dev),
            torch.full((batch, cap), float(flo), dtype=dt, device=dev))
    tid = fconsts[:, ctr[0]]             # constant ids -> runtime slot
    ctr[0] += 1
    ids = tid[:, None].expand(batch, cap)
    if not numeric:
        return ids, None
    if nv:
        ok = (tid >= 0) & (tid < nv)
        safe = torch.clamp(tid, 0, nv - 1)
        hi = torch.where(ok, values[safe, 0], nan)
        lo = torch.where(ok, values[safe, 1], nan)
    else:
        hi = nan.expand(batch)
        lo = hi
    return ids, (hi[:, None].expand(batch, cap), lo[:, None].expand(batch, cap))


def _filter_mask(expr: FilterExpr, b: JBindings, values: torch.Tensor,
                 fconsts: torch.Tensor, ctr: List[int]) -> torch.Tensor:
    """Boolean ``(B, cap)`` keep-mask over the relation's rows: identity
    comparison on ids, numeric comparison through the dictionary's
    double-single key pairs, UNBOUND/type-error rows dropped.  NaN key
    pairs make every comparison false, matching host NaN semantics."""
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
            return _false(b.data.device, b.batch, b.capacity)
        return b.data[:, :, b.cols.index(expr.var)] != UNBOUND
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
    batch, cap = b.batch, b.capacity
    if not out_vars:
        return JBindings((), b.data[:, :, :0], b.n, b.overflow)
    cols = [b.data[:, :, b.cols.index(v)] if v in b.cols
            else torch.full((batch, cap), UNBOUND, dtype=_I32,
                            device=b.data.device)
            for v in out_vars]
    data = torch.stack(cols, dim=2)
    data = torch.where(_valid_mask(cap, b.n)[..., None], data, PAD)
    return JBindings(tuple(out_vars), data, b.n, b.overflow)


def device_resize(b: JBindings, out_cap: int
                  ) -> Tuple[JBindings, torch.Tensor]:
    """Re-buffer the relation to ``out_cap`` rows — a pure truncation or
    PAD extension (valid rows are contiguous at the front).  Returns the
    relation and an overflow flag per binding for the retry protocol:
    DISTINCT/ORDER BY sort this buffer, so right-sizing it keeps
    modifier queries from sorting a join-sized buffer of mostly-PAD
    rows."""
    batch, cap, k = b.data.shape
    if out_cap < cap:
        data = b.data[:, :out_cap]
    elif out_cap > cap:
        data = torch.cat(
            [b.data, torch.full((batch, out_cap - cap, k), PAD,
                                dtype=b.data.dtype, device=b.data.device)],
            dim=1)
    else:
        data = b.data
    ovf = b.n > out_cap
    return JBindings(b.cols, data, torch.clamp(b.n, max=out_cap),
                     b.overflow), ovf


def _lexsort(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """``np.lexsort`` order along the last axis (the LAST key is the
    primary one) as chained stable sorts from the least significant key
    up; each binding's row sorts on its own."""
    order = torch.argsort(keys[0], dim=-1, stable=True)
    for key in keys[1:]:
        order = torch.gather(order, -1, torch.argsort(
            torch.gather(key, -1, order), dim=-1, stable=True))
    return order


def device_distinct(b: JBindings) -> JBindings:
    """DISTINCT: lexsort + adjacent-unique to find duplicates, then a
    stable compact of the FIRST occurrence of each distinct row in the
    original order — the host first-occurrence-stable dedup, so an order
    established before it survives."""
    batch, cap, k = b.data.shape
    if k == 0:   # zero-column relation: dedup of n empty mappings is one
        return JBindings(b.cols, b.data, torch.clamp(b.n, max=1), b.overflow)
    dev = b.data.device
    valid = _valid_mask(cap, b.n)
    keys = [b.data[:, :, j] for j in range(k - 1, -1, -1)]
    keys.append((~valid).to(_I32))                 # valid rows first
    order = _lexsort(keys)
    sdata = b.data[_rows(batch, dev), order]
    svalid = torch.gather(valid, 1, order)
    same_prev = torch.cat([
        _false(dev, batch, 1),
        torch.all(sdata[:, 1:] == sdata[:, :-1], dim=2)], dim=1)
    keep = _false(dev, batch, cap).scatter_(1, order, svalid & ~same_prev)
    data, n, _ = _compact(b.data, keep, cap)
    return JBindings(b.cols, data, n, b.overflow)


def device_order(b: JBindings, keys: Sequence[Tuple[str, bool]],
                 values: torch.Tensor) -> JBindings:
    """ORDER BY: stable lexsort over the dictionary's double-single
    ``(ord_hi, ord_lo)`` key pairs (numeric literals by value, other
    terms by id — the host ``order_rows`` semantics); UNBOUND sorts last
    ascending and first descending (SQL NULLS LAST under negation); PAD
    rows keep sorting behind every valid row."""
    batch, cap = b.batch, b.capacity
    dev = b.data.device
    valid = _valid_mask(cap, b.n)
    nv = values.shape[0]
    dt = values.dtype
    ks = []
    for var, asc in reversed(tuple(keys)):
        if var not in b.cols:
            continue                      # unbound key: constant, no-op
        ids = b.data[:, :, b.cols.index(var)]
        zero = torch.zeros((batch, cap), dtype=dt, device=dev)
        if nv:
            safe = torch.clamp(ids, 0, nv - 1)
            ok = ids >= 0
            hi = torch.where(ok, values[safe, 2], ids.to(dt))
            lo = torch.where(ok, values[safe, 3], zero)
        else:
            hi = ids.to(dt)
            lo = zero
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
    return JBindings(b.cols, b.data[_rows(batch, dev), order], b.n,
                     b.overflow)


def device_slice(b: JBindings, offset: int, limit: Optional[int]) -> JBindings:
    """OFFSET/LIMIT: static row-window over each binding's compacted
    relation.  A LIMIT below the buffer capacity also *trims the
    buffer*, so only the final ≤ limit rows ever transfer back to the
    host."""
    batch, cap, k = b.data.shape
    data, n = b.data, b.n
    if offset:
        shift = min(int(offset), cap)
        data = torch.cat(
            [data[:, shift:], torch.full((batch, shift, k), PAD,
                                         dtype=data.dtype,
                                         device=data.device)], dim=1)
        n = torch.clamp(n - offset, min=0)
    if limit is not None:
        n = torch.clamp(n, max=limit)
        if limit < cap:
            data = data[:, :max(int(limit), 0)]
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
    re-binds by changing inputs only.  ``device=None`` means ``"cuda"``.
    """

    bounds_from_plan = staticmethod(bounds_from_plan)

    def __init__(self, plan, catalog: Catalog, slack: float = 1.5,
                 spine: Optional[ModifierSpine] = None, device=None):
        if isinstance(plan, CorePlan):
            core = plan
        else:
            core = CorePlan(root=BGPSeg(plan=plan, start=0), flat=plan,
                            empty=plan.empty, vars=plan.vars)
        if core.empty:
            raise ValueError("cannot build executor for statistics-empty plan")
        self.device = resolve_device(device)
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
        # raises DeviceUnsupported only for dictionaries whose numeric
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
        """One scan for every binding of the batch (``bounds`` is
        ``(B, n_steps, 2)``), picking the windowed form when the subject
        is bound (tables are subject-sorted); TT steps scan the shared
        padded triples table.  ``first`` marks the first step of a BGP
        segment, which compacts to its own capacity slot."""
        batch = bounds.shape[0]
        if step.uses_tt:
            s_b, p_b, o_b, eqs, take, cols = _tt_meta(step.tp)
            out_cap = caps[i] if first else inp.tt_rows.shape[0]
            sb = bounds[:, i, 0] if s_b is not None else None
            ob = bounds[:, i, 1] if o_b is not None else None
            data, n, ovf = device_scan_tt(inp.tt_rows, inp.tt_n, sb, p_b, ob,
                                          eqs, take, out_cap)
            return _broadcast(JBindings(cols, data, n, ovf), batch)
        s_bound, o_bound, same, take, cols = _step_meta(step)
        out_cap = caps[i] if first else inp.rows[i].shape[0]
        sb = bounds[:, i, 0] if s_bound is not None else None
        ob = bounds[:, i, 1] if o_bound is not None else None
        if s_bound is not None and o_bound is None:
            data, n, ovf = device_scan_windowed(inp.rows[i], inp.ns[i], sb,
                                                take, out_cap, inp.s_cols[i])
        else:
            data, n, ovf = device_scan(inp.rows[i], inp.ns[i], sb, ob,
                                       same, take, out_cap)
        return _broadcast(JBindings(cols, data, n, ovf), batch)

    def _compose_bgp(self, seg: BGPSeg, caps: Tuple[int, ...], inp: _Inputs,
                     bounds: torch.Tensor, ovfs: List[torch.Tensor],
                     shared: _Shared) -> JBindings:
        """The scan/join pipeline of one BGP segment.  Overflow is
        recorded PER STEP into ``ovfs`` (at the step's flat index) so the
        host retry doubles only the capacities that actually overflowed.
        ``shared`` maps flat step index -> precomputed (relation,
        presorted join key) for bounds-independent scans (empty for
        :meth:`run`)."""
        batch = bounds.shape[0]
        no = _false(self.device, batch)
        if not seg.plan.steps:
            # empty BGP: the unit relation (one empty solution mapping)
            return JBindings((), torch.zeros((batch, 8, 0), dtype=_I32,
                                             device=self.device),
                             _scalar(1, self.device, batch), no)
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
        batch = bounds.shape[0]
        no = _false(self.device, batch)
        if isinstance(seg, EmptySeg):
            k = len(seg.vars)
            return JBindings(tuple(seg.vars),
                             torch.full((batch, 8, k), PAD, dtype=_I32,
                                        device=self.device),
                             _scalar(0, self.device, batch), no)
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
        """B bindings, end to end on the device, from their ``(B, n_steps,
        2)`` bounds and ``(B, n_fc)`` filter constants: ``(data (B, cap,
        k), n (B,), overflow flags (B, capacity slots))``."""
        batch = bounds.shape[0]
        ctr = [0]
        ovfs: List[torch.Tensor] = [_false(self.device, batch)] * \
            self._n_pipeline
        b = self._eval_seg(self.core.root, caps, inp, bounds, fconsts, ctr,
                           ovfs, shared)
        b, mod_ovf = self._apply_spine(b, inp.values, fconsts, caps, ctr)
        if mod_ovf is not None:
            ovfs = ovfs + [mod_ovf]
        stacked = torch.stack(ovfs, dim=1) if ovfs else \
            _false(self.device, batch, 0)
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

    def _hoist(self, inp: _Inputs, batch: int) -> _Shared:
        """The shared phase of a batched launch: bounds-independent scans
        (constants only enter scan selection values, so a step whose
        pattern binds no constant gives every batch element the same
        relation) and the build-side presort of the joins that consume
        them, computed once per launch.  Each relation is a view of
        ``batch`` rows over one; each presort is one ``(cap,)`` key, so
        the join probes the whole batch against one build."""
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
                        pre = _presort(build_key(cur, cols.index(key))[0])
                    shared[i] = (_broadcast(cur, batch), pre)
                for c in cols:
                    if c not in acc_cols:
                        acc_cols.append(c)

        hoist(self.core.root)
        return shared

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def run(self, max_retries: int = 16,
            bounds: Optional[np.ndarray] = None,
            fconsts: Optional[np.ndarray] = None,
            trace=None) -> Tuple[np.ndarray, Tuple[str, ...]]:
        """Execute one binding; returns the result rows (host numpy) and
        their columns: the program at a batch of one, without the
        hoisted phase (:meth:`run_batch`)."""
        b = self._default_bounds if bounds is None else \
            np.asarray(bounds, dtype=np.int32).reshape(self._default_bounds.shape)
        fc = self.fconsts_from_mapping(None) if fconsts is None else \
            np.asarray(fconsts, dtype=np.int32).reshape(len(self.filter_slots))
        return self._launch(b[None], fc[None], False, max_retries, trace)[0]

    def run_batch(self, bounds_batch: Sequence[np.ndarray],
                  fconsts_batch: Optional[Sequence[np.ndarray]] = None,
                  max_retries: int = 16, trace=None
                  ) -> List[Tuple[np.ndarray, Tuple[str, ...]]]:
        """Execute B constant-bindings of this template as one launch
        sequence: the ``(B, n_steps, 2)`` bounds stack and the ``(B,
        n_fc)`` filter-constant stack are the only batched inputs (tables
        are shared), the bounds-independent scans and their build-side
        presorts run once (:meth:`_hoist`), and every operator runs once
        for the whole batch — the reference's vmapped program.  Overflow
        on *any* batch element retries the whole batch with doubled caps:
        the batch shares one cap vector."""
        if not bounds_batch:
            return []
        shape = self._default_bounds.shape
        bb = np.stack([np.asarray(b, dtype=np.int32).reshape(shape)
                       for b in bounds_batch])
        n_fc = len(self.filter_slots)
        if fconsts_batch is None:
            fb = np.tile(self.fconsts_from_mapping(None), (len(bb), 1))
        else:
            fb = np.stack([np.asarray(f, dtype=np.int32).reshape(n_fc)
                           for f in fconsts_batch])
        return self._launch(bb, fb, True, max_retries, trace)

    def _launch(self, bb: np.ndarray, fb: np.ndarray, hoist: bool,
                max_retries: int, trace
                ) -> List[Tuple[np.ndarray, Tuple[str, ...]]]:
        """The program over the bindings' ``(B, n_steps, 2)`` bounds and
        ``(B, n_fc)`` filter constants, retried with doubled caps while
        any binding overflows (``ovf.any(axis=0)``: the reference's
        rule), then each binding's rows copied back.  The host syncs once
        per attempt, for the ``(B, 1 + slots)`` head of row counts and
        overflow flags.  A sampled request's ``trace`` (a batch's lead
        request) gets one ``device.launch`` span per attempt, ended after
        that sync (the copy of the head waits for the stream), so a
        traced launch adds no synchronization."""
        inp = self._device_inputs
        bj, fj = self._to_device(bb), self._to_device(fb)
        batch = len(bb)
        caps = tuple(self.caps)
        for attempt in range(max_retries):
            sid = trace.start("device.launch", backend="torch",
                              attempt=attempt, batch=batch,
                              cap_slots=sum(caps)) \
                if trace is not None else None
            shared = self._hoist(inp, batch) if hoist else {}
            data, n, ovf = self._program(caps, inp, bj, fj, shared)
            head = torch.cat([n[:, None], ovf.to(_I32)], dim=1).cpu().numpy()
            ovf_any = head[:, 1:].any(axis=0)
            if trace is not None:
                trace.end(sid, overflow=bool(ovf_any.any()))
            if not ovf_any.any():
                # keep grown caps: a hot template must not pay the
                # overflow->retry double-launch on every request
                self.caps = list(caps)
                cols = self._final_cols()
                return [(data[i, :int(head[i, 0])].cpu().numpy(), cols)
                        for i in range(batch)]
            caps = double_caps(caps, ovf_any, self._n_pipeline)
        raise RuntimeError("join capacity overflow after retries" +
                           (" (batched)" if hoist else ""))

    def _final_cols(self) -> Tuple[str, ...]:
        return self._out_vars
