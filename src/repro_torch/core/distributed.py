"""Distributed query engine over ``torch.distributed``.

This maps S2RDF's Spark execution model onto a process group, one rank
per device, every rank running the same program on its own shard:

* **Storage partitioning.** Every VP/ExtVP table is hash-partitioned by
  subject id (``s % n_shards``) across the ranks — the analogue of HDFS
  blocks and Spark's hash partitioning.  Each rank keeps the host copy of
  the sharding and uploads only its own shard.  An optional
  object-partitioned copy (``dual_partition=True``) removes the shuffle
  for object-keyed probes.

* **Co-partitioned joins.** A join whose key both sides are already
  partitioned by runs locally with no exchange — subject-subject joins
  over s-partitioned tables, which is why star patterns make no shuffle.

* **Shuffle joins.** Otherwise the engine *repartitions* the relation(s)
  by the join key: rows go to rank ``uint32(key) % n_shards`` through
  fixed-capacity per-destination buckets and one ``all_to_all_single`` —
  a static-shape Spark shuffle.  The per-destination counts come from
  the hand-written bucket-count kernel (:func:`repro_torch.kernels.ops
  .bucket_count`).

Every rank runs the operators of :mod:`repro_torch.core.jexec` (the join
probe in its CUDA kernel) over a batch axis: B constant-bindings of a
template are one launch sequence on every rank, every shuffle one
bucket-count launch and one ``all_to_all_single`` for the batch, and a
request is a batch of one.  Results stay sharded until ``run`` /
``run_batch`` gathers them.  This is the PyTorch counterpart of the
reference's (vmapped) ``shard_map`` engine: the same names, capacity
seeds, overflow protocol and row order (shards concatenated in rank
order).  Collectives are issued in one
order on every rank, because the program's control flow depends only on
the plan and the capacity vector, and the capacity vector is the same on
every rank (the overflow flags are all-reduced before the host reads
them).

Backends: NCCL on the card, gloo on the CPU.  gloo also takes CUDA
tensors in ``all_to_all_single``, ``all_gather`` and ``all_reduce``
(checked on the H100), so ranks that share one card exchange over gloo
with no staging here.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.algebra import is_var
from repro_torch.core.compiler import (
    BGPSeg, CorePlan, CoreSeg, EmptySeg, FilterSeg, ScanStep,
    core_filter_exprs,
)
from repro_torch.core.jexec import (
    JBindings, bounds_from_plan, build_key, device_distinct, device_filter,
    device_join, device_left_join, device_order, device_project,
    device_resize, device_scan, device_scan_tt, device_slice, device_union,
    double_caps, prepare_value_keys, _broadcast, _compact, _exec_cols,
    _false, _mod_cap_seed, _presort, _rows, _scalar, _step_meta, _tt_meta,
    _valid_mask,
)
from repro_torch.core.modifiers import ModifierSpine, filter_const_slots
from repro_torch.core.stats import Catalog
from repro_torch.core.table import Table, round_up_pow2
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.obs import counters
from repro_torch.rdf.dictionary import PAD

__all__ = ["DistBindings", "DistributedExecutor", "shard_table",
           "repartition", "extvp_pair_masks_sharded", "exchanges",
           "reset_exchanges"]

_I32 = torch.int32
_I64 = torch.int64

#: ``all_to_all``: exchanges (``all_to_all_single`` calls) this process
#: made, one a shuffle of a whole batch; ``buffer_bytes``: the bytes of
#: their send buffers (static buckets, PAD included: a batch's buffer is
#: B times a binding's); ``rows_sent``: rows this rank put in other
#: ranks' buckets, each binding's counted, a shared (bounds-free)
#: relation's shuffle once, read at each launch's host sync
exchanges: Dict[str, int] = {"all_to_all": 0, "buffer_bytes": 0,
                             "rows_sent": 0}


def reset_exchanges() -> None:
    for k in exchanges:
        exchanges[k] = 0


def _require_initialized() -> None:
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "the distributed engine needs an initialized torch.distributed "
            "process group: call torch.distributed.init_process_group(...) "
            "first (nccl on the card, gloo on the CPU)")


def _all_gather_cat(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` (one shape on all ranks), concatenated along
    dim 0 in rank order.  An empty tensor needs no collective: its shape,
    the same on every rank, is the whole answer."""
    size = dist.get_world_size(group)
    if t.numel() == 0:
        return t.new_empty((size * t.shape[0],) + tuple(t.shape[1:]))
    parts = [torch.empty_like(t) for _ in range(size)]
    counters.note("all-gather", t)
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)


# ---------------------------------------------------------------------------
# Host-side table sharding (storage layout)
# ---------------------------------------------------------------------------

def shard_table(table, n_shards: int, by: int = 0,
                min_cap: int = 16) -> Tuple[np.ndarray, np.ndarray]:
    """Hash-partition rows by column ``by``; returns (rows[S, cap, k], n[S]).

    Accepts a :class:`repro_torch.core.table.Table` or a raw ``(N, k)``
    int32 array (the triples table of unbound-predicate scans)."""
    rows = table.rows if isinstance(table, Table) else np.asarray(table)
    k = rows.shape[1]
    dest = rows[:, by].astype(np.int64) % n_shards
    counts = np.bincount(dest, minlength=n_shards)
    cap = round_up_pow2(int(counts.max()) if len(rows) else 1, min_cap)
    out = np.full((n_shards, cap, k), PAD, dtype=np.int32)
    ns = np.zeros(n_shards, dtype=np.int32)
    order = np.argsort(dest, kind="stable")
    sorted_rows, sorted_dest = rows[order], dest[order]
    starts = np.searchsorted(sorted_dest, np.arange(n_shards))
    ends = np.searchsorted(sorted_dest, np.arange(n_shards), side="right")
    for i in range(n_shards):
        k = ends[i] - starts[i]
        out[i, :k] = sorted_rows[starts[i]:ends[i]]
        ns[i] = k
    return out, ns


# ---------------------------------------------------------------------------
# Repartitioning (the static-shape Spark shuffle)
# ---------------------------------------------------------------------------

def repartition(data: torch.Tensor, n: torch.Tensor, key_col: int, group,
                out_cap: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """Exchange rows so that ``uint32(row.key) % n_shards == rank``
    afterwards, for every binding of a batch.  ``data`` (B, cap, k) holds
    this rank's rows of B bindings, the first ``n[b]`` of row b valid.
    Returns ``(rows[B, out_cap, k], n (B,), overflow (B,), sent (B,))``:
    ``sent`` (int64, on the device) counts the rows each binding put in
    other ranks' buckets; the rest is the reference's return value, row
    by row (its vmapped ``repartition``).

    Buckets are static, as in the reference: ``bucket_cap`` rows for
    every destination and binding, so the whole batch is one
    ``all_to_all_single`` of equal splits and needs no host sync.  One
    bucket-count launch gives every binding's rows bound for each
    destination; their exclusive prefix sum along the row gives each
    destination group's start in the binding's stable sort by
    destination, so a row's slot in its bucket is its rank in that sort
    minus its group's start.  The send buffer is laid out destination
    first, ``(S, B, bucket_cap, k)``, so that rank r's split holds every
    binding's bucket for r; the receiver reorders it to ``(B, S ·
    bucket_cap, k)`` (source ranks in rank order) and compacts each row,
    which gives the reference's order: source-major, then stable by
    position.  A destination with more than ``bucket_cap`` rows sets its
    binding's ``overflow`` (its extra rows are not written) and the host
    retries with larger capacities.  The reference also reduces the flag
    across ranks here (``pmax``); the executor all-reduces every step's
    flag once per launch, which covers it."""
    n_shards = dist.get_world_size(group)
    batch, cap, k = data.shape
    dev = data.device
    valid = _valid_mask(cap, n)
    key = data[:, :, key_col].contiguous()
    # a valid row never carries the probe pad, so the kernel's pad rule
    # drops nothing that repartition sends
    counts = ops.bucket_count(key, valid, n_shards).to(_I64)
    # replint: disable=int32-overflow -- an int64 mask: the uint32 view of an int32 key, as the reference's bucket rule
    dest = torch.where(valid, (key.to(_I64) & 0xFFFFFFFF) % n_shards,
                       n_shards)
    bucket_cap = max(16, round_up_pow2(2 * cap // n_shards + 16))
    order = torch.argsort(dest, dim=1, stable=True)
    sdest = torch.gather(dest, 1, order)
    ends = torch.cumsum(counts, 1)
    # group starts; the invalid rows (dest == n_shards) start after all
    starts = torch.cat([ends - counts, ends[:, -1:]], 1)
    rank = torch.arange(cap, dtype=_I64, device=dev) - \
        torch.gather(starts, 1, sdest)
    overflow = (counts > bucket_cap).any(1)
    # flat int64 slot dest·(B·bucket_cap) + b·bucket_cap + rank; torch has
    # no dropping scatter, so rows out of bucket go to a dump row
    block = batch * bucket_cap
    fits = (rank < bucket_cap) & (sdest < n_shards)
    slot = torch.where(
        fits, sdest * block + rank + torch.arange(
            0, block, bucket_cap, dtype=_I64, device=dev)[:, None],
        n_shards * block)
    send = torch.full((n_shards * block + 1, k), PAD, dtype=data.dtype,
                      device=dev)
    send[slot.reshape(-1)] = data[_rows(batch, dev), order].reshape(-1, k)
    send = send[:-1]
    recv = torch.empty_like(send)
    counters.note("all-to-all", send)
    dist.all_to_all_single(recv, send, group=group)
    exchanges["all_to_all"] += 1
    exchanges["buffer_bytes"] += send.numel() * send.element_size()
    del send
    me = dist.get_rank(group)
    placed = torch.clamp(counts, max=bucket_cap)
    sent = placed.sum(1) - placed[:, me]
    recv = recv.view(n_shards, batch, bucket_cap, k).transpose(0, 1) \
        .reshape(batch, n_shards * bucket_cap, k)
    out, n_out, ovf = _compact(recv, recv[:, :, 0] != PAD, out_cap)
    return out, n_out, overflow | ovf, sent


# ---------------------------------------------------------------------------
# Distributed plan executor
# ---------------------------------------------------------------------------

@dataclass
class DistBindings:
    """This rank's shard of a relation of a batch of bindings: row b of
    ``data`` (B, cap, k), ``n`` (B,) and ``overflow`` (B,) is binding b's,
    as in :class:`~repro_torch.core.jexec.JBindings`.  A relation no
    bound constant reaches (a scan that binds none, and what is made of
    such relations alone) is the same for every binding and is kept as a
    batch of 1, as the reference's ``vmap`` keeps an unbatched value."""

    cols: Tuple[str, ...]
    data: torch.Tensor
    n: torch.Tensor
    overflow: torch.Tensor
    part_key: Optional[str]  # variable this relation is hash-partitioned by

    @property
    def batch(self) -> int:
        return self.data.shape[0]

    def rel(self, batch: int = 1) -> JBindings:
        """As jexec relations with a clean overflow flag, a shared
        relation broadcast (views) to ``batch`` rows."""
        return _broadcast(JBindings(self.cols, self.data, self.n,
                                    _false(self.data.device, self.batch)),
                          max(batch, self.batch))


@dataclass
class _DistInputs:
    """This rank's device-resident inputs, uploaded once."""

    rows: List[torch.Tensor]         # per step: (cap, k) int32, PAD tail
    ns: List[torch.Tensor]           # per step: () int32 valid count
    values: torch.Tensor             # (nv, 4) float32 numeric keys


def _shared_build(b: DistBindings, key: str, batch: int):
    """The presorted build key of a relation every binding shares, for
    the one-build form of the join probe; ``None`` for a build a row."""
    if b.batch == batch:
        return None
    return _presort(build_key(b.rel(), b.cols.index(key))[0])


class DistributedExecutor:
    """Executes a compiled plan over the ranks of a process group.

    ``group`` is a ``torch.distributed`` process group (``None``: the
    default group), which must be initialized; every rank of it builds
    the same executor and calls ``run`` / ``run_batch`` with the same
    arguments, and every rank gets the same rows back.  ``device`` is
    this rank's device (``None`` means ``"cuda"``).
    """

    bounds_from_plan = staticmethod(bounds_from_plan)

    def __init__(self, plan, catalog: Catalog, group=None,
                 slack: float = 2.0, dual_partition: bool = False,
                 spine: Optional[ModifierSpine] = None, device=None):
        if isinstance(plan, CorePlan):
            core = plan
        else:
            core = CorePlan(root=BGPSeg(plan=plan, start=0), flat=plan,
                            empty=plan.empty, vars=plan.vars)
        if core.empty:
            raise ValueError("statistics-empty plan")
        _require_initialized()
        self.core = core
        self.plan = core.flat      # what template re-binding operates on
        self.catalog = catalog
        self.group = group
        self.rank = dist.get_rank(group)
        self.n_shards = dist.get_world_size(group)
        self.device = resolve_device(device)
        self.dual_partition = dual_partition
        self.slack = slack
        # Solution modifiers: FILTER + projection are row-local and run
        # per shard; DISTINCT / ORDER BY / OFFSET / LIMIT need the whole
        # relation, so the (small, capacity-bounded) per-shard results
        # are all-gathered and the global modifiers run replicated.
        self.spine = spine if spine is not None else ModifierSpine()
        self._pipe_cols = _exec_cols(core.root)
        self._out_vars = tuple(self.spine.project) \
            if self.spine.project is not None else self._pipe_cols
        # core filters (OPTIONAL conditions, FILTER segments) consume
        # their fconsts slots first, then the spine's — one shared
        # runtime vector, evaluation order (see PlanExecutor)
        self._all_filters = tuple(core_filter_exprs(core.root)) + \
            tuple(self.spine.filters)
        self.filter_slots = filter_const_slots(self._all_filters)
        # raises DeviceUnsupported only for dictionaries whose numeric
        # keys defeat the double-single pairs
        self._value_keys = prepare_value_keys(catalog, self.spine,
                                              self._all_filters)
        self.gathered = self.spine.needs_global

        # storage: shard every referenced table by subject (and object);
        # TT steps (unbound predicates) share one subject-sharded copy of
        # the triples table
        plan_f = self.plan
        tt_sh: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self.table_shards: List[Dict[str, Tuple[np.ndarray, np.ndarray]]] = []
        sizes: List[float] = []
        for step in plan_f.steps:
            if step.uses_tt:
                if tt_sh is None:
                    tt_sh = shard_table(np.asarray(catalog.tt, np.int32),
                                        self.n_shards, by=0)
                self.table_shards.append({"s": tt_sh})
                sizes.append(float(catalog.n_triples))
                continue
            t = catalog.table(step.kind, int(step.tp.p), step.p2)
            shards = {"s": shard_table(t, self.n_shards, by=0)}
            if dual_partition:
                shards["o"] = shard_table(t, self.n_shards, by=1)
            self.table_shards.append(shards)
            sizes.append(float(len(t)))

        # per-shard capacity seeds: the PlanExecutor estimate chain
        # divided by the shard count (each shard holds ~1/S of every
        # relation); combine segments (join/left/union) get their own
        # slots behind the flat steps, in evaluation (post-) order
        n_flat = len(plan_f.steps)
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
                    scan_est = max(1.0, sizes[i] / self.n_shards)
                    if step.tp.n_bound() > 1:
                        scan_est = max(1.0, scan_est * 0.01)
                    est = scan_est if k == 0 else \
                        max(est, scan_est, est * 1.25)
                    flat_caps[i] = round_up_pow2(int(est * slack) + 16, 16)
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
            comb_caps.append(round_up_pow2(int(est * slack) + 16, 16))
            return est

        seed(core.root)
        self.caps = flat_caps + comb_caps
        self._n_pipeline = len(self.caps)
        # per-shard resize slot ahead of the gather: the global modifiers
        # then sort/compact S·mod_cap rows instead of S·join_cap (see
        # PlanExecutor; the slot rides the same overflow-retry protocol)
        self._mod_resize = self.gathered
        if self._mod_resize:
            pipe_cap = max(self.caps) if self.caps else 64
            self.caps.append(_mod_cap_seed(self.spine, pipe_cap))
        self._default_bounds = bounds_from_plan(plan_f)

        # Which storage copy each scan uses: simulate the plan's join-key
        # sequence and pick the copy whose partition variable IS the
        # upcoming join key — an object-keyed probe then reads the
        # o-partitioned copy and skips the exchange.  The simulation only
        # makes sense within one scan/join pipeline, so it applies when
        # the whole core is a single BGP (FILTER wrappers are
        # transparent); tree cores read the s-copy everywhere.
        self.scan_copy: List[str] = ["s"] * n_flat
        root_bgp: CoreSeg = core.root
        while isinstance(root_bgp, FilterSeg):
            root_bgp = root_bgp.child
        if dual_partition and isinstance(root_bgp, BGPSeg):
            steps = root_bgp.plan.steps
            acc_cols: List[str] = []
            for i, step in enumerate(steps):
                tp = step.tp
                if not step.uses_tt:   # the TT copy is subject-sharded only
                    join_key = None
                    if i > 0:
                        scan_vars = [v for v in (tp.s, tp.o) if is_var(v)]
                        shared = [c for c in acc_cols if c in scan_vars]
                        join_key = shared[0] if shared else None
                    elif len(steps) > 1:
                        # first scan: partition by the 2nd step's join var
                        nxt = steps[1].tp
                        nxt_vars = {v for v in (nxt.s, nxt.o) if is_var(v)}
                        for v in (tp.s, tp.o):
                            if is_var(v) and v in nxt_vars:
                                join_key = v
                                break
                    if join_key is not None and is_var(tp.o) \
                            and join_key == tp.o:
                        self.scan_copy[i] = "o"
                for v in (tp.s, tp.p, tp.o):
                    if is_var(v) and v not in acc_cols:
                        acc_cols.append(v)

    # -- this rank's program ----------------------------------------------------
    #
    # Every operator runs once for the whole batch of B bindings: bounds
    # are (B, n_steps, 2), filter constants (B, n_fc).  A relation keeps
    # batch 1 while no bound constant or filter constant reaches it, so a
    # bounds-free scan, its shuffle and whatever joins it with other such
    # relations run once a launch; it is broadcast (views) only where it
    # meets a bound relation, and as a join's build it is probed as one
    # build for every row.  Which relations are shared follows from the
    # plan alone, so every rank issues the same collectives in one order.

    @functools.cached_property
    def _device_inputs(self) -> _DistInputs:
        """This rank's shard of every scanned table (the copy
        :attr:`scan_copy` picked) and the numeric key table, uploaded
        once per executor."""
        dev = self.device
        rows, ns = [], []
        for shards, copy in zip(self.table_shards, self.scan_copy):
            r, n = shards[copy]
            rows.append(torch.from_numpy(
                np.ascontiguousarray(r[self.rank])).to(dev))
            ns.append(_scalar(int(n[self.rank]), dev))
        values = torch.from_numpy(self._value_keys).to(dev)
        return _DistInputs(rows, ns, values)

    def _filter_batch(self, expr, batch: int) -> int:
        """The batch a relation needs to go through ``expr``: every
        binding's row where the filter reads a constant slot, else 1."""
        if expr is not None and filter_const_slots((expr,)):
            return batch
        return 1

    def _scan_step(self, i: int, step: ScanStep, inp: _DistInputs,
                   bounds: torch.Tensor) -> DistBindings:
        """One shard-local scan for every binding (a batch of 1 when the
        pattern binds no constant).  TT steps (unbound predicates) read
        this rank's slice of the subject-sharded triples table; VP/ExtVP
        steps read the copy :attr:`scan_copy` picked."""
        tp = step.tp
        rows, nrows = inp.rows[i], inp.ns[i]
        if step.uses_tt:
            s_b, p_b, o_b, eqs, take, cols = _tt_meta(tp)
            sb = bounds[:, i, 0] if s_b is not None else None
            ob = bounds[:, i, 1] if o_b is not None else None
            data, n, ovf = device_scan_tt(rows, nrows, sb, p_b, ob, eqs,
                                          take, rows.shape[0])
            part_var = tp.s if is_var(tp.s) else None
            return DistBindings(cols, data, n, ovf, part_var)
        s_bound, o_bound, same, take, cols = _step_meta(step)
        data, n, ovf = device_scan(
            rows, nrows, bounds[:, i, 0] if s_bound is not None else None,
            bounds[:, i, 1] if o_bound is not None else None, same, take,
            rows.shape[0])
        copy = self.scan_copy[i]
        part_var = None
        if copy == "s" and is_var(tp.s):
            part_var = tp.s
        elif copy == "o" and is_var(tp.o):
            part_var = tp.o
        return DistBindings(cols, data, n, ovf, part_var)

    def _compose_bgp(self, seg: BGPSeg, caps, inp: _DistInputs, bounds,
                     ovfs: List[torch.Tensor], sent: List[torch.Tensor]
                     ) -> DistBindings:
        """The shard-local scan/join pipeline of one BGP segment; records
        each step's overflow at its flat index (see PlanExecutor)."""
        dev = self.device
        if not seg.plan.steps:
            # empty BGP: the unit relation (one empty solution mapping)
            # lives on rank 0 — anywhere else it would be counted S times
            return DistBindings((), torch.zeros((1, 8, 0), dtype=_I32,
                                                device=dev),
                                _scalar(int(self.rank == 0), dev, 1),
                                _false(dev, 1), None)
        acc: Optional[DistBindings] = None
        for k, step in enumerate(seg.plan.steps):
            i = seg.start + k
            cur = self._scan_step(i, step, inp, bounds)
            if acc is None:
                acc = cur
                ovfs[i] = cur.overflow
                continue
            joined = self._dist_join(acc, cur, caps[i], sent)
            ovfs[i] = joined.overflow | cur.overflow
            acc = joined
        return DistBindings(acc.cols, acc.data, acc.n,
                            _false(dev, acc.batch), acc.part_key)

    def _eval_seg(self, seg: CoreSeg, caps, inp: _DistInputs, bounds,
                  fconsts, ctr: List[int], ovfs: List[torch.Tensor],
                  sent: List[torch.Tensor]) -> DistBindings:
        """Evaluate the core segment tree to one shard-local relation;
        mirrors :meth:`repro_torch.core.jexec.PlanExecutor._eval_seg`
        with the combines going through the distributed (co-partition /
        gather) join family.  Each combine writes its own overflow flag
        at its capacity index, so returned relations carry clean flags."""
        dev = self.device
        values = inp.values
        if isinstance(seg, EmptySeg):
            k = len(seg.vars)
            return DistBindings(tuple(seg.vars),
                                torch.full((1, 8, k), PAD, dtype=_I32,
                                           device=dev),
                                _scalar(0, dev, 1), _false(dev, 1), None)
        if isinstance(seg, BGPSeg):
            return self._compose_bgp(seg, caps, inp, bounds, ovfs, sent)
        if isinstance(seg, FilterSeg):
            d = self._eval_seg(seg.child, caps, inp, bounds, fconsts, ctr,
                               ovfs, sent)
            jb = device_filter(
                d.rel(self._filter_batch(seg.expr, bounds.shape[0])),
                seg.expr, values, fconsts, ctr)
            return DistBindings(jb.cols, jb.data, jb.n,
                                _false(dev, jb.batch), d.part_key)
        left = self._eval_seg(seg.left, caps, inp, bounds, fconsts, ctr,
                              ovfs, sent)
        right = self._eval_seg(seg.right, caps, inp, bounds, fconsts, ctr,
                               ovfs, sent)
        ci = self._comb_index[id(seg)]
        if seg.kind == "join":
            out = self._dist_join(left, right, caps[ci], sent)
        elif seg.kind == "left":
            out = self._dist_left_join(
                left, right, caps[ci], seg.expr, values, fconsts, ctr, sent,
                self._filter_batch(seg.expr, bounds.shape[0]))
        else:
            out = self._dist_union(left, right, caps[ci])
        ovfs[ci] = out.overflow
        return DistBindings(out.cols, out.data, out.n,
                            _false(dev, out.batch), out.part_key)

    def _shard_program(self, caps, inp: _DistInputs, bounds, fconsts):
        """B bindings on this rank, from their ``(B, n_steps, 2)`` bounds
        and ``(B, n_fc)`` filter constants: ``(data (B, cap, k), n (B,),
        overflow flags (B, capacity slots) (this rank's), rows sent
        (B,))``.  Like :meth:`repro_torch.core.jexec.PlanExecutor
        ._program`, overflow is reported per capacity slot so the host
        retry doubles only the overflowing capacities; a shared
        relation's flag is every binding's."""
        batch = bounds.shape[0]
        dev = self.device
        ctr = [0]
        ovfs: List[torch.Tensor] = [_false(dev, 1)] * self._n_pipeline
        sent: List[torch.Tensor] = []
        acc = self._eval_seg(self.core.root, caps, inp, bounds, fconsts, ctr,
                             ovfs, sent)
        # a shared relation's shuffle sent its rows once: binding 0 has it
        first = torch.arange(batch, device=dev) == 0
        total_sent = torch.zeros(batch, dtype=_I64, device=dev)
        for s in sent:
            total_sent = total_sent + (s if s.shape[0] == batch
                                       else torch.where(first, s, 0))

        # shard-local modifiers: FILTER masks (+ projection when no
        # global modifier needs the un-projected sort keys)
        jb = acc.rel()
        for expr in self.spine.filters:
            jb = device_filter(
                _broadcast(jb, max(jb.batch,
                                   self._filter_batch(expr, batch))),
                expr, inp.values, fconsts, ctr)
        if not self.gathered:
            jb = _broadcast(device_project(jb, self._out_vars), batch)
            return jb.data, jb.n, self._flags(ovfs, batch), total_sent
        if self._mod_resize:
            jb, mod_ovf = device_resize(jb, caps[self._n_pipeline])
            ovfs = ovfs + [mod_ovf]

        # global modifiers: gather the (capacity-bounded) shard results,
        # compact, then ORDER BY → project → DISTINCT → OFFSET/LIMIT
        # replicated (ordering before projection, as on the host paths) —
        # only the final n ≤ limit rows ever reach the host
        gb = self._allgather_relation(
            DistBindings(jb.cols, jb.data, jb.n, jb.overflow, None)).rel()
        if self.spine.order:
            gb = device_order(gb, self.spine.order, inp.values)
        gb = device_project(gb, self._out_vars)
        if self.spine.distinct:
            gb = device_distinct(gb)
        if self.spine.has_slice:
            gb = device_slice(gb, self.spine.offset, self.spine.limit)
        gb = _broadcast(gb, batch)
        return gb.data, gb.n, self._flags(ovfs, batch), total_sent

    def _flags(self, ovfs: List[torch.Tensor], batch: int) -> torch.Tensor:
        """``(B, slots)``: each slot's flag, a shared one every row's."""
        if not ovfs:
            return _false(self.device, batch, 0)
        return torch.stack([o.expand(batch) for o in ovfs], dim=1)

    def _allgather_relation(self, b: DistBindings) -> DistBindings:
        """Gather a shard-local relation to every rank, each binding's
        valid rows first, rank by rank (the reference's
        ``_allgather_relation``): one ``all_gather`` of the ``(B, cap,
        k)`` rows and one of the ``(B,)`` counts for the batch.  Validity
        is positional — row i of a rank's block is live iff ``i < n`` of
        that rank — which also covers 0-column relations
        (fully-constant patterns) that have no PAD slot to test."""
        size = self.n_shards
        batch, cap, k = b.data.shape
        gdata = _all_gather_cat(b.data, self.group) \
            .view(size, batch, cap, k).transpose(0, 1) \
            .reshape(batch, size * cap, k)
        ns = _all_gather_cat(b.n, self.group).view(size, batch).t()
        keep = (torch.arange(cap, dtype=_I32, device=b.data.device)
                < ns[:, :, None]).reshape(batch, size * cap)
        data, n, _ = _compact(gdata, keep, size * cap)
        return DistBindings(b.cols, data, n,
                            _false(self.device, batch), None)

    def _dist_join(self, a: DistBindings, b: DistBindings, out_cap: int,
                   sent: List[torch.Tensor]) -> DistBindings:
        """Join two shard-local relations; the returned ``overflow`` is
        this step's OWN flag (repartition bucket/compact + join output) —
        input flags are not propagated, the caller tracks them per step."""
        batch = max(a.batch, b.batch)
        shared = [c for c in a.cols if c in b.cols]
        if not shared:
            # cross join: gather the (small) b side everywhere, then local
            jb = device_join(a.rel(batch), self._allgather_relation(b)
                             .rel(batch), out_cap)
            return DistBindings(jb.cols, jb.data, jb.n, jb.overflow,
                                a.part_key)
        key = shared[0]
        a, b, ovf = self._co_partition(a, b, key, out_cap, sent)
        jb = device_join(a.rel(batch), b.rel(batch), out_cap,
                         b_presorted=_shared_build(b, key, batch))
        return DistBindings(jb.cols, jb.data, jb.n, jb.overflow | ovf, key)

    def _co_partition(self, a: DistBindings, b: DistBindings, key: str,
                      out_cap: int, sent: List[torch.Tensor]):
        """Repartition each side not already partitioned by ``key`` (one
        shuffle of its whole batch; a shared relation's once)."""
        ovf = _false(self.device, 1)
        out = []
        for d in (a, b):
            if d.part_key != key:
                data, n, o, s = repartition(
                    d.data, d.n, d.cols.index(key), self.group,
                    max(d.data.shape[1], out_cap))
                d = DistBindings(d.cols, data, n, d.overflow, key)
                ovf = ovf | o
                sent.append(s)
            out.append(d)
        return out[0], out[1], ovf

    def _dist_left_join(self, a: DistBindings, b: DistBindings,
                        out_cap: int, expr, values, fconsts, ctr,
                        sent: List[torch.Tensor],
                        expr_batch: int) -> DistBindings:
        """OPTIONAL over shard-local relations.  With a shared variable
        both sides are co-partitioned on it first, so each probe row
        meets ALL its matches locally and the unmatched (UNBOUND-padded)
        tail is computed shard-locally too; without one the (small) b
        side is gathered everywhere — either way the per-shard row sets
        partition the global left-outer-join result exactly.  A
        condition that reads a constant slot makes the result every
        binding's (``expr_batch``)."""
        batch = max(a.batch, b.batch, expr_batch)
        shared = [c for c in a.cols if c in b.cols]
        if not shared:
            jb = device_left_join(
                a.rel(batch), self._allgather_relation(b).rel(batch),
                out_cap, expr, values, fconsts, ctr)
            return DistBindings(jb.cols, jb.data, jb.n, jb.overflow,
                                a.part_key)
        key = shared[0]
        a, b, ovf = self._co_partition(a, b, key, out_cap, sent)
        jb = device_left_join(a.rel(batch), b.rel(batch), out_cap, expr,
                              values, fconsts, ctr,
                              b_presorted=_shared_build(b, key, batch))
        return DistBindings(jb.cols, jb.data, jb.n, jb.overflow | ovf, key)

    def _dist_union(self, a: DistBindings, b: DistBindings,
                    out_cap: int) -> DistBindings:
        """UNION is shard-local (no collective): each rank concatenates
        its slices of both operands.  The partition key survives only
        when both sides are partitioned by the SAME variable (rows keep
        satisfying key % S == rank)."""
        batch = max(a.batch, b.batch)
        jb = device_union(a.rel(batch), b.rel(batch), out_cap)
        pk = a.part_key if (a.part_key is not None
                            and a.part_key == b.part_key) else None
        return DistBindings(jb.cols, jb.data, jb.n, jb.overflow, pk)

    # -- public API --------------------------------------------------------------
    def fconsts_from_mapping(self, mapping=None) -> np.ndarray:
        """Runtime filter-constant vector (see
        :meth:`repro_torch.core.jexec.PlanExecutor.fconsts_from_mapping`)."""
        m = mapping or {}
        return np.asarray([m.get(c, c) for c in self.filter_slots],
                          dtype=np.int32)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _sync(self, n: torch.Tensor, ovf: torch.Tensor, sent: torch.Tensor
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The one host sync of a launch: every binding's overflow flags,
        and every rank's row count and rows sent, in one
        ``all_reduce(MAX)`` of a ``(B, slots + 2S)`` head (a rank writes
        its own counts into its own column, zeros elsewhere) and one copy
        to the host.  Returns ``(flags (B, slots), n (B, S), sent (B,
        S))``, equal on every rank."""
        size = self.n_shards
        mine = torch.arange(size, device=self.device) == self.rank
        head = torch.cat([ovf.to(_I64),
                          torch.where(mine, n.to(_I64)[:, None], 0),
                          torch.where(mine, sent[:, None], 0)], dim=1)
        counters.note("all-reduce", head)
        dist.all_reduce(head, op=dist.ReduceOp.MAX, group=self.group)
        head = head.cpu().numpy()
        slots = head.shape[1] - 2 * size
        exchanges["rows_sent"] += int(head[:, slots + size + self.rank].sum())
        return head[:, :slots], head[:, slots:slots + size], \
            head[:, slots + size:]

    def _collect(self, data: torch.Tensor, ns: np.ndarray
                 ) -> List[np.ndarray]:
        """Every binding's result rows on every rank, from ``data`` (B,
        cap, k) and the synced counts ``ns`` (B, S): a gathered
        (replicated) result cut to its count; otherwise one
        ``all_gather`` of every binding's block, each padded to the
        largest count over the batch and the ranks, and each binding's
        rows concatenated in rank order."""
        batch, _, k = data.shape
        if self.gathered:
            counts = ns[:, :1]
        else:
            counts = ns
            top = int(ns.max())
            if k and top:
                parts = [torch.empty((batch, top, k), dtype=data.dtype,
                                     device=data.device)
                         for _ in range(self.n_shards)]
                mine = data[:, :top].contiguous()
                counters.note("all-gather", mine)
                dist.all_gather(parts, mine, group=self.group)
                data = torch.stack(parts, dim=1).view(batch, -1, k)
        if not k or not counts.max(initial=0):
            return [np.zeros((int(c.sum()), k), dtype=np.int32)
                    for c in counts]
        # each binding's live rows, rank by rank, in one copy to the host
        cap = data.shape[1] // counts.shape[1]
        live = torch.arange(cap, device=data.device) < torch.from_numpy(
            counts).to(data.device)[:, :, None]
        rows = data[live.view(batch, -1)].cpu().numpy()
        return np.split(rows, np.cumsum(counts.sum(1))[:-1])

    def run(self, max_retries: int = 16,
            bounds: Optional[np.ndarray] = None,
            fconsts: Optional[np.ndarray] = None,
            trace=None) -> Tuple[np.ndarray, Tuple[str, ...]]:
        """Execute one binding on every rank: the program at a batch of
        one.  Returns the result rows (host numpy, the same on every
        rank) and their columns.  A sampled request's ``trace`` gets one
        ``device.launch`` span per attempt, ended after the all-reduce's
        host read (see :meth:`repro_torch.core.jexec.PlanExecutor.run`)."""
        b = self._default_bounds if bounds is None else \
            np.asarray(bounds, dtype=np.int32).reshape(self._default_bounds.shape)
        fc = self.fconsts_from_mapping(None) if fconsts is None else \
            np.asarray(fconsts, dtype=np.int32).reshape(len(self.filter_slots))
        return self._launch(b[None], fc[None], max_retries, trace, "")[0]

    def run_batch(self, bounds_batch: Sequence[np.ndarray],
                  fconsts_batch: Optional[Sequence[np.ndarray]] = None,
                  max_retries: int = 16, trace=None
                  ) -> List[Tuple[np.ndarray, Tuple[str, ...]]]:
        """Execute B constant-bindings of the plan as one launch sequence
        on every rank — the reference's vmapped ``shard_map`` program:
        every operator sees the whole batch, every shuffle is one
        bucket-count launch and one ``all_to_all_single``, a bounds-free
        relation is shuffled once, and the gathers are one collective
        each.  Overflow on *any* binding retries the whole batch with
        doubled caps (``ovf.any(axis=0)``: the batch shares one cap
        vector); see :meth:`repro_torch.core.jexec.PlanExecutor
        .run_batch`."""
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
        return self._launch(bb, fb, max_retries, trace, " (batched)")

    def _launch(self, bb: np.ndarray, fb: np.ndarray, max_retries: int,
                trace, what: str
                ) -> List[Tuple[np.ndarray, Tuple[str, ...]]]:
        """The program over the bindings' bounds and filter constants,
        once per attempt, retried with doubled caps while any binding
        overflows, then every binding's rows gathered."""
        inp = self._device_inputs
        bj, fj = self._to_device(bb), self._to_device(fb)
        caps = tuple(self.caps)
        for attempt in range(max_retries):
            sid = trace.start("device.launch", backend="distributed",
                              attempt=attempt, batch=len(bb),
                              shards=self.n_shards,
                              cap_slots=sum(caps)) \
                if trace is not None else None
            data, n, ovf, sent = self._shard_program(caps, inp, bj, fj)
            flags, ns, _ = self._sync(n, ovf, sent)
            ovf_any = flags.any(axis=0)
            if trace is not None:
                trace.end(sid, overflow=bool(ovf_any.any()))
            if not ovf_any.any():
                self.caps = list(caps)   # keep grown caps across requests
                cols = self._final_cols()
                return [(rows, cols) for rows in self._collect(data, ns)]
            del data
            caps = double_caps(caps, ovf_any.astype(bool), self._n_pipeline)
        raise RuntimeError("distributed join capacity overflow after "
                           "retries" + what)

    def _final_cols(self) -> Tuple[str, ...]:
        return self._out_vars

    def lower(self, caps: Optional[Sequence[int]] = None
              ) -> Dict[str, object]:
        """The counterpart of the reference's ``lower(caps)``: what one
        launch of this plan costs this rank, at ``caps`` (``None``: the
        current caps), read from the launch itself.  One attempt of the
        default binding runs (no retry), then, unless a slot overflowed,
        the result gather, under :func:`repro_torch.obs.counters.record`
        and :class:`repro_torch.obs.counters.OpCounter`.  The
        reference lowers at those caps without running, so an overflow
        does not make the record wrong; it is reported as
        ``overflowed``.  Every rank of the group must call it, in one
        order.

        Returns ``caps``, ``overflowed``, ``collectives`` (the entries),
        ``traced_bytes`` and ``aten_ops`` (this rank's aten operators and
        the bytes they read and write; the hand-written kernels are not
        aten operators, so on the card their traffic is not in it),
        ``peak_bytes`` (the most bytes the attempt allocated that were
        live at once), ``argument_bytes`` (this rank's table shards,
        numeric keys, bounds and filter constants on the device) and
        ``output_bytes`` (the attempt's rows, counts and flags)."""
        caps = tuple(self.caps if caps is None else caps)
        inp = self._device_inputs
        bj = self._to_device(self._default_bounds[None])
        fj = self._to_device(self.fconsts_from_mapping(None)[None])
        args = list(inp.rows) + list(inp.ns) + [inp.values, bj, fj]
        with counters.record() as entries, counters.OpCounter() as counter:
            data, n, ovf, sent = self._shard_program(caps, inp, bj, fj)
            flags, ns, _ = self._sync(n, ovf, sent)
            overflowed = bool(flags.any())
            if not overflowed:
                self._collect(data, ns)
        return {"caps": list(caps), "overflowed": overflowed,
                "collectives": entries, "traced_bytes": counter.bytes,
                "aten_ops": counter.ops, "peak_bytes": counter.peak,
                "argument_bytes": sum(_nbytes(t) for t in args),
                "output_bytes": sum(_nbytes(t) for t in (data, n, ovf))}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# ---------------------------------------------------------------------------
# Distributed ExtVP construction (the load-job analogue of the query engine)
# ---------------------------------------------------------------------------

def _shares(n_keys: np.ndarray, n_shards: int) -> np.ndarray:
    """Cut points of ``n_shards`` contiguous shares of the pairs, each of
    about the same number of probe keys (the semi-join's work)."""
    cum = np.cumsum(n_keys)
    total = int(cum[-1]) if len(cum) else 0
    cuts = [int(np.searchsorted(cum, total * r // n_shards, side="right"))
            for r in range(1, n_shards)]
    return np.array([0, *cuts, len(n_keys)], dtype=np.int64)


def extvp_pair_masks_sharded(vp: Dict[int, Table], evals: Sequence,
                             threshold: float, group=None, device=None,
                             pair_batch: int = 512):
    """Semi-join every pair of ``evals`` with the (kind, p1, p2) pair grid
    split across the ranks of ``group``; returns ``(sf, sizes, tables)``
    as :func:`repro_torch.core.extvp_build.evaluate_pairs` does.

    S2RDF runs the §5 semi-join reductions as a distributed Spark job;
    here each rank takes a contiguous share of the pairs (about equal in
    probe keys) and runs ``evaluate_pairs``' device build over it — the
    semi-join kernel on the card.  The shares' match counts and
    materialized rows are then all-gathered in the pairs' order, and
    every rank computes SF and the τ test from the counts with the
    expression the single-device build uses, so every rank ends with the
    same catalog, byte-identical to the numpy build.  (The reference's
    function of this name returns the masks of one padded pair batch; no
    mask leaves a device here.)  Every rank must call it with the same
    arguments; ``device`` is this rank's device (``None``: ``"cuda"``).
    """
    from repro_torch.core.extvp_build import evaluate_pairs

    _require_initialized()
    size, me = dist.get_world_size(group), dist.get_rank(group)
    dev = resolve_device(device)
    evals = list(evals)
    n1s = np.array([len(vp[k[1]]) for k in evals], dtype=np.int64)
    cuts = _shares(n1s, size)
    share = evals[cuts[me]:cuts[me + 1]]
    _, sizes, tables = evaluate_pairs(vp, share, threshold, backend="torch",
                                      device=dev, pair_batch=pair_batch)
    # match counts of every pair, in pair order (shares padded to the
    # longest for the gather)
    longest = int(np.diff(cuts).max())
    local = np.zeros(longest, dtype=np.int64)
    local[:len(share)] = [sizes[k] for k in share]
    gathered = _all_gather_cat(torch.from_numpy(local).to(dev), group) \
        .cpu().numpy().reshape(size, longest)
    counts = np.concatenate([gathered[r, :cuts[r + 1] - cuts[r]]
                             for r in range(size)])
    sfv = np.where(n1s > 0, counts / np.maximum(n1s, 1), 0.0)
    which = np.nonzero((sfv > 0) & (sfv < 1.0) & (sfv <= threshold))[0]
    # the materialized rows of each share, in pair order, end to end
    per_rank = [int(counts[which[(which >= cuts[r]) & (which < cuts[r + 1])]]
                    .sum()) for r in range(size)]
    top = max(per_rank)
    tables_out: Dict = {}
    if top:
        mine = [tables[evals[j]].rows for j in which
                if cuts[me] <= j < cuts[me + 1]]
        block = np.zeros((top, 2), dtype=np.int32)
        if mine:
            block[:per_rank[me]] = np.concatenate(mine)
        allrows = _all_gather_cat(torch.from_numpy(block).to(dev), group) \
            .cpu().numpy().reshape(size, top, 2)
        rows = np.concatenate([allrows[r, :per_rank[r]]
                               for r in range(size)])
        bounds = np.cumsum(counts[which])[:-1]
        tables_out = {evals[j]: Table(r)
                      for j, r in zip(which, np.split(rows, bounds))}
    sf = dict(zip(evals, sfv.tolist()))
    sizes_out = dict(zip(evals, counts.tolist()))
    return sf, sizes_out, tables_out
