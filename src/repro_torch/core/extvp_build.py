"""Planned ExtVP construction (the paper's §5 load job): plan the pairs,
semi-join the ones that can match, materialize the reductions.

Two builds share the planning, the SF arithmetic and the τ test, so
they are byte-identical by construction:

* ``"numpy"`` — the host loop, one sorted-array semi-join per pair;
* ``"torch"`` — the device build.  The VP catalog is packed **once**
  into ragged device columns (:class:`PackedVP`): every predicate's s
  and o columns in row order, and its sorted unique s and o, each with
  int64 offsets.  Whole batches of (kind, p1, p2) pairs are then
  semi-joined in one launch of :func:`repro_torch.kernels.ops
  .semijoin_mask` (the hand-written kernel on CUDA, its plain version
  on the CPU), which also counts each pair's matches on the device.
  Only the counts come back to the host for the SF test; the rows of
  each pair that materializes are compacted on the device (a stable
  ``torch.nonzero`` keeps the s-order) and copied back in one piece.
  No mask is copied to the host;
* ``"distributed"`` — the device build with the pair grid split across
  the ranks of a ``torch.distributed`` process group
  (:func:`repro_torch.core.distributed.extvp_pair_masks_sharded`), each
  rank semi-joining its share on its own device.

Host-side work that remains mirrors the coordinating process of
S2RDF's Spark job: pair planning (the disjoint-entity-range
short-circuit) and SF bookkeeping.

:func:`incremental_pairs` supports ``Dataset.append_triples``: only the
pairs whose inputs actually changed — a touched predicate on the probe
side, or new build-side keys inside the probe side's entity range — are
recomputed; every other pair's SF/size/table is carried over verbatim.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Iterator, List, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.core.table import LazyTableMap, Table
from repro_torch.core.vp import (
    BUILD_BACKENDS, ExtVPBuild, KINDS, OS, SO, SS, _ranges_disjoint,
    _semijoin_mask,
)
from repro_torch.kernels import ops

__all__ = ["PackedVP", "pack_vp", "all_pair_keys", "plan_pairs",
           "probe_col", "build_col", "pair_descriptors", "evaluate_pairs",
           "build_extvp_planned", "incremental_pairs"]

Key = Tuple[str, int, int]


def probe_col(kind: str) -> int:
    """Which VP column (0 = s, 1 = o) the probe side of ``kind`` reads."""
    return 1 if kind == OS else 0


def build_col(kind: str) -> int:
    """Which unique-column (0 = s, 1 = o) the build side of ``kind`` reads."""
    return 1 if kind == SO else 0


# ---------------------------------------------------------------------------
# Packing: VP catalog -> ragged device columns
# ---------------------------------------------------------------------------

@dataclass
class PackedVP:
    """The VP catalog as ragged device columns.

    ``keys[key_off[c, i] : + n[i]]`` is predicate slot ``i``'s column
    ``c`` (0 = s, 1 = o) in **row order** (so a semi-join mask indexes
    the table's rows directly, and the two columns together are its
    rows).  ``uniq[uniq_off[c, i] : + uniq_n[c, i]]`` is the sorted
    unique values of that column.  Offsets are int64: the probe keys of
    one batch can exceed 2^31 in sum; a key stays int32.
    """

    slot: Dict[int, int]            # predicate id -> slot
    keys: torch.Tensor              # int32, every s column then every o column
    key_off: np.ndarray             # (2, P) int64
    n: np.ndarray                   # (P,) int64 rows per predicate
    uniq: torch.Tensor              # int32, sorted unique s / o columns
    uniq_off: np.ndarray            # (2, P) int64
    uniq_n: np.ndarray              # (2, P) int64


def _ragged(parts: List[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """Concatenate int32 parts; (flat, int64 offset of each part)."""
    lens = np.array([len(a) for a in parts], dtype=np.int64)
    off = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    flat = np.concatenate(parts).astype(np.int32) if parts else \
        np.zeros(0, dtype=np.int32)
    return flat, off


def pack_vp(vp: Dict[int, Table], device) -> PackedVP:
    """Upload every VP table's columns and sorted-unique key sets.

    This is the hoisted per-predicate work: each ``unique_s`` /
    ``unique_o`` sort happens once (``Table`` caches them, so the pair
    planning and a later numpy build reuse the same arrays), and each
    column is copied to the device once, however many pairs read it.
    """
    preds = tuple(sorted(vp))
    n_preds = len(preds)
    tables = [vp[p] for p in preds]
    keys, koff = _ragged([t.s for t in tables] + [t.o for t in tables])
    uniq, uoff = _ragged([t.unique_s for t in tables] +
                         [t.unique_o for t in tables])
    uniq_n = np.array([[len(t.unique_s) for t in tables],
                       [len(t.unique_o) for t in tables]],
                      dtype=np.int64).reshape(2, n_preds)
    return PackedVP(
        slot={p: i for i, p in enumerate(preds)},
        keys=torch.from_numpy(keys).to(device),
        key_off=koff.reshape(2, n_preds),
        n=np.array([len(t) for t in tables], dtype=np.int64),
        uniq=torch.from_numpy(uniq).to(device),
        uniq_off=uoff.reshape(2, n_preds), uniq_n=uniq_n)


# ---------------------------------------------------------------------------
# Pair planning (host; identical semantics for both builds)
# ---------------------------------------------------------------------------

def all_pair_keys(preds: Sequence[int],
                  kinds: Sequence[str] = KINDS) -> Iterator[Key]:
    """Every (kind, p1, p2) the schema defines, in the build's order
    (SS self-pairs are identity by definition and excluded, §5.2)."""
    for p1 in preds:
        for p2 in preds:
            for kind in kinds:
                if kind == SS and p1 == p2:
                    continue
                yield (kind, p1, p2)


def plan_pairs(vp: Dict[int, Table],
               keys_iter: Iterable[Key]) -> Tuple[List[Key], List[Key]]:
    """Split pairs into (pruned, evals): a pair whose probe-side and
    build-side entity ranges are disjoint is structurally empty (SF = 0)
    and never reaches a semi-join."""
    pruned: List[Key] = []
    evals: List[Key] = []
    for key in keys_iter:
        kind, p1, p2 = key
        t1, t2 = vp[p1], vp[p2]
        own = t1.unique_o if kind == OS else t1.unique_s
        other = t2.unique_o if kind == SO else t2.unique_s
        (pruned if _ranges_disjoint(own, other) else evals).append(key)
    return pruned, evals


# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------

def pair_descriptors(packed: PackedVP, evals: Sequence[Key]) -> np.ndarray:
    """int64 (P, 4) rows (probe_off, probe_len, build_off, build_len) of
    each pair into ``packed.keys`` / ``packed.uniq``: the ``pairs``
    argument of ``ops.semijoin_mask``."""
    out = np.zeros((len(evals), 4), dtype=np.int64)
    for j, (kind, p1, p2) in enumerate(evals):
        i1, i2 = packed.slot[p1], packed.slot[p2]
        pc, bc = probe_col(kind), build_col(kind)
        out[j] = (packed.key_off[pc, i1], packed.n[i1],
                  packed.uniq_off[bc, i2], packed.uniq_n[bc, i2])
    return out


def _materialize(packed: PackedVP, chunk: Sequence[Key], desc: np.ndarray,
                 mask: torch.Tensor, counts: np.ndarray,
                 which: np.ndarray) -> Dict[Key, Table]:
    """The rows of each pair in ``which``, compacted on the device in
    row order and copied back in one piece."""
    out_off = np.concatenate([[0], np.cumsum(desc[:, 1])]).astype(np.int64)
    parts = []
    for j in which:
        seg = mask[int(out_off[j]):int(out_off[j + 1])]
        idx = torch.nonzero(seg).squeeze(1)          # ascending: stable
        i1 = packed.slot[chunk[j][1]]
        s = packed.keys[int(packed.key_off[0, i1]) + idx]
        o = packed.keys[int(packed.key_off[1, i1]) + idx]
        parts.append(torch.stack([s, o], dim=1))
    rows = torch.cat(parts).cpu().numpy()
    bounds = np.cumsum(counts[which])[:-1]
    return {chunk[j]: Table(r)
            for j, r in zip(which, np.split(rows, bounds))}


def evaluate_pairs(vp: Dict[int, Table], evals: Sequence[Key],
                   threshold: float, backend: str = "numpy",
                   device=None, pair_batch: int = 512, group=None,
                   ) -> Tuple[Dict[Key, float], Dict[Key, int],
                              Dict[Key, Table]]:
    """Semi-join every pair in ``evals``; returns (sf, sizes, tables).

    ``backend="numpy"`` is the host loop; ``"torch"`` batches the pair
    grid on ``device`` (a CUDA device launches the semi-join kernel, the
    CPU runs its plain version), at most ``pair_batch`` pairs a launch;
    ``"distributed"`` splits the pairs across the ranks of the process
    group ``group`` (``None``: the default group), each rank running the
    ``"torch"`` build over its share on ``device``.
    """
    if backend not in BUILD_BACKENDS:
        raise ValueError(f"unknown ExtVP build backend {backend!r}; "
                         f"expected one of {BUILD_BACKENDS}")
    sf: Dict[Key, float] = {}
    sizes: Dict[Key, int] = {}
    tables: Dict[Key, Table] = {}
    if not evals:
        return sf, sizes, tables

    if backend == "numpy":
        for key in evals:
            kind, p1, p2 = key
            t1, t2 = vp[p1], vp[p2]
            probe = t1.o if kind == OS else t1.s
            other = t2.unique_o if kind == SO else t2.unique_s
            mask = _semijoin_mask(probe, other)
            m = int(mask.sum())
            n1 = len(t1)
            sfv = m / n1 if n1 else 0.0
            sf[key] = sfv
            sizes[key] = m
            if 0 < sfv < 1.0 and sfv <= threshold:
                tables[key] = Table(t1.rows[mask])   # mask keeps s-order
        return sf, sizes, tables

    if backend == "distributed":
        from repro_torch.core.distributed import extvp_pair_masks_sharded
        return extvp_pair_masks_sharded(vp, evals, threshold, group=group,
                                        device=device, pair_batch=pair_batch)

    # Pack only the predicates this eval set references, so an
    # incremental rebuild of a few pairs is not charged for the whole
    # catalog (a full build references every predicate anyway).
    used = {p for k in evals for p in (k[1], k[2])}
    device = torch.device("cuda" if device is None else device)
    packed = pack_vp({p: vp[p] for p in used}, device)
    desc = pair_descriptors(packed, evals)
    # ``pair_batch`` caps a launch's mask (one byte per probe key); a
    # chunk is never padded: the ragged launch takes any count
    batch = max(1, pair_batch)
    for start in range(0, len(evals), batch):
        chunk = evals[start:start + batch]
        cdesc = desc[start:start + batch]
        mask, counts = ops.semijoin_mask(packed.keys, packed.uniq, cdesc)
        # SF for the whole chunk in one vectorized pass, from the int64
        # counts, exactly as the reference's batched build computes it
        counts = counts.cpu().numpy().astype(np.int64)
        n1s = cdesc[:, 1]
        sfv = np.where(n1s > 0, counts / np.maximum(n1s, 1), 0.0)
        sf.update(zip(chunk, sfv.tolist()))
        sizes.update(zip(chunk, counts.tolist()))
        which = np.nonzero((sfv > 0) & (sfv < 1.0) & (sfv <= threshold))[0]
        if len(which):
            tables.update(_materialize(packed, chunk, cdesc, mask, counts,
                                       which))
        del mask                 # free it before the next chunk's launch
    return sf, sizes, tables


def build_extvp_planned(vp: Dict[int, Table], threshold: float = 1.0,
                        kinds: Tuple[str, ...] = KINDS,
                        backend: str = "numpy", device=None,
                        pair_batch: int = 512, group=None) -> ExtVPBuild:
    """Full ExtVP schema via the planned pipeline (prune -> evaluate ->
    materialize).  Both builds share the pruning, SF arithmetic and the
    τ test of :func:`evaluate_pairs`, so they are byte-identical."""
    out = ExtVPBuild(threshold=threshold, backend=backend,
                     kinds=tuple(kinds))
    pruned, evals = plan_pairs(vp, all_pair_keys(sorted(vp), kinds))
    for key in pruned:
        out.sf[key] = 0.0
        out.sizes[key] = 0
    sf, sizes, tables = evaluate_pairs(vp, evals, threshold, backend=backend,
                                       device=device, pair_batch=pair_batch,
                                       group=group)
    out.sf.update(sf)
    out.sizes.update(sizes)
    out.tables.update(tables)
    out.n_semijoins = len(evals)
    return out


# ---------------------------------------------------------------------------
# Incremental rebuild (Dataset.append_triples)
# ---------------------------------------------------------------------------

def incremental_pairs(old: ExtVPBuild, old_vp: Dict[int, Table],
                      new_vp: Dict[int, Table], touched: Set[int],
                      threshold: float, kinds: Tuple[str, ...] = KINDS,
                      backend: str = "numpy", device=None, group=None,
                      ) -> Tuple[ExtVPBuild, Dict[str, int]]:
    """Rebuild only the pairs an append actually touched.

    A pair (kind, p1, p2) is carried over from ``old`` verbatim when

    * neither predicate received new triples, or
    * only the build side ``p2`` did, and every **new** unique build key
      falls outside the probe side's entity range — appended rows can
      then only have added build keys that match nothing, so the mask
      (and with it SF, size and the materialized rows) is unchanged.

    Everything else is re-evaluated through :func:`evaluate_pairs` with
    the requested backend.  Returns the new build plus an accounting
    report (``reused`` / ``range_skipped`` / ``recomputed`` /
    ``evaluated`` pair counts).
    """
    out = ExtVPBuild(threshold=threshold, backend=backend,
                     kinds=tuple(kinds))
    recompute: List[Key] = []
    carried: List[Key] = []
    reused = range_skipped = 0

    def carry(key: Key) -> None:
        out.sf[key] = old.sf[key]
        out.sizes[key] = old.sizes[key]
        if key in old.tables:
            carried.append(key)

    for key in all_pair_keys(sorted(new_vp), kinds):
        kind, p1, p2 = key
        if key not in old.sf:            # never computed (e.g. new kind set)
            recompute.append(key)
            continue
        if p1 not in touched and p2 not in touched:
            carry(key)
            reused += 1
            continue
        if p1 not in touched and p2 in touched and p2 in old_vp:
            bc = build_col(kind)
            old_u = old_vp[p2].unique_o if bc else old_vp[p2].unique_s
            new_u = new_vp[p2].unique_o if bc else new_vp[p2].unique_s
            added = np.setdiff1d(new_u, old_u, assume_unique=True)
            own = new_vp[p1].unique_o if kind == OS else new_vp[p1].unique_s
            if len(added) == 0 or len(own) == 0 or \
                    added[0] > own[-1] or added[-1] < own[0]:
                carry(key)
                range_skipped += 1
                continue
        recompute.append(key)

    pruned, evals = plan_pairs(new_vp, recompute)
    for key in pruned:
        out.sf[key] = 0.0
        out.sizes[key] = 0
    sf, sizes, tables = evaluate_pairs(new_vp, evals, threshold,
                                       backend=backend, device=device,
                                       group=group)
    out.sf.update(sf)
    out.sizes.update(sizes)
    # Carried-over tables must not be forced out of a lazy provider
    # (a store-backed catalog memory-maps them on demand): when the old
    # provider can hand out raw loaders, the merged result stays lazy —
    # carried keys keep their loaders, recomputed ones bind concrete
    # Tables — so delta replay cost scales with the journal, not with
    # the number of materialized ExtVP tables.
    loader_for = getattr(old.tables, "loader_for", None)
    if loader_for is not None:
        loaders = {key: loader_for(key) for key in carried}
        loaders.update({key: (lambda t: lambda: t)(t)
                        for key, t in tables.items()})
        out.tables = LazyTableMap(
            loaders, lengths={key: out.sizes[key] for key in loaders})
    else:
        out.tables.update({key: old.tables[key] for key in carried})
        out.tables.update(tables)
    out.n_semijoins = len(evals)
    report = {"pairs": reused + range_skipped + len(recompute),
              "reused": reused, "range_skipped": range_skipped,
              "recomputed": len(recompute), "evaluated": len(evals)}
    return out, report
