"""Dry run: the cost of every (arch × shape × mesh) cell, read from the
step itself.

The counterpart of the JAX package's ``repro/launch/dryrun.py``.  That
module lowers and compiles each cell for the TPU production meshes and
reads XLA's cost and memory analysis and the HLO's collectives.  PyTorch
has no compiled SPMD program to read, so this one reads what the port
runs:

* an LM cell's step (train, prefill or decode) runs once on stand-ins on
  the ``"meta"`` device (nothing is allocated on any device) under one
  pass that counts the products' FLOPs (``FlopCounterMode``: matmuls,
  batched matmuls, convolutions, attention; elementwise work and the SSD
  scan's updates are not counted) and the bytes every aten operator
  reads and writes (:class:`repro_torch.obs.counters.OpCounter`, the
  counterpart of XLA's "bytes accessed" on an unfused program).  The
  trace does not depend on the mesh, so a cell's
  single- and multi-pod records come from one trace.  An eager trace
  runs every group of the layer loop, so no correction for a loop body
  counted once is needed;
* the S2RDF cell (``--arch s2rdf``) runs one attempt of the paper's
  snowflake query on the port's distributed engine
  (:meth:`repro_torch.core.distributed.DistributedExecutor.lower`), its
  collectives recorded by :mod:`repro_torch.launch.collectives`.

Record keys follow the JAX package's where the meaning holds; keys that
name XLA's figures become ``traced_*``.  ``traced_flops_total`` and
``traced_bytes_total`` are the whole step's (the S2RDF cell's summed over
the ranks); per-chip figures divide them by ``n_chips``.
``argument_bytes`` and ``output_bytes`` are per chip: each leaf's bytes
divided by the product of the mesh axes its spec
(:mod:`repro_torch.models.sharding`) names.  ``temp_bytes`` is an
estimate: the trace's peak of live bytes beyond the arguments (outputs
included), divided by the size of the data axes.  The LM cells'
collective term is ``None`` with a ``collective_reason``: the port
places no leaf across cards yet.  The roofline constants are the H100's
data-sheet figures (:class:`repro_torch.launch.mesh.HW`).

``memory_s``, and so ``step_seconds_bound`` where it dominates, is the
eager port's traced traffic over the HBM rate: every unfused operator's
reads and writes, per-use casts and elementwise passes included.  It
measures the implementation, not the least traffic the step needs, and
fusing operators lowers it.  The floor is ``memory_s_lower`` (one pass
over the arguments, the outputs and ``temp_bytes``) and
``step_seconds_bound_lower``, as in the JAX package.

XLA-only helpers of the JAX module have no counterpart here:
``cost_analysis_dict`` and ``_raw_costs`` read XLA's cost analysis, and
``pick_unroll`` and ``corrected_costs`` exist because XLA counts a
``scan`` body once.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
      --shape all --mesh both --out build/dryrun.jsonl
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch s2rdf \\
      --mesh auto [--device cpu]

``--mesh single|multi`` names the (16, 16) / (2, 16, 16) meshes; for
``s2rdf`` they need a world of 256 / 512 ranks and are refused on fewer.
``--mesh auto`` is the ranks of the run: the initialized process group,
or a world of one that the command opens itself (NCCL on the card, gloo
on the CPU).  The S2RDF cell runs on ``cuda`` unless ``--device cpu``;
the LM cells allocate nothing on any device.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import tempfile
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCHS, get
from repro_torch.launch.collectives import collective_bytes
from repro_torch.launch.mesh import (
    HW, make_production_mesh, make_query_mesh, require_ranks,
)
from repro_torch.models import sharding as shard_rules
from repro_torch.models.api import Model, model_flops, total_params
from repro_torch.models.config import SHAPES, ShapeCell, shape_applicable
from repro_torch.obs.counters import OpCounter
from repro_torch.train.optimizer import AdamWState, OptConfig, init_opt_state
from repro_torch.train.train_state import make_train_step
from repro_torch.train.tree import leaves, map_tree

__all__ = ["OpCounter", "Trace", "build_cell", "trace_step", "lm_records",
           "per_chip_bytes", "analyze", "build_s2rdf_cell", "s2rdf_record",
           "run_cell", "S2RDF_QUERY", "main"]

Mesh = Tuple[Tuple[int, ...], Tuple[str, ...]]

#: the JAX package's S2RDF cell: a snowflake over a WatDiv graph
S2RDF_QUERY = ("SELECT * WHERE { ?u wsdbm:follows ?v . ?v wsdbm:likes ?p . "
               "?p sorg:price ?x . ?p rev:hasReview ?r . ?r rev:reviewer ?w }")

_COLLECTIVE_REASON = ("the port places no leaf across cards yet (one card "
                      "holds every leaf whole, models/sharding.py): no "
                      "collective is issued")


# ---------------------------------------------------------------------------
# Counting what a step runs
# ---------------------------------------------------------------------------

def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclass
class Trace:
    """What one run of a step counted."""
    flops: int           # the products' FLOPs (FlopCounterMode)
    bytes: int           # bytes the aten operators read and write
    peak_bytes: int      # most bytes allocated by the step live at once
    ops: int             # aten operators run
    seconds: float       # host time of the traced run


def trace_step(step: Callable, args: Sequence[Any]) -> Tuple[Trace, Any]:
    """Run ``step(*args)`` once under the FLOP and byte counters; returns
    the counts and the step's output."""
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as flops, OpCounter() as counter:
        out = step(*args)
    return Trace(flops=int(flops.get_total_flops()), bytes=counter.bytes,
                 peak_bytes=counter.peak, ops=counter.ops,
                 seconds=time.perf_counter() - t0), out


# ---------------------------------------------------------------------------
# Cell construction: the step and its stand-ins on "meta"
# ---------------------------------------------------------------------------

@dataclass
class Cell:
    """A cell's step, its arguments, and the specs that place them (one
    spec tree a positional argument; ``None`` for a host int), with the
    specs of its outputs as a function of them."""
    step: Callable
    args: Tuple[Any, ...]
    arg_specs: Tuple[Any, ...]
    out_specs: Callable[[Any], Any]


def _replicated(tree):
    return map_tree(lambda t: (None,) * t.dim(), tree)


def build_cell(cfg, cell: ShapeCell, mesh: Mesh) -> Cell:
    """The cell's step (train, prefill or decode) with its stand-ins on
    ``"meta"``: params from ``Model.init``, ``init_opt_state`` for a
    train step, the batch of ``Model.input_specs(cell)``, a decode at
    the int position ``cell.seq_len - 1``.  With ``cfg.dp_only_decode``
    a decode's params are replicated and its caches keep only their data
    axes, as in the JAX package.  Specs follow ``models/sharding.py``."""
    model = Model(cfg)
    params = model.init(None, device="meta")
    pspecs = shard_rules.param_specs(params, mesh)

    if cell.kind == "train":
        opt = init_opt_state(params)
        ospecs = shard_rules.opt_state_specs(pspecs, params, mesh, cfg.zero1)
        ospecs = AdamWState(step=(), mu=ospecs, nu=ospecs)
        batch = model.input_specs(cell)
        bspecs = shard_rules.batch_specs(batch, mesh)
        step = make_train_step(model, OptConfig())
        return Cell(step, (params, opt, batch), (pspecs, ospecs, bspecs),
                    lambda out: (pspecs, ospecs, _replicated(out[2])))

    if cell.kind == "prefill":
        batch = model.input_specs(cell)

        def prefill(params, batch):
            with torch.no_grad():
                return model.prefill(params, batch)

        return Cell(prefill, (params, batch),
                    (pspecs, shard_rules.batch_specs(batch, mesh)),
                    lambda out: shard_rules.batch_specs(out, mesh))

    assert cell.kind == "decode"
    specs = model.input_specs(cell)
    caches, tokens = specs["caches"], specs["tokens"]
    cspecs = shard_rules.cache_specs(caches, mesh)
    if cfg.dp_only_decode:
        pspecs = _replicated(params)
        cspecs = map_tree(
            lambda s: tuple(e if e in ("data", ("pod", "data")) else None
                            for e in s), cspecs, is_leaf=shard_rules.is_spec)
    tspecs = shard_rules.batch_specs({"tokens": tokens}, mesh)["tokens"]

    def decode(params, caches, tokens, pos):
        with torch.no_grad():
            return model.decode(params, caches, tokens, pos)

    return Cell(decode, (params, caches, tokens, cell.seq_len - 1),
                (pspecs, cspecs, tspecs, None),
                lambda out: (shard_rules.batch_specs(out[0], mesh), cspecs))


def _axis_sizes(mesh: Mesh) -> Dict[str, int]:
    shape, axes = mesh
    return dict(zip(axes, shape))


def per_chip_bytes(tree, specs, mesh: Mesh) -> int:
    """Bytes of ``tree`` on one chip: each leaf's bytes divided by the
    product of the axis sizes its spec names (an entry ``("pod",
    "data")`` names both; ``"model"`` on a mesh without that axis is
    1)."""
    sizes = _axis_sizes(mesh)

    def one(spec, leaf) -> int:
        div = 1
        for entry in spec:
            for axis in (entry if isinstance(entry, tuple) else (entry,)):
                if axis is not None:
                    div *= sizes.get(axis, 1)   # an axis the mesh lacks
        return _nbytes(leaf) // div

    return sum(leaves(map_tree(one, specs, tree,
                               is_leaf=shard_rules.is_spec)))


def _data_size(mesh: Mesh) -> int:
    sizes = _axis_sizes(mesh)
    return math.prod(sizes[a] for a in shard_rules.data_axes(mesh))


# ---------------------------------------------------------------------------
# The roofline
# ---------------------------------------------------------------------------

def analyze(n_chips: int, mflops: Optional[float], flops_total: float,
            bytes_total: float, memory: Optional[Dict[str, Any]] = None,
            coll: Optional[Dict[str, float]] = None,
            collective_reason: Optional[str] = None) -> Dict[str, Any]:
    """The JAX package's three-term roofline at :class:`HW`'s constants:
    compute (FLOPs over the bf16 peak), memory (bytes over the HBM rate)
    and collectives (operand bytes over the NVLink rate), per chip.
    ``coll`` is :func:`repro_torch.launch.collectives.collective_bytes`'s
    dict, or ``None`` (then ``collective_s`` is ``None`` with
    ``collective_reason``, and the bound is the larger of the other
    two).  ``memory`` holds ``argument_bytes``, ``output_bytes`` and
    ``temp_bytes`` (a chip's; ``temp_bytes`` may be ``None``)."""
    memory = memory or {}
    flops = flops_total / n_chips
    bytes_acc = bytes_total / n_chips
    terms = {"compute_s": flops / HW.PEAK_FLOPS_BF16,
             "memory_s": bytes_acc / HW.HBM_BW}
    if coll is not None:
        terms["collective_s"] = coll["total"] / HW.NVLINK_BW
    dominant = max(terms, key=terms.get)
    bound_s = max(terms.values())
    arg = memory.get("argument_bytes")
    out = memory.get("output_bytes")
    temp = memory.get("temp_bytes")
    mem_lo = None if None in (arg, out, temp) else arg + out + temp
    memory_s_lower = None if mem_lo is None else mem_lo / HW.HBM_BW
    bound_lo = None if memory_s_lower is None else max(
        [terms["compute_s"], memory_s_lower]
        + ([terms["collective_s"]] if coll is not None else []))
    rec = {
        "traced_flops_total": flops_total,
        "traced_flops_per_chip": flops,
        "traced_bytes_total": bytes_total,
        "traced_bytes_per_chip": bytes_acc,
        "collective_bytes_per_chip": None if coll is None else coll["total"],
        "collective_bytes_weighted":
            None if coll is None else coll["weighted"],
        "collectives": None if coll is None else {
            k: v for k, v in coll.items() if k not in ("total", "weighted")},
        "collective_s": terms.get("collective_s"),
        "collective_reason": None if coll is not None else collective_reason,
        "compute_s": terms["compute_s"],
        "memory_s": terms["memory_s"],
        "memory_s_lower": memory_s_lower,
        "dominant": dominant,
        "step_seconds_bound": bound_s,
        "step_seconds_bound_lower": bound_lo,
        "argument_bytes": arg,
        "output_bytes": out,
        "temp_bytes": temp,
        "fits_card": None if arg is None else arg <= HW.HBM_BYTES,
        "n_chips": n_chips,
    }
    if mflops:
        useful = (mflops / n_chips) / HW.PEAK_FLOPS_BF16
        rec["model_flops_total"] = mflops
        rec["model_flops_per_chip"] = mflops / n_chips
        rec["useful_compute_ratio"] = (mflops / n_chips) / max(flops, 1.0)
        rec["roofline_fraction"] = useful / max(bound_s, 1e-30)
        rec["roofline_fraction_upper"] = None if bound_lo is None else \
            useful / max(bound_lo, 1e-30)
    return rec


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------

def _mesh_of(kind: str, world: int = 1) -> Mesh:
    if kind == "auto":
        return (world,), ("data",)
    return make_production_mesh(multi_pod=(kind == "multi"))


def lm_records(cfg, cell: ShapeCell, meshes: Dict[str, Mesh]
               ) -> Dict[str, Dict[str, Any]]:
    """One record per mesh of ``meshes`` (kind -> mesh) for ``cfg`` at
    ``cell``, all from one trace of the step."""
    out = {}
    trace = result = None
    for kind, mesh in meshes.items():
        built = build_cell(cfg, cell, mesh)
        if trace is None:
            trace, result = trace_step(built.step, built.args)
        n_chips = math.prod(mesh[0])
        arg = sum(per_chip_bytes(a, s, mesh)
                  for a, s in zip(built.args, built.arg_specs)
                  if s is not None)
        specs = built.out_specs(result)
        res = result if isinstance(result, tuple) else (result,)
        specs = specs if isinstance(result, tuple) else (specs,)
        out_b = sum(per_chip_bytes(r, s, mesh) for r, s in zip(res, specs))
        memory = {"argument_bytes": arg, "output_bytes": out_b,
                  "temp_bytes": trace.peak_bytes // _data_size(mesh)}
        rec = analyze(n_chips, model_flops(cfg, cell), float(trace.flops),
                      float(trace.bytes), memory,
                      collective_reason=_COLLECTIVE_REASON)
        rec.update(total_params=total_params(cfg), remat=cfg.remat,
                   aten_ops=trace.ops, trace_s=round(trace.seconds, 2))
        out[kind] = rec
    return out


# ---------------------------------------------------------------------------
# The S2RDF cell: the paper's engine on the port's distributed backend
# ---------------------------------------------------------------------------

def _world(group=None) -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(group)
    return 1


def build_s2rdf_cell(mesh_kind: str, scale: float = 2.0,
                     layout: str = "extvp", dual_partition: bool = False,
                     device=None, group=None, dataset=None):
    """The JAX package's S2RDF cell on the port's distributed backend:
    :data:`S2RDF_QUERY` over ``Dataset.watdiv(scale, seed=0)`` (or
    ``dataset``), prepared over the ranks of ``group`` (``None``: the
    default group, which must be initialized).  ``layout="vp"``
    prepares the same query against the VP baseline: the ratio of its
    collective bytes to ``"extvp"``'s is the paper's central claim (the
    semi-join reduction shrinks the shuffles).  ``mesh_kind`` ``single``
    / ``multi`` needs a world of exactly 256 / 512 ranks; ``auto`` takes
    the group's.  Returns ``(prepared, plan)``."""
    from repro_torch.engine import Dataset, Engine

    world = _world(group)
    if mesh_kind != "auto":
        mesh = make_query_mesh(multi_pod=(mesh_kind == "multi"))
        require_ranks(mesh, world)
        if world != math.prod(mesh[0]):
            raise RuntimeError(f"mesh {mesh_kind!r} needs exactly "
                               f"{math.prod(mesh[0])} ranks; this run has "
                               f"{world}")
    ds = dataset if dataset is not None else \
        Dataset.watdiv(scale=scale, seed=0, device=device)
    engine = Engine(ds, backend="distributed", layout=layout,
                    device=device, group=group,
                    dual_partition=dual_partition)
    prepared = engine.prepare(S2RDF_QUERY)
    return prepared, prepared.plan


def s2rdf_record(prepared, group=None) -> Dict[str, Any]:
    """The record of one attempt of ``prepared`` at its initial caps
    (:meth:`DistributedExecutor.lower`): this rank's collectives, the
    ranks' traced bytes summed (outside the recorded block), the
    roofline, and ``overflowed``."""
    ex = prepared.executor
    low = ex.lower()
    coll = collective_bytes(low["collectives"])
    dev = ex.device
    totals = torch.tensor([low["traced_bytes"]], dtype=torch.float64,
                          device=dev)
    if ex.n_shards > 1:
        dist.all_reduce(totals, group=ex.group)
    memory = {"argument_bytes": low["argument_bytes"],
              "output_bytes": low["output_bytes"],
              "temp_bytes": low["peak_bytes"]}
    rec = analyze(ex.n_shards, None, 0.0, float(totals.item()), memory,
                  coll)
    rec.update(caps=low["caps"], overflowed=low["overflowed"],
               rank_traced_bytes=low["traced_bytes"],
               aten_ops=low["aten_ops"],
               collective_calls=[{k: (list(v) if k == "shape" else v)
                                  for k, v in e.items()}
                                 for e in low["collectives"]],
               plan=ex.core.describe())
    return rec


def _open_one_rank_group(device) -> str:
    """A world of one rank for ``--mesh auto`` in a plain process;
    returns the rendezvous directory (the caller removes it)."""
    rdv = tempfile.mkdtemp(prefix="dryrun_rdv_")
    dist.init_process_group(
        "nccl" if torch.device(device).type == "cuda" else "gloo",
        init_method=f"file://{os.path.join(rdv, 'rendezvous')}",
        rank=0, world_size=1)
    return rdv


# ---------------------------------------------------------------------------
# Cells and the command line
# ---------------------------------------------------------------------------

def run_cell(arch: str, shape_name: str, mesh_kinds: Sequence[str],
             device=None, layout: str = "extvp", cfg=None) -> List[Dict[str, Any]]:
    """The records of one (arch, shape) at each of ``mesh_kinds``, in
    that order; a failure is a record with ``status: "error"``.  ``cfg``
    is the LM arch's config (``None``: the published one)."""
    recs = []
    t0 = time.time()
    try:
        if arch == "s2rdf":
            for kind in mesh_kinds:
                t1 = time.time()
                rec = {"arch": arch, "shape": shape_name, "mesh": kind,
                       "layout": layout}
                try:
                    prepared, _ = build_s2rdf_cell(kind, layout=layout,
                                                   device=device)
                    rec.update(s2rdf_record(prepared), status="ok")
                except Exception as e:  # noqa: BLE001 — a failed cell is reported
                    rec.update(status="error",
                               error=f"{type(e).__name__}: {e}",
                               traceback=traceback.format_exc()[-2000:])
                rec["wall_s"] = round(time.time() - t1, 1)
                recs.append(rec)
            return recs
        cfg = cfg or get(arch)
        cell = next(c for c in SHAPES if c.name == shape_name)
        ok, reason = shape_applicable(cfg, cell)
        if not ok:
            return [{"arch": arch, "shape": shape_name, "mesh": kind,
                     "status": "skipped", "reason": reason}
                    for kind in mesh_kinds]
        meshes = {kind: _mesh_of(kind, _world()) for kind in mesh_kinds}
        for kind, rec in lm_records(cfg, cell, meshes).items():
            recs.append(dict({"arch": arch, "shape": shape_name,
                              "mesh": kind, "status": "ok"}, **rec))
    except Exception as e:  # noqa: BLE001 — a failed cell is reported
        recs = [{"arch": arch, "shape": shape_name, "mesh": kind,
                 "status": "error", "error": f"{type(e).__name__}: {e}",
                 "traceback": traceback.format_exc()[-2000:]}
                for kind in mesh_kinds]
    wall = round(time.time() - t0, 1)
    for rec in recs:
        rec.setdefault("wall_s", wall)
    return recs


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="all",
                    help="arch id, 'all', or 's2rdf'")
    ap.add_argument("--shape", default="all",
                    help="shape cell name or 'all'")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both", "auto"])
    ap.add_argument("--out", default=None, help="append JSONL here")
    ap.add_argument("--device", default=None,
                    help="the S2RDF cell's device (default: cuda, which "
                         "must exist)")
    ap.add_argument("--layout", default="extvp", choices=["extvp", "vp"],
                    help="the S2RDF cell's layout")
    ap.add_argument("--reduced", action="store_true",
                    help="the CPU-test-sized config of each LM arch")
    args = ap.parse_args(argv)

    archs = list(ARCHS) if args.arch == "all" else [args.arch]
    shapes = [c.name for c in SHAPES] if args.shape == "all" \
        else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    rdv = None
    if "s2rdf" in archs and args.mesh == "auto" and not (
            dist.is_available() and dist.is_initialized()):
        from repro_torch.device import resolve_device
        rdv = _open_one_rank_group(resolve_device(args.device))
    results = []
    try:
        for arch in archs:
            for shape in (["-"] if arch == "s2rdf" else shapes):
                cfg = get(arch).reduced() if args.reduced and \
                    arch != "s2rdf" else None
                for rec in run_cell(arch, shape, meshes, device=args.device,
                                    layout=args.layout, cfg=cfg):
                    results.append(rec)
                    if args.out:
                        os.makedirs(os.path.dirname(args.out) or ".",
                                    exist_ok=True)
                        with open(args.out, "a") as f:
                            f.write(json.dumps(rec) + "\n")
                    brief = {k: rec.get(k) for k in
                             ("arch", "shape", "mesh", "status", "dominant",
                              "compute_s", "memory_s", "collective_s",
                              "roofline_fraction", "error", "wall_s")}
                    print(json.dumps(brief), flush=True)
    finally:
        if rdv is not None:
            dist.destroy_process_group()
            shutil.rmtree(rdv, ignore_errors=True)

    n_ok = sum(1 for r in results if r["status"] == "ok")
    n_skip = sum(1 for r in results if r["status"] == "skipped")
    n_err = len(results) - n_ok - n_skip
    print(f"# dry-run: {n_ok} ok, {n_skip} skipped, {n_err} errors")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
