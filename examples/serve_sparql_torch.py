"""End-to-end serving run on the PyTorch port (the paper's kind: a query engine
serving requests).

Generates a WatDiv graph, builds the ExtVP store via the ``Dataset``
facade, then serves a mixed workload (Basic Testing + IL + ST templates)
through a micro-batching ``repro_torch.SparqlServer`` — the serving
analogue of the paper's §7 evaluation.  Because the workload repeats
templates, the engine's plan cache means requests after the first
instantiation of each template skip parsing and compilation entirely
(watch ``plan_hit_rate``), and same-template requests share one launch
sequence.  ``--backend distributed`` serves from a one-rank process group
(NCCL on the card, gloo on the CPU) that the script opens itself.

    PYTHONPATH=src python examples/serve_sparql_torch.py --scale 1.0 --requests 60
    PYTHONPATH=src python examples/serve_sparql_torch.py --backend auto
    PYTHONPATH=src python examples/serve_sparql_torch.py --device cpu --scale 0.1
"""

import argparse
import os
import shutil
import tempfile
import time

import numpy as np
import torch.distributed as dist

from repro_torch import Dataset, SparqlServer
from repro_torch.rdf.workloads import ST_QUERIES, basic_queries, il_queries


def open_one_rank_group(device: str) -> str:
    """A world of one rank for the distributed backend; returns the
    rendezvous directory (removed by the caller)."""
    rdv = tempfile.mkdtemp(prefix="serve_sparql_rdv_")
    dist.init_process_group(
        "nccl" if device.startswith("cuda") else "gloo",
        init_method=f"file://{os.path.join(rdv, 'rendezvous')}",
        rank=0, world_size=1)
    return rdv


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--requests", type=int, default=60)
    ap.add_argument("--layout", default="extvp", choices=["extvp", "vp", "tt"])
    ap.add_argument("--backend", default="torch",
                    choices=["torch", "distributed", "auto"],
                    help="the server's backend, or 'auto' for per-template "
                         "adaptive routing")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the dataset and the server")
    args = ap.parse_args()

    rdv = open_one_rank_group(args.device) \
        if args.backend == "distributed" else None
    try:
        serve(args)
    finally:
        if rdv is not None:
            dist.destroy_process_group()
            shutil.rmtree(rdv, ignore_errors=True)


def serve(args) -> None:
    print(f"generating WatDiv SF={args.scale} ...")
    t0 = time.perf_counter()
    ds = Dataset.watdiv(scale=args.scale, seed=0,
                        threshold=0.25,   # production τ (paper §7.4)
                        device=args.device)
    rep = ds.storage_report()
    print(f"  {ds.n_triples} triples; {int(rep['extvp_tables'])} ExtVP tables "
          f"({rep['extvp_over_vp']:.1f}× VP tuples) "
          f"in {time.perf_counter()-t0:.2f}s")

    # --- build the request mix ------------------------------------------------
    rng = np.random.default_rng(1)
    pool = list(ST_QUERIES.values())
    for qs in basic_queries(ds.schema, seed=2, n_instances=2).values():
        pool.extend(qs)
    for qs in il_queries(ds.schema, seed=3, n_instances=1).values():
        pool.extend(qs)
    requests = [pool[rng.integers(0, len(pool))] for _ in range(args.requests)]

    # --- serve ------------------------------------------------------------------
    server = SparqlServer(ds, backend=args.backend, layout=args.layout)
    t_start = time.perf_counter()
    results = server.query_batch(requests)
    wall = time.perf_counter() - t_start

    engine = server.engine
    m = server.metrics.summary()
    print(f"\nserved {int(m['served'])} requests in {wall:.2f}s "
          f"({m['served']/wall:.1f} qps), layout={args.layout}, "
          f"backend={engine.backend}")
    print(f"  latency ms: p50={m['p50_ms']:.1f} p90={m['p90_ms']:.1f} "
          f"p99={m['p99_ms']:.1f}")
    print(f"  plan-cache hit rate: {m['plan_hit_rate']:.2f} "
          f"({engine.cache.evictions} evictions)")
    print(f"  micro-batches: {int(m['batches'])} launches for "
          f"{int(m['batched_requests'])} requests "
          f"(occupancy {m['batch_occupancy']:.2f}, "
          f"padding waste {m['padding_waste']:.2f})")
    print(f"  result rows: {int(m['rows'])}, empty answers: "
          f"{int(m['empties'])} (statistics-only: {int(m['short_circuits'])})")
    if m["routed"]:
        print(f"  adaptive routing: {m['routed']} "
              "(server.runtime_report() has the full decision log)")

    # --- agreement: every served result against one query on its own --------
    agree = all(res.same_as(engine.query(q))
                for q, res in zip(requests, results))
    print(f"\nserved results agree with single queries: {agree}")


if __name__ == "__main__":
    main()
