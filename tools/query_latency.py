"""Warm latency of single queries and of same-template batches, on one
NVIDIA GPU, for one checkout of the port.

    python3 tools/query_latency.py [--src SRC] [--scale 340]
                                   [--instances 32] [--reps 3] [--seed 0]
                                   [--skip C1 C2] [--label NAME]
                                   [--backend torch|distributed]

Imports ``repro_torch`` from ``SRC`` (default: this checkout's
``src/``), so two checkouts can be timed in turns on one card with the
same command.  Builds ``Dataset.watdiv(scale)`` on the card (τ = 0.25),
then for each WatDiv basic template but ``--skip``: its instances one
by one (cold), ``--reps`` warm passes of single ``Engine.query`` calls
(host clock, the copy back included), and ``--reps`` warm
``Engine.query_batch`` calls over all of them (one chunk of
``--instances``).  ``--backend distributed`` serves through the
distributed engine over a world of one NCCL rank (its rendezvous file
under ``build/`` beside this tool).  Prints the card's name and power
limit and one JSON line: per template the single p50 and the batch p50,
both ms, or ``out_of_memory`` where the template's batch does not fit
the card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(os.path.dirname(HERE),
                                                  "src"))
    ap.add_argument("--scale", type=float, default=340.0)
    ap.add_argument("--instances", type=int, default=32)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--skip", nargs="*", default=["C1", "C2"])
    ap.add_argument("--label", default="")
    ap.add_argument("--backend", choices=("torch", "distributed"),
                    default="torch")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("query_latency: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch import Dataset, Engine
    from repro_torch.rdf.workloads import basic_queries

    ident = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    ds = Dataset.watdiv(scale=args.scale, seed=args.seed, threshold=0.25)
    if args.backend == "distributed":
        import torch.distributed as dist
        rdv = os.path.join(os.path.dirname(HERE), "build",
                           "query_latency_rendezvous")
        os.makedirs(os.path.dirname(rdv), exist_ok=True)
        if os.path.exists(rdv):
            os.remove(rdv)
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=f"file://{rdv}",
                                rank=0, world_size=1)
        eng = Engine(ds, backend="distributed")
    else:
        eng = ds.engine()
    queries = basic_queries(ds.schema, seed=args.seed,
                            n_instances=args.instances)
    out = {}
    for name, insts in queries.items():
        if name in args.skip:
            continue
        single, batch = [], []
        try:
            for q in insts:
                eng.query(q)
            eng.query_batch(insts)
            for _ in range(args.reps):
                for q in insts:
                    t = time.perf_counter()
                    eng.query(q)
                    single.append((time.perf_counter() - t) * 1e3)
                torch.cuda.synchronize()
                t = time.perf_counter()
                eng.query_batch(insts)
                batch.append((time.perf_counter() - t) * 1e3)
        except torch.OutOfMemoryError:
            # a batch B times one query's intermediates may not fit the
            # card: recorded as such, and the template's numbers dropped
            out[name] = {"out_of_memory": True}
            print(f"{name}: out of card memory", flush=True)
            torch.cuda.empty_cache()
            continue
        out[name] = {"single_p50_ms": float(np.percentile(single, 50)),
                     "batch_p50_ms": float(np.percentile(batch, 50))}
        print(f"{name}: single p50 {out[name]['single_p50_ms']:.3f} ms, "
              f"batch of {len(insts)} p50 {out[name]['batch_p50_ms']:.3f} "
              f"ms", flush=True)
    print(ident)
    print(json.dumps({"label": args.label, "card": ident,
                      "backend": args.backend, "scale": args.scale,
                      "instances": args.instances, "templates": out}))
    if args.backend == "distributed":
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
