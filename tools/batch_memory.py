"""Peak device memory of one batched launch sequence, on one NVIDIA GPU.

    python3 tools/batch_memory.py [--scale 340] [--templates C1 C2]
                                  [--instances 3] [--seed 0]

Builds ``Dataset.watdiv(scale)`` on the card (τ = 0.25, as
``chip_smoke.py``), then for each named WatDiv basic template: its
instances one by one (warm, so the caps have grown), the peak device
memory of one of them, then the peak of ``Engine.query_batch`` over all
of them (one launch sequence, padded to the engine's bucket shape).  A
batch that does not fit the card is reported as such, not retried.
Prints the card's name and power limit and one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "src"))


def peak_gib(fn):
    """(peak device memory GiB over ``fn()``, its seconds), or
    (``"out of memory"``, seconds) when the card cannot hold it."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    try:
        out = fn()
        torch.cuda.synchronize()
    except torch.OutOfMemoryError:
        return "out of memory", time.perf_counter() - t
    s = time.perf_counter() - t
    del out
    return torch.cuda.max_memory_allocated() / 2**30, s


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=340.0)
    ap.add_argument("--templates", nargs="+", default=["C1", "C2"])
    ap.add_argument("--instances", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("batch_memory: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import Dataset
    from repro_torch.rdf.workloads import basic_queries

    ident = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    ds = Dataset.watdiv(scale=args.scale, seed=args.seed, threshold=0.25)
    eng = ds.engine()
    queries = basic_queries(ds.schema, seed=args.seed,
                            n_instances=args.instances)
    total = torch.cuda.get_device_properties(0).total_memory / 2**30
    out = {"card": ident, "scale": args.scale, "total_gib": total,
           "templates": {}}
    for name in args.templates:
        insts = queries[name]
        for q in insts:
            eng.query(q)
        resident = torch.cuda.memory_allocated() / 2**30
        single, single_s = peak_gib(lambda: eng.query(insts[0]))
        batch, batch_s = peak_gib(lambda: eng.query_batch(insts))
        out["templates"][name] = {
            "instances": len(insts), "bucket": eng.bucket_shape(len(insts)),
            "resident_gib": resident, "single_peak_gib": single,
            "single_s": single_s, "batch_peak_gib": batch,
            "batch_s": batch_s}
        print(f"{name}: {len(insts)} instances (bucket "
              f"{eng.bucket_shape(len(insts))}), resident {resident:.2f} "
              f"GiB; one query peak {single} GiB in {single_s:.2f} s; the "
              f"batch peak {batch} GiB in {batch_s:.2f} s", flush=True)
    print(ident)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
