"""Serving launcher — SPARQL query serving (the paper's kind), or LM
decode serving for the assigned architectures, on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --scale 1.0
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --store watdiv.store        # persist on first run, boot from the
                                    # store (no build pipeline) afterwards
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --scale 0.1 --trace-sample 1.0 --trace-dump traces.jsonl \\
        --metrics-out metrics.prom
    PYTHONPATH=src python -m repro_torch.launch.serve --mode lm \\
        --arch qwen1.5-0.5b

``--mode sparql`` (the default) boots a dataset (from ``--store`` when it holds a store, else the
WatDiv generator at ``--scale``, τ = 0.25, saved to ``--store`` when
given), starts a :class:`~repro_torch.serve.SparqlServer` and serves the
selectivity-testing queries ``--passes`` times.  ``--device`` defaults
to ``cuda`` and the launcher raises without a card.

``--backend`` picks the engine: ``torch`` (the default, one device),
``eager`` (the host numpy engine), ``auto`` (each template routed
between eager and torch by measured latency; ``--router-warmup`` and
``--passes`` give the router its warmup traffic, ``--runtime-report``
prints its decisions), or ``distributed``, which serves over a
``torch.distributed`` process group: under ``torchrun`` (``RANK``/``WORLD_SIZE``/``MASTER_ADDR`` set)
every rank joins the launched world; otherwise the launcher opens a
world of one (NCCL on the card, gloo on the CPU).

``--mode lm`` serves ``--arch`` (reduced to its CPU-test size, random
weights from seed 0): empty static caches of ``--seq`` positions for
``--batch`` sequences, then ``--tokens`` greedy decode steps from
position 0, and one line with the tokens per second.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time


def _init_group(device) -> str:
    """Join (torchrun) or open (a world of one) the default process
    group; returns its backend name."""
    import torch
    import torch.distributed as dist
    backend = "nccl" if device.type == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ and \
            "MASTER_ADDR" in os.environ:
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend, init_method="env://")
        return backend
    if device.type == "cuda":
        torch.cuda.set_device(device.index or 0)
    rdv = tempfile.mkdtemp(prefix="serve_rdv_")
    try:
        dist.init_process_group(
            backend, init_method=f"file://{os.path.join(rdv, 'r')}",
            rank=0, world_size=1)
    finally:
        shutil.rmtree(rdv, ignore_errors=True)
    return backend


def serve_sparql(args) -> None:
    from repro_torch.device import resolve_device
    from repro_torch.engine import Dataset, RuntimeConfig
    from repro_torch.rdf.workloads import ST_QUERIES
    from repro_torch.serve import SparqlServer
    from repro_torch.store import is_store

    device = resolve_device(args.device)
    t0 = time.perf_counter()
    if args.store and is_store(args.store):
        # persistent-store boot: manifest + lazy memmaps, the build
        # pipeline never runs
        ds = Dataset.load(args.store, eager=args.eager_load, device=device)
        print(f"cold start from store {args.store!r} in "
              f"{time.perf_counter() - t0:.3f}s "
              f"({'eager' if args.eager_load else 'lazy memmap'})")
    else:
        ds = Dataset.watdiv(scale=args.scale, seed=0, threshold=0.25,
                            device=device)
        if args.store:
            ds.save(args.store)
            print(f"built and persisted store {args.store!r} in "
                  f"{time.perf_counter() - t0:.3f}s "
                  "(next boot loads it without rebuilding)")
    rt_kwargs = {}
    if args.batch_shapes:
        rt_kwargs["batch_shapes"] = tuple(
            int(t) for t in args.batch_shapes.replace(",", " ").split())
    if args.router_warmup is not None:
        rt_kwargs["router_warmup"] = args.router_warmup
    if args.planner:
        rt_kwargs["planner"] = args.planner
    if args.trace_sample is not None:
        rt_kwargs["trace_sample_rate"] = args.trace_sample
    runtime = RuntimeConfig(**rt_kwargs) if rt_kwargs else None
    group_backend = None
    if args.backend == "distributed":
        group_backend = _init_group(device)
    try:
        server = SparqlServer(ds, layout=args.layout, backend=args.backend,
                              runtime=runtime)
        engine = server.engine
        shards = 1
        if group_backend is not None:
            import torch.distributed as dist
            shards = dist.get_world_size()
        print(f"store: {ds.n_triples} triples on {shards} shard(s), "
              f"backend={engine.backend}, device={device}")

        t0 = time.perf_counter()
        for p in range(max(1, args.passes)):
            for name, qtext in ST_QUERIES.items():
                res = server.query(qtext)
                if p == 0:
                    print(f"  {name}: "
                          f"{'∅' if len(res) == 0 else f'{len(res)} rows'}")
        m = engine.metrics.summary()
        print(f"served {int(m['served'])} queries in "
              f"{time.perf_counter() - t0:.2f}s (p50 {m['p50_ms']:.1f} ms, "
              f"{int(m['short_circuits'])} statistics-only empties, "
              f"routed {m['routed']})")
        if args.runtime_report:
            print(json.dumps(engine.runtime_report(), indent=2))
        if args.trace_dump:
            with open(args.trace_dump, "w") as f:
                if args.trace_dump.endswith(".jsonl"):
                    f.write(engine.tracer.to_jsonl())
                else:
                    json.dump(engine.tracer.chrome_trace(), f)
            n = len(engine.tracer.recorder)
            print(f"wrote {n} trace(s) to {args.trace_dump!r} "
                  f"(inspect: python tools/trace_inspect.py "
                  f"{args.trace_dump}; chrome://tracing loads the .json "
                  "form)")
        if args.metrics_out:
            with open(args.metrics_out, "w") as f:
                f.write(engine.metrics.prometheus())
            print(f"wrote Prometheus exposition to {args.metrics_out!r}")
    finally:
        if group_backend is not None:
            import torch.distributed as dist
            dist.destroy_process_group()


def serve_lm(args) -> None:
    import torch

    from repro_torch.configs import get_reduced
    from repro_torch.device import resolve_device
    from repro_torch.models.api import Model

    device = resolve_device(args.device)
    cfg = get_reduced(args.arch)
    model = Model(cfg)
    B, S = args.batch, args.seq
    with torch.inference_mode():
        params = model.init(0, device)
        caches = model.init_caches(params if cfg.enc_dec else None, B, S,
                                   device)
        tok = torch.zeros((B, 1), dtype=torch.int32, device=device)
        t0 = time.perf_counter()
        for pos in range(args.tokens):
            logits, caches = model.decode(params, caches, tok, pos)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
    print(f"{cfg.name} (reduced): decoded {args.tokens} tokens × batch {B} "
          f"in {dt:.2f}s = {args.tokens * B / dt:.0f} tok/s")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", default="sparql", choices=["sparql", "lm"],
                    help="serve SPARQL queries, or decode an LM (lm)")
    ap.add_argument("--backend", default="torch",
                    choices=["eager", "torch", "auto", "distributed"],
                    help="the host numpy engine, one device, per-template "
                         "routing between the two by measured latency "
                         "(auto), or the ranks of a torch.distributed "
                         "process group (a world of one unless torchrun "
                         "set one up)")
    ap.add_argument("--device", default="cuda",
                    help="device the engine or the model runs on "
                         "(default cuda; cpu to run without a card)")
    ap.add_argument("--scale", type=float, default=0.5)
    ap.add_argument("--planner", default=None,
                    choices=["greedy", "estimate"],
                    help="join-order planner (default: REPRO_RT_PLANNER "
                         "env or 'greedy'); 'estimate' enumerates orders "
                         "by estimated intermediate cardinality")
    ap.add_argument("--layout", default="extvp",
                    choices=["extvp", "vp", "tt", "pt"],
                    help="storage schema the plans compile for (pt runs "
                         "on the host engine)")
    ap.add_argument("--batch-shapes", default=None,
                    help="comma-separated micro-batch bucket menu, e.g. "
                         "1,4,16 (default REPRO_RT_BATCH_SHAPES or "
                         "1,2,4,8,16,32)")
    ap.add_argument("--router-warmup", type=int, default=None,
                    help="measured executions per (template, backend) "
                         "before auto exploits the winner (default "
                         "REPRO_RT_WARMUP or 2)")
    ap.add_argument("--passes", type=int, default=1,
                    help="serve the workload N times (give the adaptive "
                         "router warmup traffic)")
    ap.add_argument("--runtime-report", action="store_true",
                    help="print the adaptive-runtime JSON snapshot "
                         "(routing decisions, batch-shape menu, knobs, "
                         "metrics)")
    ap.add_argument("--trace-sample", type=float, default=None,
                    help="per-request span-trace sampling rate in [0,1] "
                         "(default REPRO_RT_TRACE_SAMPLE or 0.0 = off)")
    ap.add_argument("--trace-dump", default=None,
                    help="write the flight recorder after serving: "
                         "Chrome chrome://tracing JSON, or JSONL when "
                         "the path ends in .jsonl")
    ap.add_argument("--metrics-out", default=None,
                    help="write the Prometheus text exposition of the "
                         "serving metrics to this file after serving")
    ap.add_argument("--store", default=None,
                    help="persistent catalog store directory: boot from it "
                         "when it exists (no build pipeline), else build "
                         "once and persist there")
    ap.add_argument("--eager-load", action="store_true",
                    help="materialize every table at boot instead of lazy "
                         "memory-mapping")
    ap.add_argument("--arch", default="qwen1.5-0.5b",
                    help="lm: the architecture (repro_torch.configs)")
    ap.add_argument("--batch", type=int, default=4,
                    help="lm: sequences decoded together")
    ap.add_argument("--seq", type=int, default=128,
                    help="lm: static cache length")
    ap.add_argument("--tokens", type=int, default=32,
                    help="lm: greedy decode steps")
    args = ap.parse_args()
    if args.mode == "sparql":
        serve_sparql(args)
    else:
        serve_lm(args)


if __name__ == "__main__":
    main()
