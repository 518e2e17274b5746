"""Jobs that the port's distributed tests run in a group of processes,
one rank each, over gloo on the CPU, and :func:`run_group`, which starts
such a group and collects its results.  A rank runs as

    python tests/_torch_dist_jobs.py JOB RANK WORLD RDV_FILE OUT_DIR ARGS_JSON

joins the group through ``init_method="file://RDV_FILE"`` (no TCP port,
so parallel test workers never collide), runs ``JOB`` and pickles its
result to ``OUT_DIR/JOB-RANK.pkl``.  This module imports the port only:
nothing of JAX or of the JAX package, so a job also shows that the
distributed engine runs without them.
"""

import datetime
import json
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

#: seconds a collective may wait for the other ranks before it fails
COLLECTIVE_TIMEOUT_S = 120
#: seconds a spawned group (or a reference subprocess) may take in all
GROUP_TIMEOUT_S = 300

_SRC = Path(__file__).resolve().parents[1] / "src"


def run_group(job, world, tmp_path, **args):
    """Run ``world`` ranks of ``job`` and return each rank's result, in
    rank order; fails if a rank fails or the group outlasts
    ``GROUP_TIMEOUT_S`` (every rank is then killed)."""
    out_dir = Path(tmp_path)
    deadline = time.monotonic() + GROUP_TIMEOUT_S
    env = dict(os.environ, PYTHONPATH=str(_SRC))
    procs = []
    for rank in range(world):
        with open(out_dir / f"{job}-{rank}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, __file__, job, str(rank), str(world),
                 str(out_dir / f"{job}-rendezvous"), str(out_dir),
                 json.dumps(args)],
                env=env, stdout=log, stderr=subprocess.STDOUT))
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for rank, p in enumerate(procs):
        log = (out_dir / f"{job}-{rank}.log").read_text()
        assert p.returncode == 0, f"{job} rank {rank}:\n{log[-4000:]}"
        with open(out_dir / f"{job}-{rank}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


def post_order_combines(seg, out):
    """The combine segments of a core tree in post-order (duck-typed, so
    the same walk serves both packages' segment classes)."""
    if hasattr(seg, "child"):
        post_order_combines(seg.child, out)
    elif hasattr(seg, "left"):
        post_order_combines(seg.left, out)
        post_order_combines(seg.right, out)
        out.append(seg)
    return out


def executor_info(ex):
    """What the cap-slot verifier reads of an executor, as plain data."""
    comb = [ex._comb_index[id(s)]
            for s in post_order_combines(ex.core.root, [])]
    return {"caps": list(ex.caps), "mod_resize": bool(ex._mod_resize),
            "n_pipeline": ex._n_pipeline, "gathered": bool(ex.gathered),
            "comb": comb, "describe": ex.core.describe(),
            "scan_copy": list(ex.scan_copy)}


def _result(res):
    return {"cols": res.cols, "data": np.asarray(res.data)}


def job_suite(args):
    """The first instance of every WatDiv basic template through the
    distributed engine (rows, columns, exchanges, executor slots), then
    every instance as one batch (rows, executor slots after it) and
    single, and ``args["dual"]`` again with ``dual_partition=True``."""
    from repro_torch import Dataset
    from repro_torch.analysis import verify_executor
    from repro_torch.core import distributed as D
    from repro_torch.rdf.workloads import basic_queries

    ds = Dataset.watdiv(scale=args["scale"], seed=args["seed"],
                        threshold=args["tau"], device="cpu")
    eng = ds.engine("distributed")
    out = {"templates": {}, "dual": {}}
    for name, insts in basic_queries(ds.schema, seed=args["seed"]).items():
        D.reset_exchanges()
        first = eng.query(insts[0])
        rec = dict(_result(first), exchanges=D.exchanges["all_to_all"])
        prepared = eng.prepare(insts[0])
        if hasattr(prepared, "executor"):
            rec["info"] = executor_info(prepared.executor)
            rec["verify"] = _diags(verify_executor(prepared.executor))
        batched = eng.query_batch(insts)
        rec["batch"] = [_result(r) for r in batched]
        if hasattr(prepared, "executor"):
            rec["batch_info"] = executor_info(prepared.executor)
            rec["batch_verify"] = _diags(verify_executor(prepared.executor))
        single = [eng.query(q) for q in insts]
        rec["batch_equal"] = all(
            a.cols == b.cols and np.array_equal(a.data, b.data)
            for a, b in zip(single, batched))
        out["templates"][name] = rec
    dual = ds.engine("distributed", dual_partition=True)
    for name in args["dual"]:
        q = basic_queries(ds.schema, seed=args["seed"])[name][0]
        D.reset_exchanges()
        res = dual.query(q)
        ex = dual.prepare(q).executor
        out["dual"][name] = dict(
            _result(res), exchanges=D.exchanges["all_to_all"],
            info=executor_info(ex), verify=_diags(verify_executor(ex)))
    out["fallbacks"] = eng.metrics.device_fallbacks + \
        dual.metrics.device_fallbacks
    return out


def job_queries(args):
    """``args["queries"]`` over ``args["triples"]`` through the
    distributed engine, single and then all together in one batch."""
    from repro_torch import Dataset

    ds = Dataset.from_triples([tuple(t) for t in args["triples"]],
                              device="cpu")
    eng = ds.engine("distributed")
    single = [_result(eng.query(q)) for q in args["queries"]]
    batched = [_result(r) for r in eng.query_batch(list(args["queries"]))]
    return {"single": single, "batched": batched,
            "terms": list(ds.dictionary.id_to_term),
            "fallbacks": eng.metrics.device_fallbacks}


def job_repartition(args):
    """``repartition`` of seeded keys (UNBOUND and negative ones among
    them): what this rank sent and received, the flags, and the bucket
    counts.  ``args["skew"]`` sends every row to rank 0; ``out_cap``
    bounds the received relation."""
    from repro_torch.core import distributed as D

    rank, world = dist.get_rank(), dist.get_world_size()
    rng = np.random.default_rng(100 + rank)
    cap, n = args["cap"], args["n"]
    keys = rng.integers(-2**31 + 8, 2**31 - 1, size=cap, dtype=np.int64)
    keys[:6] = [-1, -3, -5, 0, 1, 2**31 - 2]
    if args["skew"]:
        keys = keys - (keys.astype(np.int64) & 0xFFFFFFFF) % world
    keys = keys.astype(np.int32)
    data = np.stack([keys, np.arange(cap, dtype=np.int32) + 1000 * rank],
                    axis=1)
    data[n:] = 2**31 - 1
    t = torch.from_numpy(data)[None]
    D.reset_exchanges()
    rows, n_out, ovf, sent = D.repartition(
        t, torch.tensor([n], dtype=torch.int32), 0, None, args["out_cap"])
    return {"sent_rows": data[:n], "recv": rows[0].numpy(),
            "n": int(n_out[0]), "overflow": bool(ovf[0]),
            "sent": int(sent[0]), "exchanges": D.exchanges["all_to_all"]}


def job_build(args):
    """The distributed ExtVP build of WatDiv at each τ of ``args["taus"]``
    (its catalog as plain arrays), and an append under it held against
    a from-scratch build of the same triples."""
    from repro_torch import Dataset

    out = {"catalogs": {}}
    for tau in args["taus"]:
        ds = Dataset.watdiv(scale=args["scale"], seed=args["seed"],
                            threshold=tau, build_backend="distributed",
                            device="cpu")
        ext = ds.catalog.extvp
        out["catalogs"][tau] = {
            "sf": dict(ext.sf), "sizes": dict(ext.sizes),
            "tables": {k: np.asarray(t.rows) for k, t in ext.tables.items()},
            "n_semijoins": ext.n_semijoins, "backend": ext.backend}
    triples = ds.dictionary.decode_rows(np.asarray(ds.catalog.tt))
    cut = len(triples) - len(triples) // 50
    grown = Dataset.from_triples(triples[:cut], threshold=0.25,
                                 build_backend="distributed", device="cpu")
    report = grown.append_triples(triples[cut:])
    scratch = Dataset.from_triples(triples, threshold=0.25,
                                   build_backend="numpy", device="cpu")
    a, b = grown.catalog.extvp, scratch.catalog.extvp
    out["append_equal"] = (
        a.sf == b.sf and a.sizes == b.sizes
        and set(a.tables) == set(b.tables)
        and all(a.tables[k].rows.tobytes() == b.tables[k].rows.tobytes()
                for k in b.tables))
    out["append_report"] = report
    return out


def job_isolation(args):
    """The distributed engine and build over gloo, then the modules
    loaded: none of JAX or of the JAX package may be among them."""
    import repro_torch.core.distributed  # noqa: F401
    from repro_torch import Dataset
    from repro_torch.rdf.workloads import basic_queries

    ds = Dataset.watdiv(scale=0.05, seed=1, threshold=0.25,
                        build_backend="distributed", device="cpu")
    eng = ds.engine("distributed")
    qs = basic_queries(ds.schema, seed=1)
    rows = sum(len(eng.query(q[0])) for q in qs.values())
    rows += sum(len(r) for r in eng.query_batch(qs["L1"] + qs["C3"]))
    bad = sorted(m for m in sys.modules
                 if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
    return {"rows": rows, "bad": bad}


def job_serve(args):
    """A ``SparqlServer`` on the distributed backend: interleaved
    template instances submitted through its micro-batcher with a
    latency bound that would expire on every submit on one device, then
    flushed; every ticket's rows against the single-device engine on
    this rank, the queue left after the submits (the size bound alone
    drains buckets here), the batches, and the traced launch spans."""
    from repro_torch import Dataset, RuntimeConfig, SparqlServer
    from repro_torch.rdf.workloads import basic_queries

    ds = Dataset.watdiv(scale=args["scale"], seed=0, threshold=0.25,
                        device="cpu")
    cfg = RuntimeConfig(flush_ms=0.0, trace_sample_rate=1.0)
    srv = SparqlServer(ds, backend="distributed", runtime=cfg,
                       max_batch=args["max_batch"])
    one = ds.engine()
    qs = basic_queries(ds.schema, seed=3, n_instances=args["instances"])
    order = [qs[name][i] for i in range(args["instances"])
             for name in qs]
    tickets = [srv.submit(q) for q in order]
    pending = srv.batcher.pending()
    served = srv.flush()
    equal = 0
    for q, t in zip(order, tickets):
        got, want = t.result(), one.query(q)
        assert got.cols == want.cols, q
        assert sorted(map(tuple, got.data.tolist())) == \
            sorted(map(tuple, want.data.tolist())), q
        equal += 1
    launches = [e for e in srv.engine.tracer.chrome_trace()["traceEvents"]
                if e.get("ph") == "X" and e["name"] == "device.launch"]
    m = srv.metrics.summary()
    return {"equal": equal, "pending": pending, "served": served,
            "templates": len(qs), "batches": m["batches"],
            "batched_requests": m["batched_requests"],
            "fallbacks": m["device_fallbacks"],
            "launch_backends": sorted({e["args"]["backend"]
                                       for e in launches}),
            "launch_shards": sorted({e["args"]["shards"] for e in launches}),
            "with_cardinalities": sum("cardinalities" in e["args"]
                                      for e in launches),
            "launch_spans": len(launches)}


class _ScriptedClock:
    """A rank's fake clock: it advances only when a scripted run says."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def job_auto_routing(args):
    """An ``"auto"`` engine over the group (eager, torch, distributed)
    whose runs advance each rank's own fake clock by that rank's script
    (its ms for each request a run serves, pads not counted):
    alone, rank 0 would crown torch and rank 1 eager.  Returns the
    routing log (less the clock stamps), the router's report, and the
    answers held against the single-device engine as multisets."""
    from repro_torch import Dataset, Engine, RuntimeConfig
    from repro_torch.rdf.workloads import basic_queries

    script = ({"eager": 5.0, "torch": 1.0, "distributed": 4.0},
              {"eager": 2.0, "torch": 3.0, "distributed": 0.5}
              )[dist.get_rank()]
    clock = _ScriptedClock()
    ds = Dataset.watdiv(scale=args["scale"], seed=0, threshold=0.25,
                        device="cpu")
    eng = Engine(ds, backend="auto", device="cpu", group=dist.group.WORLD,
                 runtime=RuntimeConfig(clock=clock, router_warmup=1,
                                       router_discard=0,
                                       router_probe_every=4))
    for backend in eng._backends.values():
        prepare = backend.prepare

        def scripted(template, ctx, prepare=prepare):
            prepared = prepare(template, ctx)
            run, run_batch = prepared.run, prepared.run_batch
            ms = script[prepared.backend]

            def timed_run(*a, **k):
                out = run(*a, **k)
                clock.t += ms / 1e3
                return out

            def timed_batch(bindings, *a, **k):
                out = run_batch(bindings, *a, **k)
                # the script charges requests: the engine pads a batch
                # that is one launch sequence by repeating its last
                # binding, and a pad is no request
                live = len(bindings)
                while live > 1 and bindings[live - 1] is not None and \
                        bindings[live - 1] is bindings[live - 2]:
                    live -= 1
                clock.t += ms * live / 1e3
                return out

            prepared.run, prepared.run_batch = timed_run, timed_batch
            return prepared

        backend.prepare = scripted
    one = Engine(ds, device="cpu")
    qs = basic_queries(ds.schema, seed=3, n_instances=args["instances"])
    order = [q for name in ("S1", "L2", "F1") for q in qs[name]]
    equal = 0
    results = [eng.query(q) for q in order] + eng.query_batch(order)
    for q, got in zip(order + order, results):
        want = one.query(q)
        assert got.cols == want.cols, q
        assert sorted(map(tuple, got.data.tolist())) == \
            sorted(map(tuple, want.data.tolist())), q
        equal += 1
    rep = eng.router.report()
    sig = next(iter(rep["signatures"]))
    return {"routes": [(e["backend"], e["reason"]) for e in eng.router.log],
            "report": {"signatures": rep["signatures"],
                       "ms": [e["ms"] for e in eng.router.log],
                       "ewma": rep["signatures"][sig]["ewma_ms"]},
            "seat": rep["signatures"][sig]["choice"],
            "equal": equal, "requests": len(results)}


def job_repartition_batch(args):
    """``repartition`` of a batch of seeded rows, each with its own valid
    count (``args["ns"]``; a full row bound for rank 0 alone overflows
    ``out_cap`` there), and of each row alone: both results, flags,
    rows sent and exchanges."""
    from repro_torch.core import distributed as D

    rank, world = dist.get_rank(), dist.get_world_size()
    rng = np.random.default_rng(200 + rank)
    cap, ns = args["cap"], args["ns"]
    keys = rng.integers(-2**31 + 8, 2**31 - 1, size=(len(ns), cap),
                        dtype=np.int64)
    keys[:, :4] = [-1, -3, 0, 2**31 - 2]
    skew = args["skew_row"]
    keys[skew] -= (keys[skew] & 0xFFFFFFFF) % world
    data = np.stack([keys.astype(np.int32),
                     np.arange(cap, dtype=np.int32)[None].repeat(len(ns), 0)
                     + 1000 * rank], axis=2)
    for b, n in enumerate(ns):
        data[b, n:] = 2**31 - 1
    n_t = torch.tensor(ns, dtype=torch.int32)
    D.reset_exchanges()
    rows, n_out, ovf, sent = D.repartition(torch.from_numpy(data), n_t, 0,
                                           None, args["out_cap"])
    out = {"batch": {"rows": rows.numpy(), "n": n_out.numpy(),
                     "overflow": ovf.numpy(), "sent": sent.numpy()},
           "exchanges": D.exchanges["all_to_all"], "single": []}
    for b in range(len(ns)):
        r, n, o, st = D.repartition(torch.from_numpy(data[b:b + 1]),
                                    n_t[b:b + 1], 0, None, args["out_cap"])
        out["single"].append({"rows": r[0].numpy(), "n": int(n[0]),
                              "overflow": bool(o[0]), "sent": int(st[0])})
    return out


def job_launch_counts(args):
    """Calls of ``ops.bucket_count``, ``ops.join_probe`` and
    ``all_to_all_single`` (and attempts) made by one request and by a
    batch of ``args["batch"]`` instances, per template, with the
    executor's caps grown beforehand so that each is one attempt."""
    from repro_torch import Dataset
    from repro_torch.core import distributed as D
    from repro_torch.kernels import ops
    from repro_torch.rdf.workloads import basic_queries

    calls = {"bucket_count": 0, "join_probe": 0, "all_to_all": 0,
             "attempts": 0}

    def counted(name, fn):
        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper

    ops.bucket_count = counted("bucket_count", ops.bucket_count)
    ops.join_probe = counted("join_probe", ops.join_probe)
    dist.all_to_all_single = counted("all_to_all", dist.all_to_all_single)
    D.DistributedExecutor._shard_program = counted(
        "attempts", D.DistributedExecutor._shard_program)
    ds = Dataset.watdiv(scale=args["scale"], seed=0, threshold=0.25,
                        device="cpu")
    eng = ds.engine("distributed")
    qs = basic_queries(ds.schema, seed=5, n_instances=args["batch"])
    out = {}
    for name in args["templates"]:
        insts = qs[name]
        eng.query_batch(insts)          # grows the caps for both
        eng.query(insts[0])
        counts = []
        for run in (lambda: eng.query(insts[0]),
                    lambda: eng.query_batch(insts)):
            before = dict(calls)
            run()
            counts.append({k: calls[k] - before[k] for k in calls})
        out[name] = {"single": counts[0], "batch": counts[1]}
    return out


def job_padding(args):
    """The engine's padding on the distributed seat: ``query_batch`` of
    the first ``count`` instances of each ``(template, count)`` of
    ``args["script"]``, the first query of ``args["missing"]``'s batch
    given a constant the dictionary lacks (``args["pattern"]`` replaced
    by ``args["absent"]``); returns the metrics summary's padding and
    occupancy, the rows of every result, and the batch each launch ran
    (the reference's test runs the same script)."""
    import re

    from repro_torch import Dataset
    from repro_torch.core import distributed as D
    from repro_torch.rdf.workloads import basic_queries

    shapes = []
    run_batch = D.DistributedExecutor.run_batch

    def recorded(self, bounds_batch, *a, **k):
        shapes.append(len(bounds_batch))
        return run_batch(self, bounds_batch, *a, **k)

    D.DistributedExecutor.run_batch = recorded
    ds = Dataset.watdiv(scale=args["scale"], seed=0, threshold=0.25,
                        device="cpu")
    eng = ds.engine("distributed")
    qs = basic_queries(ds.schema, seed=0, n_instances=8)
    rows = []
    for name, count in args["script"]:
        insts = list(qs[name][:count])
        if name == args["missing"]:
            insts[0] = re.sub(args["pattern"], args["absent"], insts[0],
                              count=1)
        rows += [len(r) for r in eng.query_batch(insts)]
    m = eng.metrics.summary()
    return {"padding_waste": m["padding_waste"],
            "batch_occupancy": m["batch_occupancy"],
            "batches": m["batches"], "shapes": shapes, "rows": rows}


def _diags(report):
    """A verification report as plain data: its diagnostics and checks."""
    return ([(d.rule, d.severity, d.message, d.location)
             for d in report.diagnostics], tuple(report.checks))


def job_verify(args):
    """The port's verifier over the distributed engine's prepared forms:
    ``args["queries"]`` over ``args["triples"]`` at each τ and planner,
    and the first instance of every WatDiv basic template; each report
    as plain data, keyed ``"tau|planner|query"`` / ``"planner|name"``."""
    from repro_torch import Dataset
    from repro_torch.analysis import verify_prepared
    from repro_torch.rdf.workloads import basic_queries

    out = {"corpus": {}, "watdiv": {}}
    triples = [tuple(t) for t in args["triples"]]
    for tau in args["taus"]:
        ds = Dataset.from_triples(triples, threshold=tau, device="cpu")
        for planner in args["planners"]:
            eng = ds.engine("distributed", planner=planner)
            for q in args["queries"]:
                out["corpus"][f"{tau}|{planner}|{q}"] = _diags(
                    verify_prepared(eng.prepare(q), ds.catalog))
    ds = Dataset.watdiv(scale=args["scale"], seed=args["seed"],
                        threshold=1.0, device="cpu")
    for planner in args["planners"]:
        eng = ds.engine("distributed", planner=planner)
        for name, (q,) in basic_queries(ds.schema, n_instances=1).items():
            out["watdiv"][f"{planner}|{name}"] = _diags(
                verify_prepared(eng.prepare(q), ds.catalog))
    return out


JOBS = {"suite": job_suite, "queries": job_queries, "verify": job_verify,
        "repartition": job_repartition, "build": job_build,
        "isolation": job_isolation, "serve": job_serve,
        "auto_routing": job_auto_routing,
        "repartition_batch": job_repartition_batch,
        "launch_counts": job_launch_counts, "padding": job_padding}


def main() -> None:
    job, rank, world, rdv, out_dir, args = sys.argv[1:7]
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{rdv}", rank=int(rank),
        world_size=int(world),
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        result = JOBS[job](json.loads(args))
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"{job}-{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


if __name__ == "__main__":
    main()
