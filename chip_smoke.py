"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--scale 340] [--compare-scale 34] [--seed 0]

Phases (any failure exits non-zero and prints no result line):

1. the card's name and power limit, the CUDA version, and the build of
   every kernel from ``src/repro_torch/kernels/csrc/`` (one ``nvcc`` per
   source, all started together);
2. each kernel against its plain PyTorch version on the card, exactly,
   on unit cases and at main-path shapes, with CUDA-event times of the
   kernel, the plain version and the one-call library yardstick;
3. the main path: ``Dataset.watdiv(scale)`` (10M triples at scale 340,
   the paper's smallest WatDiv dataset, τ = 0.25) served on the card
   through ``Engine.query`` (every instance of the 20 basic templates)
   and ``Engine.query_batch`` (each template's instances in one call),
   with the kernels' launch counts reset just before and read just
   after; then the kernels timed again on the largest inputs the main
   path gave them;
4. the check: the card engine and the same port engine on the CPU serve
   the same queries, and every result must be equal row for row, with
   equal final capacities: every instance, single and batched.  At
   ``--scale`` every template but C1 and C2 (10^8 result rows each,
   which the CPU engine cannot serve within the smoke's time limit); at
   ``--compare-scale`` (a tenth) every template.

It prints one JSON line with the kernels' numbers, then the card's name
and power limit, then ``{"ok": true, "device": {...}}`` as the last line.
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

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (data sheet)
SCALAR_OPS_PER_S = 67e12       # H100 SXM float32 rate outside the tensor cores
TPU_KERNEL = {"join_probe": "src/repro/kernels/mergejoin.py:40"}
KERNEL_SOURCE = {"join_probe": "src/repro_torch/kernels/csrc/join_probe.cu"}


def log(*a) -> None:
    print(*a, flush=True)


def gpu_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


def cuda_time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# phase 2: kernel against plain
# ---------------------------------------------------------------------------

def probe_cases(gen: torch.Generator):
    """(name, probe, build) unit cases on the host."""
    big = 2**31 - 1
    cases = []

    def sorted_build(n, lo, hi):
        return torch.sort(torch.randint(lo, hi, (n,), generator=gen,
                                        dtype=torch.int32)).values

    for n_a, n_b in [(1024, 512), (2048, 1024), (1, 1), (7, 3), (1000, 513),
                     (2500, 1200), (33, 100000)]:
        a = torch.randint(0, 800, (n_a,), generator=gen, dtype=torch.int32)
        cases.append((f"random {n_a}x{n_b}", a, sorted_build(n_b, 0, 800)))
    run = torch.full((1024,), 7, dtype=torch.int32)
    run[:4] = 3
    cases.append(("duplicate run across build tiles",
                  torch.full((1024,), 7, dtype=torch.int32),
                  torch.sort(run).values))
    cases.append(("empty probe", torch.empty(0, dtype=torch.int32),
                  sorted_build(64, 0, 50)))
    cases.append(("empty build", torch.arange(50, dtype=torch.int32),
                  torch.empty(0, dtype=torch.int32)))
    # the executor's sentinels: probe pads 2^31-1, probe UNBOUND -3,
    # build pads 2^31-2, build UNBOUND -5
    a = torch.tensor([5, -3, big, 9, big - 1, -5, 0], dtype=torch.int32)
    b = torch.tensor([-5, -5, 0, 5, 5, 9, big - 1, big - 1],
                     dtype=torch.int32)
    cases.append(("sentinels", a, b))
    return cases


def check_probe(ops, ref, a: torch.Tensor, b: torch.Tensor, what: str) -> int:
    lo, cnt = ops.join_probe(a, b)
    torch.cuda.synchronize()
    wlo, wcnt = ref.join_probe_ref(a, b)
    if lo.dtype != torch.int32 or cnt.dtype != torch.int32:
        raise AssertionError(f"join_probe {what}: outputs not int32")
    err = max(int((lo.long() - wlo.long()).abs().max()) if lo.numel() else 0,
              int((cnt.long() - wcnt.long()).abs().max()) if cnt.numel() else 0)
    if err:
        raise AssertionError(f"join_probe {what}: kernel != plain "
                             f"(max abs err {err})")
    return err


def probe_numbers(ops, ref, a: torch.Tensor, b: torch.Tensor) -> dict:
    """Times and bound of the join probe on one (probe, build) pair."""
    n_a, n_b = a.numel(), b.numel()
    ms = cuda_time_ms(lambda: ops.join_probe(a, b))
    plain_ms = cuda_time_ms(lambda: ref.join_probe_ref(a, b))
    library_ms = cuda_time_ms(lambda: (
        torch.searchsorted(b, a, out_int32=True),
        torch.searchsorted(b, a, right=True, out_int32=True)))
    nbytes = 4 * (n_a + n_b) + 8 * n_a
    # compares these inputs need: a lower-bound search of ceil(log2(n_b+1))
    # steps per key, one read at the bound, and a gallop of about
    # 2 log2(cnt+1) steps for each key that matches
    _, cnt = ref.join_probe_ref(a, b)
    steps = max(1, int(np.ceil(np.log2(n_b + 1))))
    gallop = int(torch.ceil(torch.log2(cnt.double() + 1)).sum()) * 2
    nops = n_a * (steps + 1) + gallop
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = nops / SCALAR_OPS_PER_S * 1e3
    return {"n_a": n_a, "n_b": n_b, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def phase_kernels(ops, ref) -> None:
    gen = torch.Generator().manual_seed(0)
    for what, a, b in probe_cases(gen):
        check_probe(ops, ref, a.cuda(), b.cuda(), what)
        log(f"  join_probe == plain: {what}")
    for n_a, n_b in [(1 << 22, 1 << 23), (1 << 28, 1 << 23)]:
        dev_gen = torch.Generator(device="cuda").manual_seed(n_a)
        a = torch.randint(0, 1 << 24, (n_a,), generator=dev_gen,
                          device="cuda", dtype=torch.int32)
        b = torch.sort(torch.randint(0, 1 << 24, (n_b,), generator=dev_gen,
                                     device="cuda", dtype=torch.int32)).values
        a[::97] = 2**31 - 1                       # probe pads
        b[-(n_b // 64):] = 2**31 - 2              # build pads (sort-max)
        check_probe(ops, ref, a, b, f"{n_a}x{n_b}")
        nums = probe_numbers(ops, ref, a, b)
        log(f"  join_probe probe 2^{n_a.bit_length() - 1} build "
            f"2^{n_b.bit_length() - 1}: equal; kernel {nums['ms']:.4f} ms, "
            f"plain {nums['plain_ms']:.4f} ms, torch.searchsorted x2 "
            f"{nums['library_ms']:.4f} ms, bound {nums['bound_ms']:.4f} ms "
            f"({nums['bound_by']}, {HBM_BYTES_PER_S / 1e12:.2f} TB/s)")
        del a, b
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

class ProbeRecorder:
    """Keeps the largest probe the main path hands the join-probe kernel,
    so the kernel can be timed on real main-path inputs afterwards.  It
    calls the wrapper unchanged; the launch count stays the wrapper's."""

    def __init__(self, jexec):
        self.jexec = jexec
        self.inner = jexec.ops.join_probe
        self.best = None
        self.shapes = {}

    def __call__(self, a, b):
        key = (a.numel(), b.numel())
        self.shapes[key] = self.shapes.get(key, 0) + 1
        if self.best is None or a.numel() > self.best[0].numel():
            self.best = (a.clone(), b.clone())
        return self.inner(a, b)

    def __enter__(self):
        self.jexec.ops = _OpsShim(self.jexec.ops, self)
        return self

    def __exit__(self, *exc):
        self.jexec.ops = self.jexec.ops.base


class _OpsShim:
    def __init__(self, base, rec):
        self.base = base
        self.join_probe = rec


def p(xs, q):
    return float(np.percentile(np.asarray(xs, dtype=np.float64), q))


def profile_query(eng, qtext: str, name: str) -> None:
    """Where the time of one warm query goes: wall time, the device's
    busy time (the sum of its kernels and copies on the one stream, from
    the profiler's trace of the card) and the top device operations."""
    from torch.profiler import ProfilerActivity, profile
    eng.query(qtext)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        eng.query(qtext)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    rows = []
    for e in prof.key_averages():
        # device-side events only (kernels, copies): a CPU op's device
        # total repeats the time of the kernels it launched
        if e.device_type != torch.autograd.DeviceType.CPU and \
                e.self_device_time_total > 0:
            rows.append((e.self_device_time_total / 1e3, e.count, e.key))
    busy_ms = sum(r[0] for r in rows)
    if busy_ms == 0:
        log(f"  profile {name}: the profiler saw no device time; device "
            f"busy share not measured (wall {wall_ms:.3f} ms)")
        return
    log(f"  profile {name}: wall {wall_ms:.3f} ms, device busy "
        f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f} %, idle "
        f"{100 - 100 * busy_ms / wall_ms:.1f} %)")
    for ms, count, key in sorted(rows, reverse=True)[:8]:
        log(f"    {ms:10.3f} ms  x{count:<5d} {key[:90]}")


def device_table_bytes(eng) -> int:
    seen, total = set(), 0
    for key in list(eng.cache.keys()):
        ex = getattr(eng.cache.get(key), "executor", None)
        if ex is None or "_device_inputs" not in ex.__dict__:
            continue
        inp = ex._device_inputs
        for t in [*inp.rows, *inp.s_cols, inp.tt_rows, inp.values]:
            if t.numel() and t.data_ptr() not in seen:
                seen.add(t.data_ptr())
                total += t.numel() * t.element_size()
    return total


def serve_suite(eng, queries, timed_reps: int):
    """Every instance through ``query`` (first pass cold: plans, uploads,
    capacity growth), then ``timed_reps`` warm passes, then each
    template's instances through ``query_batch``, which must equal the
    single results.  Returns per-template timings."""
    stats = {}
    for name, insts in queries.items():
        t0 = time.perf_counter()
        single = [eng.query(q) for q in insts]
        cold_ms = (time.perf_counter() - t0) * 1e3
        lat = []
        for _ in range(timed_reps):
            for q in insts:
                t = time.perf_counter()
                eng.query(q)
                lat.append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        batched = eng.query_batch(insts)
        batch_ms = (time.perf_counter() - t) * 1e3
        for a, b in zip(single, batched):
            if a.cols != b.cols or not np.array_equal(a.data, b.data):
                raise AssertionError(f"{name}: query_batch != query")
        for r in single:
            if r.data.dtype != np.int32 or r.data.shape[1] != len(r.cols):
                raise AssertionError(f"{name}: malformed result")
        stats[name] = {"rows": [len(r) for r in single],
                       "cold_ms": cold_ms, "lat": lat, "batch_ms": batch_ms}
        del single, batched
    return stats


def phase_main(args, ops, ref, jexec, Dataset, basic_queries) -> dict:
    t = time.perf_counter()
    ds = Dataset.watdiv(scale=args.scale, seed=args.seed, threshold=0.25)
    build_s = time.perf_counter() - t
    rep = ds.storage_report()
    log(f"  dataset: scale {args.scale}, {ds.n_triples} triples, "
        f"VP {int(rep['vp_tuples'])} rows, ExtVP {int(rep['extvp_tables'])} "
        f"tables / {int(rep['extvp_tuples'])} rows; generation + catalog "
        f"build {build_s:.1f} s (catalog build "
        f"{rep['vp_build_seconds'] + rep['extvp_build_seconds']:.1f} s)")
    eng = ds.engine()
    assert eng.device.type == "cuda"
    queries = basic_queries(ds.schema, seed=args.seed)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    with ProbeRecorder(jexec) as rec:
        t = time.perf_counter()
        stats = serve_suite(eng, queries, args.reps)
        serve_s = time.perf_counter() - t
    launches = dict(ops.launches)
    peak = torch.cuda.max_memory_allocated()
    log(f"  served {sum(len(v) for v in queries.values())} queries x "
        f"{1 + args.reps} + {len(queries)} batches in {serve_s:.1f} s; "
        f"join_probe launches {launches['join_probe']}; tables on the card "
        f"{device_table_bytes(eng) / 2**20:.1f} MiB; peak device memory "
        f"{peak / 2**30:.2f} GiB")
    for name, s in stats.items():
        log(f"  {name}: rows {s['rows']}, p50 {p(s['lat'], 50):.3f} ms, "
            f"max {max(s['lat']):.3f} ms of {len(s['lat'])} warm queries, "
            f"cold {s['cold_ms']:.1f} ms for {len(s['rows'])}, batch of "
            f"{len(s['rows'])} {s['batch_ms']:.1f} ms")
    for name in ("S1", "C1"):
        profile_query(eng, queries[name][0], name)
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"kernel {k} was not launched on the main "
                                 "path")
    a, b = rec.best
    shapes = sorted(rec.shapes.items(), key=lambda kv: -kv[0][0])[:5]
    log(f"  largest join_probe shapes (n_a, n_b): count: {shapes}")
    err = check_probe(ops, ref, a, b, "main-path inputs")
    nums = probe_numbers(ops, ref, a, b)
    log(f"  join_probe on the main path's largest inputs "
        f"({nums['n_a']} x {nums['n_b']}): equal; kernel {nums['ms']:.4f} ms, "
        f"plain {nums['plain_ms']:.4f} ms, torch.searchsorted x2 "
        f"{nums['library_ms']:.4f} ms, bound {nums['bound_ms']:.4f} ms")
    del rec, a, b
    torch.cuda.empty_cache()
    return {"join_probe": dict(nums, launches=launches["join_probe"],
                               max_abs_err=err)}, ds, eng, queries


# ---------------------------------------------------------------------------
# phase 4: card against CPU
# ---------------------------------------------------------------------------

def compare(ds, gpu, queries, ops, skip=()) -> None:
    """Every instance of every template but those in ``skip`` through
    ``query`` and each template's instances through ``query_batch``, on
    the card engine ``gpu`` and on the same port engine on the CPU:
    results equal row for row, and both executors end with the same
    capacities.  Results are dropped as soon as they are compared."""
    cpu = ds.engine(device="cpu")
    ops.reset_launches()
    n, t_gpu, t_cpu = 0, 0.0, 0.0
    for name, insts in queries.items():
        if name in skip:
            continue
        runs = [("query", [q]) for q in insts] + [("query_batch", insts)]
        for how, qs in runs:
            t = time.perf_counter()
            g = gpu.query(qs[0]) if how == "query" else gpu.query_batch(qs)
            t_gpu += time.perf_counter() - t
            t = time.perf_counter()
            c = cpu.query(qs[0]) if how == "query" else cpu.query_batch(qs)
            t_cpu += time.perf_counter() - t
            for a, b in zip(g if how == "query_batch" else [g],
                            c if how == "query_batch" else [c]):
                if a.cols != b.cols or not np.array_equal(a.data, b.data):
                    raise AssertionError(f"{name} ({how}): card != CPU")
                n += 1
            del g, c
        ge, ce = gpu.prepare(insts[0]), cpu.prepare(insts[0])
        if getattr(ge, "executor", None) is not None and \
                ge.executor.caps != ce.executor.caps:
            raise AssertionError(f"{name}: card and CPU ended with "
                                 "different caps")
    if ops.launches["join_probe"] <= 0:
        raise AssertionError("no join_probe launch in the comparison run")
    skipped = f" ({', '.join(sorted(skip))} not compared here)" \
        if skip else ""
    log(f"  {ds.n_triples} triples: {n} results equal row for row, card vs "
        f"CPU{skipped}; join_probe launches on the card "
        f"{ops.launches['join_probe']}; card {t_gpu:.1f} s, CPU "
        f"{t_cpu:.1f} s")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=340.0)
    ap.add_argument("--compare-scale", type=float, default=34.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=3,
                    help="warm passes over every instance for latencies")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "src"))
    from repro_torch import Dataset
    from repro_torch.core import jexec
    from repro_torch.kernels import build, ops, ref
    from repro_torch.rdf.workloads import basic_queries

    ident = gpu_identity()
    log(f"[1] card: {ident}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t = time.perf_counter()
    libs = build.build_all()
    log(f"  built {sorted(libs)} from {build.CSRC} in "
        f"{time.perf_counter() - t:.1f} s")
    log("[2] kernels against their plain versions")
    phase_kernels(ops, ref)
    log("[3] main path")
    nums, ds, eng, queries = phase_main(args, ops, ref, jexec, Dataset,
                                        basic_queries)
    log(f"[4] card against CPU at scale {args.scale}")
    compare(ds, eng, queries, ops, skip={"C1", "C2"})
    del ds, eng, queries
    torch.cuda.empty_cache()
    log(f"[4] card against CPU at scale {args.compare_scale}")
    ds = Dataset.watdiv(scale=args.compare_scale, seed=args.seed,
                        threshold=0.25)
    compare(ds, ds.engine(), basic_queries(ds.schema, seed=args.seed), ops)

    kernels = [{"name": k, "route": "cuda", "source": KERNEL_SOURCE[k],
                "replaces": TPU_KERNEL[k], "launches": v["launches"],
                "max_abs_err": v["max_abs_err"], "ms": v["ms"],
                "plain_ms": v["plain_ms"], "bound_ms": v["bound_ms"],
                "bound_by": v["bound_by"], "library_ms": v["library_ms"]}
               for k, v in nums.items()]
    print(json.dumps({"kernels": kernels}))
    print(ident)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
