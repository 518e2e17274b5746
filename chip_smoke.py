"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--scale 340] [--compare-scale 34] [--seed 0]

Phases (any failure exits non-zero and prints no result line):

1. the card's name and power limit, the CUDA version, and the build of
   every kernel from ``src/repro_torch/kernels/csrc/`` (one ``nvcc`` per
   source, all started together);
2. each kernel against its plain PyTorch version on the card, exactly,
   on unit cases and at main-path shapes, with CUDA-event times of the
   kernel, the plain version and the one-call library yardstick (the
   join probe's unit cases at several ``ops.SMEM_KEYS``, so that every
   stride of its search occurs; a misaligned build column must raise;
   its batched launches, B of 1, 2, 7 and 32 rows against one build for
   every row and against a build a row, builds of 16 to 2^19 keys with
   pads and UNBOUND keys, one launch a call; unaligned build rows must
   raise;
   the semi-join's batches mix its bitmap and search paths, sit at the
   edges of its density rule and have bitmap ranges that are not a
   multiple of 32, and its bitmap words are held against their plain
   build; the bucket count on every path and both sides of each cut,
   sizes around 16 and 4,096 keys, key and validity views at offsets of
   0-3 keys, with the register cut as committed and at 0, and at 2^28
   keys with 1 and 2 buckets its register path against its shared
   histogram in turns; its batched launch, ``(B, n)`` keys into ``(B,
   n_buckets)`` with B of 1, 2, 7 and 32, rows of unlike valid counts,
   bucket counts on each side of each cut, rows whose length is and is
   not a whole number of 16-key steps, one launch a call);
3. the main path, with the kernels' launch counts reset just before and
   read just after: ``Dataset.watdiv(scale)`` (10M triples at scale 340,
   the paper's smallest WatDiv dataset, τ = 0.25) builds its ExtVP on
   the card (the semi-join kernel over every pair batch), then serves
   through ``Engine.query`` (every instance of the 20 basic templates)
   and ``Engine.query_batch`` (each template's instances as one launch
   sequence, padded to its bucket shape, with its peak device memory;
   ``BATCH_CUT`` templates skip it: their batch does not fit the card);
   a pair of CUDA events around every join-probe call, read after the
   suite (the probe's whole cost over the path, by probe size); then the
   numpy ExtVP build over the same VP tables, which must give a
   byte-identical catalog, and both kernels timed again on the largest
   inputs the main path gave them (the join probe at 16,384 and 32,768
   ``SMEM_KEYS`` too; the semi-join's batch with the pairs and segments
   on each path of its plan, and the committed plan against one that
   sends every segment to the search, in turns);
4. the check: the card engine and the same port engine on the CPU serve
   the same queries, and every result must be equal row for row, with
   equal final capacities.  At ``--scale`` the first instance of every
   template but C1 and C2 (10^8 result rows each, which the CPU engine
   cannot serve within the smoke's time limit), single (``DEPTH_CUTS``);
   at ``--compare-scale`` (a tenth) every instance of every template,
   single and batched;
5. append, save and load at ``--compare-scale``: build on the first 99 %
   of the triples, save, append the last 1 %, load the store lazily
   (the journal replays on the card), and hold the catalog byte for
   byte against a from-scratch build over all of them, and a few
   templates row for row against the in-memory dataset;
6. the distributed engine (``repro_torch.core.distributed``).
   6a: a world of one rank over NCCL at ``--scale``, with the kernels'
   launch counts reset just before and read just after: the ExtVP build
   with ``build_backend="distributed"``, byte-identical to the numpy
   build, then every instance of the basic templates through
   ``Engine(backend="distributed")``, single and as one batch (one
   launch sequence, padded to its bucket shape: cold, then warm), each
   result equal as a multiset to the single-device card engine's (all
   but C1 and C2, whose static shuffle buckets do not fit on the card at
   one rank: ``ONE_RANK_CUT``); per template the single p50, the batch
   walls, the final caps, and the bucket-count and join-probe launches
   per attempt of the warm batch, which must equal one warm query's; a
   pair of CUDA events around every bucket-count call (every shuffle),
   summed over the path against its bound; the kernel timed on the
   largest one-row input this path gave it (repeated, so the input sits
   in L2; repeated with the host's work hidden; with L2 flushed before
   each call), a host-clock split of one small call, and the batched
   launch at 32 rows of the largest row of the path's batched shuffles
   against 32 single launches, the plain version, one ``torch.bincount``
   and its bound.  6b: two ranks that share the card, spawned by this
   script, over gloo at ``--compare-scale``: each loads the store phase
   5 saved, builds ExtVP distributed (byte-identical to the numpy build)
   and serves all 20 templates, single and batched (one launch sequence
   an attempt), held against the single-device card engine; a rank's
   failure fails the smoke.
7. the serving surface, with the kernels' launch counts reset just
   before each part and read just after (all three must run).  7a, at
   ``--scale`` after 6a, on phase 3's dataset: a ``SparqlServer`` takes
   32 interleaved instances of every template (3 of C1 and C2, whose
   results do not fit 32 times beside the catalog: ``SERVE_CUT``; one
   of a ``BATCH_CUT`` template) and one flush, then ``PARTIAL_INSTANCES``
   of each template but ``BATCH_CUT`` and one flush (partial buckets),
   each ticket held row for row against ``Engine.query``; every bucket
   is one launch sequence padded to its shape.  It prints
   ``summary()`` after each pass (non-zero padding waste), the tuner's
   report, the batch walls, and per template the chunks, attempts,
   join-probe launches per attempt against phase 3's per warm query and
   peak memory; then the batched probe on the most frequent served
   32-row step of each build form, against 32 single launches, the
   plain version and a batched ``torch.searchsorted`` pair; the suite served at trace rates 0, 1.0
   and 0.1 in turns on one engine (``TRACE_NO_CARDINALITY`` with the
   cardinality report off, then one request of each of
   ``REPORT_AT_SCALE`` with it on, timed: C1's is timed in 7b),
   traced results equal to untraced ones, the Chrome dump read by
   ``tools/trace_inspect.py``, a ``device.launch`` span on every traced
   request and cardinalities on every flat BGP's; the estimate planner
   against greedy and the vp and tt layouts against extvp, results equal
   as multisets and p50s in turns (a template that runs out of card
   memory is left out and listed); the server on the distributed
   backend at one NCCL rank, where no bucket drains by the clock, then a
   pass of partial buckets, each one launch sequence padded to its shape
   (non-zero padding waste, and the tuner's report).  7b,
   at ``--compare-scale`` after phase 5: every template under every
   layout, one traced request of each ``TRACE_NO_CARDINALITY`` template
   with the cardinality report on (timed), a server booted from phase
   5's store path, and ``python -m repro_torch.launch.serve`` on that
   store as a subprocess (exit 0,
   latency and stage histograms in its Prometheus file, its trace dump
   read by ``tools/trace_inspect.py``).
8. the adaptive runtime and the host engine, with the kernels' launch
   counts reset just before each part and read just after.  8a, at
   ``--scale`` after 7a: ``Engine(ds, backend="auto")`` (a
   ``SparqlServer``'s, default router knobs) serves ``AUTO_INSTANCES``
   instances of every template but ``AUTO_SMALL_ONLY`` one by one, each
   held against the torch engine (row for row when routed to torch, as
   a multiset when to eager), with join-probe launches counted over the
   auto calls routed to torch (more than 0) and no ``failed``
   exclusion; per template the router's seat, reason, EWMAs, requests
   routed to each backend and warm p50s through auto, torch and eager;
   the same templates under ``layout="pt"`` (the flagged eager
   fallback: every request counted), equal to the eager engine's, with
   their host-time p50s beside phase 7's extvp, vp and tt columns; two
   served passes of 7a's request mix (less ``AUTO_SMALL_ONLY``) through
   the auto server, one with the default router knobs (less
   ``DEFAULT_KNOBS_CUT``: its eager share and batch p50 / p99) and one
   with the probes off, and the Prometheus page's router and tuner
   families (the tuner's per-slot times among them).  8b, at ``--compare-scale`` after 7b: the
   same for ``AUTO_SMALL_ONLY`` through auto and all 20 templates under
   pt.  The cuts are printed as ``reduced``.
9. static analysis and the missing-constant repair, with the kernels'
   launch counts reset just before each part and read just after.  9a,
   at ``--scale`` after 8a, on phase 3's dataset: a fresh
   ``Engine(RuntimeConfig(verify_plans=True))`` prepares every template
   (each report free of errors and warnings; per template the
   verifier's host ms, the median of ``VERIFY_REPS`` calls of
   ``verify_prepared``, beside the prepare's) and serves one instance of
   each but ``BATCH_CUT``, single and as one batch of 3, each
   equal row for row to phase 3's engine, with the join probe launched
   through it; the eager engine's prepared forms pass the same
   verifier, with its checks run on every form that holds a plan; a prepared plan with its executor's last cap slot dropped
   must raise ``PlanVerificationError`` through ``Engine.query`` with no
   launch and nothing cached.  9b, at ``--compare-scale`` after 8b:
   ``explain()``'s verdict line of every template equal on the card
   engine and the CPU engine; the repair's queries (``REPAIR_QUERIES``,
   a constant missing from the dictionary under OPTIONAL, in a UNION
   branch, in a FILTER, and one in a required pattern) on a small
   dataset built on the card, on the torch backend and on the
   distributed backend at one NCCL rank, single and batched, each equal
   to the oracle (``core/reference.py``), the semi-join launched by the
   card build, the join probe by each backend and the bucket count by
   the distributed one, each part counted apart;
   ``examples/quickstart_torch.py`` (its two ``True`` lines) and
   ``examples/serve_sparql_torch.py`` (its agreement line) as
   subprocesses on the card, each exiting 0.
10. the LM substrate's serving path (``repro_torch.models``), after 6b,
   with the kernels' launch counts reset before and read after (the
   path launches none of them; the count is printed).  10a: qwen1.5-0.5b,
   granite-moe-1b-a400m, mamba2-370m and whisper-small at full width,
   one config at a time, params from the port's ``init`` on the card
   (seed ``--seed``), freed before the next.  In float32: teacher-forced
   ``forward`` equal to 128 ``decode`` steps at B = 2 (whisper:
   ``decode_train`` against ``decode_step`` over caches of one encoder
   output; granite-moe at a capacity no routing exceeds,
   ``lm_no_drops``; mamba2's forward at an SSD chunk of 16,
   ``LM_EXACT_SSM_CHUNK``), and ``prefill`` at B = 1 equal on the card
   and on the CPU (mamba2 at its published chunk).  At the published
   bf16: ``prefill`` at B = 4 × 1,024 tokens and 32 greedy decode steps
   at B = 4 from empty caches of 1,024 positions (``lm_greedy``, as the
   launcher decodes), on CUDA events, every logit finite, with the peak
   memory, the param bytes and each one's bound.  10b: the other six
   architectures at reduced size, prefill and 4 decode steps in
   float32, card equal to CPU.  10c: ``python -m repro_torch.launch.serve
   --mode lm`` as a subprocess (exit 0, its tok/s line).
11. the LM substrate's training path (``repro_torch.train``), after
   phase 10, with the kernels' launch counts reset before and read
   after (all must read 0).  11c's subprocesses start first and run in
   a thread (``Subprocesses``) while the float32 checks do:
   ``python -m repro_torch.launch.train`` on the full qwen1.5-0.5b for
   20 steps with a checkpoint at step 10, again for 25 (its resume line
   from step 10 required), then ``examples/train_lm_torch.py``, each
   exiting 0.  11a's float32 half, for the four configs of 10a at full
   width: ``loss_and_grads`` at B = 1 (S = 64; mamba2 256) on the card
   with TF32 off and on the CPU, ‖g_card − g_cpu‖ / ‖g_cpu‖ at most
   ``TRAIN_GRAD_RATIO`` or, past it, ``TRAIN_COND_FACTOR`` times the
   CPU's own movement under a ``TRAIN_PERTURB`` perturbation of the
   params; one step with ``accum_steps=2`` equal to one with 1 on the
   same batch.  11b: the six other configs reduced, the same gradient
   check.  Then 11a's half at the published bf16, alone on the card:
   20 steps whose loss must fall (remat off: ``TRAIN_CUTS``), the
   step at 4 × 1,024 tokens with remat on and off (the median of 5
   after 2 on CUDA events, forward + backward and optimizer apart,
   tokens/s, the share of its bound, peak memory, lower with remat on),
   and on qwen a checkpoint saved at step 3, restored into a fresh
   state and 2 more steps equal to the uninterrupted run under
   deterministic algorithms.
12. the dry run (``repro_torch.launch.dryrun``) against the card, after
   phase 11.  12a: the S2RDF cell at one NCCL rank (``--mesh auto``),
   with the kernels' launch counts reset before and read after (all
   three must run): ``Dataset.watdiv(2.0, seed=0)`` built on the card
   (the semi-join), then for ``extvp`` and ``vp`` the record of one
   attempt at the initial caps (collective bytes by kind, ``collective_s``
   at the NVLink figure, traced bytes, ``overflowed``) and a full run
   of the cell's query (join probe and bucket count), whose answer must
   equal the single-device engine's as a multiset (checked after the
   counts are read); the vp/extvp ratio of collective bytes.  12b: for
   qwen1.5-0.5b and granite-moe-1b-a400m at full width and bf16, the dry
   run's record at a one-card mesh of phase 10a's prefill (4 × 1,024)
   and phase 11a's train step (4 × 1,024, remat off): its
   ``traced_flops_total`` must equal a ``FlopCounterMode`` count of the
   same step run on the card, and its ``argument_bytes`` the summed
   bytes of the params, optimizer state and batch on the card, both
   exactly; each step's ``step_seconds_bound`` (the eager port's traced
   work: its unfused traffic, not a floor) and
   ``step_seconds_bound_lower`` (one pass over arguments, outputs and
   peak temporaries: the floor) are printed beside the milliseconds
   phases 10a and 11a measured, as shares (not timed again).

Each phase's header gives the seconds since the start.  It prints one
JSON line with phase 6's numbers, one with the join probe's numbers
over the main path, one with the batched probe's (phase 2's check, the
served step's times, each template's launches per served batch), one
with phase 7's numbers, one with phase 8's, one with phase 9's, one
with phase 10's (``{"lm": ...}``), one with phase 11's (``{"train":
...}``), one with phase 12's (``{"dryrun": ...}``), one with the
kernels' numbers, then
the card's name and power limit, then ``{"ok": true, "device": {...}}``
as the last line.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import subprocess
import shutil
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (data sheet)
SCALAR_OPS_PER_S = 67e12       # H100 SXM float32 rate outside the tensor cores
TPU_KERNEL = {"join_probe": "src/repro/kernels/mergejoin.py:40",
              "semijoin_membership": "src/repro/kernels/semijoin.py:40",
              "bucket_count": "src/repro/kernels/bucketcount.py:30"}
KERNEL_SOURCE = {
    "join_probe": "src/repro_torch/kernels/csrc/join_probe.cu",
    "semijoin_membership": "src/repro_torch/kernels/csrc/semijoin.cu",
    "bucket_count": "src/repro_torch/kernels/csrc/bucketcount.cu"}
PROBE_PAD = 2**31 - 1
#: depth cuts of earlier paths that keep the smoke inside its time limit
#: (a whole run on a slower host reached ``[end]`` at 1,318 s of the
#: 1,200 allowed: PERF.md section 6), printed as ``reduced`` in phase 4
DEPTH_CUTS = [
    "phase 4 at --scale holds each template's first instance, single, "
    "card against CPU (was every instance and each template's batch); "
    "--compare-scale still holds every instance and batch",
    "7a's trace turns at --scale run one text each of C1 and C2 (was "
    "each distinct instance)",
    "8b's pt layout times C1 and C2 by their checked run (was one more "
    "run each): on the host engine a run of theirs takes 3.5-18 s",
    "10a holds decode against forward over 128 positions (was 256)"]
#: distinct texts of each ``TRACE_NO_CARDINALITY`` template in 7a's
#: trace turns
HEAVY_TEXTS = 1
#: seconds the two ranks of phase 6b may take together
RANKS_TIMEOUT_S = 600
#: templates phase 6a leaves out: at one rank their shuffles' static
#: buckets (four times a relation's 2^28 slots) do not fit on the card
#: beside the catalog; phase 6b serves them at two ranks
ONE_RANK_CUT = ("C1", "C2")


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
    # aimed at the search: runs longer than a segment, runs on splitters
    # or filling the column, keys equal to splitters, all-pad probes and
    # builds of pads (phase_kernels runs them at several SMEM_KEYS)
    keys = torch.arange(-2, 130, dtype=torch.int32)
    for n_b, r in [(64, 37), (200, 16), (1000, 37), (1000, 300), (2049, 64)]:
        cases.append((f"runs of {r} in {n_b}", keys,
                      torch.arange(n_b, dtype=torch.int32) // r))
    b = torch.arange(0, 3 * 1024, 3, dtype=torch.int32)
    cases.append(("keys on splitters", b[::8].clone(), b))
    cases.append(("whole-column run",
                  torch.tensor([6, 7, 8, big, -3], dtype=torch.int32),
                  torch.full((777,), 7, dtype=torch.int32)))
    cases.append(("all-pad probe", torch.full((300,), big, dtype=torch.int32),
                  sorted_build(500, 0, 1000)))
    cases.append(("all-pad build",
                  torch.tensor([0, big, big - 1, -3, 5], dtype=torch.int32),
                  torch.full((300,), big - 1, dtype=torch.int32)))
    b = torch.full((1500,), big - 1, dtype=torch.int32)
    b[:3] = -5
    b[3:90] = sorted_build(87, 0, 40)
    cases.append(("mostly-pad build",
                  torch.cat([torch.arange(-6, 42, dtype=torch.int32),
                             torch.tensor([big, -3, big - 1],
                                          dtype=torch.int32)]), b))
    cases.append(("long run of int32 max",
                  torch.tensor([big, 9, big - 1], dtype=torch.int32),
                  torch.cat([torch.arange(10, dtype=torch.int32),
                             torch.full((100,), big, dtype=torch.int32)])))
    for n_b in [100, 127, 128]:       # stride 2 at SMEM_KEYS 64
        cases.append((f"runs past 64 in {n_b}",
                      torch.arange(-1, 8, dtype=torch.int32),
                      sorted_build(n_b, 0, 6)))
    for n_b in [31, 33, 1023, 1025, 4096, 4097, 32768, 32769]:
        b = sorted_build(n_b, 0, 2 * n_b)
        a = torch.randint(-1, 2 * n_b + 2, (700,), generator=gen,
                          dtype=torch.int32)
        a[::3] = b[torch.randint(0, n_b, (len(a[::3]),), generator=gen)]
        cases.append((f"ragged build {n_b}", a, b))
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


def smem_keys_ms(ops, ref, a: torch.Tensor, b: torch.Tensor) -> dict:
    """The kernel's time at 16,384 and 32,768 staged splitters, in turns
    (16K, 32K, 32K, 16K), each checked against the plain version."""
    default, out = ops.SMEM_KEYS, {}
    try:
        for sk in (16384, 32768, 32768, 16384):
            ops.SMEM_KEYS = sk
            check_probe(ops, ref, a, b, f"SMEM_KEYS {sk}")
            out.setdefault(sk, []).append(
                cuda_time_ms(lambda: ops.join_probe(a, b)))
    finally:
        ops.SMEM_KEYS = default
    return out


def allocator_counts():
    """``cudaMalloc`` calls and retries (cached blocks freed to make room)
    of PyTorch's caching allocator so far."""
    st = torch.cuda.memory_stats()
    return st.get("num_device_alloc", 0), st.get("num_alloc_retries", 0)


def probe_profile(ref, a: torch.Tensor, b: torch.Tensor) -> dict:
    """What the keys of one probe input are like: probe pads, keys
    outside the build's range, keys that match and their mean run."""
    _, cnt = ref.join_probe_ref(a, b)
    hit = cnt > 0
    live = b[b != 2**31 - 2]
    out_of_range = (a < live[0]) | (a > live[-1]) if live.numel() else a == a
    return {"n_a": a.numel(), "n_b": b.numel(),
            "probe_pads": int((a == PROBE_PAD).sum()),
            "build_pads": b.numel() - live.numel(),
            "outside_build_range": int(out_of_range.sum()),
            "matching": int(hit.sum()),
            "mean_run_of_matching": float(cnt[hit].double().mean())
            if bool(hit.any()) else 0.0}


def phase_kernels(ops, ref) -> None:
    gen = torch.Generator().manual_seed(0)
    cases = [(what, a.cuda(), b.cuda()) for what, a, b in probe_cases(gen)]
    default = ops.SMEM_KEYS
    # small SMEM_KEYS give these sizes every stride from 1 to above 32
    try:
        for smem_keys in (default, 1, 4, 16, 64):
            ops.SMEM_KEYS = smem_keys
            for what, a, b in cases:
                check_probe(ops, ref, a, b, f"{what}, SMEM_KEYS {smem_keys}")
            log(f"  join_probe == plain at SMEM_KEYS {smem_keys}: "
                f"{', '.join(w for w, _, _ in cases)}")
    finally:
        ops.SMEM_KEYS = default
    b = torch.arange(100, dtype=torch.int32, device="cuda")
    before = ops.launches["join_probe"]
    try:
        ops.join_probe(b[:10], b[1:])
    except ValueError as e:
        log(f"  join_probe refuses a misaligned build: {e}")
    else:
        raise AssertionError("join_probe took a build column that is not "
                             "16-byte aligned")
    if ops.launches["join_probe"] != before:
        raise AssertionError("join_probe launched on a misaligned build")
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


#: the batched probe's unit cases: bindings a batch, and build lengths
#: from 16 to 2^19 keys (with SMEM_KEYS at 32,768 and at 64 every stride
#: and window width of the search occurs).  A build a row needs rows of a
#: multiple of 4 keys (16-byte aligned), so the odd lengths take one
#: build for every row only, beside a multiple of 4 just past them.
BATCH_SIZES = (1, 2, 7, 32)
BATCH_BUILD_KEYS = (16, 100, 1024, 4097, 4100, 32768, 32769, 32772,
                    1 << 17, 1 << 19)
BATCH_PROBE_KEYS = 1000


def batched_probe_case(gen: torch.Generator, batch: int, n_b: int):
    """(probe (B, n_a), builds (B, n_b)) on the card: each build row
    ascending with its own count of live keys (UNBOUND keys -5 at its
    head when it has a few, build pads 2^31-2 behind), each probe row a
    mix of its build's keys, keys outside it, probe pads 2^31-1 and
    UNBOUND keys -3; the last row of a batch of 3 or more all pads (a
    padding binding's)."""
    dev = "cuda"
    live = torch.randint(0, n_b + 1, (batch,), generator=gen)
    live[0] = n_b
    keys = torch.sort(torch.randint(0, max(n_b // 2, 2), (batch, n_b),
                                    generator=gen, dtype=torch.int32),
                      dim=1).values
    col = torch.arange(n_b)[None, :]
    b = torch.where(col < live[:, None], keys, torch.tensor(2**31 - 2,
                                                           dtype=torch.int32))
    b[:, :2] = torch.where(live[:, None] > 4, torch.tensor(-5,
                           dtype=torch.int32), b[:, :2])
    a = torch.randint(-2, n_b, (batch, BATCH_PROBE_KEYS), generator=gen,
                      dtype=torch.int32)
    pick = torch.randint(0, n_b, (batch, BATCH_PROBE_KEYS), generator=gen)
    pick = torch.minimum(pick, torch.clamp(live[:, None] - 1, min=0))
    own = torch.gather(b, 1, pick)
    a = torch.where((torch.arange(BATCH_PROBE_KEYS) % 3 == 0)[None, :]
                    & (live[:, None] > 0), own, a)
    a[:, ::7] = PROBE_PAD
    a[:, 1::11] = -3
    if batch >= 3:
        a[-1] = PROBE_PAD
    return a.to(dev).contiguous(), b.to(dev).contiguous()


def phase_batched_probe(ops, ref) -> dict:
    """The batched join probe against its plain version, exactly: every
    batch size of ``BATCH_SIZES`` and build length of
    ``BATCH_BUILD_KEYS``, with a build a row (``join_probe_batched_
    launch``) and with one build for every row (row 0's: the rows end to
    end, one launch), at the committed ``SMEM_KEYS`` and at 64; one
    launch a call.  A build a row whose rows are not 16-byte aligned
    raises and launches nothing."""
    gen = torch.Generator().manual_seed(19)
    default, calls = ops.SMEM_KEYS, 0
    cases = [(bsz, n_b) + batched_probe_case(gen, bsz, n_b)
             for bsz in BATCH_SIZES for n_b in BATCH_BUILD_KEYS]
    try:
        for smem_keys in (default, 64):
            ops.SMEM_KEYS = smem_keys
            for bsz, n_b, a, b in cases:
                forms = [(b[0].contiguous(), "one build")]
                if bsz == 1 or n_b % 4 == 0:
                    forms.append((b, "a build a row"))
                for build, form in forms:
                    before = ops.launches["join_probe"]
                    lo, cnt = ops.join_probe(a, build)
                    torch.cuda.synchronize()
                    if ops.launches["join_probe"] != before + 1:
                        raise AssertionError("a batched join_probe call did "
                                             "not launch once")
                    wlo, wcnt = ref.join_probe_ref(a, build)
                    if not (torch.equal(lo, wlo) and torch.equal(cnt, wcnt)):
                        raise AssertionError(
                            f"batched join_probe B {bsz}, n_b {n_b}, {form}, "
                            f"SMEM_KEYS {smem_keys}: kernel != plain")
                    calls += 1
    finally:
        ops.SMEM_KEYS = default
    bad = torch.zeros((3, 6), dtype=torch.int32, device="cuda")
    before = ops.launches["join_probe"]
    try:
        ops.join_probe(torch.zeros((3, 10), dtype=torch.int32,
                                   device="cuda"), bad)
    except ValueError:
        pass
    else:
        raise AssertionError("join_probe took build rows that are not "
                             "16-byte aligned")
    if ops.launches["join_probe"] != before:
        raise AssertionError("join_probe launched on unaligned build rows")
    log(f"  batched join_probe == plain on {calls} calls: B "
        f"{list(BATCH_SIZES)} x n_b {list(BATCH_BUILD_KEYS)} x (one build; "
        f"a build a row where n_b is a multiple of 4) x SMEM_KEYS "
        f"({default}, 64), {BATCH_PROBE_KEYS} probe keys a row; unaligned "
        f"build rows refused")
    del cases
    torch.cuda.empty_cache()
    return {"calls": calls, "max_abs_err": 0}


def batched_probe_numbers(ops, ref, a: torch.Tensor, b: torch.Tensor
                          ) -> dict:
    """Times and bound of one batched probe (a ``(B, n_a)`` probe
    against a ``(B, n_b)`` build, or one ``(n_b,)`` build for every
    row): the batched kernel, B single launches, the plain version, one
    batched ``torch.searchsorted`` pair; the bytes bound reads the B·n_a
    probe keys and one build per distinct build row and writes B·n_a·8
    bytes.  Each checked against the plain version first."""
    batch, n_a = a.shape
    per_row = b.dim() == 2
    n_b = b.shape[-1]
    err = check_probe(ops, ref, a, b, f"batched {batch} x {n_a} x {n_b}")
    rows = [(a[r], b[r] if per_row else b) for r in range(batch)]

    def singles():
        for x, y in rows:
            ops.join_probe(x, y)

    ms = cuda_time_ms(lambda: ops.join_probe(a, b))
    singles_ms = cuda_time_ms(singles)
    plain_ms = cuda_time_ms(lambda: ref.join_probe_ref(a, b))
    library_ms = cuda_time_ms(lambda: (
        torch.searchsorted(b, a, out_int32=True),
        torch.searchsorted(b, a, right=True, out_int32=True)))
    nbytes = 12 * batch * n_a + 4 * n_b * (batch if per_row else 1)
    return {"batch": batch, "n_a": n_a, "n_b": n_b,
            "build": "a build a row" if per_row else "one build",
            "ms": ms, "singles_ms": singles_ms, "plain_ms": plain_ms,
            "library_ms": library_ms,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "max_abs_err": err}


def span_build(rng, n: int, lo: int, span: int) -> torch.Tensor:
    """``n`` ascending unique int32 keys, the first ``lo`` and the last
    ``lo + span - 1``."""
    if n == 1:
        return torch.tensor([lo], dtype=torch.int32)
    mid = rng.choice(span - 2, n - 2, replace=False) + 1 + lo
    keys = np.sort(np.concatenate([[lo, lo + span - 1], mid]))
    return torch.from_numpy(keys.astype(np.int32))


def probe_near(rng, b: torch.Tensor, n: int) -> torch.Tensor:
    """Probe keys around a build segment: members, keys inside and just
    outside its range, the probe pad."""
    lo, hi = int(b[0]), int(b[-1])
    near = rng.integers(max(lo - 64, -2**31), min(hi + 65, PROBE_PAD - 1),
                        n - n // 2 - 3)
    edge = [max(lo - 1, -2**31), min(hi + 1, PROBE_PAD - 1), PROBE_PAD]
    a = np.concatenate([rng.choice(b.numpy(), n // 2), near, edge])
    return torch.from_numpy(rng.permutation(a).astype(np.int32))


def semijoin_cases(gen: torch.Generator, rng):
    """(name, [(probe, build_sorted), ...], which pairs take the bitmap
    or None) pair batches on the host."""
    big = 2**31 - 1
    floor = 65536                     # ops.SEMIJOIN_BITMAP_MIN_WORDS

    def build_of(n, hi):
        return torch.unique(torch.randint(0, hi, (n,), generator=gen,
                                          dtype=torch.int32))

    def probe_of(n, hi):
        return torch.randint(0, hi, (n,), generator=gen, dtype=torch.int32)

    mixed = [span_build(rng, 300, 1000, 1000), span_build(rng, 10, -1, 2**31),
             span_build(rng, 16, 5000, 32 * floor + 1),
             span_build(rng, 200_000, -300, 4_000_000),
             span_build(rng, 1, 77, 1)]
    edges = [span_build(rng, 100_000, 0, 32 * 100_000),
             span_build(rng, 100_000, 0, 32 * 100_000 + 1),
             span_build(rng, 16, 123, 32 * floor),
             span_build(rng, 16, 123, 32 * floor + 1)]
    odd = [span_build(rng, n, lo, span) for n, lo, span in
           [(5, 0, 37), (40, -7, 1001), (3000, 11, 65_535), (1, 5, 1)]]
    return [
        # the pad sentinels: probe pads 2^31-1, build pads 2^31-2
        ("sentinels", [(torch.tensor([5, big, 9, big - 1, -1, 0, 7],
                                     dtype=torch.int32),
                        torch.tensor([-1, 0, 5, 9, big - 1],
                                     dtype=torch.int32))], [False]),
        ("empty build", [(torch.arange(50, dtype=torch.int32),
                          torch.empty(0, dtype=torch.int32))], [False]),
        ("build of one key", [(probe_of(300, 4),
                               torch.tensor([2], dtype=torch.int32))],
         [True]),
        ("probe not in order", [(torch.randperm(5000, generator=gen)
                                 .to(torch.int32), build_of(2000, 6000))],
         [True]),
        ("ragged batch", [(probe_of(n_a, 900), build_of(n_b, 900))
                          for n_a, n_b in [(255, 7), (256, 1), (257, 300),
                                           (0, 5), (1, 0), (1000, 513),
                                           (3001, 2000)]], None),
        ("64 pairs of up to 2^20 keys",
         [(probe_of(int(n_a), 1 << 21), build_of(int(n_b), 1 << 21))
          for n_a, n_b in torch.randint(0, 1 << 20, (64, 2), generator=gen)],
         None),
        # bitmap and search pairs in one launch
        ("mixed bitmap and search pairs",
         [(probe_near(rng, b, 20_000 + 9 * i), b)
          for i, b in enumerate(mixed)], [True, False, False, True, True]),
        # the density rule's edges: 1 word a key, and the 65,536-word floor
        ("segments at the density threshold and one word past",
         [(probe_near(rng, b, 50_000), b) for b in edges],
         [True, False, True, False]),
        ("bitmap ranges not a multiple of 32",
         [(probe_near(rng, b, 4_001), b) for b in odd], [True] * 4),
    ]


def pack_pairs(batch):
    """One ragged (probe, build, pairs) triple of a list of pairs."""
    probe = torch.cat([a for a, _ in batch])
    build = torch.cat([b for _, b in batch])
    la = np.array([a.numel() for a, _ in batch], dtype=np.int64)
    lb = np.array([b.numel() for _, b in batch], dtype=np.int64)
    pairs = np.stack([np.cumsum(la) - la, la, np.cumsum(lb) - lb, lb], axis=1)
    return probe, build, pairs


def check_semijoin(ops, ref, probe, build, pairs, what: str,
                   expect_bitmap=None) -> int:
    """The semi-join against its plain version, exactly: the mask, the
    counts, the plan's bitmap words against their plain build, and the
    pairs ``ops.semijoin_paths`` says took each path."""
    mask, counts = ops.semijoin_mask(probe, build, pairs)
    torch.cuda.synchronize()
    paths = dict(ops.semijoin_paths)
    wmask, wcounts = ref.semijoin_pairs_ref(probe, build, pairs)
    if mask.dtype != torch.uint8 or counts.dtype != torch.int64:
        raise AssertionError(f"semijoin {what}: outputs not uint8 / int64")
    err = max(int((mask.int() - wmask.int()).abs().max())
              if mask.numel() else 0,
              int((counts - wcounts).abs().max()) if counts.numel() else 0)
    if err:
        raise AssertionError(f"semijoin {what}: kernel != plain "
                             f"(max abs err {err})")
    plan = ops.semijoin_plan(build, pairs)
    words = ops.semijoin_bitmaps(build, plan)
    torch.cuda.synchronize()
    if not torch.equal(words, ref.semijoin_bitmaps_ref(build, plan)):
        raise AssertionError(f"semijoin {what}: bitmap words != plain")
    on_bitmap = plan.bitmap[plan.seg_of_pair]
    want = {"bitmap": int(on_bitmap.sum()),
            "search": len(pairs) - int(on_bitmap.sum())}
    if int(pairs[:, 1].sum()) and paths != want:
        raise AssertionError(f"semijoin {what}: paths {paths} != plan {want}")
    if expect_bitmap is not None and on_bitmap.tolist() != expect_bitmap:
        raise AssertionError(f"semijoin {what}: bitmap path of the pairs "
                             f"{on_bitmap.tolist()} != {expect_bitmap}")
    return err


def tagged_keys(probe, build, pairs):
    """Every pair's probe keys and build segment as int64 keys
    ``pair << 32 | uint32(key)``: one ``torch.isin`` over the two computes
    the batch's masks end to end."""
    dev = probe.device
    pairs_t = torch.from_numpy(pairs).to(dev)
    pidx = torch.arange(len(pairs), device=dev, dtype=torch.int64)

    def side(off, n, keys):
        start = torch.cumsum(n, 0) - n
        pos = torch.arange(int(n.sum()), device=dev) + \
            torch.repeat_interleave(off - start, n)
        tag = torch.repeat_interleave(pidx, n) << 32
        return tag | (keys[pos].to(torch.int64) & 0xFFFFFFFF)

    return (side(pairs_t[:, 0], pairs_t[:, 1], probe),
            side(pairs_t[:, 2], pairs_t[:, 3], build))


def semijoin_numbers(ops, ref, probe, build, pairs, reps: int) -> dict:
    """Times and bound of the semi-join on one pair batch.  The library
    yardstick is one ``torch.isin``: over the pair's keys for a batch of
    one pair, else over the keys tagged with their pair
    (:func:`tagged_keys`, made before the timing)."""
    pairs = np.asarray(pairs, dtype=np.int64)
    ms = cuda_time_ms(lambda: ops.semijoin_mask(probe, build, pairs), reps)
    plain_ms = cuda_time_ms(
        lambda: ref.semijoin_pairs_ref(probe, build, pairs), reps)
    if len(pairs) == 1:
        po, pl, bo, bl = (int(x) for x in pairs[0])
        a, b = probe[po:po + pl], build[bo:bo + bl]
        library = "torch.isin"
    else:
        a, b = tagged_keys(probe, build, pairs)
        library = "torch.isin over int64 keys tagged with their pair"
    library_ms = cuda_time_ms(lambda: torch.isin(a, b), reps)
    del a, b
    n_keys = int(pairs[:, 1].sum())
    # bytes the function must move: each probe key read (4 B) and its
    # mask byte written, each distinct build segment read once, the
    # pair descriptors read and the int64 counts written
    builds = {(int(o), int(n)) for o, n in pairs[:, 2:4]}
    nbytes = 5 * n_keys + 4 * sum(n for _, n in builds) + 40 * len(pairs)
    return {"pairs": len(pairs), "n_keys": n_keys, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library": library,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}


def phase_semijoin_kernel(ops, ref) -> None:
    gen = torch.Generator().manual_seed(1)
    rng = np.random.default_rng(1)
    for what, batch, expect in semijoin_cases(gen, rng):
        probe, build, pairs = pack_pairs(batch)
        probe, build = probe.cuda(), build.cuda()
        check_semijoin(ops, ref, probe, build, pairs, what, expect)
        # the probe as a view one key past a 16-byte boundary
        shifted = torch.cat([probe[:1], probe])[1:]
        check_semijoin(ops, ref, shifted, build, pairs, what + ", shifted",
                       expect)
        log(f"  semijoin == plain: {what} ({len(pairs)} pairs, "
            f"{int(pairs[:, 1].sum())} probe keys; bitmap words equal; "
            f"pairs by path {ops.semijoin_paths})")


def bucket_cases(gen: torch.Generator):
    """(name, keys, valid, n_buckets) unit cases on the host."""
    def keys_of(n):
        return torch.randint(-2**31, PROBE_PAD, (n,), generator=gen,
                             dtype=torch.int32)

    cases = [("empty", keys_of(0), torch.zeros(0, dtype=torch.bool), 3)]
    k = keys_of(5000)
    cases.append(("all invalid", k, torch.zeros(5000, dtype=torch.bool), 6))
    # UNBOUND (-1), A_NULL (-3), pads (valid and not)
    k = torch.tensor([-1, -1, -3, 5, PROBE_PAD, PROBE_PAD, 7, -3],
                     dtype=torch.int32)
    v = torch.tensor([1, 1, 1, 1, 1, 0, 0, 1], dtype=torch.bool)
    cases.append(("sentinels", k, v, 3))
    for nb in (1, 2, 3, 6, 8, 256, 20000):
        k = keys_of(100003)
        k[::5] = -1
        k[1::7] = -3
        k[2::11] = PROBE_PAD
        v = torch.rand(100003, generator=gen) < 0.8
        cases.append((f"random, {nb} buckets", k, v, nb))
    return cases


def check_bucket(ops, ref, keys, valid, nb: int, what: str) -> int:
    got = ops.bucket_count(keys, valid, nb)
    torch.cuda.synchronize()
    want = ref.bucket_count_ref(keys, valid, nb)
    if got.dtype != torch.int32 or got.shape != (nb,):
        raise AssertionError(f"bucket_count {what}: output not int32 ({nb},)")
    err = int((got.long() - want.long()).abs().max()) if nb else 0
    if err:
        raise AssertionError(f"bucket_count {what}: kernel != plain "
                             f"(max abs err {err})")
    return err


def bucket_numbers(ops, ref, keys, valid, nb: int) -> dict:
    """Times and bound of the bucket count on one input.  The library
    yardstick is ``torch.bincount`` over the destination column, which
    one elementwise pass computes and is timed with.  Each is card time
    with the host's work hidden (:func:`queued_time_ms`); the kernel is
    also timed as :func:`cuda_time_ms` reads it (``repeated_ms``), where
    a call's host work longer than its kernel shows."""
    n = keys.numel()
    ms = queued_time_ms(lambda: ops.bucket_count(keys, valid, nb))
    repeated_ms = cuda_time_ms(lambda: ops.bucket_count(keys, valid, nb))
    plain_ms = queued_time_ms(lambda: ref.bucket_count_ref(keys, valid, nb))

    def library():
        dest = torch.where(valid & (keys != PROBE_PAD),
                           (keys.long() & 0xFFFFFFFF) % nb, nb)
        return torch.bincount(dest, minlength=nb + 1)[:nb]

    library_ms = queued_time_ms(library)
    # bytes: each key (4 B) and its validity byte read once, the
    # histogram written once; operations: two tests, a modulo and an add
    # per row
    bytes_ms = (5 * n + 4 * nb) / HBM_BYTES_PER_S * 1e3
    ops_ms = 4 * n / SCALAR_OPS_PER_S * 1e3
    return {"n": n, "n_buckets": nb, "ms": ms, "repeated_ms": repeated_ms,
            "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def cold_time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Card time of one call of ``fn`` with L2 cold: before each call the
    card reads 256 MB (five times the 50 MB L2; a read, so that no dirty
    line is left to write back during the call), and a pair of CUDA
    events encloses the call alone.  The read takes longer than the
    call's host work, so the host has queued the call when the card
    reaches it: the events read card time."""
    flush = torch.ones(1 << 26, dtype=torch.int32, device="cuda")
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(reps):
        flush.max()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    del flush
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def queued_time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Card time a call of ``fn`` repeated with its inputs warm in L2 and
    its host work hidden: the card first spins (``torch.cuda._sleep``)
    while the host queues every call, so the events read card time even
    where a call's host work is longer than its kernel (which
    :func:`cuda_time_ms` would read instead)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bucket_host_split_us(ops, ref, n: int = 1 << 13, nb: int = 1,
                         reps: int = 2000) -> dict:
    """Where one small call's time goes, by the host clock with the card
    idle (microseconds a call): the wrapper's checks
    (``ops._bucket_on_card``), the output's allocation (``new_empty``;
    the zeroing is a ``cudaMemsetAsync`` inside the C entry point), the
    launch arithmetic and stream lookup (``_bucket_plan``, the raw
    current stream, the current device), the ctypes call (its memset and
    launch), and the whole call; each warm (``reps`` calls in a row) and
    with the host's caches cold (``reps / 20`` calls, each after the host
    reads 64 MB, as a call finds them on the main path, where other work
    runs between two calls).  Then by CUDA events, one call with the
    card idle before it (what phase 6a's path sum reads for a call) and
    the card time a call, host hidden."""
    gen = torch.Generator(device="cuda").manual_seed(n)
    keys = torch.randint(-2**31, PROBE_PAD, (n,), generator=gen,
                         device="cuda", dtype=torch.int32)
    valid = torch.rand(n, generator=gen, device="cuda") < 0.75
    dev = keys.get_device()
    out = keys.new_empty(nb)
    plan = ops._bucket_plan(n, nb, ops._sm_count(dev), keys.data_ptr(),
                            valid.data_ptr())
    args = (keys.data_ptr(), valid.data_ptr(), n, nb,
            ops.BUCKET_PATH_IDS[plan.path], plan.lo, plan.hi, plan.blocks,
            ops.BUCKET_THREADS, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    fn = ops._bucket_count_fn()

    # the whole call again, each after the host reads 64 MB (more than
    # its caches hold), as a call finds them on the main path
    pollute = np.ones(1 << 23)

    def host_us(f, cold: bool):
        f()
        torch.cuda.synchronize()
        if cold:
            total = 0.0
            for _ in range(reps // 20):
                pollute.sum()
                t = time.perf_counter()
                f()
                total += time.perf_counter() - t
            us = total * 1e6 / (reps // 20)
        else:
            t = time.perf_counter()
            for _ in range(reps):
                f()
            us = (time.perf_counter() - t) * 1e6 / reps
        torch.cuda.synchronize()
        return us

    def plan_and_stream():
        ops._bucket_plan(n, nb, ops._sm_count(dev), keys.data_ptr(),
                         valid.data_ptr())
        torch._C._cuda_getCurrentRawStream(dev)
        return dev == torch._C._cuda_getDevice()

    pieces = {"checks": lambda: ops._bucket_on_card(keys, valid, nb),
              "allocation": lambda: keys.new_empty(nb),
              "plan_and_stream": plan_and_stream,
              "ctypes_launch": lambda: fn(*args),
              "whole_call": lambda: ops.bucket_count(keys, valid, nb)}
    split = {"n": n, "n_buckets": nb, "path": plan.path}
    for state in ("warm", "cold_caches"):
        us = {k: host_us(f, state != "warm") for k, f in pieces.items()}
        us["rest"] = us["whole_call"] - sum(
            v for k, v in us.items() if k != "whole_call")
        split[f"{state}_us"] = us
    idle = []
    for _ in range(200):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()     # created here, outside the timed span
        end.record()
        torch.cuda.synchronize()
        start.record()
        ops.bucket_count(keys, valid, nb)
        end.record()
        idle.append((start, end))
    torch.cuda.synchronize()
    split["event_idle_us"] = 1e3 * sum(a.elapsed_time(b)
                                       for a, b in idle) / len(idle)
    split["card_us"] = 1e3 * queued_time_ms(
        lambda: ops.bucket_count(keys, valid, nb), reps=200)
    check_bucket(ops, ref, keys, valid, nb, "the split's input")
    return split


#: bucket counts on both sides of each cut of the bucket-count kernel's
#: paths (registers up to ops.BUCKET_REG_MAX = 8, the shared histogram
#: up to 12,288, global atomics above)
BUCKET_CUT_CASES = (1, 2, 3, 4, 8, 9, 256, 12288, 12289, 20000)
#: key counts around multiples of the kernel's 16-key step and of 4,096
BUCKET_SIZES = (15, 16, 17, 31, 4095, 4096, 4097, 3 * 4096 + 21, 100003)


def bucket_path(ops, keys, valid, nb: int) -> str:
    return ops._bucket_plan(keys.numel(), nb, ops._sm_count(0),
                            keys.data_ptr(), valid.data_ptr()).path


def bucket_edge_cases(ops, ref, gen: torch.Generator) -> None:
    """Every path and both sides of each cut, sizes around 16 and 4,096,
    key and validity views at offsets of 0-3 keys (so the body starts at
    another key, or the call takes the scalar loop), with the register
    cut as committed and at 0; each exact, each on the path its plan
    names."""
    n_max = max(BUCKET_SIZES) + 3
    keys = torch.randint(-2**31, PROBE_PAD, (n_max,), generator=gen,
                         dtype=torch.int32)
    keys[::5] = -1
    keys[1::7] = -3
    keys[2::11] = PROBE_PAD
    keys[3::3] = torch.randint(0, 50, (len(keys[3::3]),), generator=gen,
                               dtype=torch.int32)
    kc = keys.cuda()
    vc = (torch.rand(n_max, generator=gen) < 0.8).cuda()
    saved = ops.BUCKET_REG_MAX
    try:
        for reg_max in (saved, 0):
            ops.BUCKET_REG_MAX = reg_max
            for nb in BUCKET_CUT_CASES:
                want_path = ("registers" if nb <= reg_max else "shared"
                             if nb <= ops.BUCKET_SMEM_MAX else "global")
                calls, scalar = 0, 0
                for n in BUCKET_SIZES:
                    for ko in range(4):
                        for vo in range(4):
                            k, v = kc[ko:ko + n], vc[vo:vo + n]
                            plan = ops._bucket_plan(
                                n, nb, ops._sm_count(0), k.data_ptr(),
                                v.data_ptr())
                            if plan.path != want_path:
                                raise AssertionError(
                                    f"bucket_count plan: {nb} buckets at "
                                    f"register cut {reg_max} took "
                                    f"{plan.path}, not {want_path}")
                            before = ops.launches["bucket_count"]
                            check_bucket(ops, ref, k, v, nb,
                                         f"{n} keys at offsets {ko}/{vo}, "
                                         f"{nb} buckets, {plan.path}")
                            if ops.launches["bucket_count"] != before + 1:
                                raise AssertionError("bucket_count: a call "
                                                     "did not count one "
                                                     "launch")
                            calls += 1
                            scalar += plan.hi == plan.lo
                log(f"  bucket_count == plain, register cut {reg_max}, "
                    f"{nb} buckets ({want_path}): {calls} calls of "
                    f"{list(BUCKET_SIZES)} keys at key/validity offsets "
                    f"0-3 ({scalar} with no 16-byte body)")
    finally:
        ops.BUCKET_REG_MAX = saved


def bucket_registers_vs_shared_ms(ops, ref, keys, valid, nb: int) -> dict:
    """The register path against the shared histogram (register cut 0)
    on one input, in turns (registers, shared, shared, registers), each
    checked against the plain version."""
    saved = ops.BUCKET_REG_MAX
    out = {"registers": [], "shared": []}
    try:
        for which in ("registers", "shared", "shared", "registers"):
            ops.BUCKET_REG_MAX = saved if which == "registers" else 0
            if bucket_path(ops, keys, valid, nb) != which:
                raise AssertionError(f"bucket_count: {nb} buckets did not "
                                     f"take the {which} path")
            check_bucket(ops, ref, keys, valid, nb, f"{which} path")
            out[which].append(cuda_time_ms(
                lambda: ops.bucket_count(keys, valid, nb)))
    finally:
        ops.BUCKET_REG_MAX = saved
    return out


def phase_bucket_kernel(ops, ref) -> None:
    gen = torch.Generator().manual_seed(2)
    for what, k, v, nb in bucket_cases(gen):
        check_bucket(ops, ref, k.cuda(), v.cuda(), nb, what)
        log(f"  bucket_count == plain: {what} ({k.numel()} keys)")
    bucket_edge_cases(ops, ref, gen)
    n = 1 << 28
    dev_gen = torch.Generator(device="cuda").manual_seed(n)
    keys = torch.randint(-2**31, PROBE_PAD, (n,), generator=dev_gen,
                         device="cuda", dtype=torch.int32)
    valid = torch.rand(n, generator=dev_gen, device="cuda") < 0.75
    for nb in (1, 2):
        check_bucket(ops, ref, keys, valid, nb, f"2^28 keys, {nb} buckets")
        bn = bucket_numbers(ops, ref, keys, valid, nb)
        log(f"  bucket_count 2^28 keys, {nb} buckets: equal; kernel "
            f"{bn['ms']:.4f} ms (repeated as cuda_time_ms reads it "
            f"{bn['repeated_ms']:.4f}), plain {bn['plain_ms']:.4f} ms, "
            f"torch.bincount {bn['library_ms']:.4f} ms, bound "
            f"{bn['bound_ms']:.4f} ms ({bn['bound_by']}, "
            f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s)")
        turns = bucket_registers_vs_shared_ms(ops, ref, keys, valid, nb)
        log(f"  bucket_count 2^28 keys, {nb} buckets, register path "
            f"against the shared histogram (register cut 0), in turns "
            f"(ms): {json.dumps(turns)}")
    del keys, valid
    torch.cuda.empty_cache()


#: rows of phase 2's batched bucket-count cases
BUCKET_BATCHES = (1, 2, 7, 32)
#: bucket counts of the batched cases: each register count up to the cut
#: and one above it, one on each side of the shared-histogram cut, and
#: one in the global path
BUCKET_BATCH_BUCKETS = (1, 2, 3, 8, 9, 12287, 12288, 12289, 20000)
#: row lengths of the batched cases: a whole number of 16-key steps (each
#: row's body aligned) and not
BUCKET_BATCH_KEYS = (4096, 4096 + 21)


def batched_bucket_rows(gen: torch.Generator, batch: int, n: int,
                        off: int):
    """``(keys, valid)`` of ``batch`` rows of ``n`` keys on the card, a
    view ``off`` keys into its buffer: every row with its own share of
    valid keys and its own valid count (a PAD tail, as the executor's
    rows have), UNBOUND (-1), A_NULL (-3) and pads among the keys."""
    keys = torch.randint(-2**31, PROBE_PAD, (batch * n + off,),
                         generator=gen, dtype=torch.int32)
    keys[::5] = -1
    keys[1::7] = -3
    keys[2::11] = PROBE_PAD
    valid = torch.rand(batch * n + off, generator=gen) < 0.8
    k = keys.cuda()[off:].view(batch, n)
    v = valid.cuda()[off:].view(batch, n)
    for b in range(batch):
        v[b, n - (b * 613) % (n + 1):] = False
        k[b, n - (b * 613) % (n + 1):] = PROBE_PAD
    return k, v


def phase_batched_bucket(ops, ref) -> None:
    """The batched bucket count (``(B, n)`` keys, ``blockIdx.y`` the row)
    against its plain version, exactly: B of 1, 2, 7 and 32, each
    bucket count of ``BUCKET_BATCH_BUCKETS``, rows whose length is and is
    not a whole number of 16-key steps, at offsets of 0 and 1 key; each
    call one launch."""
    gen = torch.Generator().manual_seed(3)
    calls, paths, bodies = 0, set(), 0
    for batch in BUCKET_BATCHES:
        for n in BUCKET_BATCH_KEYS:
            for off in (0, 1):
                k, v = batched_bucket_rows(gen, batch, n, off)
                for nb in BUCKET_BATCH_BUCKETS:
                    plan = ops._bucket_plan(n, nb, ops._sm_count(0),
                                            k.data_ptr(), v.data_ptr(),
                                            batch)
                    before = ops.launches["bucket_count"]
                    got = ops.bucket_count(k, v, nb)
                    torch.cuda.synchronize()
                    if ops.launches["bucket_count"] != before + 1:
                        raise AssertionError("bucket_count: a batched call "
                                             "was not one launch")
                    want = ref.bucket_count_ref(k, v, nb)
                    if got.shape != (batch, nb) or not torch.equal(got,
                                                                   want):
                        raise AssertionError(
                            f"batched bucket_count != plain: B {batch}, n "
                            f"{n}, offset {off}, {nb} buckets, {plan}")
                    calls += 1
                    paths.add(plan.path)
                    bodies += plan.hi > plan.lo
    if paths != {"registers", "shared", "global"}:
        raise AssertionError(f"batched bucket_count took paths {paths}")
    log(f"  batched bucket_count == plain: {calls} calls (B "
        f"{list(BUCKET_BATCHES)}, rows of {list(BUCKET_BATCH_KEYS)} keys at "
        f"offsets 0 and 1, {list(BUCKET_BATCH_BUCKETS)} buckets, paths "
        f"{sorted(paths)}; {bodies} with a 16-byte body), one launch each")


def batched_bucket_numbers(ops, ref, n: int, nb: int,
                           batch: int = 32) -> dict:
    """The batched bucket count at ``batch`` rows of ``n`` keys and
    ``nb`` buckets, checked against its plain version and timed (CUDA
    events, host work hidden): the batched launch, ``batch`` single
    launches of its rows, the plain version, and the library yardstick,
    one ``torch.bincount`` over ``row·nb + dest`` of the live keys; the
    bound is the bytes: ``batch·n·5`` read, ``batch·nb·4`` written."""
    gen = torch.Generator(device="cuda").manual_seed(n + nb)
    keys = torch.randint(-2**31, PROBE_PAD, (batch, n), generator=gen,
                         device="cuda", dtype=torch.int32)
    valid = torch.rand((batch, n), generator=gen, device="cuda") < 0.75
    got = ops.bucket_count(keys, valid, nb)
    want = ref.bucket_count_ref(keys, valid, nb)
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    if err:
        raise AssertionError(f"batched bucket_count != plain at {batch} x "
                             f"{n} keys (max abs err {err})")
    rows = list(zip(keys.unbind(0), valid.unbind(0)))
    row_ids = torch.arange(batch, device="cuda")[:, None] * nb

    def singles():
        for k, v in rows:
            ops.bucket_count(k, v, nb)

    def library():
        dest = torch.where(valid & (keys != PROBE_PAD),
                           row_ids + (keys.long() & 0xFFFFFFFF) % nb,
                           batch * nb)
        return torch.bincount(dest.view(-1),
                              minlength=batch * nb + 1)[:batch * nb]

    out = {"batch": batch, "n": n, "n_buckets": nb,
           "path": ops._bucket_plan(n, nb, ops._sm_count(0),
                                    keys.data_ptr(), valid.data_ptr(),
                                    batch).path,
           "ms": queued_time_ms(lambda: ops.bucket_count(keys, valid, nb)),
           "singles_ms": queued_time_ms(singles),
           "plain_ms": queued_time_ms(
               lambda: ref.bucket_count_ref(keys, valid, nb)),
           "library_ms": queued_time_ms(library),
           "bound_ms": (5 * batch * n + 4 * batch * nb)
           / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
           "max_abs_err": err}
    del keys, valid, rows
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

class ProbeRecorder:
    """Keeps the largest probe the main path hands the join-probe kernel,
    so the kernel can be timed on real main-path inputs afterwards, and
    records a pair of CUDA events around every call (read only by
    :meth:`path_times`, after the run: no sync inside it).  It calls the
    wrapper unchanged; the launch count stays the wrapper's."""

    def __init__(self, jexec):
        self.jexec = jexec
        self.inner = jexec.ops.join_probe
        self.best = None
        self.shapes = {}
        self.events = []

    def __call__(self, a, b):
        key = (a.numel(), b.numel())
        self.shapes[key] = self.shapes.get(key, 0) + 1
        if self.best is None or a.numel() > self.best[0].numel():
            self.best = (a.clone(), b.clone())
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        before = allocator_counts()
        start.record()
        out = self.inner(a, b)
        end.record()
        grew = [x - y for x, y in zip(allocator_counts(), before)]
        self.events.append((a.numel(), b.numel(), start, end, grew))
        return out

    def path_times(self) -> dict:
        """The probe's whole cost over the run: the sum of every call's
        event time and of its bound, and both by ``n_a`` bucket (2^k <=
        n_a < 2^k+1) with the launches, the slowest call, the largest
        ``n_b``, and the ``cudaMalloc`` calls and allocator retries the
        calls made.  A call's events enclose the whole wrapper, so when
        the card is idle before it the time also holds the wrapper's host
        work (allocating the outputs, the launch)."""
        torch.cuda.synchronize()
        total, bound, buckets = 0.0, 0.0, {}
        for n_a, n_b, start, end, grew in self.events:
            ms = start.elapsed_time(end)
            # the bytes bound of probe_numbers
            bms = (12 * n_a + 4 * n_b) / HBM_BYTES_PER_S * 1e3
            total += ms
            bound += bms
            k = max(n_a, 1).bit_length() - 1
            bk = buckets.setdefault(k, {"launches": 0, "ms": 0.0,
                                        "bound_ms": 0.0,
                                        "max_call_ms": 0.0, "max_n_b": 0,
                                        "cuda_mallocs": 0, "alloc_retries": 0,
                                        "max_call_malloc": False})
            bk["launches"] += 1
            bk["ms"] += ms
            bk["bound_ms"] += bms
            bk["cuda_mallocs"] += grew[0]
            bk["alloc_retries"] += grew[1]
            if ms > bk["max_call_ms"]:
                bk["max_call_ms"], bk["max_call_malloc"] = ms, grew[0] > 0
            bk["max_n_b"] = max(bk["max_n_b"], n_b)
        return {"calls": len(self.events), "total_ms": total,
                "bound_ms": bound, "gap_ms": total - bound,
                "by_log2_n_a": {f"2^{k}": buckets[k]
                                for k in sorted(buckets)}}

    def __enter__(self):
        self.jexec.ops = _OpsShim(self.jexec.ops, join_probe=self)
        return self

    def __exit__(self, *exc):
        self.jexec.ops = self.jexec.ops.base


class SemijoinRecorder:
    """Keeps the largest pair batch the main path hands the semi-join
    kernel, with the pairs its call sent down each path, and for each
    call the wall time from a sync before it to a sync after it (the
    host reads the counts right after the call anyway), the time that
    first sync waited, and the ``cudaMalloc`` calls and allocator retries
    the call made.  It calls the wrapper unchanged; the launch count
    stays the wrapper's."""

    def __init__(self, eb):
        self.eb = eb
        self.inner = eb.ops.semijoin_mask
        self.best = None
        self.paths = {}
        self.calls = []

    def __call__(self, probe, build, pairs=None):
        t = time.perf_counter()
        torch.cuda.synchronize()         # work queued before the call
        t0 = time.perf_counter()
        before = allocator_counts()
        out = self.inner(probe, build, pairs)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        grew = [x - y for x, y in zip(allocator_counts(), before)]
        n_keys = int(np.asarray(pairs)[:, 1].sum())
        self.calls.append({"pairs": len(pairs), "probe_keys": n_keys,
                           "ms": (t1 - t0) * 1e3,
                           "queued_before_ms": (t0 - t) * 1e3,
                           "cuda_mallocs": grew[0],
                           "alloc_retries": grew[1]})
        if self.best is None or n_keys > int(self.best[2][:, 1].sum()):
            self.best = (probe, build, np.array(pairs, dtype=np.int64))
            self.paths = dict(self.eb.ops.semijoin_paths)
        return out

    def __enter__(self):
        self.eb.ops = _OpsShim(self.eb.ops, semijoin_mask=self)
        return self

    def __exit__(self, *exc):
        self.eb.ops = self.eb.ops.base


class _OpsShim:
    """The kernels' ops module with some wrappers replaced."""

    def __init__(self, base, **override):
        self.base = base
        self.__dict__.update(override)

    def __getattr__(self, name):
        return getattr(self.base, name)


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


def serve_suite(eng, queries, timed_reps: int, ops, batch_cut=()):
    """Every instance through ``query`` (first pass cold: plans, uploads,
    capacity growth), then ``timed_reps`` warm passes, then each
    template's instances through ``query_batch`` (one launch sequence,
    padded to its bucket shape), which must equal the single results;
    ``batch_cut`` templates skip the batch (it does not fit the card at
    this scale).  Returns per-template timings, the join-probe launches
    of one warm query and the batch's peak device memory, and the peak
    over the whole call (the batches' peaks are read after a reset)."""
    stats, overall = {}, 0
    for name, insts in queries.items():
        t0 = time.perf_counter()
        single = [eng.query(q) for q in insts]
        cold_ms = (time.perf_counter() - t0) * 1e3
        lat = []
        before = ops.launches["join_probe"]
        for _ in range(timed_reps):
            for q in insts:
                t = time.perf_counter()
                eng.query(q)
                lat.append((time.perf_counter() - t) * 1e3)
        per_query = (ops.launches["join_probe"] - before) / \
            max(timed_reps * len(insts), 1)
        batch_ms, peak = None, None
        if name not in batch_cut:
            overall = max(overall, torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            batched = eng.query_batch(insts)
            batch_ms = (time.perf_counter() - t) * 1e3
            peak = torch.cuda.max_memory_allocated() / 2**30
            for a, b in zip(single, batched):
                if a.cols != b.cols or not np.array_equal(a.data, b.data):
                    raise AssertionError(f"{name}: query_batch != query")
            del batched
        for r in single:
            if r.data.dtype != np.int32 or r.data.shape[1] != len(r.cols):
                raise AssertionError(f"{name}: malformed result")
        stats[name] = {"rows": [len(r) for r in single],
                       "cold_ms": cold_ms, "lat": lat, "batch_ms": batch_ms,
                       "batch_peak_gib": peak, "probes_per_query": per_query}
        del single
    return stats, max(overall, torch.cuda.max_memory_allocated())


def phase_main(args, ops, ref, jexec, eb, Dataset, basic_queries):
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    with SemijoinRecorder(eb) as srec:
        t = time.perf_counter()
        ds = Dataset.watdiv(scale=args.scale, seed=args.seed, threshold=0.25)
        build_s = time.perf_counter() - t
    if ds.build_backend != "torch" or ds.device.type != "cuda" or \
            ds.catalog.extvp.backend != "torch":
        raise AssertionError("the dataset's ExtVP was not built on the card")
    rep = ds.storage_report()
    log(f"  dataset: scale {args.scale}, {ds.n_triples} triples, "
        f"VP {int(rep['vp_tuples'])} rows, ExtVP {int(rep['extvp_tables'])} "
        f"tables / {int(rep['extvp_tuples'])} rows, "
        f"{int(rep['n_semijoins'])} pairs semi-joined; generation + catalog "
        f"build {build_s:.1f} s (VP {rep['vp_build_seconds']:.3f} s, ExtVP "
        f"on the card {rep['extvp_build_seconds']:.3f} s)")
    log(f"  semijoin calls of the build (wall ms to the counts on the "
        f"host): {json.dumps(srec.calls)}")
    eng = ds.engine()
    assert eng.device.type == "cuda"
    queries = basic_queries(ds.schema, seed=args.seed)
    with ProbeRecorder(jexec) as rec:
        t = time.perf_counter()
        stats, peak = serve_suite(eng, queries, args.reps, ops, BATCH_CUT)
        serve_s = time.perf_counter() - t
    launches = dict(ops.launches)
    no_fallbacks(eng, "main path")
    log(f"  served {sum(len(v) for v in queries.values())} queries x "
        f"{1 + args.reps} + {len(queries)} batches in {serve_s:.1f} s; "
        f"launches {launches}; tables on the card "
        f"{device_table_bytes(eng) / 2**20:.1f} MiB; peak device memory "
        f"(build and suite) {peak / 2**30:.2f} GiB")
    for name, s in stats.items():
        batch = "cut (BATCH_CUT)" if s["batch_ms"] is None else (
            f"{s['batch_ms']:.1f} ms, peak {s['batch_peak_gib']:.2f} GiB")
        log(f"  {name}: rows {s['rows']}, p50 {p(s['lat'], 50):.3f} ms, "
            f"max {max(s['lat']):.3f} ms of {len(s['lat'])} warm queries, "
            f"cold {s['cold_ms']:.1f} ms for {len(s['rows'])}, batch of "
            f"{len(s['rows'])} {batch}; join-probe launches a warm query "
            f"{s['probes_per_query']:.2f}")
    for name in ("S1", "C1"):
        profile_query(eng, queries[name][0], name)
    # the bucket count runs on the distributed path only (phase 6a)
    for k in ("join_probe", "semijoin_membership"):
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched on the main "
                                 "path")
    nums = {}
    a, b = rec.best
    shapes = sorted(rec.shapes.items(), key=lambda kv: -kv[0][0])[:5]
    log(f"  largest join_probe shapes (n_a, n_b): count: {shapes}")
    path = dict(rec.path_times(), **{
        f"calls_n_b_le_{lim}": sum(c for (_, nb), c in rec.shapes.items()
                                   if nb <= lim) for lim in (16384, 32768)})
    log(f"  join_probe over the main path (CUDA events around each call): "
        f"{path['calls']} calls, {path['total_ms']:.4f} ms in all against "
        f"a {path['bound_ms']:.4f} ms bound (gap {path['gap_ms']:.4f} ms); "
        f"by n_a: "
        f"{json.dumps(path['by_log2_n_a'])}; calls with n_b <= 16384: "
        f"{path['calls_n_b_le_16384']}, <= 32768: "
        f"{path['calls_n_b_le_32768']}")
    path["probes_per_query"] = {n: s["probes_per_query"]
                                for n, s in stats.items()}
    path["batch_peak_gib"] = {n: s["batch_peak_gib"]
                              for n, s in stats.items()}
    path["largest"] = probe_profile(ref, a, b)
    log(f"  the largest input's keys: {json.dumps(path['largest'])}")
    err = check_probe(ops, ref, a, b, "main-path inputs")
    path["smem_keys_ms"] = smem_keys_ms(ops, ref, a, b)
    log(f"  join_probe on the main path's largest inputs by SMEM_KEYS "
        f"(ms): {path['smem_keys_ms']}")
    pn = probe_numbers(ops, ref, a, b)
    log(f"  join_probe on the main path's largest inputs "
        f"({pn['n_a']} x {pn['n_b']}): equal; kernel {pn['ms']:.4f} ms, "
        f"plain {pn['plain_ms']:.4f} ms, torch.searchsorted x2 "
        f"{pn['library_ms']:.4f} ms, bound {pn['bound_ms']:.4f} ms")
    nums["join_probe"] = dict(pn, launches=launches["join_probe"],
                              max_abs_err=err)
    del rec, a, b
    nums["semijoin_membership"] = semijoin_main_numbers(
        ops, ref, srec.best, launches["semijoin_membership"], srec.paths)
    del srec
    torch.cuda.empty_cache()
    return nums, path, ds, eng, queries


def semijoin_plan_stats(ops, build, pairs) -> dict:
    """Pairs and distinct build segments on each path of the committed
    plan, the bitmaps' bytes, and a check that every segment within the
    density rule took the bitmap (and no other did)."""
    plan = ops.semijoin_plan(build, pairs)
    n = plan.segs[:, 1]
    bm = plan.bitmap
    # the rule again, from the segments' keys on the card
    first = build[torch.from_numpy(plan.segs[n > 0, 0]).cuda()].cpu()
    last = build[torch.from_numpy(plan.segs[n > 0, 0] + n[n > 0] - 1)
                 .cuda()].cpu()
    words = -(-(last.numpy().astype(np.int64) -
                first.numpy().astype(np.int64) + 1) // 32)
    within = words <= np.maximum(ops.SEMIJOIN_BITMAP_DENSITY * n[n > 0],
                                 ops.SEMIJOIN_BITMAP_MIN_WORDS)
    if not np.array_equal(within, bm[n > 0]) or bm[n == 0].any():
        raise AssertionError("semijoin plan: a segment within the density "
                             "rule did not take the bitmap, or one outside "
                             "it did")
    on = bm[plan.seg_of_pair]
    return {"pairs_bitmap": int(on.sum()), "pairs_search": int((~on).sum()),
            "segments_bitmap": int(bm.sum()),
            "segments_search": int((~bm).sum()),
            "bitmap_bytes": 4 * plan.n_words,
            "largest_bitmap_bytes": 4 * int(plan.words.max(initial=0)),
            "build_keys_bitmap": int(n[bm].sum()),
            "build_keys_search": int(n[~bm].sum())}


def semijoin_split_ms(ops, probe, build, pairs, reps: int) -> dict:
    """Where one call's time goes: the plan (its gather and copy of the
    segments' ends to the host, by the host clock after a sync); by CUDA
    events, the call after its plan (the descriptors' copy, the bitmap
    build and the membership kernel, with no host sync, so the host runs
    ahead of the card), the bitmap build alone, and the whole call, in
    which each plan's sync waits for the call before it."""
    plan = ops.semijoin_plan(build, pairs)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        ops.semijoin_plan(build, pairs)
    plan_ms = (time.perf_counter() - t) * 1e3 / reps
    return {"plan_host_ms": plan_ms,
            "after_plan_ms": cuda_time_ms(
                lambda: ops._semijoin_launch(probe, build, pairs, plan),
                reps),
            "bitmap_build_ms": cuda_time_ms(
                lambda: ops.semijoin_bitmaps(build, plan), reps),
            "call_ms": cuda_time_ms(
                lambda: ops.semijoin_mask(probe, build, pairs), reps)}


def semijoin_bitmap_vs_search_ms(ops, ref, probe, build, pairs) -> dict:
    """The committed plan against one that sends every segment to the
    search (both plan constants 0), in turns (plan, search, search,
    plan), each checked against the plain version."""
    saved = ops.SEMIJOIN_BITMAP_DENSITY, ops.SEMIJOIN_BITMAP_MIN_WORDS
    out = {"plan": [], "search": []}
    try:
        for which in ("plan", "search", "search", "plan"):
            if which == "plan":
                ops.SEMIJOIN_BITMAP_DENSITY, ops.SEMIJOIN_BITMAP_MIN_WORDS = \
                    saved
            else:
                ops.SEMIJOIN_BITMAP_DENSITY = 0
                ops.SEMIJOIN_BITMAP_MIN_WORDS = 0
            check_semijoin(ops, ref, probe, build, pairs, f"{which} path")
            out[which].append(cuda_time_ms(
                lambda: ops.semijoin_mask(probe, build, pairs), 10))
    finally:
        ops.SEMIJOIN_BITMAP_DENSITY, ops.SEMIJOIN_BITMAP_MIN_WORDS = saved
    return out


def semijoin_main_numbers(ops, ref, best, launches: int,
                          paths: dict) -> dict:
    """The semi-join against its plain version on the main path's pair
    batch (the whole build at scale 340: the JSON line's row) and on its
    largest pair; the plan's paths and bitmaps; the committed plan
    against the search alone."""
    probe, build, pairs = best
    stats = semijoin_plan_stats(ops, build, pairs)
    log(f"  semijoin plan of the main path's batch: {json.dumps(stats)}; "
        f"ops.semijoin_paths after the build: {paths}")
    if paths != {"bitmap": stats["pairs_bitmap"],
                 "search": stats["pairs_search"]}:
        raise AssertionError("semijoin: the build's paths differ from the "
                             "plan of its batch")
    if stats["pairs_bitmap"] <= 0:
        raise AssertionError("semijoin: no pair of the main path took the "
                             "bitmap")
    err = check_semijoin(ops, ref, probe, build, pairs, "main-path batch")
    bn = semijoin_numbers(ops, ref, probe, build, pairs, reps=10)
    log(f"  semijoin on the main path's batch ({bn['pairs']} pairs, "
        f"{bn['n_keys']} probe keys): equal, bitmap words equal; kernel "
        f"{bn['ms']:.4f} ms, plain {bn['plain_ms']:.4f} ms, "
        f"{bn['library']} {bn['library_ms']:.4f} ms, bound "
        f"{bn['bound_ms']:.4f} ms ({bn['bound_by']}, "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s)")
    split = semijoin_split_ms(ops, probe, build, pairs, 10)
    log(f"  semijoin on the main path's batch, split (ms): "
        f"{json.dumps(split)}")
    turns = semijoin_bitmap_vs_search_ms(ops, ref, probe, build, pairs)
    log(f"  semijoin on the main path's batch, committed plan against "
        f"every segment on the search, in turns (ms): {json.dumps(turns)}")
    j = int(np.lexsort((pairs[:, 3], pairs[:, 1]))[-1])
    one = pairs[j:j + 1]
    err = max(err, check_semijoin(ops, ref, probe, build, one,
                                  "main-path largest pair"))
    ln = semijoin_numbers(ops, ref, probe, build, one, reps=20)
    lsplit = semijoin_split_ms(ops, probe, build, one, 20)
    log(f"  semijoin on the main path's largest pair ({int(one[0, 1])} "
        f"probe keys x {int(one[0, 3])} build keys, "
        f"{ops.semijoin_paths}): equal; kernel {ln['ms']:.4f} ms, plain "
        f"{ln['plain_ms']:.4f} ms, torch.isin {ln['library_ms']:.4f} ms, "
        f"bound {ln['bound_ms']:.4f} ms ({ln['bound_by']}); split (ms) "
        f"{json.dumps(lsplit)}; launches on the main path {launches}")
    return dict(bn, launches=launches, max_abs_err=err)


def same_extvp(want, got, what: str) -> None:
    """Byte identity of two ExtVP builds; raises on the first difference."""
    if want.sf != got.sf or want.sizes != got.sizes:
        raise AssertionError(f"{what}: SF map or sizes != numpy build")
    if set(want.tables) != set(got.tables):
        raise AssertionError(f"{what}: materialized set != numpy build")
    for k, t in want.tables.items():
        if t.rows.tobytes() != got.tables[k].rows.tobytes():
            raise AssertionError(f"{what}: rows of {k} != numpy build")


def phase_identity(ds, build_extvp):
    """The numpy ExtVP build over the card build's VP tables must give a
    byte-identical ExtVP.  Both builds read the same sorted-unique
    columns, computed once with the VP statistics before either ran."""
    card = ds.catalog.extvp
    host = build_extvp(ds.catalog.vp, threshold=card.threshold,
                       kinds=card.kinds, backend="numpy")
    same_extvp(host, card, "card ExtVP")
    log(f"  ExtVP byte-identical to the numpy build: {len(card.sf)} pairs "
        f"(SF, sizes), {len(card.tables)} tables, "
        f"{card.total_tuples()} rows; ExtVP build on the card "
        f"{card.build_seconds:.3f} s, numpy build {host.build_seconds:.3f} s")
    return host


# ---------------------------------------------------------------------------
# phase 4: card against CPU
# ---------------------------------------------------------------------------

def compare(ds, gpu, queries, ops, skip=(), first_only=False) -> None:
    """Every instance of every template but those in ``skip`` through
    ``query`` and each template's instances through ``query_batch`` (with
    ``first_only``, each template's first instance through ``query``
    alone), on the card engine ``gpu`` and on the same port engine on
    the CPU: results equal row for row, and both executors end with the
    same capacities.  Results are dropped as soon as they are
    compared."""
    cpu = ds.engine(device="cpu")
    ops.reset_launches()
    n, t_gpu, t_cpu = 0, 0.0, 0.0
    for name, insts in queries.items():
        if name in skip:
            continue
        runs = [("query", [insts[0]])] if first_only else \
            [("query", [q]) for q in insts] + [("query_batch", insts)]
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


# ---------------------------------------------------------------------------
# phase 5: append, save and load
# ---------------------------------------------------------------------------

def same_catalog(a, b, what: str) -> None:
    """Byte-level equality of two catalogs (tables, statistics,
    dictionary); raises on the first difference."""
    def same(x, y):
        return np.asarray(x).tobytes() == np.asarray(y).tobytes()

    checks = [("triples", same(a.tt, b.tt)),
              ("VP set", set(a.vp) == set(b.vp)),
              ("ExtVP set", set(a.extvp.tables) == set(b.extvp.tables)),
              ("SF map", a.extvp.sf == b.extvp.sf),
              ("sizes", a.extvp.sizes == b.extvp.sizes),
              ("distinct counts", (a.distinct_s, a.distinct_o, a.m2_s,
                                   a.m2_o) == (b.distinct_s, b.distinct_o,
                                               b.m2_s, b.m2_o)),
              ("dictionary", a.dictionary.id_to_term ==
               b.dictionary.id_to_term and
               same(a.dictionary.values, b.dictionary.values))]
    for name, ok in checks:
        if not ok:
            raise AssertionError(f"{what}: {name} differ")
    for p in a.vp:
        if not same(a.vp[p].rows, b.vp[p].rows):
            raise AssertionError(f"{what}: VP rows of {p} differ")
    for k in a.extvp.tables:
        if not same(a.extvp.tables[k].rows, b.extvp.tables[k].rows):
            raise AssertionError(f"{what}: ExtVP rows of {k} differ")


def phase_store(ds, queries, ops, Dataset, root: str) -> str:
    """Build on the first 99 % of ``ds``'s triples (as strings), save,
    append the last 1 %, load the store lazily (the journal replays on
    the card) and hold it against a from-scratch build over all of them
    and, on a few templates, against the in-memory dataset.  Returns the
    store's path (base and journal), which phase 6b loads."""
    triples = ds.dictionary.decode_rows(np.asarray(ds.catalog.tt))
    cut = len(triples) - len(triples) // 100
    ops.reset_launches()
    t = time.perf_counter()
    mem = Dataset.from_triples(triples[:cut], threshold=0.25)
    base_s = time.perf_counter() - t
    path = os.path.join(root, "store")
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(root, exist_ok=True)
    t = time.perf_counter()
    mem.save(path)
    save_s = time.perf_counter() - t
    t = time.perf_counter()
    report = mem.append_triples(triples[cut:])
    append_s = time.perf_counter() - t
    t = time.perf_counter()
    loaded = Dataset.load(path)
    load_s = time.perf_counter() - t
    vp, ext = loaded.catalog.vp, loaded.catalog.extvp.tables
    lazy = f"{ext.n_loaded} of {len(ext)} ExtVP tables loaded" \
        if hasattr(ext, "n_loaded") else "ExtVP not lazy"
    if loaded.catalog.store is None or \
            loaded.storage_report()["delta_segments"] != 1:
        raise AssertionError("loaded store carries no delta segment")
    launches = ops.launches["semijoin_membership"]
    t = time.perf_counter()
    scratch = Dataset.from_triples(triples, threshold=0.25)
    scratch_s = time.perf_counter() - t
    same_catalog(scratch.catalog, loaded.catalog, "load + replay")
    same_catalog(scratch.catalog, mem.catalog, "append")
    n = 0
    for name in ("S1", "L2", "F3", "C3"):
        for q in queries[name]:
            a = loaded.engine().query(q)
            b = mem.engine().query(q)
            if a.cols != b.cols or not np.array_equal(a.data, b.data):
                raise AssertionError(f"{name}: loaded store != "
                                     "in-memory dataset")
            n += 1
    del loaded, mem, scratch, vp, ext
    if launches <= 0:
        raise AssertionError("no semijoin launch in build, append or replay")
    log(f"  {len(triples)} triples: base build on {cut} {base_s:.1f} s, "
        f"save {save_s:.2f} s, append {len(triples) - cut} "
        f"{append_s:.2f} s (pairs {report}), lazy load + replay "
        f"{load_s:.2f} s ({lazy} after replay), scratch build "
        f"{scratch_s:.1f} s; catalog byte-identical to scratch; {n} "
        f"results equal row for row; semijoin launches {launches}")
    return path

# ---------------------------------------------------------------------------
# phase 6: the distributed engine
# ---------------------------------------------------------------------------

def canon(rows: np.ndarray) -> torch.Tensor:
    """The rows on the card in lexicographic order: one form per
    multiset (chained stable sorts, last column first)."""
    t = torch.from_numpy(np.ascontiguousarray(rows)).cuda()
    if t.shape[0] < 2 or t.shape[1] == 0:
        return t
    order = torch.argsort(t[:, -1], stable=True)
    for j in range(t.shape[1] - 2, -1, -1):
        order = order[torch.argsort(t[order, j], stable=True)]
    return t[order]


def same_multiset(a, b) -> bool:
    if a.cols != b.cols or a.data.shape != b.data.shape:
        return False
    return bool(torch.equal(canon(a.data), canon(b.data)))


class BucketRecorder:
    """Keeps the largest one-row input the main path hands the
    bucket-count kernel (a shuffle of one binding, or of a relation every
    binding shares), as a key column, so the kernel can be timed on it
    afterwards; counts the calls by input shape ``(rows, keys a row)``;
    and records a pair of CUDA events around every call (read only by
    :meth:`path_times`, after the run).  It calls the wrapper unchanged;
    the launch count stays the wrapper's."""

    def __init__(self, dist_mod):
        self.mod = dist_mod
        self.inner = dist_mod.ops.bucket_count
        self.best = None
        self.shapes = {}
        self.events = []
        self.gc_ms, self.gc_runs, self._gc_t = 0.0, 0, 0.0

    def __call__(self, keys, valid, n_buckets):
        key = (tuple(keys.shape), n_buckets)
        self.shapes[key] = self.shapes.get(key, 0) + 1
        if keys.numel() == keys.shape[-1] and (
                self.best is None or keys.numel() > self.best[0].numel()):
            self.best = (keys.reshape(-1).clone(), valid.reshape(-1).clone(),
                         n_buckets)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        idle = torch.cuda.current_stream().query()
        # a CUDA event is created at its first record: record both once
        # here, so that neither creation falls inside the timed span
        start.record()
        end.record()
        gc0 = self.gc_ms
        t0 = time.perf_counter()
        start.record()
        t1 = time.perf_counter()
        out = self.inner(keys, valid, n_buckets)
        t2 = time.perf_counter()
        end.record()
        t3 = time.perf_counter()
        self.events.append((keys.numel(), n_buckets * (keys.numel() //
                                                       max(keys.shape[-1],
                                                           1)),
                            start, end, idle,
                            (t3 - t0) * 1e3, (t2 - t1) * 1e3,
                            self.gc_ms - gc0))
        return out

    def _gc(self, phase, info):
        if phase == "start":
            self._gc_t = time.perf_counter()
        else:
            self.gc_ms += (time.perf_counter() - self._gc_t) * 1e3
            self.gc_runs += 1

    def path_times(self) -> dict:
        """The bucket count's whole cost over the run: the sum of every
        call's event time and of its bound, and both by key count (2^k <=
        n < 2^k+1), so that launches x (time - bound) can be ranked
        against the other kernels.  The events enclose the whole wrapper
        (its output allocation and launch too), so where the card is idle
        when a call starts they read the call's host work as well; the
        host clock around the same span, and the event time of the calls
        that found the card idle, say how much."""
        torch.cuda.synchronize()
        total, bound, buckets = 0.0, 0.0, {}
        host, idle_calls, idle_ms, wrapper, gc_in = 0.0, 0, 0.0, 0.0, 0.0
        for n, nb, start, end, idle, host_ms, wrap_ms, gc_ms in self.events:
            wrapper += wrap_ms
            gc_in += gc_ms
            ms = start.elapsed_time(end)
            bms = (5 * n + 4 * nb) / HBM_BYTES_PER_S * 1e3
            total += ms
            bound += bms
            host += host_ms
            idle_calls += idle
            idle_ms += ms if idle else 0.0
            k = max(n, 1).bit_length() - 1
            bk = buckets.setdefault(k, {"launches": 0, "ms": 0.0,
                                        "bound_ms": 0.0, "max_call_ms": 0.0})
            bk["launches"] += 1
            bk["ms"] += ms
            bk["bound_ms"] += bms
            bk["max_call_ms"] = max(bk["max_call_ms"], ms)
        return {"calls": len(self.events), "total_ms": total,
                "bound_ms": bound, "gap_ms": total - bound,
                "host_ms": host, "wrapper_host_ms": wrapper,
                "gc_in_calls_ms": gc_in, "gc_runs": self.gc_runs,
                "gc_ms": self.gc_ms, "calls_on_idle_card": idle_calls,
                "idle_card_ms": idle_ms,
                "by_log2_n": {f"2^{k}": buckets[k] for k in sorted(buckets)}}

    def __enter__(self):
        self.mod.ops = _OpsShim(self.mod.ops, bucket_count=self)
        gc.callbacks.append(self._gc)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._gc)
        self.mod.ops = self.mod.ops.base


class AttemptCounter:
    """Counts the distributed executor's launches (one program run per
    attempt, every binding of a batch in it) while it is entered."""

    def __init__(self, dist_mod):
        self.cls = dist_mod.DistributedExecutor
        self.inner = self.cls._shard_program
        self.n = 0

    def __enter__(self):
        inner = self.inner

        def counted(ex, *a, **k):
            self.n += 1
            return inner(ex, *a, **k)

        self.cls._shard_program = counted
        return self

    def __exit__(self, *exc):
        self.cls._shard_program = self.inner


def counted_run(ops, attempts: AttemptCounter, fn):
    """``fn()``, its host-clock ms (the card synchronized after it), and
    the kernel launches and executor attempts it made."""
    before, tries = dict(ops.launches), attempts.n
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    return out, ms, {"attempts": attempts.n - tries, **{
        k: ops.launches[k] - before[k] for k in ("bucket_count",
                                                 "join_probe")}}


def serve_distributed(deng, eng, queries, reps: int, order, ops, dmod):
    """Every instance through the distributed engine's ``query`` (cold,
    then ``reps`` warm passes) and each template's instances through its
    ``query_batch`` (one launch sequence: cold, then warm), every result
    equal to the single-device engine ``eng``'s as a multiset.  Each
    template's warm batch must launch the bucket count and the join probe
    per attempt as often as one warm query.  Returns per-template
    timings, launches and final caps."""
    stats = {}
    with AttemptCounter(dmod) as attempts:
        for name in order:
            insts = queries[name]
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            single = [deng.query(q) for q in insts]
            cold_ms = (time.perf_counter() - t0) * 1e3
            lat = []
            for _ in range(reps):
                for q in insts:
                    t = time.perf_counter()
                    deng.query(q)
                    lat.append((time.perf_counter() - t) * 1e3)
            _, _, one = counted_run(ops, attempts,
                                    lambda: deng.query(insts[0]))
            batched, cold_batch_ms, cold = counted_run(
                ops, attempts, lambda: deng.query_batch(insts))
            _, batch_ms, warm = counted_run(
                ops, attempts, lambda: deng.query_batch(insts))
            peak = torch.cuda.max_memory_allocated() / 2**30
            for k in ("bucket_count", "join_probe"):
                if warm[k] * one["attempts"] != one[k] * warm["attempts"]:
                    raise AssertionError(
                        f"{name}: a batched attempt launched {k} "
                        f"{warm[k]} / {warm['attempts']} times, one query "
                        f"{one[k]} / {one['attempts']}")
            for q, a, b in zip(insts, single, batched):
                want = eng.query(q)
                if not same_multiset(a, want) or not same_multiset(b, want):
                    raise AssertionError(f"{name}: distributed engine != "
                                         "single-device card engine")
                del want
            stats[name] = {
                "rows": [len(r) for r in single], "lat": lat,
                "cold_ms": cold_ms, "cold_batch_ms": cold_batch_ms,
                "batch_ms": batch_ms, "one_query": one, "cold_batch": cold,
                "warm_batch": warm, "peak_gib": peak,
                "caps": list(deng.prepare(insts[0]).executor.caps)}
            del single, batched
            torch.cuda.empty_cache()
    return stats


def phase_one_rank(args, ds, eng, host_ext, queries, ops, ref, dmod,
                   build_extvp, Engine, here: str):
    """6a: a world of one rank over NCCL, on the main path's dataset."""
    import torch.distributed as dist
    rdv = os.path.join(here, "build", "smoke_nccl_rendezvous")
    os.makedirs(os.path.dirname(rdv), exist_ok=True)
    if os.path.exists(rdv):
        os.remove(rdv)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{rdv}", rank=0,
                            world_size=1)
    try:
        ops.reset_launches()
        dmod.reset_exchanges()
        with BucketRecorder(dmod) as brec:
            t = time.perf_counter()
            ext = build_extvp(ds.catalog.vp, threshold=host_ext.threshold,
                              kinds=host_ext.kinds, backend="distributed")
            build_s = time.perf_counter() - t
            deng = Engine(ds, backend="distributed")
            order = [n for n in queries if n not in ONE_RANK_CUT]
            t = time.perf_counter()
            stats = serve_distributed(deng, eng, queries, args.reps, order,
                                      ops, dmod)
            serve_s = time.perf_counter() - t
        launches = dict(ops.launches)
        no_fallbacks(deng, "distributed engine")
        ex = dict(dmod.exchanges)
        same_extvp(host_ext, ext, "distributed ExtVP (one rank)")
        log(f"  distributed ExtVP build (one rank) {build_s:.3f} s, "
            f"byte-identical to the numpy build ({len(ext.sf)} pairs, "
            f"{len(ext.tables)} tables)")
        log(f"  served {sum(len(queries[n]) for n in order)} queries x "
            f"{1 + args.reps} + {len(order)} batches through the "
            f"distributed engine in {serve_s:.1f} s, every result equal "
            f"to the single-device card engine's; launches {launches}; "
            f"exchanges {ex}")
        for name in ONE_RANK_CUT:
            ex_s = eng.prepare(queries[name][0]).executor
            width, top = len(ex_s._pipe_cols), max(ex_s.caps)
            log(f"  {name} left out at one rank: its single-device "
                f"relations reach {top} slots of up to {width} columns; "
                f"one rank's static buckets are 4x a relation's slots, so "
                f"a shuffle of such a relation needs up to "
                f"{2 * 4 * top * width * 4 / 2**30:.0f} GiB of send and "
                f"receive buffers beside the relation and the catalog")
        for name in order:
            st = stats[name]
            log(f"  {name}: rows {st['rows']}, p50 {p(st['lat'], 50):.3f} ms, "
                f"max {max(st['lat']):.3f} ms of {len(st['lat'])} warm "
                f"queries, cold {st['cold_ms']:.1f} ms; batch of "
                f"{len(st['rows'])} (one launch sequence) cold "
                f"{st['cold_batch_ms']:.3f} ms, warm {st['batch_ms']:.3f} "
                f"ms; launches per attempt, warm batch against one warm "
                f"query: {json.dumps(st['warm_batch'])} against "
                f"{json.dumps(st['one_query'])} (cold batch "
                f"{json.dumps(st['cold_batch'])}); final caps "
                f"{st['caps']}; peak device memory {st['peak_gib']:.2f} GiB")
        for name in ("S1", "F1"):
            profile_query(deng, queries[name][0], f"{name} distributed")
        for k, v in launches.items():
            if v <= 0:
                raise AssertionError(f"kernel {k} was not launched on the "
                                     "distributed path")
        if ex["all_to_all"] <= 0:
            raise AssertionError("the distributed path made no exchange")
        keys, valid, nb = brec.best
        shapes = sorted(brec.shapes.items(),
                        key=lambda kv: -np.prod(kv[0][0]))[:5]
        log(f"  largest bucket_count inputs ((rows, keys a row), buckets): "
            f"count: {shapes}")
        bpath = brec.path_times()
        log(f"  bucket_count over the distributed path (CUDA events around "
            f"each call): {bpath['calls']} calls, {bpath['total_ms']:.4f} ms "
            f"in all against a {bpath['bound_ms']:.4f} ms bound (gap "
            f"{bpath['gap_ms']:.4f} ms); host clock over the same spans "
            f"{bpath['host_ms']:.4f} ms (the wrapper alone "
            f"{bpath['wrapper_host_ms']:.4f} ms, garbage collection in "
            f"them {bpath['gc_in_calls_ms']:.4f} ms; over the whole run "
            f"{bpath['gc_runs']} collections, {bpath['gc_ms']:.4f} ms); "
            f"{bpath['calls_on_idle_card']} "
            f"calls found the card idle, {bpath['idle_card_ms']:.4f} ms "
            f"of their event time; by n: "
            f"{json.dumps(bpath['by_log2_n'])}")
        err = check_bucket(ops, ref, keys, valid, nb, "main-path input")
        bn = bucket_numbers(ops, ref, keys, valid, nb)
        largest = {"n": bn["n"], "n_buckets": nb,
                   "path": bucket_path(ops, keys, valid, nb),
                   "repeated_ms": bn["repeated_ms"],
                   "queued_ms": bn["ms"], "l2_flushed_ms": cold_time_ms(
                       lambda: ops.bucket_count(keys, valid, nb)),
                   "bound_ms": bn["bound_ms"]}
        log(f"  bucket_count on the main path's largest input ({bn['n']} "
            f"keys, {nb} bucket, {largest['path']} path): equal; kernel "
            f"{bn['ms']:.4f} ms repeated with its host work hidden "
            f"(inputs in L2), {bn['repeated_ms']:.4f} ms repeated as "
            f"cuda_time_ms reads it, {largest['l2_flushed_ms']:.4f} ms "
            f"with L2 flushed before each call; plain "
            f"{bn['plain_ms']:.4f} ms, "
            f"torch.bincount {bn['library_ms']:.4f} ms, bound "
            f"{bn['bound_ms']:.4f} ms ({bn['bound_by']})")
        split = bucket_host_split_us(ops, ref)
        log(f"  bucket_count host split of a small call (card idle, "
            f"microseconds a call): {json.dumps(split)}")
        # the batched launch at 32 rows of the largest row a batched
        # shuffle of this path gave it
        rows_n = max(shape[-1] for (shape, _), _ in brec.shapes.items()
                     if shape[0] > 1)
        batched = batched_bucket_numbers(ops, ref, rows_n, nb)
        log(f"  batched bucket_count, 32 rows of {rows_n} keys (the "
            f"largest row of this path's batched shuffles), {nb} bucket, "
            f"{batched['path']} path: equal; kernel {batched['ms']:.4f} ms, "
            f"32 single launches {batched['singles_ms']:.4f} ms, plain "
            f"{batched['plain_ms']:.4f} ms, torch.bincount over row*S + "
            f"dest {batched['library_ms']:.4f} ms, bound "
            f"{batched['bound_ms']:.4f} ms (bytes)")
        del deng, brec, keys, valid
        numbers = {"backend": "nccl", "ranks": 1, "scale": args.scale,
                   "build_s": build_s, "exchanges": ex["all_to_all"],
                   "buffer_bytes": ex["buffer_bytes"],
                   "bucket_count_launches": launches["bucket_count"],
                   "bucket_count_path": bpath,
                   "bucket_count_largest": largest,
                   "bucket_count_host_split": split,
                   "bucket_count_batched": batched,
                   "p50_ms": {n: p(stats[n]["lat"], 50) for n in order},
                   "batch_ms": {n: stats[n]["batch_ms"] for n in order},
                   "batch_launches": {n: stats[n]["warm_batch"]
                                      for n in order},
                   "query_launches": {n: stats[n]["one_query"]
                                      for n in order},
                   "caps": {n: stats[n]["caps"] for n in order},
                   "reduced": [f"{', '.join(ONE_RANK_CUT)} left out at one "
                               "rank: static shuffle buckets"]}
        return dict(bn, launches=launches["bucket_count"],
                    max_abs_err=err), numbers
    finally:
        dist.destroy_process_group()


def phase_two_ranks(args, store: str, queries_file: str, here: str):
    """6b: two ranks of this script that share the card, over gloo."""
    build = os.path.join(here, "build")
    rdv = os.path.join(build, "smoke_gloo_rendezvous")
    if os.path.exists(rdv):
        os.remove(rdv)
    ranks = []
    for rank in range(2):
        out = os.path.join(build, f"smoke_rank{rank}.json")
        if os.path.exists(out):
            os.remove(out)
        logf = os.path.join(build, f"smoke_rank{rank}.log")
        with open(logf, "w") as f:
            proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--rank",
                 str(rank), "--world", "2", "--store", store,
                 "--queries", queries_file, "--rendezvous", rdv,
                 "--out", out], stdout=f, stderr=subprocess.STDOUT)
        ranks.append((proc, logf, out))
    deadline = time.monotonic() + RANKS_TIMEOUT_S
    try:
        for proc, _, _ in ranks:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for proc, _, _ in ranks:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    results = []
    for rank, (proc, logf, out) in enumerate(ranks):
        with open(logf) as f:
            text = f.read()
        if proc.returncode != 0:
            raise AssertionError(f"rank {rank} of phase 6b failed (exit "
                                 f"{proc.returncode}):\n{text[-6000:]}")
        for line in text.splitlines():
            log(f"  rank {rank}: {line}")
        with open(out) as f:
            results.append(json.load(f))
    return results


def rank_main(args) -> int:
    """One rank of phase 6b (run by :func:`phase_two_ranks`)."""
    import datetime
    import torch.distributed as dist
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "src"))
    from repro_torch import Dataset, Engine
    from repro_torch.core import distributed as dmod
    from repro_torch.core.vp import build_extvp
    from repro_torch.kernels import ops

    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method=f"file://{args.rendezvous}", rank=args.rank,
        world_size=args.world,
        timeout=datetime.timedelta(seconds=RANKS_TIMEOUT_S))
    try:
        with open(args.queries) as f:
            queries = json.load(f)
        t = time.perf_counter()
        ds = Dataset.load(args.store)
        load_s = time.perf_counter() - t
        ops.reset_launches()
        dmod.reset_exchanges()
        cat = ds.catalog
        t = time.perf_counter()
        ext = build_extvp(cat.vp, threshold=cat.extvp.threshold,
                          kinds=cat.extvp.kinds, backend="distributed")
        build_s = time.perf_counter() - t
        same_extvp(build_extvp(cat.vp, threshold=cat.extvp.threshold,
                               kinds=cat.extvp.kinds, backend="numpy"),
                   ext, f"distributed ExtVP (rank {args.rank} of 2)")
        deng, eng = Engine(ds, backend="distributed"), ds.engine()
        n, batch_attempts = 0, {}
        t = time.perf_counter()
        for name, insts in queries.items():
            single = [deng.query(q) for q in insts]
            # each template's instances as one launch sequence an attempt
            with AttemptCounter(dmod) as attempts:
                batched = deng.query_batch(insts)
            batch_attempts[name] = attempts.n
            for q, a, b in zip(insts, single, batched):
                want = eng.query(q)
                if not same_multiset(a, want) or not same_multiset(b, want):
                    raise AssertionError(f"{name}: distributed engine != "
                                         "single-device card engine")
                n += 2
        serve_s = time.perf_counter() - t
        res = {"rank": args.rank, "n_triples": ds.n_triples, "load_s": load_s,
               "build_s": build_s, "serve_s": serve_s, "results_equal": n,
               "exchanges": dmod.exchanges["all_to_all"],
               "rows_sent": dmod.exchanges["rows_sent"],
               "buffer_bytes": dmod.exchanges["buffer_bytes"],
               "launches": dict(ops.launches),
               "batch_attempts": batch_attempts}
        if min(res["launches"].values()) <= 0 or res["exchanges"] <= 0:
            raise AssertionError(f"rank {args.rank}: a kernel or the "
                                 f"exchange never ran: {res}")
        print(json.dumps(res), flush=True)
        with open(args.out, "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()
    return 0


# ---------------------------------------------------------------------------
# phase 7: the serving surface
# ---------------------------------------------------------------------------

#: instances a template sends through the server: each bucket a real
#: batch of up to 32
SERVE_INSTANCES = 32
#: templates served at SERVE_CUT_INSTANCES instances only: a batch holds
#: every binding's result on the card until the batch ends, and one
#: result of these is 2.9-4.1 GB (10^8 rows), so 32 do not fit beside
#: the catalog
SERVE_CUT = ("C1", "C2")
SERVE_CUT_INSTANCES = 3
#: templates whose batch does not fit the card at ``--scale``: a batch
#: holds every binding's intermediates at once (B times one query's), and
#: at scale 340 one query of C1 or C2 peaks at 32.3 and 32.5 GiB, so their
#: 3 instances padded to 4 run out of the card's 79.2 GiB (measured
#: by tools/batch_memory.py, a tool since removed).  Phase 3 runs no
#: ``query_batch`` of them and phase 7a serves them one instance a
#: batch; phases 4 and 7b at ``--compare-scale`` batch them.
BATCH_CUT = ("C1", "C2")
#: instances a template sends in 7a's second pass, a partial bucket as a
#: latency-bound flush drains it under light load (padded to 8)
PARTIAL_INSTANCES = 5
#: instances a template sends through the distributed server
SERVE_DIST_INSTANCES = 8
#: the trace turns serve these with ``trace_cardinality`` off (their
#: cardinality reports join 10^8 rows on the host), then time one
#: traced request each with it on
TRACE_NO_CARDINALITY = ("C1", "C2")
#: the templates 7a times one traced request of with the cardinality
#: report on; C1's is timed at --compare-scale only (7b's
#: ``heavy_report_turn``): at scale 340 its host joins took 245.9 and
#: 257.2 s of the smoke (PERF.md section 6, PR 22 runs 8 and 9)
REPORT_AT_SCALE = ("C2",)
TRACE_RATES = (0.0, 1.0, 0.1)
LAYOUTS_COMPARED = ("vp", "tt")


def same_rows(a, b) -> bool:
    return a.cols == b.cols and np.array_equal(a.data, b.data)


def same_bag(a, b) -> bool:
    """Equal as multisets over the same variables, whatever the column
    order (plans that join in another order bind the columns in
    another order)."""
    if sorted(a.cols) != sorted(b.cols) or a.data.shape != b.data.shape:
        return False
    perm = [b.cols.index(c) for c in a.cols]
    return bool(torch.equal(canon(a.data), canon(b.data[:, perm])))


def interleave(queries) -> list:
    """(template, query) pairs, one instance of every template in turn."""
    n = max(len(v) for v in queries.values())
    return [(name, insts[i]) for i in range(n)
            for name, insts in queries.items() if i < len(insts)]


def server_check(srv, eng, queries, exact: bool) -> dict:
    """Every query of ``queries`` submitted to ``srv``, the templates
    interleaved, then one flush; every ticket's rows held against
    ``eng.query`` of the same text (row for row when ``exact``, else
    as multisets).  Results are dropped as soon as they are compared."""
    order = interleave(queries)
    t = time.perf_counter()
    tickets = [srv.submit(q) for _, q in order]
    pending = srv.batcher.pending()
    flushed = srv.flush()
    wall_s = time.perf_counter() - t
    same = same_rows if exact else same_multiset
    for i, (name, q) in enumerate(order):
        got, want = tickets[i].result(), eng.query(q)
        if not same(got, want):
            raise AssertionError(f"{name}: the server's result != "
                                 "Engine.query's")
        tickets[i] = None
        del got, want
    return {"requests": len(order), "pending_after_submits": pending,
            "served_by_flush": flushed, "wall_s": wall_s}


def no_fallbacks(eng, what: str) -> None:
    """Every request ``eng`` served ran on the device path: none went
    through the eager fallback."""
    n = eng.metrics.device_fallbacks
    if n:
        raise AssertionError(f"{what}: {n} requests served by the eager "
                             "fallback")


def summary_line(m: dict) -> str:
    return (f"served {m['served']}, p50 {m['p50_ms']:.3f} ms, p90 "
            f"{m['p90_ms']:.3f} ms, p99 {m['p99_ms']:.3f} ms, queue p50 "
            f"{m['queue_p50_ms']:.3f} ms, queue p99 "
            f"{m['queue_p99_ms']:.3f} ms, batches {m['batches']}, batched "
            f"requests {m['batched_requests']}, occupancy "
            f"{m['batch_occupancy']:.3f}")


def trace_turns(eng, queries, here: str) -> dict:
    """The suite through ``eng.query`` at each rate of ``TRACE_RATES``
    in turn on the one engine, two passes a rate (the first warms what
    the rate adds: a traced binding's first sight runs its cardinality
    joins on the host); the p50 of the second.  ``TRACE_NO_CARDINALITY``
    runs its distinct texts with the cardinality report off, its p50s
    apart; after the turns one traced request of each of
    ``REPORT_AT_SCALE`` with the report on gives what the report
    costs.  Traced results must equal untraced
    ones row for row; then the Chrome dump, ``tools/trace_inspect.py``
    on it, and the span checks."""
    cfg = eng.config
    suite = [(n, q) for n, insts in queries.items()
             if n not in TRACE_NO_CARDINALITY for q in insts]
    heavy = [(n, q) for n in TRACE_NO_CARDINALITY
             for q in list(dict.fromkeys(queries[n]))[:HEAVY_TEXTS]]
    base, p50, heavy_p50 = {}, {}, {}

    def turn(items, rate) -> dict:
        for _ in range(2):
            lat = {}
            for name, q in items:
                t = time.perf_counter()
                r = eng.query(q)
                lat.setdefault(name, []).append(
                    (time.perf_counter() - t) * 1e3)
                if q not in base:
                    base[q] = r
                elif not same_rows(r, base[q]):
                    raise AssertionError(f"{name}: traced result at rate "
                                         f"{rate} != the untraced one")
                del r
        return lat

    with_cardinality = cfg.trace_cardinality
    for rate in TRACE_RATES:
        cfg.trace_sample_rate = rate
        lat = turn(suite, rate)
        p50[str(rate)] = p([x for v in lat.values() for x in v], 50)
        cfg.trace_cardinality = False
        try:
            lat = turn(heavy, rate)
        finally:
            cfg.trace_cardinality = with_cardinality
        heavy_p50[str(rate)] = {n: p(v, 50) for n, v in lat.items()}
    del base
    gc.collect()
    cfg.trace_sample_rate = 1.0
    cfg.trace_cardinality = True
    report_s = {}
    for name, q in dict(heavy).items():
        if name not in REPORT_AT_SCALE:
            continue
        t = time.perf_counter()
        eng.query(q)
        report_s[name] = time.perf_counter() - t
    cfg.trace_sample_rate = 0.0
    cfg.trace_cardinality = with_cardinality
    tracer = eng.tracer
    path = os.path.join(here, "build", "smoke_trace.json")
    with open(path, "w") as f:
        json.dump(tracer.chrome_trace(), f)
    out = subprocess.run(
        [sys.executable, os.path.join(here, "tools", "trace_inspect.py"),
         path, "--stages"], capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise AssertionError(f"trace_inspect failed: {out.stderr[-2000:]}")
    traces = tracer.recorder.traces()
    flat = {q[:200] for _, q in suite if "OPTIONAL" not in q}
    heavy_texts = {q[:200] for _, q in heavy}
    n_launch = n_card = n_short = n_heavy_card = 0
    for ctx in traces:
        names = {s.name for s in ctx.spans}
        events = {e["name"] for s in ctx.spans for e in s.events}
        if "short_circuit" in events:
            n_short += 1
            continue
        if "device.launch" not in names:
            raise AssertionError(f"trace {ctx.trace_id} has no "
                                 "device.launch span")
        n_launch += 1
        qtext = ctx.root.attrs.get("qtext")
        carded = all("cardinalities" in s.attrs for s in ctx.spans
                     if s.name == "device.launch")
        if qtext in flat:
            if not carded:
                raise AssertionError(f"trace {ctx.trace_id} of a flat BGP "
                                     "carries no cardinalities")
            n_card += 1
        elif qtext in heavy_texts and carded:
            n_heavy_card += 1
    if n_launch == 0 or n_card == 0 or \
            n_heavy_card < len(REPORT_AT_SCALE):
        raise AssertionError("no traced launch, or no cardinalities")
    return {"p50_ms": p50, "requests_per_pass": len(suite),
            "no_cardinality_p50_ms": heavy_p50,
            "with_cardinality_first_s": report_s,
            "traces": len(traces), "with_launch": n_launch,
            "with_cardinalities": n_card + n_heavy_card,
            "short_circuits": n_short,
            "started": tracer.started, "sampled_out": tracer.sampled_out,
            "inspect_stages": out.stdout.strip().splitlines()}


def timed_turns(engines: dict, queries, reps: int, check) -> dict:
    """Each template through every engine of ``engines`` (name ->
    engine): one cold pass over its distinct instances (a template
    without constants repeats one text) whose results ``check(name,
    query, results)`` holds against each other, then ``reps`` warm
    passes in turns (engine after engine for each instance; one pass
    over the distinct instances for ``SERVE_CUT``, whose queries take
    seconds).  Per-template p50s and peak card memory (all of it; what
    was allocated when the turns began is ``resident_gib``).  A template that
    runs out of card memory on an engine is left out of every engine's
    numbers and reported with its peak."""
    out, left_out = {}, {}
    resident_gib = torch.cuda.memory_allocated() / 2**30
    for name, insts in queries.items():
        distinct = list(dict.fromkeys(insts))
        torch.cuda.reset_peak_memory_stats()
        try:
            for q in distinct:
                res = {k: e.query(q) for k, e in engines.items()}
                check(name, q, res)
                del res
            lat = {k: [] for k in engines}
            warm = [distinct] if name in SERVE_CUT else [insts] * reps
            for passes in warm:
                for q in passes:
                    for k, e in engines.items():
                        t = time.perf_counter()
                        e.query(q)
                        lat[k].append((time.perf_counter() - t) * 1e3)
        except torch.OutOfMemoryError as exc:
            left_out[name] = {
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                "error": str(exc).splitlines()[0][:160]}
            del exc
            gc.collect()
            torch.cuda.empty_cache()
            continue
        out[name] = {k: p(v, 50) for k, v in lat.items()}
        out[name]["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return {"p50_ms": out, "left_out": left_out,
            "resident_gib": resident_gib}


def planner_turns(ds, eng, queries, reps: int) -> dict:
    """The basic templates under ``planner="estimate"`` against the
    greedy engine ``eng``: equal as multisets (no basic template has an
    ORDER BY, so neither pins a row order), p50s in turns, and
    ``explain()`` of one star and one snowflake.  The estimate engine
    is not the dataset's cached one, so its tables leave the card with
    it."""
    from repro_torch import Engine
    est = Engine(ds, planner="estimate")

    def check(name, q, res):
        if not same_bag(res["estimate"], res["greedy"]):
            raise AssertionError(f"{name}: estimate planner != greedy")

    turns = timed_turns({"greedy": eng, "estimate": est}, queries, reps,
                        check)
    orders = {}
    for name, insts in queries.items():
        if name in turns["left_out"]:
            continue
        g, e = eng.prepare(insts[0]).plan, est.prepare(insts[0]).plan
        orders[name] = {"planner": e.planner,
                        "same_order": g.describe() == e.describe()}
    turns["orders"] = orders
    turns["explain"] = {name: est.explain(queries[name][0]).splitlines()
                        for name in ("S1", "F1")}
    no_fallbacks(est, "estimate planner")
    del est
    gc.collect()
    torch.cuda.empty_cache()
    return turns


def layout_turns(ds, eng, queries, reps: int, skip=()) -> dict:
    """The basic templates (less ``skip``) under ``layout="vp"`` and
    ``"tt"`` against the ExtVP engine ``eng``: equal as multisets, and
    the paper's Table 4 comparison as p50s in turns.  The vp and tt
    engines are not the dataset's cached ones, so their tables leave
    the card with them."""
    from repro_torch import Engine
    engines = {"extvp": eng}
    engines.update({k: Engine(ds, layout=k) for k in LAYOUTS_COMPARED})

    def check(name, q, res):
        for k in LAYOUTS_COMPARED:
            if not same_bag(res[k], res["extvp"]):
                raise AssertionError(f"{name}: layout {k} != extvp")

    turns = timed_turns(engines, {n: v for n, v in queries.items()
                                  if n not in skip}, reps, check)
    turns["skipped"] = list(skip)
    for k in LAYOUTS_COMPARED:
        if engines[k].metrics.device_fallbacks:
            raise AssertionError(f"layout {k} fell back")
    del engines
    gc.collect()
    torch.cuda.empty_cache()
    return turns


def serve_queries(schema, seed: int, n: int, names, cut=(),
                  cut_n: int = 0) -> dict:
    from repro_torch.rdf.workloads import basic_queries
    qs = basic_queries(schema, seed=seed, n_instances=n)
    return {k: (v[:cut_n] if k in cut else v) for k, v in qs.items()
            if k in names}


class BatchRecorder:
    """What a served flush does, read off the server's engine: for each
    template (by signature) its batches (chunks), the attempts of its
    executor's program with their batch size, the join-probe launches of
    those attempts, each batch's wall time (``record_latency``, once a
    chunk) and the peak device memory over its chunks; and for each
    batched join-probe form and shape the calls, with the inputs of the
    first call of each B = 32 shape kept for timing.  It calls every
    wrapper unchanged: launch counts stay the wrappers'."""

    def __init__(self, eng, jexec, ops):
        self.eng, self.jexec, self.ops = eng, jexec, ops
        self.groups = {}
        self.walls = []
        self.shapes = {}
        self.inputs = {}
        self.kept_bytes = 0
        self._sig = None

    def _group(self, sig, decision, prepared, bindings, traces=None):
        g = self.groups.setdefault(sig, {"chunks": 0, "attempts": {},
                                         "probe_launches": 0,
                                         "peak_gib": 0.0})
        before = (self.eng.metrics.batches, self.ops.launches["join_probe"])
        torch.cuda.reset_peak_memory_stats()
        self._sig = sig
        try:
            out = self._inner_group(sig, decision, prepared, bindings,
                                    traces)
        finally:
            self._sig = None
        g["chunks"] += self.eng.metrics.batches - before[0]
        g["probe_launches"] += self.ops.launches["join_probe"] - before[1]
        g["peak_gib"] = max(g["peak_gib"],
                            torch.cuda.max_memory_allocated() / 2**30)
        return out

    def _program(self, ex, caps, inp, bounds, fconsts, shared):
        if self._sig is not None:
            att = self.groups[self._sig]["attempts"]
            att[bounds.shape[0]] = att.get(bounds.shape[0], 0) + 1
        return self._inner_program(ex, caps, inp, bounds, fconsts, shared)

    def _probe(self, a, b):
        if self._sig is not None and a.dim() == 2:
            key = (a.shape[0], a.shape[1], b.shape[-1], b.dim() == 2)
            self.shapes[key] = self.shapes.get(key, 0) + 1
            nbytes = (a.numel() + b.numel()) * 4
            if a.shape[0] == 32 and key not in self.inputs and \
                    self.kept_bytes + nbytes < 2**31:
                self.inputs[key] = (a.clone(), b.clone())
                self.kept_bytes += nbytes
        return self.inner_probe(a, b)

    def _latency(self, ms, count=1):
        self.walls.append(ms)
        return self._inner_latency(ms, count)

    def __enter__(self):
        eng, cls = self.eng, self.jexec.PlanExecutor
        self._inner_group = eng._run_group
        eng._run_group = self._group
        self._inner_program = cls._program
        rec = self

        def program(ex, *a):
            return rec._program(ex, *a)

        cls._program = program
        self.inner_probe = self.jexec.ops.join_probe
        self.jexec.ops = _OpsShim(self.jexec.ops, join_probe=self._probe)
        self._inner_latency = eng.metrics.record_latency
        eng.metrics.record_latency = self._latency
        return self

    def __exit__(self, *exc):
        eng = self.eng
        del eng._run_group
        del eng.metrics.record_latency
        self.jexec.PlanExecutor._program = self._inner_program
        self.jexec.ops = self.jexec.ops.base

    def most_frequent(self, per_row: bool):
        """The most frequent B = 32 probe shape of one build form, with
        its call count, or None."""
        keys = [k for k in self.shapes if k[0] == 32 and k[3] == per_row
                and k in self.inputs]
        if not keys:
            return None
        key = max(keys, key=lambda k: (self.shapes[k], k[1] * k[2]))
        return key, self.shapes[key]


def served_batches(rec: BatchRecorder, queries, probes_per_query) -> dict:
    """Per template: its chunks, program attempts by batch size, the
    join-probe launches a served attempt against phase 3's a warm query,
    and the peak device memory of its chunks."""
    from repro_torch.engine import template_signature
    out = {}
    for name, insts in queries.items():
        g = rec.groups.get(template_signature(insts[0]))
        if g is None:
            continue
        attempts = sum(g["attempts"].values())
        out[name] = {
            "instances": len(insts), "chunks": g["chunks"],
            "attempts_by_batch": {str(b): n for b, n in
                                  sorted(g["attempts"].items())},
            "probe_launches": g["probe_launches"],
            "probes_per_attempt": g["probe_launches"] / max(attempts, 1),
            "probes_per_query_phase3": probes_per_query.get(name),
            "peak_gib": g["peak_gib"]}
    return out


def phase_serve(args, ds, eng, queries, ops, ref, jexec, probe_path,
                here: str) -> dict:
    """7a at ``--scale`` on the main path's dataset: the server (each
    bucket one launch sequence, padded to its shape), the batched probe
    timed on its most frequent served shape, the trace turns, the
    estimate planner, the layouts, and the server on the distributed
    backend at one NCCL rank."""
    from repro_torch import RuntimeConfig, SparqlServer
    nums = {}
    # the latency bound at a minute: the server check wants every
    # bucket to fill to 32 (submitting 580 requests takes longer than
    # the default 2 ms)
    srv = SparqlServer(ds, runtime=RuntimeConfig(flush_ms=60_000.0))
    if srv.engine.device.type != "cuda":
        raise AssertionError("the server does not run on the card")
    sq = serve_queries(ds.schema, 42, SERVE_INSTANCES, queries,
                       SERVE_CUT, SERVE_CUT_INSTANCES)
    sq = {k: (v[:1] if k in BATCH_CUT else v) for k, v in sq.items()}
    # the mix, then a pass of partial buckets (a different draw)
    partial = {k: v for k, v in serve_queries(
        ds.schema, 43, PARTIAL_INSTANCES, queries).items()
        if k not in BATCH_CUT}
    with BatchRecorder(srv.engine, jexec, ops) as rec:
        chk = server_check(srv, eng, sq, exact=True)
        mix = srv.metrics.summary()
        chk_partial = server_check(srv, eng, partial, exact=True)
    no_fallbacks(srv.engine, "server")
    m = srv.metrics.summary()
    fewer = ", ".join(f"{len(v)} of {k}" for k, v in sq.items()
                      if len(v) != SERVE_INSTANCES)
    log(f"  server: {chk['requests']} requests ({SERVE_INSTANCES} of each "
        f"template; {fewer}), "
        f"interleaved, submitted and flushed in {chk['wall_s']:.1f} s; "
        f"every result equal row for row to Engine.query's; "
        f"{summary_line(mix)}; padding waste {mix['padding_waste']:.4f}")
    log(f"  then {chk_partial['requests']} requests in partial buckets "
        f"({PARTIAL_INSTANCES} of each template but "
        f"{', '.join(BATCH_CUT) or 'none'}, one flush in "
        f"{chk_partial['wall_s']:.1f} s), equal row for row; over both "
        f"passes: {summary_line(m)}; padding waste "
        f"{m['padding_waste']:.4f}")
    if m["padding_waste"] <= 0:
        raise AssertionError("the served buckets were not padded")
    tuner = srv.engine.tuner.report()
    if not any(b["launches"] for b in tuner["buckets"].values()):
        raise AssertionError("the tuner observed no served batch")
    log(f"  tuner: menu {tuner['menu']}, active {tuner['active']}, "
        f"retired {json.dumps(tuner['retired'])}; per shape (launches, "
        f"per-slot ms, occupancy, padding waste): " + ", ".join(
            f"{k}: ({v['launches']}, {v['per_slot_ms']}, {v['occupancy']}, "
            f"{v['padding_waste']:.4f})"
            for k, v in tuner["buckets"].items()
            if v["launches"] or v["padding_waste"]))
    per = served_batches(rec, {k: v + partial.get(k, [])
                               for k, v in sq.items()},
                         probe_path["probes_per_query"])
    walls = rec.walls
    log(f"  batch wall (host clock around each served chunk): "
        f"{len(walls)} chunks, p50 {p(walls, 50):.3f} ms, p99 "
        f"{p(walls, 99):.3f} ms, max {max(walls):.3f} ms")
    for name, v in per.items():
        log(f"    {name}: {v['instances']} requests, {v['chunks']} chunk(s), "
            f"attempts by batch {json.dumps(v['attempts_by_batch'])}, "
            f"join-probe launches {v['probe_launches']} "
            f"({v['probes_per_attempt']:.2f} an attempt; a warm query of "
            f"phase 3: {v['probes_per_query_phase3']:.2f}), peak "
            f"{v['peak_gib']:.2f} GiB")
    del m["routed"], mix["routed"]
    nums["server"] = dict(m, mix=mix, check=chk, partial_check=chk_partial,
                          tuner=tuner, batches=per,
                          batch_wall_p50_ms=p(walls, 50),
                          batch_wall_p99_ms=p(walls, 99))
    timed = {}
    for per_row in (True, False):
        top = rec.most_frequent(per_row)
        if top is None:
            continue
        key, count = top
        a, b = rec.inputs[key]
        timed["a build a row" if per_row else "one build"] = dict(
            batched_probe_numbers(ops, ref, a, b), calls_in_flush=count)
    del rec
    if not timed:
        raise AssertionError("no batched join probe of 32 rows was served")
    for form, v in timed.items():
        log(f"  batched join_probe on the most frequent served B = 32 step "
            f"({form}: 32 x {v['n_a']} probe keys, n_b {v['n_b']}, "
            f"{v['calls_in_flush']} calls in the flush): equal; kernel "
            f"{v['ms']:.4f} ms, 32 single launches {v['singles_ms']:.4f} "
            f"ms, plain {v['plain_ms']:.4f} ms, batched torch.searchsorted "
            f"x2 {v['library_ms']:.4f} ms, bound {v['bound_ms']:.4f} ms")
    nums["batched_probe"] = timed
    serve_cut = [k for k in SERVE_CUT if k not in BATCH_CUT]
    nums["reduced"] = [
        f"{', '.join(serve_cut)} served at {SERVE_CUT_INSTANCES} instances "
        f"(a result of 10^8 rows does not fit 32 times beside the catalog)"
    ] if serve_cut else []
    if BATCH_CUT:
        nums["reduced"].append(
            f"{', '.join(BATCH_CUT)} at one instance a batch in 7a, none in "
            f"its partial pass, and no phase-3 batch of them: their batch "
            f"does not fit the card at scale {args.scale} (BATCH_CUT)")
    nums["reduced"].append(
        f"one traced request with the cardinality report on at "
        f"{args.scale} for {', '.join(REPORT_AT_SCALE)} only; the others "
        f"of {', '.join(TRACE_NO_CARDINALITY)} at {args.compare_scale} "
        f"(7b): at 340 C1's host joins took 246-257 s of the smoke "
        f"(REPORT_AT_SCALE)")
    for line in nums["reduced"]:
        log(f"  reduced: {line}")

    tr = trace_turns(srv.engine, queries, here)
    log(f"  trace turns ({tr['requests_per_pass']} requests a pass, then "
        f"{', '.join(TRACE_NO_CARDINALITY)} without the cardinality "
        f"report): p50 by rate (ms) {json.dumps(tr['p50_ms'])}; "
        f"{', '.join(TRACE_NO_CARDINALITY)} p50 by rate (ms) "
        f"{json.dumps(tr['no_cardinality_p50_ms'])}; one traced request "
        f"of {', '.join(REPORT_AT_SCALE)} with the report on (s) "
        f"{json.dumps(tr['with_cardinality_first_s'])}; "
        f"traced results equal untraced; "
        f"{tr['traces']} traces kept, {tr['with_launch']} with a "
        f"device.launch span, {tr['with_cardinalities']} flat-BGP ones "
        f"with cardinalities, {tr['short_circuits']} short-circuited")
    for line in tr["inspect_stages"][:12]:
        log(f"    {line}")
    nums["tracing"] = tr
    no_fallbacks(srv.engine, "trace turns")
    nums["prometheus_bytes"] = len(srv.metrics.prometheus())
    # the server's engine has its own runtime, so the dataset does not
    # cache it: its tables leave the card with it
    del srv
    gc.collect()
    torch.cuda.empty_cache()

    pl = planner_turns(ds, eng, queries, args.reps)
    log(f"  estimate planner: every result equal to greedy's (multisets); "
        f"left out {json.dumps(pl['left_out'])}; resident at the start "
        f"{pl['resident_gib']:.2f} GiB")
    for name, v in pl["p50_ms"].items():
        o = pl["orders"][name]
        log(f"    {name}: p50 greedy {v['greedy']:.3f} ms, estimate "
            f"{v['estimate']:.3f} ms (plan by {o['planner']}, "
            f"{'same' if o['same_order'] else 'another'} order); peak "
            f"{v['peak_gib']:.2f} GiB")
    for name, lines in pl["explain"].items():
        log(f"    explain {name} (estimate):")
        for line in lines:
            log(f"      {line}")
    nums["planners"] = pl

    lay = layout_turns(ds, eng, queries, args.reps)
    log(f"  layouts at scale {args.scale}: every result equal to extvp's "
        f"(multisets); left out (out of card memory) "
        f"{json.dumps(lay['left_out'])}; resident at the start "
        f"{lay['resident_gib']:.2f} GiB")
    for name, v in lay["p50_ms"].items():
        log(f"    {name}: p50 extvp {v['extvp']:.3f} ms, vp {v['vp']:.3f} "
            f"ms, tt {v['tt']:.3f} ms; peak {v['peak_gib']:.2f} GiB")
    nums["layouts"] = {str(args.scale): lay}
    nums["distributed"] = phase_serve_distributed(ds, eng, queries, here)
    no_fallbacks(eng, "the torch engine of phases 3-7a")
    return nums


def phase_serve_distributed(ds, eng, queries, here: str) -> dict:
    """The server on the distributed backend, a world of one rank over
    NCCL as in 6a, over the templates 6a serves: interleaved submits
    with a latency bound of 0 ms, which on one device would drain every
    bucket on the next submit; here only full buckets and the flush
    drain, and every result equals the single-device engine's.  A second
    pass of ``PARTIAL_INSTANCES`` of each template fills its buckets in
    part: each bucket is one launch sequence padded to its shape, so
    the padding waste is not 0 and the tuner observes the batches."""
    import torch.distributed as dist
    from repro_torch import RuntimeConfig, SparqlServer
    rdv = os.path.join(here, "build", "smoke_nccl_rendezvous_serve")
    if os.path.exists(rdv):
        os.remove(rdv)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{rdv}", rank=0,
                            world_size=1)
    try:
        srv = SparqlServer(ds, backend="distributed",
                           runtime=RuntimeConfig(flush_ms=0.0))
        names = [n for n in queries if n not in ONE_RANK_CUT]
        sq = serve_queries(ds.schema, 42, SERVE_DIST_INSTANCES, names)
        chk = server_check(srv, eng, sq, exact=False)
        no_fallbacks(srv.engine, "distributed server")
        if chk["pending_after_submits"] != chk["requests"]:
            raise AssertionError("a bucket drained before the flush on the "
                                 "distributed backend")
        m = srv.metrics.summary()
        log(f"  distributed server (one NCCL rank): {chk['requests']} "
            f"requests ({SERVE_DIST_INSTANCES} of each of {len(names)} "
            f"templates), all {chk['pending_after_submits']} still queued "
            f"after the submits at flush_ms 0, flushed in "
            f"{chk['wall_s']:.1f} s; every result equal to the "
            f"single-device engine's (multisets); {summary_line(m)}, "
            f"padding waste {m['padding_waste']:.4f}")
        partial = server_check(srv, eng, serve_queries(
            ds.schema, 43, PARTIAL_INSTANCES, names), exact=False)
        m = srv.metrics.summary()
        del m["routed"]
        if m["padding_waste"] <= 0:
            raise AssertionError("the distributed server's buckets were "
                                 "not padded")
        tuner = srv.engine.tuner.report()
        if not any(b["launches"] for b in tuner["buckets"].values()):
            raise AssertionError("the tuner observed no distributed batch")
        log(f"  distributed server, {partial['requests']} more requests "
            f"({PARTIAL_INSTANCES} of each template, buckets padded to "
            f"their shape) flushed in {partial['wall_s']:.1f} s, equal; "
            f"both passes: {summary_line(m)}, padding waste "
            f"{m['padding_waste']:.4f}")
        log(f"  distributed tuner: menu {tuner['menu']}, active "
            f"{tuner['active']}, retired {json.dumps(tuner['retired'])}; "
            f"per shape (launches, per-slot ms, occupancy, padding waste): "
            + ", ".join(f"{k}: ({v['launches']}, {v['per_slot_ms']}, "
                        f"{v['occupancy']}, {v['padding_waste']:.4f})"
                        for k, v in tuner["buckets"].items()
                        if v["launches"] or v["padding_waste"]))
        del srv
        return dict(m, check=chk, partial=partial, tuner=tuner)
    finally:
        dist.destroy_process_group()


def heavy_report_turn(ds, queries) -> dict:
    """One traced request of each ``TRACE_NO_CARDINALITY`` template with
    the cardinality report on, on a fresh engine (its first sight: the
    report joins every step on the host), timed; each trace must carry
    a ``device.launch`` span with the cardinalities."""
    from repro_torch import Engine, RuntimeConfig
    eng = Engine(ds, runtime=RuntimeConfig(trace_sample_rate=1.0))
    report_s = {}
    for name in TRACE_NO_CARDINALITY:
        t = time.perf_counter()
        eng.query(queries[name][0])
        report_s[name] = time.perf_counter() - t
    traces = eng.tracer.recorder.traces()
    carded = [any(s.name == "device.launch" for s in ctx.spans)
              and all("cardinalities" in s.attrs for s in ctx.spans
                      if s.name == "device.launch")
              for ctx in traces]
    if len(traces) != len(TRACE_NO_CARDINALITY) or not all(carded):
        raise AssertionError("a traced request with the report on carries "
                             "no cardinalities")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return report_s


def phase_serve_small(args, ds, eng, queries, store: str, ops,
                      here: str) -> dict:
    """7b at ``--compare-scale``: every template under every layout, a
    server booted from phase 5's store path (its journal replays through
    the semi-join on the card), and the launcher as a subprocess."""
    from repro_torch import Engine, SparqlServer
    nums = {}
    lay = layout_turns(ds, eng, queries, args.reps)
    if lay["left_out"]:
        raise AssertionError(f"layouts left out at {args.compare_scale}: "
                             f"{lay['left_out']}")
    log(f"  layouts at scale {args.compare_scale}: every result equal to "
        f"extvp's (multisets)")
    for name, v in lay["p50_ms"].items():
        log(f"    {name}: p50 extvp {v['extvp']:.3f} ms, vp {v['vp']:.3f} "
            f"ms, tt {v['tt']:.3f} ms; peak {v['peak_gib']:.2f} GiB")
    nums["layouts"] = {str(args.compare_scale): lay}
    report_s = heavy_report_turn(ds, queries)
    log(f"  one traced request each with the cardinality report on, at "
        f"scale {args.compare_scale} (s): {json.dumps(report_s)}; each "
        f"trace's launch spans carry the cardinalities")
    nums["with_cardinality_first_s"] = {str(args.compare_scale): report_s}

    before = ops.launches["semijoin_membership"]
    t = time.perf_counter()
    srv = SparqlServer(store)
    boot_s = time.perf_counter() - t
    if ops.launches["semijoin_membership"] <= before:
        raise AssertionError("booting from the store ran no semi-join")
    q = {k: v for k, v in queries.items() if k in ("S1", "L2", "F3", "C3")}
    # the store's dictionary is phase 5's (built from the decoded
    # triples), so its ids are not ``ds``'s: held against a fresh engine
    # over the booted dataset (phase 5 holds that against a rebuild)
    chk = server_check(srv, Engine(srv.dataset), q, exact=True)
    log(f"  server booted from the store path in {boot_s:.2f} s (journal "
        f"replayed on the card); {chk['requests']} results equal row for "
        f"row to Engine.query's over the booted dataset")
    nums["store_boot"] = dict(chk, boot_s=boot_s)
    del srv

    build = os.path.join(here, "build")
    dump = os.path.join(build, "serve_trace.jsonl")
    prom = os.path.join(build, "serve_metrics.prom")
    for f in (dump, prom):
        if os.path.exists(f):
            os.remove(f)
    env = dict(os.environ, PYTHONPATH=os.path.join(here, "src"))
    t = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--store", store,
         "--passes", "2", "--trace-sample", "1.0", "--trace-dump", dump,
         "--metrics-out", prom], cwd=here, env=env, capture_output=True,
        text=True, timeout=600)
    launcher_s = time.perf_counter() - t
    if out.returncode != 0:
        raise AssertionError(f"the launcher failed ({out.returncode}):\n"
                             f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    for line in out.stdout.splitlines():
        if not line.startswith("  ST-"):
            log(f"    launcher: {line}")
    with open(prom) as f:
        text = f.read()
    for family in ("repro_request_latency_ms", "repro_stage_ms"):
        if f"# TYPE {family} histogram" not in text:
            raise AssertionError(f"the Prometheus file lacks {family}")
    inspect = subprocess.run(
        [sys.executable, os.path.join(here, "tools", "trace_inspect.py"),
         dump, "--stages"], capture_output=True, text=True, timeout=300)
    if inspect.returncode != 0:
        raise AssertionError(f"trace_inspect failed: "
                             f"{inspect.stderr[-2000:]}")
    nums["launcher"] = {"wall_s": launcher_s, "prometheus_lines":
                        len(text.splitlines())}
    log(f"  launcher: exit 0 in {launcher_s:.1f} s; the Prometheus file "
        f"has the latency and stage histograms; trace_inspect read its "
        f"dump")
    return nums


# ---------------------------------------------------------------------------
# phase 8: the adaptive runtime and the host engine
# ---------------------------------------------------------------------------

#: instances of a template the auto engine serves one by one, drawn
#: with this seed
AUTO_INSTANCES = 32
AUTO_SEED = 8
#: templates phase 8 serves at --compare-scale only: on the host engine
#: their joins take 254 s (C1) and 32 s (C2) a run at scale 340 (the
#: cardinality report of PR 17's run 3 is the same host join), and the
#: router runs each on eager at least router_warmup + router_discard
#: times
AUTO_SMALL_ONLY = ("C1", "C2")
#: templates the served pass with the default router knobs leaves out:
#: over 200 ms a request on the host engine at scale 340 (F1, F4 and C3
#: over 500 ms), where each probe sends a whole batch of 32 there
DEFAULT_KNOBS_CUT = ("F1", "F2", "F4", "C3")
#: warm passes a template takes on the pt layout for its p50 (the
#: AUTO_SMALL_ONLY ones take none: on the host their pt joins take
#: seconds, so their checked run is timed; DEPTH_CUTS)
PT_REPS = 2


def auto_turns(auto, eng, queries, ops) -> dict:
    """Each template's ``AUTO_INSTANCES`` instances through the auto
    engine one by one, each timed on the host clock and held against the
    torch engine ``eng`` (timed too): row for row when the router sent
    it to torch (the same executor), as a multiset when to eager (no
    basic template pins a row order).  Join-probe launches are counted
    over the auto calls alone.  Per template: the router's seat, reason
    and EWMAs, the requests routed to each backend, and warm p50s through
    auto (after the router's warmup), torch and eager (the eager runs
    less the first, which the router discards too)."""
    from repro_torch.engine import template_signature
    cfg = auto.config
    warm_after = (cfg.router_warmup + cfg.router_discard) * \
        len(auto.backends)
    out, probe_launches = {}, 0
    for name, insts in queries.items():
        lat = {"auto": [], "torch": [], "eager": []}
        routed = {}
        for i, q in enumerate(insts):
            before = ops.launches["join_probe"]
            t = time.perf_counter()
            got = auto.query(q)
            ms = (time.perf_counter() - t) * 1e3
            backend = auto.router.log[-1]["backend"]
            if backend == "torch":
                probe_launches += ops.launches["join_probe"] - before
            routed[backend] = routed.get(backend, 0) + 1
            if i >= warm_after:
                lat["auto"].append(ms)
            if backend == "eager":
                lat["eager"].append(ms)
            t = time.perf_counter()
            want = eng.query(q)
            lat["torch"].append((time.perf_counter() - t) * 1e3)
            same = same_rows if backend == "torch" else same_bag
            if not same(got, want):
                raise AssertionError(f"{name}: auto ({backend}) != torch")
            del got, want
        st = auto.router.report()["signatures"][template_signature(insts[0])]
        if st["failed"]:
            raise AssertionError(f"{name}: the router excluded "
                                 f"{st['failed']} as failed")
        out[name] = {
            "seat": st["choice"], "reason": st["reason"],
            "ewma_ms": st["ewma_ms"], "routed": routed,
            "fallback": st["fallback"],
            "p50_ms": {k: p(v[1:] if k == "eager" and len(v) > 1 else v, 50)
                       for k, v in lat.items() if v}}
    return {"templates": out, "join_probe_launches": probe_launches}


def pt_turns(ds, queries, names) -> dict:
    """Every template of ``names`` under ``layout="pt"`` on a torch
    engine, which serves it through the flagged eager fallback: one cold
    run held against the eager engine (multisets), then warm runs for a
    p50 of host time (``AUTO_SMALL_ONLY``: the cold run's time).  Every
    request must count as a fallback."""
    from repro_torch import Engine
    pt = Engine(ds, layout="pt")
    eager = Engine(ds, backend="eager")
    out = {}
    for name in names:
        q = queries[name][0]
        t = time.perf_counter()
        got = pt.query(q)
        cold_ms = (time.perf_counter() - t) * 1e3
        if not same_bag(got, eager.query(q)):
            raise AssertionError(f"{name}: pt != eager")
        del got
        lat = [cold_ms] if name in AUTO_SMALL_ONLY else []
        for _ in range(0 if name in AUTO_SMALL_ONLY else PT_REPS):
            t = time.perf_counter()
            pt.query(q)
            lat.append((time.perf_counter() - t) * 1e3)
        out[name] = p(lat, 50)
    m = pt.metrics.summary()
    if m["device_fallbacks"] != m["served"]:
        raise AssertionError(f"pt: {m['device_fallbacks']} fallbacks for "
                             f"{m['served']} requests")
    return {"p50_ms": out, "served": m["served"],
            "device_fallbacks": m["device_fallbacks"]}


def log_auto(turns: dict, pt: dict, layouts: dict) -> None:
    for name, v in turns["templates"].items():
        ewma = ", ".join(f"{b} {ms:.3f}" for b, ms in
                         sorted(v["ewma_ms"].items()))
        p50 = ", ".join(f"{b} {ms:.3f}" for b, ms in v["p50_ms"].items())
        log(f"    {name}: seat {v['seat']} ({v['reason']}); EWMA ms "
            f"{ewma}; routed {json.dumps(v['routed'])}; warm p50 ms {p50}")
    for name, ms in pt["p50_ms"].items():
        lay = layouts.get(name)
        cols = "" if lay is None else (
            f"; extvp {lay['extvp']:.3f}, vp {lay['vp']:.3f}, tt "
            f"{lay['tt']:.3f} ms (phase 7, card)")
        what = "the checked run" if name in AUTO_SMALL_ONLY else "p50"
        log(f"    {name}: pt {what} {ms:.3f} ms (host time){cols}")


def phase_adaptive(args, ds, eng, queries, ops, scale: float, auto_names,
                   pt_names, layouts: dict, serve_mix: bool) -> dict:
    """Phase 8 at one scale: ``auto_names`` through an auto engine,
    ``pt_names`` under the pt layout, and (``serve_mix``) one served
    pass of phase 7a's request mix through the same auto engine."""
    from repro_torch import RuntimeConfig, SparqlServer
    nums = {"scale": scale}
    # the server's engine is Engine(ds, backend="auto") with the default
    # router and tuner knobs; the latency bound at a minute lets the
    # served pass fill its buckets
    srv = SparqlServer(ds, backend="auto",
                       runtime=RuntimeConfig(flush_ms=60_000.0))
    auto = srv.engine
    if auto.backends != ("eager", "torch") or \
            auto.device.type != "cuda":
        raise AssertionError(f"auto engine over {auto.backends} on "
                             f"{auto.device}")
    t = time.perf_counter()
    aq = serve_queries(ds.schema, AUTO_SEED, AUTO_INSTANCES, auto_names)
    turns = auto_turns(auto, eng, aq, ops)
    turns["wall_s"] = time.perf_counter() - t
    if turns["join_probe_launches"] <= 0:
        raise AssertionError("the torch seat launched no join probe")
    t = time.perf_counter()
    pt = pt_turns(ds, queries, pt_names)
    pt["wall_s"] = time.perf_counter() - t
    log(f"  auto engine at scale {scale}: {len(auto_names)} templates x "
        f"{AUTO_INSTANCES} requests in {turns['wall_s']:.1f} s, every "
        f"result equal to the torch engine's (row for row when routed to "
        f"torch, multisets when to eager), no failed exclusion, "
        f"{turns['join_probe_launches']} join-probe launches on the torch "
        f"seat; pt layout: {pt['served']} requests in {pt['wall_s']:.1f} "
        f"s, all {pt['device_fallbacks']} eager fallbacks, results equal "
        f"to the eager engine's")
    log_auto(turns, pt, layouts)
    nums["auto"], nums["pt"] = turns, pt
    if serve_mix:
        nums["served"] = served_auto(srv, eng, ds, queries)
    del srv, auto
    gc.collect()
    torch.cuda.empty_cache()
    return nums


def served_pass(srv, eng, ds, names) -> dict:
    """Phase 7a's request mix over ``names`` submitted to the auto
    server ``srv`` and flushed once, each ticket held against the torch
    engine (multisets).  From the router's log of the pass: the requests
    routed to each backend and why, the eager share, and the p50 and p99
    over requests of the batch wall time each request saw (the host
    clock around its ``run_batch`` chunk; the flush runs the groups one
    after another)."""
    sq = serve_queries(ds.schema, 42, SERVE_INSTANCES, names)
    before = srv.metrics.batches
    chk = server_check(srv, eng, sq, exact=False)
    chunks = srv.metrics.batches - before
    log_tail = list(srv.engine.router.log)[-chunks:] if chunks else []
    routed, reasons, waits = {}, {}, []
    for e in log_tail:
        w = int(e["weight"])
        routed[e["backend"]] = routed.get(e["backend"], 0) + w
        key = f"{e['backend']}/{e['reason']}"
        reasons[key] = reasons.get(key, 0) + w
        waits.extend([e["ms"] * w] * w)
    n = sum(routed.values())
    if n != chk["requests"]:
        raise AssertionError(f"the router's log covers {n} of "
                             f"{chk['requests']} requests")
    return {"check": chk, "routed": routed, "reasons": reasons,
            "eager_share": routed.get("eager", 0) / n,
            "batch_p50_ms": p(waits, 50), "batch_p99_ms": p(waits, 99)}


def served_auto(srv, eng, ds, queries) -> dict:
    """Two served passes of phase 7a's request mix (less
    ``AUTO_SMALL_ONLY``) through the auto server the turns warmed.  The
    first keeps the default router knobs, as a user gets them, and
    leaves out ``DEFAULT_KNOBS_CUT`` too: with batches of 32 and the
    default ``router_probe_every`` of 32, every batch group crosses a
    probe boundary and the router sends the whole batch to the losing
    backend, which the pass measures.  The second turns the probes off.
    Then the Prometheus page's router and tuner families are printed;
    the tuner's per-slot times must be among them (the torch seat's
    batches are one launch sequence, which the tuner measures)."""
    out = {}
    cfg = srv.engine.config
    base = [n for n in queries if n not in AUTO_SMALL_ONLY]
    for knobs, names in (("default", [n for n in base
                                      if n not in DEFAULT_KNOBS_CUT]),
                         ("probes_off", base)):
        if knobs == "probes_off":
            cfg.router_probe_every = 0
        r = served_pass(srv, eng, ds, names)
        log(f"  served through auto, {knobs} router knobs (probe every "
            f"{cfg.router_probe_every}): {r['check']['requests']} requests "
            f"({SERVE_INSTANCES} of each of {len(names)} templates), one "
            f"flush in {r['check']['wall_s']:.1f} s, routed "
            f"{json.dumps(r['routed'])} ({json.dumps(r['reasons'])}), "
            f"eager share {r['eager_share']:.3f}, batch wall time a "
            f"request saw p50 {r['batch_p50_ms']:.3f} ms, p99 "
            f"{r['batch_p99_ms']:.3f} ms; every result equal to the torch "
            f"engine's (multisets)")
        out[knobs] = r
    page = srv.metrics.prometheus().splitlines()
    fams = [ln for ln in page if ln.startswith(("repro_router_",
                                                "repro_tuner_"))
            or ln.startswith(("# HELP repro_router_",
                              "# HELP repro_tuner_"))]
    if not any(ln.startswith("repro_router_ewma_ms") for ln in fams) or \
            not any(ln.startswith("repro_tuner_shape_active")
                    for ln in fams):
        raise AssertionError("the Prometheus page lacks the router or "
                             "tuner families")
    # the torch seat's batches are one launch sequence: the tuner has
    # measured them
    if not any(ln.startswith("repro_tuner_per_slot_ms") for ln in fams):
        raise AssertionError("the tuner families do not move")
    for ln in fams:
        log(f"    {ln[:200]}")
    out["prometheus_lines"] = len(fams)
    return out


# ---------------------------------------------------------------------------
# phase 9: static analysis and the missing-constant repair on the card
# ---------------------------------------------------------------------------

#: repetitions of ``verify_prepared`` a template; its host time is their
#: median
VERIFY_REPS = 20
#: the missing-constant repair: each query holds a constant absent from
#: the dictionary outside its required patterns, so SPARQL keeps the two
#: rows of ``?s ex:pa ?o``; the last one's is required (an empty answer)
REPAIR_TRIPLES = [("ex:e0", "ex:pa", "ex:e1"), ("ex:e1", "ex:pa", "ex:e2"),
                  ("ex:e2", "ex:pb", "ex:e0"), ("ex:e1", "ex:pb", "ex:e3")]
REPAIR_QUERIES = [
    "SELECT * WHERE { ?s ex:pa ?o OPTIONAL { ?o ex:pb ex:e99 } }",
    "SELECT * WHERE { { ?s ex:pa ?o } UNION { ?s ex:pb ex:e99 } }",
    "SELECT * WHERE { ?s ex:pa ?o FILTER(?o != ex:e99) }",
    'SELECT * WHERE { ?s ex:pa ?o FILTER(?o != "lit") }',
    "SELECT * WHERE { ?s ex:pa ex:e99 . ?s ex:pa ?o }"]
#: the serve twin's arguments on the card (its defaults: scale 1.0)
SERVE_TWIN_ARGS = ("--scale", "1.0", "--requests", "60")


def verify_reports(eng, ds, queries, analysis) -> dict:
    """Every template prepared on ``eng`` (an engine with
    ``verify_plans`` on, so the prepare runs the verifier before it
    caches the plan): its report must be free of errors and warnings,
    and must have run its checks wherever the prepared form holds a plan
    or an executor (only an eager host operator tree, which holds
    neither, reports "skipped"); the verifier's host ms (median of
    ``VERIFY_REPS`` calls) beside the prepare's (one cache miss,
    verification included)."""
    out = {}
    for name, insts in queries.items():
        t = time.perf_counter()
        prepared = eng.prepare(insts[0])
        prepare_ms = (time.perf_counter() - t) * 1e3
        report = analysis.verify_prepared(prepared, ds.catalog)
        compiled = getattr(prepared, "executor", None) is not None or \
            getattr(prepared, "plan", None) is not None
        if report.diagnostics or (compiled and not report.checks):
            raise AssertionError(f"{name}: {report.describe()}")
        times = []
        for _ in range(VERIFY_REPS):
            t = time.perf_counter()
            analysis.verify_prepared(prepared, ds.catalog)
            times.append((time.perf_counter() - t) * 1e3)
        out[name] = {"prepare_ms": round(prepare_ms, 4),
                     "verify_ms": round(float(np.median(times)), 4),
                     "checks": len(report.checks)}
    return out


def phase_analysis(ds, eng, queries, ops, Engine, RuntimeConfig,
                   analysis) -> dict:
    """9a on phase 3's dataset: a fresh engine with ``verify_plans`` on
    prepares every template (every report clean) and serves one instance
    of each but ``BATCH_CUT``, single and as one batch of 3, each
    result equal row for row to phase 3's engine, with the join probe's
    launches counted over the verified engine's calls; the eager
    engine's prepared forms pass the same verifier; and a corrupt plan
    (its executor's last cap slot dropped) must raise
    ``PlanVerificationError`` with nothing launched and nothing
    cached."""
    torch.cuda.reset_peak_memory_stats()
    veng = Engine(ds, runtime=RuntimeConfig(verify_plans=True))
    assert veng.device.type == "cuda" and veng.config.verify_plans
    torch_reports = verify_reports(veng, ds, queries, analysis)
    launches, served = 0, 0
    for name, insts in queries.items():
        if name in BATCH_CUT:
            continue
        for how, qs in (("query", insts[:1]), ("query_batch", insts[:3])):
            before = ops.launches["join_probe"]
            got = veng.query(qs[0]) if how == "query" \
                else veng.query_batch(qs)
            launches += ops.launches["join_probe"] - before
            want = eng.query(qs[0]) if how == "query" \
                else eng.query_batch(qs)
            for a, b in zip(got if how == "query_batch" else [got],
                            want if how == "query_batch" else [want]):
                if a.cols != b.cols or not np.array_equal(a.data, b.data):
                    raise AssertionError(f"{name} ({how}): the verified "
                                         "engine != phase 3's engine")
                served += 1
            del got, want
    if launches <= 0:
        raise AssertionError("no join_probe launch through the verified "
                             "engine")
    no_fallbacks(veng, "verified engine")
    eager = Engine(ds, backend="eager",
                   runtime=RuntimeConfig(verify_plans=True))
    eager_reports = verify_reports(eager, ds, queries, analysis)
    del veng, eager
    # a corrupt plan: the torch backend's executor loses its last slot
    bad = Engine(ds, runtime=RuntimeConfig(verify_plans=True))
    backend = bad._backends["torch"]
    inner = backend._prepared

    def corrupt(template, ctx, cp, spine):
        prepared = inner(template, ctx, cp, spine)
        prepared.executor.caps = prepared.executor.caps[:-1]
        return prepared

    backend._prepared = corrupt
    ops.reset_launches()
    try:
        bad.query(queries["S1"][0])
    except analysis.PlanVerificationError as exc:
        refused = list(exc.rules())
    else:
        raise AssertionError("the corrupt plan was not refused")
    if "cap-slots" not in refused or sum(ops.launches.values()) != 0 or \
            len(bad.cache) != 0:
        raise AssertionError(f"the corrupt plan: rules {refused}, launches "
                             f"{dict(ops.launches)}, cached {len(bad.cache)}")
    del bad
    gc.collect()
    torch.cuda.empty_cache()
    v = [r["verify_ms"] for r in torch_reports.values()]
    pr = [r["prepare_ms"] for r in torch_reports.values()]
    log(f"  verified engine: {len(torch_reports)} templates prepared, every "
        f"report clean ({torch_reports['S1']['checks']} checks); verify "
        f"median {min(v):.4f}-{max(v):.4f} ms a template against prepare "
        f"{min(pr):.1f}-{max(pr):.1f} ms; {served} results equal row for "
        f"row to phase 3's engine; join_probe launches through it "
        f"{launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for name, r in torch_reports.items():
        e = eager_reports[name]
        eager = f"{e['verify_ms']:.4f} ms" if e["checks"] else \
            "skipped: a host operator tree"
        log(f"  {name}: verify {r['verify_ms']:.4f} ms (eager {eager}), "
            f"prepare {r['prepare_ms']:.3f} ms")
    log(f"  corrupt plan (dropped cap slot): refused with {refused}, "
        f"0 launches, nothing cached")
    return {"torch": torch_reports, "eager": eager_reports,
            "served_equal": served, "join_probe_launches": launches,
            "corrupt_refused": refused}


def repair_check(eng, ref_mod, parse_sparql, ds, what: str) -> int:
    """The repair's queries on ``eng``, single and as one batch: each
    result equal as a multiset to the port's oracle
    (``core/reference.py``)."""
    batched = eng.query_batch(REPAIR_QUERIES)
    n = 0
    for q, b in zip(REPAIR_QUERIES, batched):
        want = ref_mod.mappings_to_multiset(ref_mod.execute_reference(
            parse_sparql(q, ds.dictionary), ds.catalog.tt,
            ds.dictionary.values), ["?o", "?s"])
        for got in (eng.query(q), b):
            if dict(got.as_multiset(["?o", "?s"])) != want:
                raise AssertionError(f"{what}: {q} differs from the oracle")
            n += 1
    return n


def run_example(here: str, *argv) -> str:
    """An example twin as a subprocess on the card; it must exit 0."""
    env = dict(os.environ, PYTHONPATH=os.path.join(here, "src"))
    out = subprocess.run([sys.executable, *argv], cwd=here, env=env,
                         capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise AssertionError(f"{argv[0]} exited {out.returncode}:\n"
                             f"{out.stdout[-2000:]}\n{out.stderr[-2000:]}")
    return out.stdout


def phase_analysis_small(ds, queries, ops, Dataset, here: str) -> dict:
    """9b at the compare scale: ``explain()``'s verdict line of every
    template equal on the card engine and the CPU port engine; the
    repair's queries on a small dataset built on the card, on the torch
    backend and on the distributed backend (one NCCL rank), single and
    batched, each equal to the oracle; the example twins as subprocesses
    on the card."""
    import torch.distributed as dist
    from repro_torch.core import reference as ref_mod
    from repro_torch.core.sparql import parse_sparql
    gpu, cpu = ds.engine(), ds.engine(device="cpu")
    verdicts = {}
    for name, insts in queries.items():
        g = gpu.explain(insts[0]).splitlines()[-1]
        c = cpu.explain(insts[0]).splitlines()[-1]
        if g != c or not g.startswith("verify: ok"):
            raise AssertionError(f"{name}: explain verdict {g!r} on the "
                                 f"card, {c!r} on the CPU")
        verdicts[name] = g
    del cpu
    # each part's launches apart: the card build, then each backend
    ops.reset_launches()
    small = Dataset.from_triples(REPAIR_TRIPLES, threshold=1.0)
    if small.device.type != "cuda":
        raise AssertionError("the repair dataset is not on the card")
    launches = {"build": dict(ops.launches)}
    ops.reset_launches()
    n = repair_check(small.engine(), ref_mod, parse_sparql, small, "torch")
    launches["torch"] = dict(ops.launches)
    rdv = os.path.join(here, "build", "smoke_nccl_rendezvous_repair")
    if os.path.exists(rdv):
        os.remove(rdv)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{rdv}", rank=0,
                            world_size=1)
    try:
        ops.reset_launches()
        n += repair_check(small.engine("distributed"), ref_mod,
                          parse_sparql, small, "distributed")
        launches["distributed"] = dict(ops.launches)
    finally:
        dist.destroy_process_group()
    need = {"build": ("semijoin_membership",), "torch": ("join_probe",),
            "distributed": ("join_probe", "bucket_count")}
    if any(launches[part][k] <= 0 for part, ks in need.items() for k in ks):
        raise AssertionError(f"a kernel of the repair's path was not "
                             f"launched (needed: {need}): {launches}")
    log(f"  explain verdicts: {len(verdicts)} templates, card == CPU, "
        f"{sorted(set(v.split(' (')[0] for v in verdicts.values()))}")
    log(f"  repair: {len(REPAIR_QUERIES)} queries, {n} results (torch and "
        f"distributed, single and batched) equal to the oracle; launches "
        f"of the card build {launches['build']}, of the torch backend "
        f"{launches['torch']}, of the distributed backend "
        f"{launches['distributed']}")
    t = time.perf_counter()
    quick = run_example(here, "examples/quickstart_torch.py")
    quick_s = time.perf_counter() - t
    agree = [ln for ln in quick.splitlines() if ln.endswith(": True")]
    if len(agree) != 2:
        raise AssertionError(f"quickstart twin agreement lines: {agree}")
    t = time.perf_counter()
    served = run_example(here, "examples/serve_sparql_torch.py",
                         *SERVE_TWIN_ARGS)
    serve_s = time.perf_counter() - t
    if "served results agree with single queries: True" not in served:
        raise AssertionError(f"serve twin:\n{served[-2000:]}")
    summary = [ln.strip() for ln in served.splitlines()
               if ln.startswith(("served ", "  latency", "  micro"))]
    log(f"  quickstart twin: exit 0 in {quick_s:.1f} s, {agree}")
    log(f"  serve twin {' '.join(SERVE_TWIN_ARGS)}: exit 0 in {serve_s:.1f} "
        f"s; {summary}")
    return {"verdicts_equal": len(verdicts), "repair_results": n,
            "repair_launches": launches, "quickstart_s": round(quick_s, 1),
            "serve_twin_s": round(serve_s, 1), "serve_twin": summary}


# ---------------------------------------------------------------------------
# phase 10: the LM substrate's serving path
# ---------------------------------------------------------------------------

#: the configs phase 10a runs at full width, each with its decode ==
#: forward tolerance (the reference's own: 2e-3 in its qwen test, 5e-3
#: in its hybrid one; the SSD scan takes the hybrid's)
LM_FULL = {"qwen1.5-0.5b": 2e-3, "granite-moe-1b-a400m": 2e-3,
           "mamba2-370m": 5e-3, "whisper-small": 2e-3}
#: the other six, at their reduced (CPU-test) size
LM_REDUCED = {"gemma3-12b": 2e-3, "mistral-nemo-12b": 2e-3,
              "granite-3-2b": 2e-3, "deepseek-moe-16b": 2e-3,
              "jamba-1.5-large-398b": 5e-3, "llava-next-34b": 2e-3}
LM_EXACT_BATCH, LM_EXACT_SEQ = 2, 128       # a multiple of LM_EXACT_SSM_CHUNK
#: decode is held against a forward whose SSD chunk is at most this: at
#: mamba2's published 256 a chunk's cumulative log-decay reaches about
#: -2,900, where a float32 step is 2.4e-4, and the chunked forward
#: itself departs from the exact recurrence by up to 5.35e-3 (PERF.md
#: section 7); the published chunk is held card against CPU and timed
LM_EXACT_SSM_CHUNK = 16
#: card against CPU: prefill at B = 1 over this many tokens (mamba2's
#: sequence must be a whole number of its 256-token chunks)
LM_CPU_SEQ = {"mamba2-370m": 256}
LM_CPU_SEQ_DEFAULT = 64
LM_BATCH, LM_PREFILL_SEQ, LM_DECODE_TOKENS, LM_S_MAX = 4, 1024, 32, 1024
LM_REDUCED_STEPS = 4


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


def lm_inputs(cfg, batch: int, seq: int, gen, device) -> dict:
    """Tokens uniform in the vocabulary (and stub frames or patches where
    the family takes them) from ``gen`` on ``device``."""
    out = {"tokens": torch.randint(0, cfg.vocab, (batch, seq), generator=gen,
                                   device=device, dtype=torch.int32)}
    if cfg.enc_dec:
        out["frames"] = torch.randn((batch, cfg.n_frames, cfg.d_model),
                                    generator=gen, device=device) * 0.5
    if cfg.vlm:
        out["patches"] = torch.randn((batch, cfg.n_patches, cfg.d_model),
                                     generator=gen, device=device) * 0.5
    return out


def lm_caches(m, params) -> dict:
    """Empty caches for ``LM_BATCH`` sequences of ``LM_S_MAX`` positions
    on the card (the encoder-decoder's cross K/V from a zero encoder
    output, as ``Model.init_caches`` makes them)."""
    return m.init_caches(params if m.cfg.enc_dec else None, LM_BATCH,
                         LM_S_MAX, device="cuda")


def lm_greedy(m, params, caches, n: int) -> torch.Tensor:
    """``n`` greedy decode steps at ``LM_BATCH`` from token 0 at position
    0, as the launcher decodes; a flag on the card, true if every logit
    was finite."""
    tok = torch.zeros((LM_BATCH, 1), dtype=torch.int32, device="cuda")
    ok = torch.ones((), dtype=torch.bool, device="cuda")
    for pos in range(n):
        lg, caches = m.decode(params, caches, tok, pos)
        ok &= torch.isfinite(lg.float()).all()
        tok = torch.argmax(lg, dim=-1).to(torch.int32)
    return ok


def lm_close(got: torch.Tensor, want: torch.Tensor, tol: float,
             what: str) -> dict:
    """|got - want| <= tol + tol·|want| everywhere (numpy's allclose);
    returns the largest absolute difference and the largest share of
    that bound used."""
    got, want = got.float(), want.float().to(got.device)
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite values")
    diff = (got - want).abs()
    share = float((diff / (tol + tol * want.abs())).max())
    if share > 1.0:
        raise AssertionError(f"{what}: max abs diff {float(diff.max())} "
                             f"beyond rtol/atol {tol}")
    return {"max_abs_err": float(diff.max()), "share_of_tol": share}


def lm_no_drops(cfg):
    """``cfg`` with an expert capacity no routing can exceed (a token's k
    experts are distinct, so an expert takes at most T of the T·k
    assignments: capacity_factor E/k gives C = T).  With the published
    factor a forward over B·S tokens drops assignments past capacity
    that one-token decode steps keep, so the two differ by design."""
    m = cfg.moe
    if not m.n_experts:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.n_experts / m.top_k))


def lm_decode_vs_forward(cfg, params, tol: float, gen) -> dict:
    """Teacher-forced forward against step-by-step decode over
    ``LM_EXACT_SEQ`` positions (an MoE config at :func:`lm_no_drops`'s
    capacity, the forward's SSD chunk at most ``LM_EXACT_SSM_CHUNK``);
    for the encoder-decoder, ``decode_train`` against ``decode_step``
    over caches of one encoder output."""
    from repro_torch.models import encdec, transformer
    from repro_torch.models.api import Model
    cfg = lm_no_drops(cfg)
    m = Model(cfg)
    dev = torch.device("cuda")
    b, s = LM_EXACT_BATCH, LM_EXACT_SEQ
    inp = lm_inputs(cfg, b, s, gen, dev)
    tokens = inp["tokens"]
    if cfg.enc_dec:
        enc_out = encdec.encode(params, inp["frames"], cfg)
        full = encdec.decode_train(params, tokens, enc_out, cfg)
        caches = encdec.init_caches(params, cfg, b, s, enc_out=enc_out,
                                    device=dev)
    else:
        full = transformer.forward(params, tokens, dataclasses.replace(
            cfg, ssm_chunk=min(cfg.ssm_chunk, LM_EXACT_SSM_CHUNK)))
        caches = m.init_caches(None, b, s, device=dev)
    steps = []
    for t in range(s):
        lg, caches = m.decode(params, caches, tokens[:, t:t + 1], t)
        steps.append(lg)
    return lm_close(torch.cat(steps, 1), full, tol,
                    f"{cfg.name}: decode against forward")


def lm_card_vs_cpu(m, cfg, params, tol: float, gen) -> dict:
    """``prefill`` at B = 1 on the card and on the CPU, from the same
    parameters and inputs."""
    s = LM_CPU_SEQ.get(cfg.name, LM_CPU_SEQ_DEFAULT)
    inp = lm_inputs(cfg, 1, s, gen, torch.device("cuda"))
    card = m.prefill(params, inp)
    t = time.perf_counter()
    cpu_params = tree_map(lambda x: x.cpu(), params)
    cpu = m.prefill(cpu_params, tree_map(lambda x: x.cpu(), inp))
    cpu_s = time.perf_counter() - t
    del cpu_params
    return dict(lm_close(card, cpu, tol,
                         f"{cfg.name}: prefill, card against CPU"),
                seq=s, cpu_s=round(cpu_s, 2))


def lm_timed(m, cfg, params, gen) -> dict:
    """The published dtype: prefill at (``LM_BATCH``, ``LM_PREFILL_SEQ``)
    and ``LM_DECODE_TOKENS`` steps of :func:`lm_greedy` from empty
    caches, on CUDA events; every logit finite; the peak device
    memory."""
    from repro_torch.launch.mesh import HW
    from repro_torch.models.api import model_flops
    from repro_torch.models.config import ShapeCell
    dev = torch.device("cuda")
    b = LM_BATCH
    inp = lm_inputs(cfg, b, LM_PREFILL_SEQ, gen, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    finite = torch.ones((), dtype=torch.bool, device=dev)
    m.prefill(params, inp)                                   # warm
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    reps = 3
    start.record()
    for _ in range(reps):
        logits = m.prefill(params, inp)
        finite &= torch.isfinite(logits.float()).all()
    end.record()
    torch.cuda.synchronize()
    prefill_ms = start.elapsed_time(end) / reps
    lm_greedy(m, params, lm_caches(m, params), 4)            # warm
    caches = lm_caches(m, params)
    torch.cuda.synchronize()
    t = time.perf_counter()
    start.record()
    finite &= lm_greedy(m, params, caches, LM_DECODE_TOKENS)
    end.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t
    decode_ms = start.elapsed_time(end)
    if not bool(finite):
        raise AssertionError(f"{cfg.name}: non-finite logits at "
                             f"{cfg.dtype}")
    param_bytes = sum(x.numel() * x.element_size()
                      for x in tree_leaves(params))
    flops = model_flops(cfg, ShapeCell("prefill", LM_PREFILL_SEQ, b,
                                       "prefill"))
    return {
        "prefill_ms": round(prefill_ms, 4),
        "prefill_bound_ms": round(flops / HW.PEAK_FLOPS_BF16 * 1e3, 4),
        "decode_ms_per_token": round(decode_ms / LM_DECODE_TOKENS, 4),
        "decode_tok_per_s": round(LM_DECODE_TOKENS * b / decode_ms * 1e3, 1),
        "decode_host_s": round(host_s, 4),
        # one read of the fp32 params a token (the dtype policy casts
        # each weight where it is used), and of a bf16 copy
        "decode_bound_ms_fp32_weights": round(
            param_bytes / HBM_BYTES_PER_S * 1e3, 4),
        "decode_bound_ms_bf16_weights": round(
            param_bytes / 2 / HBM_BYTES_PER_S * 1e3, 4),
        "peak_gib": round(torch.cuda.max_memory_allocated() / 2**30, 3),
        "param_bytes": param_bytes}


def lm_free() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def lm_full_width(name: str, tol: float, seed: int) -> dict:
    """10a for one config: float32 params from the port's ``init`` on the
    card, decode against forward and card against CPU; then the same
    seed's params at the published dtype, timed."""
    from repro_torch.configs import get
    from repro_torch.models.api import Model, total_params
    cfg = get(name)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    out = {"tol": tol, "params": total_params(cfg)}
    t0 = time.perf_counter()
    params = Model(cfg32).init(seed, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    with torch.inference_mode():
        out["decode_vs_forward"] = lm_decode_vs_forward(cfg32, params, tol,
                                                        gen)
        out["card_vs_cpu"] = lm_card_vs_cpu(Model(cfg32), cfg32, params, tol,
                                            gen)
    del params
    lm_free()
    out["exact_s"] = round(time.perf_counter() - t0, 1)
    t0 = time.perf_counter()
    m = Model(cfg)
    params = m.init(seed, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    with torch.inference_mode():
        out.update(lm_timed(m, cfg, params, gen))
    del params
    lm_free()
    out["timed_s"] = round(time.perf_counter() - t0, 1)
    dvf, cvc = out["decode_vs_forward"], out["card_vs_cpu"]
    log(f"  {name} ({out['params'] / 1e6:.1f} M params, "
        f"{out['param_bytes'] / 1e9:.2f} GB): decode == forward over "
        f"{LM_EXACT_SEQ} positions (max abs err {dvf['max_abs_err']:.2e}, "
        f"{dvf['share_of_tol']:.2f} of rtol/atol {tol}); card == CPU "
        f"prefill at S {cvc['seq']} (max abs err {cvc['max_abs_err']:.2e}, "
        f"{cvc['share_of_tol']:.2f} of it; CPU {cvc['cpu_s']} s); float32 "
        f"half {out['exact_s']} s; {cfg.dtype}: prefill "
        f"{LM_BATCH}×{LM_PREFILL_SEQ} {out['prefill_ms']} ms (bound "
        f"{out['prefill_bound_ms']}), decode {out['decode_ms_per_token']} "
        f"ms a token = {out['decode_tok_per_s']} tok/s (bounds "
        f"{out['decode_bound_ms_bf16_weights']} / "
        f"{out['decode_bound_ms_fp32_weights']} ms), peak "
        f"{out['peak_gib']} GiB; {out['timed_s']} s")
    return out


def lm_reduced(name: str, tol: float, seed: int) -> float:
    """10b for one config at reduced size, float32: prefill and
    ``LM_REDUCED_STEPS`` decode steps on the card equal to the CPU's."""
    from repro_torch.configs import get_reduced
    from repro_torch.models.api import Model
    cfg = get_reduced(name, dtype="float32")
    m = Model(cfg)
    cpu_p = m.init(seed, device="cpu")
    card_p = tree_map(lambda x: x.cuda(), cpu_p)
    gen = torch.Generator(device="cpu").manual_seed(seed + 1)
    inp = lm_inputs(cfg, 2, 16, gen, torch.device("cpu"))
    err = lm_close(m.prefill(card_p, tree_map(lambda x: x.cuda(), inp)),
                   m.prefill(cpu_p, inp), tol,
                   f"{name}: reduced prefill")["max_abs_err"]
    caches = {d: m.init_caches(p if cfg.enc_dec else None, 2, 16, device=d)
              for d, p in (("cuda", card_p), ("cpu", cpu_p))}
    tok = inp["tokens"][:, :1]
    for pos in range(LM_REDUCED_STEPS):
        card, caches["cuda"] = m.decode(card_p, caches["cuda"], tok.cuda(),
                                        pos)
        cpu, caches["cpu"] = m.decode(cpu_p, caches["cpu"], tok, pos)
        err = max(err, lm_close(card, cpu, tol, f"{name}: reduced decode "
                                f"step {pos}")["max_abs_err"])
        tok = torch.argmax(cpu, dim=-1).to(torch.int32)
    return err


def phase_lm(here: str, ops, seed: int) -> dict:
    """Phase 10: the LM serving path, with the kernels' launch counts
    reset before and read after (the path launches none of them)."""
    t0 = time.perf_counter()
    ops.reset_launches()
    out = {"full_width": {}, "reduced": {}}
    for name, tol in LM_FULL.items():
        out["full_width"][name] = lm_full_width(name, tol, seed)
    with torch.inference_mode():
        for name, tol in LM_REDUCED.items():
            out["reduced"][name] = lm_reduced(name, tol, seed)
    log(f"  reduced, card == CPU (prefill and {LM_REDUCED_STEPS} decode "
        f"steps, float32), max abs err: {out['reduced']}")
    t = time.perf_counter()
    served = run_example(here, "-m", "repro_torch.launch.serve",
                         "--mode", "lm", "--arch", "qwen1.5-0.5b")
    line = [ln for ln in served.splitlines() if ln.endswith(" tok/s")]
    if len(line) != 1 or "decoded 32 tokens × batch 4" not in line[0]:
        raise AssertionError(f"launcher --mode lm:\n{served[-2000:]}")
    out["launcher"] = {"line": line[0],
                       "s": round(time.perf_counter() - t, 1)}
    log(f"  launcher --mode lm: exit 0 in {out['launcher']['s']} s: "
        f"{line[0]}")
    out["launches"] = dict(ops.launches)
    out["seconds"] = round(time.perf_counter() - t0, 1)
    log(f"  kernel launches over phase 10: {out['launches']}; "
        f"{out['seconds']} s")
    return out


# ---------------------------------------------------------------------------
# phase 11: the LM substrate's training path
# ---------------------------------------------------------------------------

#: card against CPU, float32 with TF32 off: ‖g_card − g_cpu‖ / ‖g_cpu‖
#: over every leaf of the gradient tree at most this
TRAIN_GRAD_RATIO = 1e-4
#: ... unless the model's float32 gradient is itself too ill-conditioned
#: for that bound: where the ratio exceeds it, the CPU's gradient is
#: taken again from params each multiplied by (1 + TRAIN_PERTURB · a
#: normal draw), a float32 rounding's size, and the card is held to
#: TRAIN_COND_FACTOR times the CPU's own movement.  mamba2 at full width
#: moves by 6.58e-3 at SSD chunk 256 (6.70e-4 at chunk 16), where the
#: card departs from the CPU by 4.88e-3 (6.92e-4): PERF.md section 6,
#: ``tools/grad_conditioning.py``
TRAIN_PERTURB = 1e-7
TRAIN_COND_FACTOR = 4.0
#: accumulation: one step with ``accum_steps=2`` against one with 1 on
#: the same global batch, float32, no clipping: params within the
#: reference's own rtol / atol for this check
#: (``tests/test_train_runtime.py``), the loss within ``TRAIN_LOSS_RTOL``
TRAIN_ACCUM_RTOL, TRAIN_ACCUM_ATOL = 2e-2, 2e-4
TRAIN_LOSS_RTOL = 1e-5
#: resume: losses within ``TRAIN_LOSS_RTOL`` and params and moments
#: within this of the uninterrupted run (bit-equality is printed)
TRAIN_RESUME_ATOL = 1e-5
#: accumulation, the falling loss and resume (mamba2: 256, one chunk)
TRAIN_BATCH, TRAIN_SEQ = 4, 128
TRAIN_FALL_STEPS = 20
TRAIN_WARM, TRAIN_TIMED = 2, 5
TRAIN_RESUME_AT, TRAIN_RESUME_MORE = 3, 2
TRAIN_RESUME_ARCH = "qwen1.5-0.5b"
#: phase 11's cuts, printed as ``reduced``
TRAIN_CUTS = [
    "11a's falling-loss check trains with remat off: the selective "
    "checkpoint's per-operator dispatch cost about 36 s of phase 11 "
    "there (PERF.md section 6, PR 23 run 8); the timed step, the resume "
    "and 11c's launcher train with it on"]
TRAIN_REDUCED_BATCH, TRAIN_REDUCED_SEQ = 2, 16


class no_tf32:
    """float32 products in float32 on the card (no TF32) while open."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved


def train_batch(cfg, batch: int, seq: int, seed: int, step: int = 0,
                vocab=None, device="cuda") -> dict:
    """The data pipeline's batch (``repro_torch.train.data``) of
    ``batch`` rows of ``seq`` text tokens (rounded up to a whole number
    of SSD chunks where the config has mamba blocks; plus the family's
    frames or patches), on ``device``."""
    from repro_torch.models.config import ShapeCell
    from repro_torch.train.data import DataConfig, as_tensors, make_batch
    specs = cfg.group_pattern + ((cfg.first_layer_override,)
                                 if cfg.first_layer_override else ())
    if any(mixer == "mamba" for mixer, _ in specs):
        seq = -(-seq // cfg.ssm_chunk) * cfg.ssm_chunk
    total = seq + (cfg.n_patches if cfg.vlm else 0)
    dc = DataConfig(seed=seed, vocab=vocab or cfg.vocab)
    return as_tensors(make_batch(dc, cfg, ShapeCell("t", total, batch,
                                                     "train"), step), device)


def norm_ratio(got, want) -> float:
    """‖got − want‖ / ‖want‖ over every leaf (host tensors, float64
    sums)."""
    num = den = 0.0
    for a, b in zip(got, want):
        num += float(torch.linalg.vector_norm(a - b, dtype=torch.float64)) ** 2
        den += float(torch.linalg.vector_norm(b, dtype=torch.float64)) ** 2
    return (num / den) ** 0.5


def grad_ratio(m, params, batch) -> dict:
    """One ``loss_and_grads`` on the card and on the CPU from the same
    params and batch (float32, TF32 off): the loss difference and
    ‖g_card − g_cpu‖ / ‖g_cpu‖ over every leaf, at most
    ``TRAIN_GRAD_RATIO`` or, past it, ``TRAIN_COND_FACTOR`` times the
    CPU's own movement under a ``TRAIN_PERTURB`` perturbation of the
    params; every gradient finite."""
    from repro_torch.train.train_state import loss_and_grads
    from repro_torch.train.tree import leaves
    with no_tf32():
        loss, grads = loss_and_grads(m, params, batch)
    card = [g.cpu() for g in leaves(grads)]
    del grads
    if not all(bool(torch.isfinite(g).all()) for g in card):
        raise AssertionError(f"{m.cfg.name}: non-finite gradient")
    cpu_params = tree_map(lambda x: x.cpu(), params)
    cpu_batch = tree_map(lambda x: x.cpu(), batch)
    t = time.perf_counter()
    cpu_loss, cpu = loss_and_grads(m, cpu_params, cpu_batch)
    cpu_s = time.perf_counter() - t
    cpu = leaves(cpu)
    ratio = norm_ratio(card, cpu)
    out = {"ratio": ratio, "loss_diff": abs(float(loss) - float(cpu_loss)),
           "cpu_s": round(cpu_s, 2)}
    if ratio <= TRAIN_GRAD_RATIO:
        return out
    gen = torch.Generator().manual_seed(5)
    perturbed = tree_map(lambda x: x * (1 + TRAIN_PERTURB * torch.randn(
        x.shape, generator=gen)), cpu_params)
    _, moved = loss_and_grads(m, perturbed, cpu_batch)
    out["cpu_perturbed_ratio"] = norm_ratio(leaves(moved), cpu)
    if not ratio <= TRAIN_COND_FACTOR * out["cpu_perturbed_ratio"]:
        raise AssertionError(
            f"{m.cfg.name}: card against CPU gradient ratio {ratio:.3e} > "
            f"{TRAIN_GRAD_RATIO} and > {TRAIN_COND_FACTOR} × the CPU's own "
            f"{out['cpu_perturbed_ratio']:.3e} under a {TRAIN_PERTURB} "
            f"perturbation of the params")
    return out


def accum_parity(cfg32, params, seed: int) -> dict:
    """One float32 step with ``accum_steps=2`` against one with 1 on the
    same global batch of ``TRAIN_BATCH`` × ``TRAIN_SEQ`` (no clipping;
    an MoE config at :func:`lm_no_drops`'s capacity, since a microbatch
    of half the tokens has half the capacity); ``params`` is consumed."""
    from repro_torch.models.api import Model
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_state import make_train_step
    from repro_torch.train.tree import leaves
    m = Model(lm_no_drops(cfg32))
    opt = OptConfig(lr=1e-3, clip_norm=1e9)
    batch = train_batch(cfg32, TRAIN_BATCH, TRAIN_SEQ, seed + 3)
    one = tree_map(torch.clone, params)
    with no_tf32():
        _, _, m1 = make_train_step(m, opt, accum_steps=1)(
            one, init_opt_state(one), batch)
        _, _, m2 = make_train_step(m, opt, accum_steps=2)(
            params, init_opt_state(params), batch)
    share = 0.0
    for a, b in zip(leaves(params), leaves(one)):
        diff = (a - b).abs()
        share = max(share, float((diff / (TRAIN_ACCUM_ATOL + TRAIN_ACCUM_RTOL
                                          * b.abs())).max()))
    loss_rel = abs(float(m2["loss"]) - float(m1["loss"])) / \
        abs(float(m1["loss"]))
    if share > 1.0 or loss_rel > TRAIN_LOSS_RTOL:
        raise AssertionError(f"{cfg32.name}: accum_steps=2 against 1: "
                             f"{share:.3f} of the params' tolerance, loss "
                             f"{loss_rel:.2e} relative")
    return {"share_of_tol": share, "loss_rel": loss_rel}


def loss_falls(m, params, seed: int):
    """``TRAIN_FALL_STEPS`` steps at ``OptConfig(lr=1e-3,
    warmup_steps=2)`` on ``DataConfig(seed=1, vocab=64)`` at the
    published dtype: every loss finite, the mean of the last 5 below the
    mean of the first 5.  Returns the losses and the optimizer state."""
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_state import make_train_step
    step = make_train_step(m, OptConfig(lr=1e-3, warmup_steps=2))
    state = init_opt_state(params)
    losses = []
    for i in range(TRAIN_FALL_STEPS):
        batch = train_batch(m.cfg, TRAIN_BATCH, TRAIN_SEQ, 1, step=i,
                            vocab=64)
        params, state, metrics = step(params, state, batch)
        losses.append(metrics["loss"])
    losses = torch.stack(losses).float().cpu().tolist()
    if not all(np.isfinite(losses)) or \
            not np.mean(losses[-5:]) < np.mean(losses[:5]):
        raise AssertionError(f"{m.cfg.name}: the loss did not fall: "
                             f"{losses}")
    return losses, state


def timed_steps(m, params, state, seed: int) -> dict:
    """``TRAIN_WARM`` then ``TRAIN_TIMED`` steps at (``LM_BATCH``,
    ``LM_PREFILL_SEQ``) on CUDA events, split into forward + backward
    (``loss_and_grads``) and the optimizer (``adamw_update``): the
    medians, tokens/s and the peak device memory (params and optimizer
    state included)."""
    from repro_torch.train.optimizer import OptConfig, adamw_update
    from repro_torch.train.train_state import loss_and_grads
    opt = OptConfig(lr=1e-3, warmup_steps=2)
    batch = train_batch(m.cfg, LM_BATCH, LM_PREFILL_SEQ, seed + 4)
    lm_free()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    marks = []
    for _ in range(TRAIN_WARM + TRAIN_TIMED):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        loss, grads = loss_and_grads(m, params, batch)
        ev[1].record()
        params, state, _ = adamw_update(opt, grads, state, params)
        ev[2].record()
        del grads
        marks.append(ev)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(loss)):
        raise AssertionError(f"{m.cfg.name}: non-finite loss in the timed "
                             f"steps")
    fb = [e[0].elapsed_time(e[1]) for e in marks[TRAIN_WARM:]]
    up = [e[1].elapsed_time(e[2]) for e in marks[TRAIN_WARM:]]
    step = [e[0].elapsed_time(e[2]) for e in marks[TRAIN_WARM:]]
    step_ms = float(np.median(step))
    return {"step_ms": step_ms, "fwd_bwd_ms": float(np.median(fb)),
            "opt_ms": float(np.median(up)),
            "tok_per_s": LM_BATCH * LM_PREFILL_SEQ / step_ms * 1e3,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def resume_parity(cfg, seed: int, here: str) -> dict:
    """``TRAIN_RESUME_AT`` steps, ``checkpoint.save(...,
    async_write=True)``, a restore into a fresh state and
    ``TRAIN_RESUME_MORE`` more steps, against the uninterrupted run,
    under ``torch.use_deterministic_algorithms(True, warn_only=True)``."""
    from repro_torch.models.api import Model
    from repro_torch.train import checkpoint
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_state import make_train_step
    from repro_torch.train.tree import flatten_with_paths
    ckpt = os.path.join(here, "build", "smoke_resume_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    m = Model(cfg)
    step_fn = make_train_step(m, OptConfig(lr=1e-3, warmup_steps=2))
    det = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        p = m.init(seed, device="cuda")
        o = init_opt_state(p)
        losses = []
        for i in range(TRAIN_RESUME_AT + TRAIN_RESUME_MORE):
            p, o, mt = step_fn(p, o, train_batch(cfg, TRAIN_BATCH, TRAIN_SEQ,
                                                 seed + 5, step=i))
            losses.append(mt["loss"])
            if i == TRAIN_RESUME_AT - 1:
                t = time.perf_counter()
                future = checkpoint.save(ckpt, TRAIN_RESUME_AT,
                                         {"params": p, "opt": o},
                                         async_write=True)
                save_return_s = time.perf_counter() - t
        written = future.result()
        write_s = time.perf_counter() - t
        fresh = m.init(seed + 7, device="cuda")
        t = time.perf_counter()
        r = checkpoint.restore(ckpt, checkpoint.latest_step(ckpt),
                               {"params": fresh,
                                "opt": init_opt_state(fresh)})
        restore_s = time.perf_counter() - t
        del fresh
        p2, o2 = r["params"], r["opt"]
        for i in range(TRAIN_RESUME_AT, TRAIN_RESUME_AT + TRAIN_RESUME_MORE):
            p2, o2, mt = step_fn(p2, o2, train_batch(
                cfg, TRAIN_BATCH, TRAIN_SEQ, seed + 5, step=i))
            rel = abs(float(mt["loss"]) - float(losses[i])) / \
                abs(float(losses[i]))
            if rel > TRAIN_LOSS_RTOL:
                raise AssertionError(f"resume: loss at step {i} differs by "
                                     f"{rel:.2e} relative")
        bitwise, err = True, 0.0
        want = dict(flatten_with_paths({"params": p, "opt": o}))
        for k, v in flatten_with_paths({"params": p2, "opt": o2}):
            bitwise &= torch.equal(v, want[k])
            err = max(err, float((v.float() - want[k].float()).abs().max()))
        if err > TRAIN_RESUME_ATOL:
            raise AssertionError(f"resume: params or moments differ by {err}")
    finally:
        torch.use_deterministic_algorithms(det)
        shutil.rmtree(ckpt, ignore_errors=True)
    return {"bitwise": bool(bitwise), "max_abs_err": err,
            "save_return_s": round(save_return_s, 3),
            "write_s": round(write_s, 2), "restore_s": round(restore_s, 2),
            "written": os.path.basename(written)}


def train_exact(name: str, seed: int) -> dict:
    """11a's float32 half for one config at its published widths and
    depth: card against CPU gradients, then accumulation parity."""
    from repro_torch.configs import get
    from repro_torch.models.api import Model, total_params
    cfg32 = dataclasses.replace(get(name), dtype="float32")
    out = {"params": total_params(cfg32)}
    t0 = time.perf_counter()
    params = Model(cfg32).init(seed, device="cuda")
    s = LM_CPU_SEQ.get(name, LM_CPU_SEQ_DEFAULT)
    out["card_vs_cpu"] = dict(grad_ratio(
        Model(cfg32), params, train_batch(cfg32, 1, s, seed + 2)), seq=s)
    lm_free()
    out["accum"] = accum_parity(cfg32, params, seed)
    del params
    lm_free()
    out["exact_s"] = round(time.perf_counter() - t0, 1)
    cvc, acc = out["card_vs_cpu"], out["accum"]
    held = f"<= {TRAIN_GRAD_RATIO}" if "cpu_perturbed_ratio" not in cvc \
        else (f"<= {TRAIN_COND_FACTOR} × the CPU's own "
              f"{cvc['cpu_perturbed_ratio']:.3e} under a {TRAIN_PERTURB} "
              f"perturbation of the params")
    log(f"  {name} ({out['params'] / 1e6:.1f} M params), float32: card == "
        f"CPU gradients at B 1 × S {cvc['seq']} (ratio {cvc['ratio']:.3e} "
        f"{held}, loss diff {cvc['loss_diff']:.2e}; CPU {cvc['cpu_s']} s); "
        f"accum 2 == 1 ({acc['share_of_tol']:.3f} of rtol "
        f"{TRAIN_ACCUM_RTOL} / atol {TRAIN_ACCUM_ATOL}, loss "
        f"{acc['loss_rel']:.2e}); {out['exact_s']} s")
    return out


def train_published(name: str, seed: int, here: str) -> dict:
    """11a's half at the published dtype for one config: the falling
    loss, the timed step with remat on and off, and (qwen) resume."""
    from repro_torch.configs import get
    from repro_torch.launch.mesh import HW
    from repro_torch.models.api import Model, model_flops
    from repro_torch.models.config import ShapeCell
    cfg = get(name)
    out = {"remat": cfg.remat}
    t0 = time.perf_counter()
    params = Model(cfg).init(seed, device="cuda")
    out["losses"], state = loss_falls(
        Model(dataclasses.replace(cfg, remat=False)), params, seed)
    out["timed"] = {}
    for remat in (True, False):
        mr = Model(dataclasses.replace(cfg, remat=remat))
        out["timed"]["remat_on" if remat else "remat_off"] = timed_steps(
            mr, params, state, seed)
    del params, state
    lm_free()
    bound = model_flops(cfg, ShapeCell("train", LM_PREFILL_SEQ, LM_BATCH,
                                       "train")) / HW.PEAK_FLOPS_BF16 * 1e3
    out["bound_ms"] = bound
    for v in out["timed"].values():
        v["share_of_bound"] = bound / v["step_ms"]
    on, off = out["timed"]["remat_on"], out["timed"]["remat_off"]
    if not on["peak_gib"] < off["peak_gib"]:
        raise AssertionError(f"{name}: peak with remat on {on['peak_gib']} "
                             f"GiB not below off {off['peak_gib']} GiB")
    if name == TRAIN_RESUME_ARCH:
        out["resume"] = resume_parity(cfg, seed, here)
    out["train_s"] = round(time.perf_counter() - t0, 1)
    log(f"  {name}, {cfg.dtype}: loss {out['losses'][0]:.3f} -> "
        f"{out['losses'][-1]:.3f} over {TRAIN_FALL_STEPS} steps (remat "
        f"off)")
    for k, v in out["timed"].items():
        log(f"    step at {LM_BATCH} × {LM_PREFILL_SEQ}, {k}: "
            f"{v['step_ms']:.4f} ms (forward + backward "
            f"{v['fwd_bwd_ms']:.4f}, optimizer {v['opt_ms']:.4f}), "
            f"{v['tok_per_s']:.1f} tok/s, bound {bound:.4f} ms "
            f"({v['share_of_bound']:.4f} of it), peak "
            f"{v['peak_gib']:.3f} GiB")
    if "resume" in out:
        r = out["resume"]
        log(f"    resume: saved at step {TRAIN_RESUME_AT} (save returned "
            f"in {r['save_return_s']} s, its files in place {r['write_s']} "
            f"s after the call, the next steps running meanwhile), "
            f"restored in {r['restore_s']} s, {TRAIN_RESUME_MORE} more "
            f"steps equal to the uninterrupted run (bitwise "
            f"{r['bitwise']}, max abs err {r['max_abs_err']:.2e})")
    log(f"    {out['train_s']} s")
    return out


def train_reduced(name: str, seed: int) -> dict:
    """11b for one config at reduced size: float32 gradients on the card
    against the CPU's."""
    from repro_torch.configs import get_reduced
    from repro_torch.models.api import Model
    cfg = get_reduced(name, dtype="float32")
    params = Model(cfg).init(seed, device="cuda")
    return grad_ratio(Model(cfg), params,
                      train_batch(cfg, TRAIN_REDUCED_BATCH,
                                  TRAIN_REDUCED_SEQ, seed + 2))


class Subprocesses:
    """Commands run one after another in a thread, each as a
    subprocess of the script (``PYTHONPATH`` at the checkout's ``src``);
    :meth:`results` waits for them, :meth:`stop` kills the one
    running."""

    def __init__(self, here: str, commands):
        import threading
        self.here, self.commands = here, commands
        self.outputs, self.seconds, self.error = [], [], None
        self.proc, self.stopped = None, False
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self) -> None:
        env = dict(os.environ, PYTHONPATH=os.path.join(self.here, "src"))
        try:
            for argv in self.commands:
                if self.stopped:
                    return
                t = time.perf_counter()
                self.proc = subprocess.Popen(
                    [sys.executable, *argv], cwd=self.here, env=env,
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                stdout, stderr = self.proc.communicate(timeout=600)
                if self.proc.returncode != 0:
                    raise AssertionError(
                        f"{argv[:2]} exited {self.proc.returncode}:\n"
                        f"{stdout[-2000:]}\n{stderr[-2000:]}")
                self.outputs.append(stdout)
                self.seconds.append(round(time.perf_counter() - t, 1))
        except Exception as e:          # reported by results()
            self.error = e

    def stop(self) -> None:
        self.stopped = True
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()

    def results(self, timeout: float):
        self.thread.join(timeout)
        if self.thread.is_alive():
            self.stop()
            raise AssertionError("phase 11c's subprocesses did not finish")
        if self.error is not None:
            raise self.error
        return self.outputs, self.seconds


def phase_train(here: str, ops, seed: int) -> dict:
    """Phase 11: the LM training path, with the kernels' launch counts
    reset before and read after (the path launches none of them).  11c's
    subprocesses run while the float32 checks of 11a and 11b do; the
    timed half of 11a runs after they end, alone on the card."""
    t0 = time.perf_counter()
    ops.reset_launches()
    out = {"full_width": {}, "reduced": {}, "cuts": TRAIN_CUTS}
    for line in TRAIN_CUTS:
        log(f"  reduced: {line}")
    ckpt = os.path.join(here, "build", "smoke_ckpt")
    ckpt_ex = os.path.join(here, "build", "smoke_ckpt_ex")
    for d in (ckpt, ckpt_ex):
        shutil.rmtree(d, ignore_errors=True)
    launcher = ("-m", "repro_torch.launch.train", "--arch", "qwen1.5-0.5b",
                "--ckpt-dir", ckpt, "--ckpt-every", "10")
    background = Subprocesses(here, [
        launcher + ("--steps", "20"), launcher + ("--steps", "25"),
        (os.path.join("examples", "train_lm_torch.py"), "--steps", "20",
         "--ckpt-dir", ckpt_ex)])
    try:
        for name in LM_FULL:
            out["full_width"][name] = train_exact(name, seed)
        for name in LM_REDUCED:
            out["reduced"][name] = train_reduced(name, seed)
        ratios = {k: float(f"{v['ratio']:.3e}")
                  for k, v in out["reduced"].items()}
        log(f"  reduced, card == CPU gradients (float32), ratio: {ratios}")
        t = time.perf_counter()
        (first, second, example), seconds = background.results(600)
        out["waited_for_11c_s"] = round(time.perf_counter() - t, 1)
    finally:
        background.stop()
        for d in (ckpt, ckpt_ex):
            shutil.rmtree(d, ignore_errors=True)
    resumed = "[elastic] resumed from step 10 onto 1 devices"
    if not first.rstrip().endswith("training complete") or \
            resumed in first or resumed not in second or \
            not second.rstrip().endswith("training complete"):
        raise AssertionError(f"launcher:\n{first[-2000:]}\n{second[-2000:]}")
    if not example.rstrip().endswith("done."):
        raise AssertionError(f"train_lm_torch.py:\n{example[-2000:]}")
    out["launcher"] = {"first": first.strip().splitlines(),
                       "second": second.strip().splitlines(),
                       "s": seconds[:2]}
    out["example"] = {"lines": example.strip().splitlines(),
                      "s": seconds[2]}
    log(f"  launcher (while the float32 checks ran): 20 steps then 25 "
        f"resumed from step 10, exit 0 in {seconds[0]} + {seconds[1]} s: "
        f"{first.strip().splitlines()[-2]} / "
        f"{second.strip().splitlines()[-2]}")
    log(f"  examples/train_lm_torch.py: exit 0 in {seconds[2]} s: "
        f"{example.strip().splitlines()[-2]}; waited "
        f"{out['waited_for_11c_s']} s for 11c")
    for name in LM_FULL:
        out["full_width"][name].update(train_published(name, seed, here))
    out["launches"] = dict(ops.launches)
    if any(out["launches"].values()):
        raise AssertionError(f"a kernel was launched on the training path: "
                             f"{out['launches']}")
    out["seconds"] = round(time.perf_counter() - t0, 1)
    log(f"  kernel launches over phase 11: {out['launches']}; "
        f"{out['seconds']} s")
    return out


# ---------------------------------------------------------------------------
# phase 12: the dry run against the card
# ---------------------------------------------------------------------------

#: the LM configs whose dry-run records are held against the card
DRYRUN_LM = ("qwen1.5-0.5b", "granite-moe-1b-a400m")
#: the dry run's S2RDF cell: the JAX package's WatDiv scale
DRYRUN_S2RDF_SCALE = 2.0
DRYRUN_LAYOUTS = ("extvp", "vp")


def dryrun_s2rdf(ops, here: str) -> dict:
    """12a: the S2RDF cell at one NCCL rank, launches counted over the
    cell (build, records, full runs), then each full run's answer held
    against the single-device engine's."""
    import torch.distributed as dist
    from repro_torch import Dataset
    from repro_torch.launch import dryrun as D
    rdv = os.path.join(here, "build", "smoke_nccl_rendezvous_12")
    os.makedirs(os.path.dirname(rdv), exist_ok=True)
    if os.path.exists(rdv):
        os.remove(rdv)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{rdv}", rank=0,
                            world_size=1)
    out = {"scale": DRYRUN_S2RDF_SCALE, "ranks": 1, "query": D.S2RDF_QUERY}
    try:
        ops.reset_launches()
        t = time.perf_counter()
        ds = Dataset.watdiv(scale=DRYRUN_S2RDF_SCALE, seed=0)
        out["build_s"] = round(time.perf_counter() - t, 3)
        answers = {}
        for layout in DRYRUN_LAYOUTS:
            prepared, _ = D.build_s2rdf_cell("auto", layout=layout,
                                             dataset=ds)
            rec = D.s2rdf_record(prepared)
            answers[layout] = prepared.run()
            out[layout] = {k: rec[k] for k in (
                "caps", "overflowed", "collectives",
                "collective_bytes_per_chip", "collective_bytes_weighted",
                "collective_s", "traced_bytes_total", "aten_ops",
                "memory_s", "dominant", "step_seconds_bound",
                "argument_bytes", "output_bytes", "temp_bytes")}
            out[layout]["rows"] = len(answers[layout])
        out["launches"] = dict(ops.launches)
    finally:
        dist.destroy_process_group()
    if min(out["launches"].values()) <= 0:
        raise AssertionError(f"a kernel was not launched on the dry run's "
                             f"S2RDF cell: {out['launches']}")
    for layout in DRYRUN_LAYOUTS:
        want = ds.engine(layout=layout).query(D.S2RDF_QUERY)
        if not same_multiset(answers[layout], want):
            raise AssertionError(f"the S2RDF cell ({layout}) at one rank "
                                 f"differs from the single-device engine")
    out["vp_over_extvp"] = out["vp"]["collective_bytes_per_chip"] / \
        out["extvp"]["collective_bytes_per_chip"]
    return out


def _tree_bytes(*trees) -> int:
    from repro_torch.train.tree import leaves
    return sum(t.numel() * t.element_size() for tree in trees
               for t in leaves(tree))


def dryrun_lm(name: str, seed: int, prefill_ms: float,
              step_ms: float) -> dict:
    """12b for one config at full width: the dry run's records at a
    one-card mesh against the same steps on the card."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get
    from repro_torch.launch import dryrun as D
    from repro_torch.models.api import Model
    from repro_torch.models.config import ShapeCell
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_state import make_train_step
    mesh = {"card": ((1,), ("data",))}
    cfg = get(name)
    cfg_off = dataclasses.replace(cfg, remat=False)
    out = {}
    params = Model(cfg).init(seed, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    cells = (("prefill", cfg, LM_PREFILL_SEQ, prefill_ms),
             ("train", cfg_off, LM_PREFILL_SEQ, step_ms))
    for kind, c, seq, ms in cells:
        cell = ShapeCell(f"{kind}_smoke", seq, LM_BATCH, kind)
        rec = D.lm_records(c, cell, mesh)["card"]
        torch.cuda.synchronize()
        if kind == "prefill":
            batch = lm_inputs(c, LM_BATCH, seq, gen, torch.device("cuda"))
            card_bytes = _tree_bytes(params, batch)
            with torch.no_grad(), FlopCounterMode(display=False) as fc:
                Model(c).prefill(params, batch)
        else:
            state = init_opt_state(params)
            batch = train_batch(c, LM_BATCH, seq, seed + 4)
            card_bytes = _tree_bytes(params, state, batch)
            step = make_train_step(Model(c), OptConfig())
            with FlopCounterMode(display=False) as fc:
                step(params, state, batch)
            del state
        torch.cuda.synchronize()
        want = Model(c).input_specs(cell)
        if {k: (tuple(v.shape), v.dtype) for k, v in want.items()} != \
                {k: (tuple(v.shape), v.dtype) for k, v in batch.items()}:
            raise AssertionError(f"{name} {kind}: the card's batch is not "
                                 f"the dry run's cell")
        card_flops = int(fc.get_total_flops())
        if rec["traced_flops_total"] != card_flops or \
                rec["argument_bytes"] != card_bytes:
            raise AssertionError(
                f"{name} {kind}: dry run FLOPs {rec['traced_flops_total']} "
                f"/ argument bytes {rec['argument_bytes']} against the "
                f"card's {card_flops} / {card_bytes}")
        traced_ms = rec["step_seconds_bound"] * 1e3
        floor_ms = rec["step_seconds_bound_lower"] * 1e3
        out[kind] = {"traced_flops_total": rec["traced_flops_total"],
                     "card_flops": card_flops,
                     "argument_bytes": rec["argument_bytes"],
                     "card_argument_bytes": card_bytes,
                     "traced_bytes_total": rec["traced_bytes_total"],
                     "temp_bytes": rec["temp_bytes"],
                     "dominant": rec["dominant"],
                     "compute_ms": rec["compute_s"] * 1e3,
                     "memory_ms": rec["memory_s"] * 1e3,
                     "traced_ms": traced_ms, "floor_ms": floor_ms,
                     "measured_ms": ms, "traced_share": traced_ms / ms,
                     "floor_share": floor_ms / ms, "remat": c.remat,
                     "trace_s": rec["trace_s"]}
    del params
    lm_free()
    return out


def phase_dryrun(here: str, ops, seed: int, lm: dict, train: dict,
                 ident: str) -> dict:
    """Phase 12: the dry run's S2RDF cell on the card (12a) and its LM
    records against the card (12b)."""
    t0 = time.perf_counter()
    out = {"s2rdf": dryrun_s2rdf(ops, here), "lm": {}}
    s2 = out["s2rdf"]
    for layout in DRYRUN_LAYOUTS:
        r = s2[layout]
        log(f"  S2RDF cell, {layout}, scale {s2['scale']}, one NCCL rank: "
            f"collective bytes {r['collectives']} (total "
            f"{r['collective_bytes_per_chip']}, weighted "
            f"{r['collective_bytes_weighted']}), collective_s "
            f"{r['collective_s']:.6e} at 450 GB/s, traced bytes "
            f"{r['traced_bytes_total']} over {r['aten_ops']} aten ops, "
            f"caps {r['caps']}, overflowed {r['overflowed']}; the full "
            f"run's {r['rows']} rows equal the single-device engine's "
            f"[{ident}]")
    log(f"  S2RDF cell: vp / extvp collective bytes "
        f"{s2['vp_over_extvp']:.6f}; build {s2['build_s']} s; launches "
        f"over the cell {s2['launches']} [{ident}]")
    for name in DRYRUN_LM:
        prefill_ms = lm["full_width"][name]["prefill_ms"]
        step_ms = train["full_width"][name]["timed"]["remat_off"]["step_ms"]
        out["lm"][name] = r = dryrun_lm(name, seed, prefill_ms, step_ms)
        for kind, v in r.items():
            log(f"  {name} {kind} at {LM_BATCH} × {LM_PREFILL_SEQ}, bf16"
                f"{', remat off' if kind == 'train' else ''}: traced FLOPs "
                f"{v['traced_flops_total']} == the card's, argument bytes "
                f"{v['argument_bytes']} == the card's; the eager port's "
                f"traced work {v['traced_ms']:.4f} ms ({v['dominant']}: "
                f"products {v['compute_ms']:.4f} at the bf16 peak, traced "
                f"traffic {v['memory_ms']:.4f} at the HBM rate; not a "
                f"floor: fusing lowers it), the floor {v['floor_ms']:.4f} "
                f"ms (one pass over arguments, outputs and peak "
                f"temporaries), against {v['measured_ms']:.4f} ms "
                f"measured in phase {'10a' if kind == 'prefill' else '11a'}"
                f": {v['traced_share']:.4f} and {v['floor_share']:.4f} of "
                f"it [{ident}]")
    out["seconds"] = round(time.perf_counter() - t0, 1)
    log(f"  phase 12: {out['seconds']} s")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=340.0)
    ap.add_argument("--compare-scale", type=float, default=34.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=3,
                    help="warm passes over every instance for latencies")
    # one rank of phase 6b (the script starts these itself)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=2, help=argparse.SUPPRESS)
    for name in ("--store", "--queries", "--rendezvous", "--out"):
        ap.add_argument(name, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if args.rank is not None:
        return rank_main(args)
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "src"))
    from repro_torch import Dataset, Engine, RuntimeConfig, analysis
    from repro_torch.core import distributed as dmod
    from repro_torch.core import extvp_build as eb
    from repro_torch.core import jexec
    from repro_torch.core.vp import build_extvp
    from repro_torch.kernels import build, ops, ref
    from repro_torch.rdf.workloads import basic_queries

    t_start = time.perf_counter()

    def stage(msg: str) -> None:
        log(f"{msg} (at {time.perf_counter() - t_start:.0f} s)")

    ident = gpu_identity()
    log(f"[1] card: {ident}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t = time.perf_counter()
    libs = build.build_all()
    log(f"  built {sorted(libs)} from {build.CSRC} in "
        f"{time.perf_counter() - t:.1f} s")
    stage("[2] kernels against their plain versions")
    phase_kernels(ops, ref)
    batched = phase_batched_probe(ops, ref)
    phase_semijoin_kernel(ops, ref)
    phase_bucket_kernel(ops, ref)
    phase_batched_bucket(ops, ref)
    stage("[3] main path")
    nums, probe_path, ds, eng, queries = phase_main(
        args, ops, ref, jexec, eb, Dataset, basic_queries)
    host_ext = phase_identity(ds, build_extvp)
    stage(f"[4] card against CPU at scale {args.scale}")
    for line in DEPTH_CUTS:
        log(f"  reduced: {line}")
    compare(ds, eng, queries, ops, skip={"C1", "C2"}, first_only=True)
    stage(f"[6a] the distributed engine, one rank over NCCL, scale "
          f"{args.scale}")
    nums["bucket_count"], one_rank = phase_one_rank(
        args, ds, eng, host_ext, queries, ops, ref, dmod, build_extvp,
        Engine, here)
    stage(f"[7a] the serving surface at scale {args.scale}")
    ops.reset_launches()
    serve = phase_serve(args, ds, eng, queries, ops, ref, jexec, probe_path,
                        here)
    serve_launches = dict(ops.launches)
    stage(f"[8a] the adaptive runtime and the host engine at scale "
          f"{args.scale}")
    ops.reset_launches()
    big = [n for n in queries if n not in AUTO_SMALL_ONLY]
    adaptive = {"reduced": [
        f"{', '.join(AUTO_SMALL_ONLY)} through auto and pt at "
        f"{args.compare_scale}, not {args.scale}: on the host engine their "
        f"joins take 254 s and 32 s a run at scale 340",
        f"the served passes at {args.scale} leave out "
        f"{', '.join(AUTO_SMALL_ONLY)} (an unwarmed template's first batch "
        f"runs on eager)",
        f"the served pass at {args.scale} with the default router knobs "
        f"also leaves out {', '.join(DEFAULT_KNOBS_CUT)} (over 200 ms a "
        f"request on eager, where each probe sends a whole batch of 32); "
        f"the second pass, with the probes off, serves them"]}
    adaptive[str(args.scale)] = phase_adaptive(
        args, ds, eng, queries, ops, args.scale, big, big,
        serve["layouts"][str(args.scale)]["p50_ms"], serve_mix=True)
    adaptive["launches"] = dict(ops.launches)
    stage(f"[9a] static analysis at scale {args.scale}")
    ops.reset_launches()
    analysis9 = {"a": phase_analysis(ds, eng, queries, ops, Engine,
                                     RuntimeConfig, analysis)}
    del ds, eng, queries, host_ext
    gc.collect()
    torch.cuda.empty_cache()
    stage(f"[4] card against CPU at scale {args.compare_scale}")
    ds = Dataset.watdiv(scale=args.compare_scale, seed=args.seed,
                        threshold=0.25)
    queries = basic_queries(ds.schema, seed=args.seed)
    compare(ds, ds.engine(), queries, ops)
    stage(f"[5] append, save and load at scale {args.compare_scale}")
    store = phase_store(ds, queries, ops, Dataset,
                        os.path.join(here, "build", "smoke_store"))
    queries_file = os.path.join(here, "build", "smoke_queries.json")
    with open(queries_file, "w") as f:
        json.dump(queries, f)
    stage(f"[7b] the serving surface at scale {args.compare_scale}")
    ops.reset_launches()
    small = phase_serve_small(args, ds, ds.engine(), queries, store, ops,
                              here)
    serve["layouts"].update(small.pop("layouts"))
    serve.update(small)
    for k, v in ops.launches.items():
        serve_launches[k] += v
    if min(serve_launches.values()) <= 0:
        raise AssertionError(f"a kernel was not launched on the serving "
                             f"path: {serve_launches}")
    serve["launches"] = serve_launches
    log(f"  launches over phase 7 (7a and 7b): {serve_launches}")
    stage(f"[8b] the adaptive runtime and the host engine at scale "
          f"{args.compare_scale}")
    ops.reset_launches()
    adaptive[str(args.compare_scale)] = phase_adaptive(
        args, ds, ds.engine(), queries, ops, args.compare_scale,
        list(AUTO_SMALL_ONLY), list(queries),
        serve["layouts"][str(args.compare_scale)]["p50_ms"],
        serve_mix=False)
    for k, v in ops.launches.items():
        adaptive["launches"][k] += v
    log(f"  launches over phase 8 (8a and 8b): {adaptive['launches']}")
    for line in adaptive["reduced"]:
        log(f"  reduced: {line}")
    stage(f"[9b] static analysis and the repair at scale "
          f"{args.compare_scale}")
    analysis9["b"] = phase_analysis_small(ds, queries, ops, Dataset, here)
    analysis9["reduced"] = [
        f"9a serves {', '.join(BATCH_CUT)} through the verified "
        f"engine at neither scale: their batches do not fit on the card "
        f"at {args.scale}; both are prepared and verified"]
    del ds, queries
    gc.collect()
    torch.cuda.empty_cache()
    stage(f"[6b] the distributed engine, two ranks sharing the card over "
          f"gloo, scale {args.compare_scale}")
    ranks = phase_two_ranks(args, store, queries_file, here)
    stage("[10] the LM serving path")
    lm = phase_lm(here, ops, args.seed)
    stage("[11] the LM training path")
    train = phase_train(here, ops, args.seed)
    stage("[12] the dry run against the card")
    dry = phase_dryrun(here, ops, args.seed, lm, train, ident)
    stage("[end]")
    print(json.dumps({"phase6": {"one_rank": one_rank, "two_ranks": {
        "backend": "gloo", "ranks": 2, "scale": args.compare_scale,
        "build_s": [r["build_s"] for r in ranks],
        "exchanges": [r["exchanges"] for r in ranks],
        "rows_sent": [r["rows_sent"] for r in ranks],
        "buffer_bytes": [r["buffer_bytes"] for r in ranks],
        "results_equal": [r["results_equal"] for r in ranks],
        "batch_attempts": [r["batch_attempts"] for r in ranks]}}}),
        flush=True)
    print(json.dumps({"join_probe_path": probe_path}), flush=True)
    print(json.dumps({"join_probe_batched": dict(
        batched, served_step=serve["batched_probe"],
        launches_by_template=serve["server"]["batches"])}), flush=True)
    print(json.dumps({"phase7": serve}), flush=True)
    print(json.dumps({"phase8": adaptive}), flush=True)
    print(json.dumps({"phase9": analysis9}), flush=True)
    print(json.dumps({"lm": lm}), flush=True)
    print(json.dumps({"train": train}), flush=True)
    print(json.dumps({"dryrun": dry}), flush=True)

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
