"""One run of one cell: set-up, the window, the check.

Set-up makes the graph (:mod:`s2bench.inputs.watdiv`): the
configuration's WatDiv graph, its entities renamed by a permutation
drawn from the seed, so that every seed gives the same sizes.  It
hands the encoded triples and term list to the program through its
public constructors (``Dictionary.from_terms``, ``build_catalog``,
``Dataset``, ``SparqlServer``), which build VP, and ExtVP where the
configuration asks, on the card, and warms up one full bucket of every
template of the mix.  The window is the closed loop of
:mod:`s2bench.loop`, opened once it has settled (:class:`Settle`): every
client has had an answer and the server's batch-shape menu has stopped
changing.  Once
it has closed, the requests still outstanding are answered, the device
peak is read, the program is dropped, and :mod:`s2bench.check` compares
the kept answers with the plain reference.

In a traced run (``trace=True``) the server is built with
``trace_sample_rate`` 1.0, the join probe is timed by CUDA events over
the window, and ``torch.profiler`` covers a slice of it; the run reports
the per-layer metrics instead of the end-to-end ones.
"""

from __future__ import annotations

import gc
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from s2bench import check, reference, spec
from s2bench.devtrace import ProbeTimer, Slice
from s2bench.inputs import queries, watdiv
from s2bench.loop import ClosedLoop, window_numbers

#: streams of the seed's generator (the data takes the seed itself)
TRAFFIC_STREAM, WARMUP_STREAM = 1, 2
#: the first word of the query set's generator: the same for every seed
POOL_KEY = 0x5EED
#: the window opens once every client has had ``MIN_ROUNDS`` answers and
#: the server's batch-shape menu holds one shape or has stayed the same
#: over the last ``STEADY_ROUNDS`` rounds of the loop, or once the loop
#: has run ``SETTLE_CAP_S`` seconds
MIN_ROUNDS, STEADY_ROUNDS, SETTLE_CAP_S = 1, 4, 120.0
#: the profiler's slice: from a third of the window, at most this long
SLICE_S = 3.0
#: top-level module names the run may not hold once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} &
                  set(FORBIDDEN))


class Pool:
    """The requests of a mix: ``size`` instances of every template (the
    traffic file's ``instances_per_template``), a fixed query set as
    WatDiv's stress tests run one.  Its constants are drawn by a
    generator that does not depend on the seed, over the graph as
    generated, and renamed as the seed renames the graph
    (:func:`s2bench.inputs.watdiv.renaming`): every seed asks the same
    queries up to names, with the same answer sizes.  A template's
    instances are sent in an order drawn from the seed, afresh each time
    they have all been sent."""

    def __init__(self, seed: int, stream: int, templates: List[str],
                 queryset: dict, counts: Dict[str, int], size: int):
        rename = watdiv.renaming(counts, seed)
        self.pool = {
            t: [queries.instantiate(queryset["templates"][t], queryset,
                                    counts, np.random.default_rng(
                                        [POOL_KEY, stream, i, k]), rename)
                for k in range(size)]
            for i, t in enumerate(templates)}
        self.rngs = {t: np.random.default_rng([seed, stream, i])
                     for i, t in enumerate(templates)}
        self.order: Dict[str, List[int]] = {t: [] for t in templates}

    def __call__(self, template: str) -> str:
        order = self.order[template]
        if not order:
            order.extend(int(k) for k in self.rngs[template].permutation(
                len(self.pool[template])))
        return self.pool[template][order.pop()]


def build_server(cfg: dict, graph, device, trace: bool):
    """The program over ``graph``, as the configuration deploys it."""
    from repro_torch.core.stats import build_catalog
    from repro_torch.engine import Dataset
    from repro_torch.rdf.dictionary import Dictionary
    from repro_torch.runtime import RuntimeConfig
    from repro_torch.serve import SparqlServer
    store, srv = cfg["store"], cfg["server"]
    d = Dictionary.from_terms(graph.terms)
    cat = build_catalog(graph.tt, d, threshold=store["threshold"],
                        kinds=tuple(store["extvp_kinds"]),
                        with_extvp=store["with_extvp"],
                        build_backend=store["build_backend"], device=device)
    ds = Dataset(catalog=cat, dictionary=d, device=device,
                 build_backend=store["build_backend"])
    rt = RuntimeConfig(batch_shapes=tuple(srv["batch_shapes"]),
                       max_batch=srv["max_batch"], flush_ms=srv["flush_ms"],
                       trace_sample_rate=1.0 if trace else 0.0,
                       trace_cardinality=False, **srv["runtime"])
    server = SparqlServer(ds, layout=store["layout"], backend=srv["backend"],
                          device=device, max_batch=srv["max_batch"],
                          flush_ms=srv["flush_ms"],
                          batch_shapes=srv["batch_shapes"],
                          plan_cache_size=srv["plan_cache_size"], runtime=rt)
    return server, ds.storage_report()


def warmup(server, draw: Callable[[str], str], templates: List[str]) -> None:
    """One bucket of every template at the largest batch shape the
    server will launch: plans, table uploads, kernel loads and the
    capacities of the bucket the traffic fills.  The closed loop then
    runs the traffic's own shapes until it settles (:class:`Settle`)
    before the window opens."""
    engine = server.engine
    for t in templates:
        engine.query_batch([draw(t) for _ in range(
            min(server.batcher.max_batch, engine.max_active_batch()))])


class Settle:
    """When the closed loop has reached the state a long-running server
    serves in.  The server's tuner retires batch shapes for good as it
    measures them, so its menu only shrinks: the window opens once the
    menu can shrink no more (one shape is left), or has stopped
    shrinking (:data:`STEADY_ROUNDS`), or at the cap.
    ``changes`` keeps (round, seconds into the loop, menu) for the menu
    before the loop and for each change."""

    def __init__(self, server, start: float):
        self.server, self.start = server, start
        self.menu = self.read()
        self.since = 0
        self.capped = False
        self.changes: List[tuple] = [(0, 0.0, list(self.menu))]

    def read(self) -> Tuple[int, ...]:
        return tuple(self.server.engine.tuner.active_shapes())

    def __call__(self, rounds: int, now: float) -> bool:
        menu = self.read()
        if menu != self.menu:
            self.menu, self.since = menu, rounds
            self.changes.append((rounds, now - self.start, list(menu)))
        if rounds >= MIN_ROUNDS and (len(menu) == 1 or
                                     rounds - self.since >= STEADY_ROUNDS):
            return True
        self.capped = now - self.start >= SETTLE_CAP_S
        return self.capped


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda",
             scale: Optional[float] = None,
             root: Path = spec.ROOT,
             fault: Optional[Callable[[object], None]] = None
             ) -> Tuple[dict, List[str], dict]:
    """The result line, the check's lines and a few notes for one run.
    ``scale`` and ``fault`` are for tests: a smaller graph, and a function
    that breaks the built server underneath."""
    on_card = str(device).startswith("cuda")
    if on_card:
        import torch
    cell = spec.resolve(name, root)
    cfg, mix = cell.config, cell.traffic
    seed = int(seed) % 2 ** 64
    t_gen = time.perf_counter()
    graph = watdiv.relabel(watdiv.generate(
        cfg["dataset"]["scale_factor"] if scale is None else scale,
        cfg["dataset"]["seed"]), seed)
    t_build = time.perf_counter()
    server, storage = build_server(cfg, graph, device, trace)
    if fault is not None:
        fault(server)
    qset = queries.load_queryset(mix["queryset"])
    templates = list(mix["templates"])
    clients = spec.clients(mix)

    t_warm = time.perf_counter()
    size = mix["instances_per_template"]
    warmup(server, Pool(seed, WARMUP_STREAM, templates, qset, graph.counts,
                        size), templates)
    if on_card:
        torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t_warm

    sample = check.Sample(seed)
    loop = ClosedLoop(server, clients,
                      Pool(seed, TRAFFIC_STREAM, templates, qset,
                           graph.counts, size), sample)
    obs = Window(server, seconds, trace, root)
    t_loop = time.perf_counter()
    settle = Settle(server, t_loop)
    t0 = loop.run(seconds, obs.tick, settle)
    setup_s = t0 - t_start
    obs.close()
    loop.drain()
    peak = 0
    if on_card:
        torch.cuda.synchronize()
        peak = int(torch.cuda.max_memory_allocated())
    numbers = window_numbers(loop.requests, t0, seconds)
    in_window = [r for r in loop.requests if r.t_done is not None
                 and r.error is None and t0 <= r.t_done <= t0 + seconds]

    traced = None
    if trace:
        traced = SimpleNamespace(
            requests=in_window, counters=obs.counters,
            probe=obs.probe.totals(),
            profile=obs.slice.result if obs.slice else None,
            memory_peak_bytes=peak, storage=storage, warmup_s=warmup_s)
    del server
    loop.server = obs.server = None
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    store = reference.Store(graph.tt, graph.terms)
    checks = check.verdict(loop.requests, store, templates)
    correct = check.passes(checks)

    if trace:
        metrics = spec.read_metrics(cell.per_layer, traced, root)
    else:
        metrics = {}
        for mdef in cell.end_to_end:
            value = {"qps": numbers["qps"], "p95_ms": numbers["p95_ms"],
                     "setup_s": setup_s}.get(mdef["name"])
            if value is not None:
                metrics[mdef["name"]] = {"value": float(value),
                                         "unit": mdef["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    line = {"correct": correct, "attempted": numbers["attempted"],
            "failed": numbers["failed"], "metrics": metrics, "device": dev}
    if trace and traced.profile is not None:
        dev["busy_s"] = traced.profile["busy_s"]
        dev["window_s"] = traced.profile["window_s"]
        line["breakdown"] = traced.profile["breakdown"]
    line["checks"] = {k: {"value": v["value"], "limit": v["limit"],
                          "holds": v["holds"]} for k, v in checks.items()}
    notes = [f"{k} {v['value']} (limit {v['holds']} {v['limit']})"
             for k, v in checks.items()]
    per_template = {}
    for r in in_window:
        per_template.setdefault(r.template, []).append(
            (r.t_done - r.t_submit) * 1e3)
    info = {"per_template_n_p50_max_ms": {
                t: [len(v), float(np.median(v)), max(v)]
                for t, v in per_template.items()},
            "completed": numbers["completed"], "setup_s": setup_s,
            "warmup_s": warmup_s, "n_triples": int(len(graph.tt)),
            "settle_s": t0 - t_loop, "settle_capped": settle.capped,
            "menu_changes": settle.changes, "menu_window": obs.menus,
            "generate_s": t_build - t_gen, "build_s": t_warm - t_build,
            "before_generate_s": t_gen - t_start,
            "check_s": time.perf_counter() - t_check}
    return line, notes, info


class Window:
    """What the harness does at the window's edges: the server's batch
    counters read at its start and end and, in a traced run, the join
    probe timed and the profiler's slice opened a third of the way in."""

    def __init__(self, server, seconds: float, trace: bool, root: Path):
        self.server, self.seconds, self.trace = server, seconds, trace
        self.t0: Optional[float] = None
        self.before = self.counters = None
        self.probe: Optional[ProbeTimer] = None
        self.slice: Optional[Slice] = None
        #: (seconds into the window, menu) at its start and each change
        self.menus: List[tuple] = []
        if trace:
            self.slice = Slice(root / "build" / "s2bench" / "trace.json")
            self.slice.arm()

    def _read(self) -> Tuple[int, int, int]:
        m = self.server.metrics
        return m.batches, m.batched_requests, m.padding_slots

    def tick(self, now: float, t0: float) -> None:
        if now < t0:
            return
        if self.t0 is None:
            self.t0 = t0
            self.before = self._read()
            if self.trace:
                from repro_torch.kernels import ops
                self.probe = ProbeTimer(ops)
                self.probe.install()
                self.slice.start = t0 + self.seconds / 3
                self.slice.stop = self.slice.start + min(SLICE_S,
                                                         self.seconds / 3)
        menu = list(self.server.engine.tuner.active_shapes())
        if not self.menus or menu != self.menus[-1][1]:
            self.menus.append((now - t0, menu))
        if self.slice is not None:
            self.slice.tick(now)

    def close(self) -> None:
        after = self._read()
        before = self.before or after
        self.counters = {"batches": after[0] - before[0],
                         "batched_requests": after[1] - before[1],
                         "padding_slots": after[2] - before[2]}
        if self.slice is not None:
            self.slice.close()
        if self.probe is not None:
            self.probe.remove()
