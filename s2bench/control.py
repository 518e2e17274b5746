"""The control: the plain reference in the program's place, with one of
the configuration's guarantees broken, which the check must fail.

    python3 -m s2bench.control --workload <cell> --seed <n> --seconds <s>

The configurations state no precision; their guarantee is an exact
answer under multiset semantics, never truncated.  The control serves
every request of the cell's closed loop, at the cell's load, from
:mod:`s2bench.reference`, and drops the last row of every answer that
has one: the step a later change would be tempted by (a cap that cuts
an answer short).  It prints the check's numbers, as a run does, and
``correct`` must come out false.  The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional

from s2bench import check, reference, spec
from s2bench.inputs import queries, watdiv
from s2bench.loop import ClosedLoop, window_numbers


class Answer:
    """A served answer as the check reads it."""

    def __init__(self, cols, data):
        self.cols, self.data = tuple(cols), data

    def __len__(self) -> int:
        return len(self.data)


class Ticket:
    def __init__(self, server: "ReferenceServer", qtext: str):
        self.server, self.qtext = server, qtext
        self.answer: Optional[Answer] = None

    def done(self) -> bool:
        return self.answer is not None

    def result(self) -> Answer:
        if self.answer is None:
            self.server.flush()
        return self.answer


class ReferenceServer:
    """``submit`` answers at once from the reference, truncated by one
    row.  Every request is evaluated afresh, as the program evaluates
    each, so that the control runs at about the cell's load and keeps
    about as many answers for the check as a run does."""

    def __init__(self, store: reference.Store):
        self.store = store
        self.batcher = self
        self._queue: List[Ticket] = []

    def pending(self) -> int:
        return len(self._queue)

    def submit(self, qtext: str) -> Ticket:
        ticket = Ticket(self, qtext)
        self._queue.append(ticket)
        self.flush()
        return ticket

    def flush(self) -> int:
        n = len(self._queue)
        for t in self._queue:
            rel = self.store.answer(t.qtext)
            t.answer = Answer(rel.vars, rel.data[:max(len(rel) - 1, 0)])
        self._queue = []
        return n


def run_control(name: str, seed: int, seconds: float,
                scale: Optional[float] = None, root=spec.ROOT) -> dict:
    cell = spec.resolve(name, root)
    cfg, mix = cell.config, cell.traffic
    seed = int(seed) % 2 ** 64
    graph = watdiv.relabel(watdiv.generate(
        cfg["dataset"]["scale_factor"] if scale is None else scale,
        cfg["dataset"]["seed"]), seed)
    store = reference.Store(graph.tt, graph.terms)
    qset = queries.load_queryset(mix["queryset"])
    templates = list(mix["templates"])
    clients = spec.clients(mix)
    from s2bench.cell import TRAFFIC_STREAM, Pool
    loop = ClosedLoop(ReferenceServer(store), clients,
                      Pool(seed, TRAFFIC_STREAM, templates, qset,
                           graph.counts, mix["instances_per_template"]),
                      check.Sample(seed))
    t0 = loop.run(seconds)
    loop.drain()
    numbers = window_numbers(loop.requests, t0, seconds)
    checks = check.verdict(loop.requests, store, templates)
    return {"correct": check.passes(checks),
            "attempted": numbers["attempted"], "failed": numbers["failed"],
            "checks": checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    t = time.perf_counter()
    out = run_control(args.workload, args.seed, args.seconds)
    out["seconds"] = time.perf_counter() - t
    for k, v in out["checks"].items():
        print(f"{k} {v['value']} (limit {v['holds']} {v['limit']})",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
