"""What a cell is made of, found by name.

``BENCHMARK.json`` at the root of the checkout lists the cells
(``workloads``), the configurations and the metrics.  Everything else
belongs to one configuration, one traffic mix or one per-layer metric,
and sits in a file of its own that this module finds by that name:

* ``s2bench/configs/<config>.json``  (the file ``BENCHMARK.json`` names)
* ``s2bench/traffic/<traffic>.json``
* ``s2bench/querysets/<queryset>.json``  (named by the traffic file)
* ``s2bench/metrics/<metric>.py``, a module with ``read(run)``

A later cell, configuration or metric is therefore new files and new
entries, with no edit to a file that is already here.  A traffic mix is
data for the one loop the harness implements: :data:`TRAFFIC` lists
every key a traffic file may give and the values the harness runs, and
:func:`resolve` refuses any other, so that no file is run as something
it does not say.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


#: what a traffic file may say, and what the harness can run: a closed
#: loop (each client keeps one request outstanding), each client sending
#: one template for the whole run (``clients_per_template`` clients a
#: template, in the file's order), with no think time, over a query set
#: of ``instances_per_template`` instances a template
#: (:class:`s2bench.cell.Pool`).  An open loop,
#: another draw or a think time is harness code still to write.
TRAFFIC = {"loop": ("closed",), "draw": ("per_client",), "think_ms": (0,)}
TRAFFIC_KEYS = {"queryset", "templates", "clients_per_template",
                "instances_per_template", *TRAFFIC}
TRAFFIC_NOTES = {"name", "why"}


def check_traffic(mix: dict, path: Path) -> dict:
    """``mix`` as read from ``path``, refused where it asks for what the
    harness does not implement."""
    extra = set(mix) - TRAFFIC_KEYS - TRAFFIC_NOTES
    missing = TRAFFIC_KEYS - set(mix)
    if extra or missing:
        raise ValueError(f"{path}: unknown keys {sorted(extra)}, "
                         f"missing keys {sorted(missing)}")
    for key, runs in TRAFFIC.items():
        if mix[key] not in runs:
            raise ValueError(f"{path}: {key} {mix[key]!r} is not "
                             f"implemented; the harness runs {list(runs)}")
    counts = (mix["clients_per_template"], mix["instances_per_template"])
    if not (mix["templates"] and all(isinstance(n, int) and n >= 1
                                     for n in counts)):
        raise ValueError(f"{path}: needs templates, and positive "
                         "clients_per_template and instances_per_template")
    return mix


def clients(mix: dict) -> List[str]:
    """Client c's template, for every client of the mix."""
    templates = list(mix["templates"])
    return [templates[c % len(templates)]
            for c in range(mix["clients_per_template"] * len(templates))]


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _json(path: Path, what: str) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"no {what} at {path}")
    return json.loads(path.read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` with its configuration and traffic files read,
    and the metrics it reports."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; known: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(root / configs[w["config"]]["file"], "configuration")
    path = root / "s2bench" / "traffic" / f"{w['traffic']}.json"
    traffic = check_traffic(_json(path, "traffic mix"), path)
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if _applies(m, name) and m["moves"] in reported]
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, end_to_end=e2e, per_layer=layer)


def metric_reader(name: str, root: Path = ROOT) -> ModuleType:
    """The module ``s2bench/metrics/<name>.py`` (it defines ``read``)."""
    path = root / "s2bench" / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r} at {path}")
    spec = importlib.util.spec_from_file_location(
        f"s2bench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if not callable(getattr(mod, "read", None)):
        raise TypeError(f"{path} defines no read(run)")
    return mod


def read_metrics(metrics: List[dict], run, root: Path = ROOT
                 ) -> Dict[str, dict]:
    """Each metric's value from its reader; a reader that finds nothing
    to read returns ``None`` and the metric is left out."""
    out: Dict[str, dict] = {}
    for m in metrics:
        value: Optional[float] = metric_reader(m["name"], root).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
