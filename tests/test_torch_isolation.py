"""The port stands alone: importing and running ``repro_torch`` loads
neither JAX nor the JAX package, its sources import neither, and its
entry points refuse to carry on silently on the CPU when no CUDA device
is present."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from _torch_dist_jobs import run_group

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

_CHILD = r"""
import sys
from repro_torch import Dataset
from repro_torch.rdf.workloads import basic_queries
ds = Dataset.watdiv(scale=0.05, seed=1, threshold=0.25, device="cpu")
eng = ds.engine()
qs = basic_queries(ds.schema, seed=1)
rows = sum(len(eng.query(q[0])) for q in qs.values())
rows += sum(len(r) for r in eng.query_batch(qs["S1"] + qs["C3"]))
bad = sorted(m for m in sys.modules
             if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
print("ROWS", rows)
print("BAD", bad)
"""


_STORE_CHILD = r"""
import sys, tempfile
from repro_torch import Dataset
from repro_torch.kernels import ops
triples = [(f"e{i % 17}", f"p{i % 4}", f"e{(3 * i) % 19}") for i in range(200)]
ds = Dataset.from_triples(triples[:180], threshold=0.25,
                          build_backend="torch", device="cpu")
with tempfile.TemporaryDirectory() as tmp:
    ds.save(tmp + "/s")
    ds.append_triples(triples[180:])
    loaded = Dataset.load(tmp + "/s", device="cpu")
    rows = len(loaded.engine().query("SELECT * WHERE { ?a p0 ?b . ?b p1 ?c }"))
    same = loaded.catalog.extvp.sf == ds.catalog.extvp.sf
bad = sorted(m for m in sys.modules
             if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
print("ROWS", rows, "SAME", same, "LAUNCHES", sum(ops.launches.values()))
print("BAD", bad)
"""


_SERVE_CHILD = r"""
import sys
import repro_torch.launch.serve
import repro_torch.obs, repro_torch.obs.prometheus
import repro_torch.runtime
import repro_torch.serve
from repro_torch import Dataset, RuntimeConfig, SparqlServer
from repro_torch.rdf.workloads import basic_queries
ds = Dataset.watdiv(scale=0.05, seed=1, threshold=0.25, device="cpu")
srv = SparqlServer(ds, runtime=RuntimeConfig(planner="estimate",
                                             trace_sample_rate=1.0))
qs = basic_queries(ds.schema, seed=1)
tickets = [srv.submit(q) for insts in qs.values() for q in insts]
srv.flush()
rows = sum(len(t.result()) for t in tickets)
text = srv.metrics.prometheus() + srv.engine.tracer.to_jsonl()
text += srv.engine.explain(qs["S1"][0])
rows += len(ds.engine(layout="tt").query(qs["L4"][0]))
bad = sorted(m for m in sys.modules
             if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
print("ROWS", rows, "TEXT", len(text) > 0)
print("BAD", bad)
"""


_HOST_CHILD = r"""
import sys
import repro_torch.core.executor, repro_torch.core.pt
import repro_torch.core.reference
import repro_torch.runtime.router, repro_torch.runtime.tuner
from repro_torch import Dataset, RuntimeConfig, SparqlServer
from repro_torch.core.reference import execute_reference
from repro_torch.core.sparql import parse_sparql
from repro_torch.rdf.workloads import basic_queries
ds = Dataset.watdiv(scale=0.05, seed=1, threshold=0.25, device="cpu")
qs = basic_queries(ds.schema, seed=1)
auto = ds.engine("auto", runtime=RuntimeConfig(router_warmup=1))
rows = 0
for _ in range(3):
    rows += sum(len(auto.query(q[0])) for q in qs.values())
rows += sum(len(r) for r in auto.query_batch(qs["S1"] + qs["C3"]))
rows += sum(len(ds.engine(layout="pt").query(q[0])) for q in qs.values())
rows += len(ds.engine("eager").query(qs["L4"][0]))
srv = SparqlServer(ds, backend="auto", runtime=RuntimeConfig())
tickets = [srv.submit(q) for q in qs["S2"]]
srv.flush()
rows += sum(len(t.result()) for t in tickets)
q = parse_sparql("SELECT * WHERE { ?a ?p ?b }", ds.dictionary)
rows += len(execute_reference(q, ds.catalog.tt[:50], ds.dictionary.values))
text = srv.metrics.prometheus() + auto.explain(qs["S1"][0])
routed = auto.metrics.summary()["routed"]
bad = sorted(m for m in sys.modules
             if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
print("ROWS", rows, "ROUTED", sorted(routed), "TEXT", "repro_router_" in text)
print("BAD", bad)
"""


_ANALYSIS_CHILD = r"""
import sys
import repro_torch.analysis
from repro_torch import Dataset, Engine, RuntimeConfig
from repro_torch.analysis import lint_paths, verify_prepared
from repro_torch.rdf.workloads import basic_queries
ds = Dataset.watdiv(scale=0.05, seed=1, threshold=0.25, device="cpu")
eng = Engine(ds, runtime=RuntimeConfig(verify_plans=True), device="cpu")
qs = basic_queries(ds.schema, seed=1)
rows = sum(len(eng.query(q[0])) for q in qs.values())
ok = all(verify_prepared(eng.prepare(q[0]), ds.catalog).ok
         for q in qs.values())
text = eng.explain(qs["S1"][0])
findings = lint_paths([sys.argv[1]])
bad = sorted(m for m in sys.modules
             if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
print("ROWS", rows, "OK", ok, "VERDICT", "verify: ok" in text,
      "FINDINGS", len(findings))
print("BAD", bad)
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC)
    return env


def test_port_imports_neither_jax_nor_repro():
    out = subprocess.run([sys.executable, "-c", _CHILD], env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    assert int(out.stdout.split("ROWS")[1].split()[0]) > 0


def test_load_path_imports_neither_jax_nor_repro():
    """Build with the ``"torch"`` build on the CPU, save, append, load
    with delta replay and query, all through the port."""
    out = subprocess.run([sys.executable, "-c", _STORE_CHILD], env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    assert "SAME True LAUNCHES 0" in out.stdout, out.stdout
    assert int(out.stdout.split("ROWS")[1].split()[0]) > 0


def test_serving_layer_imports_neither_jax_nor_repro():
    """The server, its micro-batcher, tracing and Prometheus export, the
    estimate planner, the layouts and the launcher module, all through
    the port."""
    out = subprocess.run([sys.executable, "-c", _SERVE_CHILD], env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    assert "TEXT True" in out.stdout, out.stdout
    assert int(out.stdout.split("ROWS")[1].split()[0]) > 0


def test_host_engine_and_auto_import_neither_jax_nor_repro():
    """The eager executor, the property-table layout, the oracle, and an
    ``"auto"`` engine with its router and tuner (single, batched and
    served), all through the port."""
    out = subprocess.run([sys.executable, "-c", _HOST_CHILD], env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    assert "ROUTED ['eager', 'torch'] TEXT True" in out.stdout, out.stdout
    assert int(out.stdout.split("ROWS")[1].split()[0]) > 0


def test_analysis_imports_neither_jax_nor_repro():
    """The plan verifier behind an engine's ``verify_plans``, its verdict
    in ``explain()``, and the lint over the port's own sources, all
    through the port."""
    out = subprocess.run([sys.executable, "-c", _ANALYSIS_CHILD,
                          str(SRC / "repro_torch")], env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    assert "OK True VERDICT True FINDINGS 0" in out.stdout, out.stdout
    assert int(out.stdout.split("ROWS")[1].split()[0]) > 0


def test_tools_and_examples_of_the_port_import_neither():
    """The lint's command line and the example twins stand on the port
    alone, as its sources do."""
    pat = re.compile(r"^\s*(import|from) (jax|repro)(\.|\s|$)", re.M)
    files = [ROOT / "tools" / "replint_torch.py",
             ROOT / "examples" / "quickstart_torch.py",
             ROOT / "examples" / "serve_sparql_torch.py"]
    hits = [f"{f}: {m.group(0).strip()}" for f in files
            for m in pat.finditer(f.read_text())]
    assert hits == []


def test_distributed_engine_imports_neither_jax_nor_repro(tmp_path):
    """Two ranks over gloo import ``repro_torch.core.distributed``, build
    with the distributed build and serve through the distributed engine,
    all through the port."""
    for rank in run_group("isolation", 2, tmp_path):
        assert rank["bad"] == []
        assert rank["rows"] > 0


def test_sources_import_neither_jax_nor_repro():
    pat = re.compile(r"^\s*(import|from) (jax|repro)(\.|\s|$)", re.M)
    files = sorted((SRC / "repro_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    hits = [f"{f}: {m.group(0).strip()}" for f in files
            for m in pat.finditer(f.read_text())]
    assert hits == []


def test_entry_points_need_cuda_unless_asked_for_cpu():
    from repro_torch import Dataset, Engine
    from repro_torch.kernels import build
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Dataset.watdiv(scale=0.05)
    with pytest.raises(RuntimeError, match="CUDA"):
        Dataset.from_triples([("a", "p", "b")])
    ds = Dataset.from_triples([("a", "p", "b")], device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(ds)
    with pytest.raises(RuntimeError, match="CUDA"):
        ds.engine(device="cuda")
    assert ds.engine().device.type == "cpu"
    assert build.SOURCES  # the kernels exist, built only on first use


def test_executor_and_context_need_cuda_unless_asked_for_cpu():
    """``PlanExecutor`` and ``ExecutionContext`` resolve a missing device
    to ``"cuda"``, as ``Engine`` and ``Dataset`` do."""
    from repro_torch import Dataset
    from repro_torch.core.compiler import compile_core
    from repro_torch.core.jexec import PlanExecutor
    from repro_torch.core.sparql import parse_sparql
    from repro_torch.engine.backends import ExecutionContext
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    ds = Dataset.from_triples([("a", "p", "b"), ("b", "p", "c")],
                              device="cpu")
    q = parse_sparql("SELECT * WHERE { ?x p ?y . ?y p ?z }", ds.dictionary)
    cp = compile_core(q.root, ds.catalog)
    with pytest.raises(RuntimeError, match="CUDA"):
        PlanExecutor(cp, ds.catalog)
    with pytest.raises(RuntimeError, match="CUDA"):
        ExecutionContext(catalog=ds.catalog)
    assert PlanExecutor(cp, ds.catalog, device="cpu").device.type == "cpu"
    assert ExecutionContext(catalog=ds.catalog,
                            device="cpu").device.type == "cpu"


def test_chip_smoke_refuses_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         env=_env(), capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    # alone in a directory, without the rest of the repo
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, str(alone)], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
