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
