"""The example twins, ``examples/quickstart_torch.py`` and
``examples/serve_sparql_torch.py``, run on the CPU in a subprocess: each
exits 0 and prints its agreement lines, and neither JAX nor the JAX
package ever enters ``sys.modules``."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

#: runs an example as ``__main__`` with the given argv, then lists the
#: modules of JAX or of the JAX package that it loaded
_RUNNER = r"""
import runpy, sys
path = sys.argv[1]
sys.argv = sys.argv[1:]
runpy.run_path(path, run_name="__main__")
bad = sorted(m for m in sys.modules
             if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
print("BAD", bad)
"""


def run_example(name, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", _RUNNER, str(ROOT / "examples" / name),
         *args], env=env, capture_output=True, text=True, timeout=300,
        cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "BAD []" in out.stdout, out.stdout
    return out.stdout


def test_quickstart_twin_agrees_on_the_cpu():
    out = run_example("quickstart_torch.py", "--device", "cpu")
    assert "G1: 7 triples, 8 terms" in out
    assert "SF(ExtVP^OS_follows|likes) = 0.25" in out
    assert "verify: ok" in out
    assert "{'?y': 'B', '?z': 'C', '?w': 'I2', '?x': 'A'}" in out
    assert "static-capacity torch engine agrees: True" in out
    assert "VP baseline result identical: True" in out


@pytest.mark.parametrize("backend", ["torch", "distributed", "auto"])
def test_serve_twin_agrees_on_the_cpu(backend):
    out = run_example("serve_sparql_torch.py", "--device", "cpu",
                      "--scale", "0.1", "--requests", "24",
                      "--backend", backend)
    served = re.search(r"served (\d+) requests .* backend=(\w+)", out)
    assert served and served.groups() == ("24", backend)
    for line in ("latency ms: p50=", "plan-cache hit rate:",
                 "micro-batches:", "result rows:", "adaptive routing:"):
        assert line in out, line
    assert "served results agree with single queries: True" in out


def test_twins_import_neither_jax_nor_repro():
    pat = re.compile(r"^\s*(import|from) (jax|repro)(\.|\s|$)", re.M)
    for name in ("quickstart_torch.py", "serve_sparql_torch.py"):
        assert pat.findall((ROOT / "examples" / name).read_text()) == []
