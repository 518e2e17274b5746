"""The port's lint (``repro_torch.analysis.lint``): a torch counterpart of
each replint case of ``tests/test_analysis.py`` over known-bad and
known-clean snippets, a firing and a clean case of each rule new to
torch (``unstable-sort``, the data-dependent-shape ops, the copy-back
methods), the rule catalog, and the port's own sources, which must come
out clean (``tools/replint_torch.py src/repro_torch --strict``)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from repro.analysis.lint import RULES as REF_RULES

from repro_torch.analysis import RULES, lint_paths, lint_source

ROOT = Path(__file__).resolve().parents[1]


def rules_of(findings):
    return [f.rule for f in findings]


# ---------------------------------------------------------------------------
# counterparts of tests/test_analysis.py's replint cases
# ---------------------------------------------------------------------------

def test_lint_tensor_branch():
    findings = lint_source(
        "import torch\n"
        "def device_f(x):\n"
        "    y = torch.sum(x)\n"
        "    z = y * 2\n"
        "    if y > 0:\n"
        "        return y\n"
        "    return -z\n")
    assert rules_of(findings) == ["tensor-branch"]
    assert findings[0].line == 5


def test_lint_tensor_while_and_ternary():
    findings = lint_source(
        "import torch\n"
        "def device_count(x):\n"
        "    t = torch.sum(x)\n"
        "    while t > 0:\n"
        "        t = t - 1\n"
        "    return t if t > 0 else -t\n")
    assert rules_of(findings) == ["tensor-branch", "tensor-branch"]


def test_lint_host_sync_item_and_np():
    findings = lint_source(
        "import numpy as np\n"
        "import torch\n"
        "def device_norm(x):\n"
        "    t = torch.exp(x)\n"
        "    a = np.asarray(t)\n"
        "    return t.sum().item()\n")
    assert sorted(rules_of(findings)) == ["host-sync", "host-sync"]


def test_lint_host_sync_float_cast():
    findings = lint_source(
        "import torch\n"
        "def device_f(x):\n"
        "    return float(torch.sum(x))\n")
    assert rules_of(findings) == ["host-sync"]


def test_lint_int32_overflow():
    findings = lint_source(
        "def device_f(x):\n"
        "    return x + 3000000000\n")
    assert rules_of(findings) == ["int32-overflow"]


def test_lint_nonstatic_shape_from_tensor_n():
    findings = lint_source(
        "import torch\n"
        "def device_pad(b):\n"
        "    return torch.zeros((b.n,), dtype=torch.int32)\n")
    assert rules_of(findings) == ["nonstatic-shape"]


def test_lint_has_no_shard_map_rule():
    """The original's ``shard-map-check-rep`` has no counterpart: the
    port has no ``shard_map``, and the catalog says so instead of
    keeping a rule that can never fire."""
    assert "shard-map-check-rep" in REF_RULES
    assert "shard-map-check-rep" not in RULES
    assert set(REF_RULES) - set(RULES) == {"traced-branch",
                                           "shard-map-check-rep"}
    assert "traced-branch" in RULES["tensor-branch"]
    src = (
        "from jax.experimental.shard_map import shard_map\n"
        "def device_build(body, mesh, specs):\n"
        "    return shard_map(body, mesh=mesh, in_specs=specs,\n"
        "                     out_specs=specs)\n")
    assert lint_source(src) == []


def test_lint_launch_wrappers_and_programs_are_device_code():
    """torch has no tracer: a kernel's launch wrapper (it counts a
    launch, or reaches a function of its module that does) and an
    executor's ``*_program`` are the roots the original's tracer calls
    were."""
    wrapper = (
        "import torch\n"
        "launches = {'k': 0}\n"
        "def _launch(x):\n"
        "    launches['k'] += 1\n"
        "def kernel(x):\n"
        "    s = torch.sum(x)\n"
        "    if s > 0:\n"
        "        _launch(x)\n"
        "    return x\n")
    findings = lint_source(wrapper)
    assert rules_of(findings) == ["tensor-branch"] and findings[0].line == 7
    program = (
        "import torch\n"
        "class Ex:\n"
        "    def _shard_program(self, x):\n"
        "        return x.sum().tolist()\n")
    assert rules_of(lint_source(program)) == ["host-sync"]


def test_lint_call_graph_propagation():
    findings = lint_source(
        "import torch\n"
        "def helper(x):\n"
        "    m = torch.max(x)\n"
        "    if m > 0:\n"
        "        return m\n"
        "    return x\n"
        "def device_entry(x):\n"
        "    return helper(x)\n")
    assert rules_of(findings) == ["tensor-branch"]


def test_lint_static_idioms_stay_clean():
    assert lint_source(
        "import torch\n"
        "def device_f(x, flag):\n"
        "    # host-metadata branches + host list of tensors: all fine\n"
        "    if x.shape[0] > 2:\n"
        "        x = x[:2]\n"
        "    if x.size(0) > 1 and x.numel() and x.dim() == 1:\n"
        "        x = x + 1\n"
        "    if flag:\n"
        "        x = -x\n"
        "    masks = [torch.sum(x), torch.prod(x)]\n"
        "    out = masks[0]\n"
        "    for m in masks[1:]:\n"
        "        out = out + m\n"
        "    if len(masks) > 1:\n"
        "        out = out * 2\n"
        "    total = torch.sum(out)\n"
        "    if total is not None:\n"
        "        out = out + 1\n"
        "    if torch.cuda.is_available() and x.device.type == 'cuda':\n"
        "        out = out + 0\n"
        "    return out\n") == []


def test_lint_untraced_functions_not_checked():
    # host code may branch on tensors and read them back freely
    assert lint_source(
        "import torch\n"
        "def host(x):\n"
        "    y = torch.sum(x)\n"
        "    if y > 0:\n"
        "        return float(y) + y.item()\n"
        "    return x.cpu().numpy()\n") == []


def test_lint_suppression_requires_justification():
    base = (
        "import torch\n"
        "def device_f(x):\n"
        "    y = torch.sum(x)\n"
        "    if y > 0:  # replint: disable=tensor-branch{tail}\n"
        "        return y\n"
        "    return -y\n")
    justified = base.format(tail=" -- the one read of this launch")
    assert lint_source(justified) == []
    bare = base.format(tail="")
    assert rules_of(lint_source(bare)) == ["bare-suppression"]


def test_lint_standalone_suppression_line_covers_next_line():
    src = (
        "import torch\n"
        "def device_f(x):\n"
        "    y = torch.sum(x)\n"
        "    # replint: disable=tensor-branch -- the one read per attempt\n"
        "    if y > 0:\n"
        "        return y\n"
        "    return -y\n")
    assert lint_source(src) == []


def test_repo_lint_is_clean():
    """``src/repro_torch`` comes out clean, and every suppression in it
    carries its reason (a bare one would be a finding here)."""
    src = ROOT / "src" / "repro_torch"
    findings = lint_paths([src])
    assert findings == [], "\n".join(str(f) for f in findings)
    directives = [line for f in sorted(src.rglob("*.py"))
                  for line in f.read_text().splitlines()
                  if "replint: disable=" in line]
    assert directives and all(" -- " in line for line in directives)


# ---------------------------------------------------------------------------
# rules new to torch: each fires, and its clean form stays clean
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("call", [
    "torch.sort(x)", "torch.argsort(x, dim=-1)", "t.sort(dim=1)",
    "t.argsort()", "torch.sort(x, stable=False)"])
def test_lint_unstable_sort_fires(call):
    findings = lint_source(
        "import torch\n"
        "def device_order(x):\n"
        "    t = torch.abs(x)\n"
        f"    return {call}\n")
    assert rules_of(findings) == ["unstable-sort"]


def test_lint_stable_sorts_stay_clean():
    assert lint_source(
        "import numpy as np\n"
        "import torch\n"
        "def device_order(x, cols):\n"
        "    t = torch.abs(x)\n"
        "    a = torch.argsort(t, dim=-1, stable=True)\n"
        "    b = t.sort(stable=True)\n"
        "    c = torch.sort(x, dim=0, stable=True)\n"
        "    cols.sort()\n"          # a Python list: host, stable
        "    return a, b, c, sorted(cols)\n") == []


@pytest.mark.parametrize("expr", [
    "torch.nonzero(t)", "t.nonzero()", "t[t > 0]", "t[~keep]",
    "t[keep & (t != 3)]", "torch.masked_select(t, keep)", "t.unique()",
    "torch.unique(t, return_counts=True)", "t.repeat_interleave(c)",
    "torch.where(keep)", "torch.argwhere(t)", "t[:, torch.isnan(t)]"])
def test_lint_data_dependent_shapes_fire(expr):
    findings = lint_source(
        "import torch\n"
        "def device_f(x, c):\n"
        "    t = torch.abs(x)\n"
        "    keep = t > 1\n"
        f"    return {expr}\n")
    assert rules_of(findings) == ["nonstatic-shape"]


def test_lint_static_shapes_stay_clean():
    assert lint_source(
        "import torch\n"
        "def device_f(x, c, cap):\n"
        "    t = torch.abs(x)\n"
        "    keep = t > 1\n"
        "    a = torch.where(keep, t, 0)\n"
        "    b = t.repeat_interleave(c, output_size=cap)\n"
        "    t[keep] = 0\n"                 # a masked write keeps the shape
        "    d = t[:, :cap]\n"
        "    e = torch.full((x.shape[0], cap), 7)\n"
        "    f = t.view(x.shape[0], -1).expand(3, -1, -1)\n"
        "    return a, b, d, e, f, t[torch.arange(cap)]\n") == []


@pytest.mark.parametrize("read", [
    "t.cpu()", "t.numpy()", "t.tolist()", "bool(t.any())", "int(t[0])"])
def test_lint_copy_backs_fire(read):
    findings = lint_source(
        "import torch\n"
        "def device_f(x):\n"
        "    t = torch.cumsum(x, 0)\n"
        f"    return {read}\n")
    assert rules_of(findings) == ["host-sync"]


def test_lint_views_sized_by_tensors_fire():
    findings = lint_source(
        "import torch\n"
        "def device_f(x):\n"
        "    n = torch.sum(x)\n"
        "    a = torch.arange(n)\n"
        "    b = x.view(n, -1)\n"
        "    return a, b, x.new_zeros(n)\n")
    assert rules_of(findings) == ["nonstatic-shape"] * 3


# ---------------------------------------------------------------------------
# the catalog and the tool
# ---------------------------------------------------------------------------

def test_tool_lists_rules_and_is_strict(tmp_path):
    tool = [sys.executable, str(ROOT / "tools" / "replint_torch.py")]
    out = subprocess.run(tool + ["--list-rules"], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0
    assert [ln.split(":")[0] for ln in out.stdout.splitlines()] == \
        list(RULES)
    clean = subprocess.run(tool + [str(ROOT / "src" / "repro_torch"),
                                   "--strict"],
                           capture_output=True, text=True, timeout=120)
    assert clean.returncode == 0 and "replint: clean" in clean.stderr
    bad = tmp_path / "bad.py"
    bad.write_text("import torch\n"
                   "def device_f(x):\n"
                   "    return torch.sort(x)\n")
    report = tmp_path / "findings.json"
    loose = subprocess.run(tool + [str(bad), "--json", str(report)],
                           capture_output=True, text=True, timeout=120)
    strict = subprocess.run(tool + [str(bad), "--strict"],
                            capture_output=True, text=True, timeout=120)
    assert loose.returncode == 0 and strict.returncode == 1
    assert "unstable-sort" in strict.stdout
    assert [f["rule"] for f in json.loads(report.read_text())] == \
        ["unstable-sort"]
