"""The port's dry run (``repro_torch.launch.dryrun``) held against the
JAX package's (``repro.launch.dryrun``): the cell list, the memory a
chip holds, the counts of an eager trace, the roofline, the S2RDF cell
at two ranks against the reference's compiled program, and the command
line."""

import dataclasses
import json
import os
import pickle
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.launch import dryrun as D
from repro_torch.launch.collectives import collective_bytes
from repro_torch.launch.mesh import HW

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
ARCH_NAMES = ["qwen1.5-0.5b", "gemma3-12b", "mistral-nemo-12b",
              "granite-3-2b", "granite-moe-1b-a400m", "deepseek-moe-16b",
              "jamba-1.5-large-398b", "whisper-small", "llava-next-34b",
              "mamba2-370m"]
#: the group of processes (or the reference's subprocess) may take this
#: long in all
GROUP_TIMEOUT_S = 300


def _env(**extra):
    return dict(os.environ, PYTHONPATH=str(SRC), **extra)


def test_arch_names_are_the_registry():
    from repro.configs import ARCHS as REF
    from repro_torch.configs import ARCHS
    assert list(ARCHS) == list(REF) == ARCH_NAMES


# ---------------------------------------------------------------------------
# The cell list: every (arch × shape × mesh), as the reference's
# shape_applicable says (the counterpart of test_dryrun_artifact_complete)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_cell_list_matches_reference(arch):
    """At reduced size, every shape cell at both meshes: ``ok`` where the
    reference's ``shape_applicable`` admits the cell, else ``skipped``
    with its reason; no cell errors, and every ok record has the
    roofline's keys with the collective term stated as absent.  The SSD
    chunk is 64, not the reduced 8: a 32k-token cell then traces 512
    chunks a layer, not 4,096 (jamba's list took a minute)."""
    from repro.configs import get as ref_get
    from repro.models.config import SHAPES as REF_SHAPES
    from repro.models.config import shape_applicable
    from repro_torch.configs import get
    from repro_torch.models.config import SHAPES
    assert [c.name for c in SHAPES] == [c.name for c in REF_SHAPES]
    for cell in REF_SHAPES:
        recs = D.run_cell(arch, cell.name, ["single", "multi"],
                          cfg=get(arch).reduced(ssm_chunk=64))
        assert [r["mesh"] for r in recs] == ["single", "multi"]
        ok, reason = shape_applicable(ref_get(arch), cell)
        for r in recs:
            assert r["status"] == ("ok" if ok else "skipped"), r
            if not ok:
                assert r["reason"] == reason
                continue
            for key in ("traced_flops_total", "traced_bytes_total",
                        "compute_s", "memory_s", "dominant",
                        "step_seconds_bound", "argument_bytes",
                        "output_bytes", "temp_bytes", "fits_card",
                        "model_flops_total", "useful_compute_ratio",
                        "roofline_fraction", "total_params", "wall_s"):
                assert r[key] is not None, (key, r)
            assert r["collective_s"] is None
            assert "no leaf across cards" in r["collective_reason"]
            assert r["dominant"] in ("compute_s", "memory_s")
            assert r["n_chips"] == (256 if r["mesh"] == "single" else 512)
        if ok:
            single, multi = recs
            # one trace serves both meshes
            assert single["traced_flops_total"] == \
                multi["traced_flops_total"]
            assert single["traced_bytes_total"] == \
                multi["traced_bytes_total"]
            assert multi["traced_flops_per_chip"] * 2 == \
                single["traced_flops_per_chip"]


# ---------------------------------------------------------------------------
# Memory per chip against XLA's memory analysis
# ---------------------------------------------------------------------------

_REF_MEMORY = textwrap.dedent("""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    assert len(jax.devices()) == 4
    import repro.launch.dryrun as D     # after the backend is up
    from repro.configs import get
    from repro.models.config import SHAPES, shape_applicable
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    out = {}
    for arch in sys.argv[2].split(","):
        cfg = get(arch).reduced()
        for cell in SHAPES:
            if not shape_applicable(cfg, cell)[0]:
                continue
            fn, structs = D.build_cell(cfg, cell, mesh)
            m = fn.lower(*structs).compile().memory_analysis()
            out[(arch, cell.name)] = (m.argument_size_in_bytes,
                                      m.output_size_in_bytes)
    with open(sys.argv[1], "wb") as f:
        pickle.dump(out, f)
""")

#: a dense, an MoE and an SSM config
MEMORY_ARCHS = ("qwen1.5-0.5b", "granite-moe-1b-a400m", "mamba2-370m")
MEMORY_CASES = [(a, c) for a in MEMORY_ARCHS
                for c in ("train_4k", "prefill_32k", "decode_32k")] + \
    [("mamba2-370m", "long_500k")]


@pytest.fixture(scope="module")
def xla_memory(tmp_path_factory):
    out = tmp_path_factory.mktemp("mem") / "memory.pkl"
    run = subprocess.run([sys.executable, "-c", _REF_MEMORY, str(out),
                          ",".join(MEMORY_ARCHS)], env=_env(),
                         capture_output=True, text=True,
                         timeout=GROUP_TIMEOUT_S)
    assert run.returncode == 0, run.stderr[-4000:]
    with open(out, "rb") as f:
        return pickle.load(f)


def _port_bytes(arch, shape, mesh):
    from repro_torch.configs import get
    from repro_torch.models.config import SHAPES
    cfg = get(arch).reduced()
    cell = next(c for c in SHAPES if c.name == shape)
    built = D.build_cell(cfg, cell, mesh)
    return sum(D.per_chip_bytes(a, s, mesh)
               for a, s in zip(built.args, built.arg_specs) if s is not None)


@pytest.mark.parametrize("arch,shape", MEMORY_CASES)
def test_argument_bytes_match_xla(xla_memory, arch, shape):
    """Per-chip argument bytes on a (2, 2) ("data", "model") mesh equal
    ``memory_analysis().argument_size_in_bytes`` of the reference's
    ``build_cell`` compiled for that mesh, exactly — but for one stated
    difference: a decode step's position is an int32 argument of the
    reference's program (4 bytes, kept where the step reads it; XLA
    drops it from mamba2's, whose SSM decode does not) and a host int of
    the port's, which puts nothing on the card."""
    mesh = ((2, 2), ("data", "model"))
    port = _port_bytes(arch, shape, mesh)
    ref, _ = xla_memory[(arch, shape)]
    reads_pos = shape.startswith(("decode", "long")) and \
        arch != "mamba2-370m"
    assert port + (4 if reads_pos else 0) == ref, (port, ref)


def test_fits_card_reads_argument_bytes():
    rec = D.analyze(1, None, 0.0, 0.0, {"argument_bytes": HW.HBM_BYTES,
                                        "output_bytes": 0,
                                        "temp_bytes": 0})
    assert rec["fits_card"] is True
    rec = D.analyze(1, None, 0.0, 0.0, {"argument_bytes": HW.HBM_BYTES + 1,
                                        "output_bytes": 0,
                                        "temp_bytes": 0})
    assert rec["fits_card"] is False


def test_per_chip_bytes_multiplies_tuple_entries():
    t = torch.empty((32, 8), dtype=torch.float32, device="meta")
    mesh = ((2, 4, 2), ("pod", "data", "model"))
    assert D.per_chip_bytes(t, (("pod", "data"), "model"), mesh) == \
        32 * 8 * 4 // 16
    assert D.per_chip_bytes(t, (None, "model"), mesh) == 32 * 8 * 4 // 2
    assert D.per_chip_bytes(t, (), mesh) == 32 * 8 * 4
    # a spec naming "model" on a data-only mesh divides by 1
    assert D.per_chip_bytes(t, (None, "model"), ((4,), ("data",))) == \
        32 * 8 * 4


def test_dp_only_decode_replicates_params():
    """mamba2 decodes data-parallel only: its params are whole on every
    chip and its caches keep only their data axes (as the reference's
    ``build_cell``); the position is the int ``seq_len - 1``."""
    from repro_torch.configs import get
    from repro_torch.models.config import SHAPES
    from repro_torch.models.sharding import is_spec
    from repro_torch.train.tree import flatten_with_paths, leaves
    cfg = get("mamba2-370m").reduced()
    assert cfg.dp_only_decode
    cell = next(c for c in SHAPES if c.name == "decode_32k")
    mesh = ((2, 2), ("data", "model"))
    built = D.build_cell(cfg, cell, mesh)
    params = built.args[0]
    assert D.per_chip_bytes(params, built.arg_specs[0], mesh) == \
        sum(t.numel() * t.element_size() for t in leaves(params))
    specs = flatten_with_paths(built.arg_specs[1], is_leaf=is_spec)
    assert specs
    for _, spec in specs:
        assert all(e in (None, "data") for e in spec), spec
    assert built.args[3] == cell.seq_len - 1


# ---------------------------------------------------------------------------
# The eager trace counts every group (the counterpart of
# test_xla_undercounts_loop_bodies: no unroll correction is needed)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "jamba-1.5-large-398b",
                                  "whisper-small", "mamba2-370m"])
def test_trace_counts_every_group(arch):
    """Reduced configs with 1, 2 and 4 groups of the layer loop: the
    traced FLOPs and bytes grow by exactly the per-group count, so 4
    groups trace twice the per-group count of 2 more than 2 do, over the
    same non-loop part."""
    from repro_torch.configs import get
    from repro_torch.models.config import ShapeCell
    base = get(arch).reduced()
    extra = 1 if base.first_layer_override else 0
    cell = ShapeCell("train_small", 256, 2, "train")
    counts = {}
    for groups in (1, 2, 4):
        cfg = dataclasses.replace(
            base, n_layers=groups * len(base.group_pattern) + extra)
        assert cfg.n_groups == groups
        built = D.build_cell(cfg, cell, ((1,), ("data",)))
        trace, _ = D.trace_step(built.step, built.args)
        counts[groups] = (trace.flops, trace.bytes)
    for i in (0, 1):
        per_group = counts[2][i] - counts[1][i]
        assert per_group > 0
        assert counts[4][i] - counts[2][i] == 2 * per_group
        assert counts[1][i] - per_group >= 0     # the non-loop part


# ---------------------------------------------------------------------------
# The roofline
# ---------------------------------------------------------------------------

#: (n_chips, model FLOPs, traced FLOPs, traced bytes, (argument, output,
#: temp) bytes a chip, collective operand bytes a chip by kind): one case
#: each term dominates, and one without model FLOPs (the S2RDF cell's)
ANALYZE_CASES = {
    "compute": (4, 3.0e15, 8.0e15, 2.0e13, (10_000, 2_000, 5_000),
                {"all-to-all": 3.0e11, "all-reduce": 1.0e9}),
    "memory": (2, 1.0e12, 4.0e12, 6.0e13, (3 * 2**30, 2**20, 2**28),
               {"all-gather": 2.0e8}),
    "collective": (8, 5.0e13, 6.0e13, 1.0e12, (2**24, 2**22, 2**23),
                   {"all-to-all": 2.0e12, "all-gather": 4.0e11,
                    "reduce-scatter": 1.0e10,
                    "collective-permute": 3.0e9, "all-reduce": 8.0e8}),
    "no_model_flops": (1, None, 0.0, 4.1239369e7, (167_996, 43_008,
                                                    9_437_184),
                       {"all-to-all": 1_966_080.0, "all-reduce": 56.0}),
}

_REF_ANALYZE = textwrap.dedent("""
    import json, sys, types
    import repro.launch.dryrun as R
    # the port's H100 constants, NVLink where the reference divides by ICI
    hw = json.loads(sys.argv[1])
    R.HW.PEAK_FLOPS_BF16 = hw["PEAK_FLOPS_BF16"]
    R.HW.HBM_BW = hw["HBM_BW"]
    R.HW.HBM_BYTES = hw["HBM_BYTES"]
    R.HW.ICI_BW = hw["NVLINK_BW"]

    class Compiled:
        # the stand-in for a compiled program: XLA's per-program figures
        def __init__(self, c):
            self.c = c
        def cost_analysis(self):
            return {"flops": self.c["flops"],
                    "bytes accessed": self.c["bytes"]}
        def as_text(self):
            return self.c["hlo"]
        def memory_analysis(self):
            arg, out, temp = self.c["memory"]
            return types.SimpleNamespace(argument_size_in_bytes=arg,
                                         output_size_in_bytes=out,
                                         temp_size_in_bytes=temp)

    cases = json.loads(sys.stdin.read())
    print(json.dumps({name: R.analyze(Compiled(c), c["n"], c["mflops"])
                      for name, c in cases.items()}))
""")


def _hlo_of(coll) -> str:
    """An HLO program whose collectives have these operand bytes: one
    ``s8`` parameter and one collective on it a kind."""
    lines = ["HloModule analyze", "ENTRY %main {"]
    for i, (kind, nbytes) in enumerate(coll.items()):
        lines.append(f"  %p{i} = s8[{int(nbytes)}]{{0}} parameter({i})")
        lines.append(f"  %c{i} = s8[{int(nbytes)}]{{0}} {kind}(%p{i})")
    return "\n".join(lines + ["}"])


@pytest.fixture(scope="module")
def ref_analyze():
    """The reference's ``analyze`` on each of ``ANALYZE_CASES``, in one
    subprocess (the reference's module sets ``XLA_FLAGS`` on import)."""
    cases = {name: {"n": n, "mflops": mflops, "flops": flops / n,
                    "bytes": nbytes / n, "memory": list(mem),
                    "hlo": _hlo_of(coll)}
             for name, (n, mflops, flops, nbytes, mem, coll)
             in ANALYZE_CASES.items()}
    hw = {k: getattr(HW, k) for k in ("PEAK_FLOPS_BF16", "HBM_BW",
                                      "HBM_BYTES", "NVLINK_BW")}
    out = subprocess.run(
        [sys.executable, "-c", _REF_ANALYZE, json.dumps(hw)],
        input=json.dumps(cases), env=_env(JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=GROUP_TIMEOUT_S)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("case", list(ANALYZE_CASES))
def test_analyze_matches_reference_formulas(case, ref_analyze):
    """The port's ``analyze`` against the reference's, called on a
    stand-in compiled program with the same figures (per chip: XLA's
    per-program ones) and the reference's ``HW`` patched to the H100's
    constants (its ICI rate to NVLink's): every key of the reference's
    record equals the port's exactly, ``hlo_*`` read as ``traced_*``;
    the collective dict is the reference's HLO parse of a program with
    these collectives.  The port's own keys are the totals, ``fits_card``
    and the absent ``collective_reason``."""
    n, mflops, flops, nbytes, (arg, out, temp), coll = ANALYZE_CASES[case]
    entries = [{"kind": k, "bytes": b} for k, b in coll.items()]
    got = D.analyze(n, mflops, flops, nbytes,
                    {"argument_bytes": arg, "output_bytes": out,
                     "temp_bytes": temp},
                    collective_bytes(entries))
    want = ref_analyze[case]
    assert want["dominant"] == (case + "_s" if case != "no_model_flops"
                                else "memory_s")
    renamed = {"hlo_flops_per_chip": "traced_flops_per_chip",
               "hlo_bytes_per_chip": "traced_bytes_per_chip"}
    for key, value in want.items():
        assert got[renamed.get(key, key)] == value, key
    assert set(got) - {renamed.get(k, k) for k in want} == {
        "traced_flops_total", "traced_bytes_total", "collective_reason",
        "fits_card"}
    assert (got["traced_flops_total"], got["traced_bytes_total"]) == \
        (flops, nbytes)
    assert got["fits_card"] == (arg <= 80 * 2**30)
    assert got["collective_reason"] is None
    assert (HW.PEAK_FLOPS_BF16, HW.HBM_BW, HW.NVLINK_BW) == \
        (989e12, 3.35e12, 450e9)


def test_analyze_without_collectives_picks_of_two_terms():
    rec = D.analyze(2, None, 1.0e12, 1.0e13, None, None, "none placed")
    assert rec["collective_s"] is None
    assert rec["collective_bytes_per_chip"] is None
    assert rec["collective_reason"] == "none placed"
    assert rec["dominant"] == "memory_s"
    assert rec["step_seconds_bound"] == 1.0e13 / 2 / 3.35e12
    assert "roofline_fraction" not in rec


# ---------------------------------------------------------------------------
# The byte counter
# ---------------------------------------------------------------------------

def test_op_counter_three_ops():
    """``z = x + y`` reads x and y and writes z (3 × 128 bytes);
    ``z.view(32)`` moves nothing; ``v.mul_(2)`` writes its operand once
    (128): 512 bytes, three aten operators."""
    x = torch.ones((4, 8))
    y = torch.ones((4, 8))
    with D.OpCounter() as c:
        z = x + y
        v = z.view(32)
        v.mul_(2.0)
    assert (c.bytes, c.ops) == (3 * 128 + 128, 3)
    assert c.peak == 128                 # z's storage, shared by v


def test_op_counter_views_move_nothing():
    x = torch.ones((4, 8), device="meta")
    with D.OpCounter() as c:
        x.t()
        x.expand(2, 4, 8)
        x.as_strided((8,), (1,))
        x.unbind(0)
        x[1:3]
        x.reshape(32)
    assert c.bytes == 0 and c.peak == 0 and c.ops > 0


def test_op_counter_out_form_writes_once():
    x = torch.ones(16)
    out = torch.empty(16)
    with D.OpCounter() as c:
        torch.add(x, x, out=out)
    assert c.bytes == 2 * 64       # x read once, out written once


def test_op_counter_peak_follows_frees():
    """Two 4 KiB temporaries, the first freed before the second exists:
    the peak is one of them beside the running result."""
    x = torch.ones(1024, device="meta")
    with D.OpCounter() as c:
        a = x * 2                      # 4 KiB
        b = a + 1                      # 8 KiB live
        del a                          # 4 KiB live
        d = b * 3                      # 8 KiB live
        del b
    assert c.peak == 2 * 4096
    assert c.live == 4096 and d.numel() == 1024


# ---------------------------------------------------------------------------
# Device branches: the meta trace takes the card's path
# ---------------------------------------------------------------------------

def test_lm_step_takes_no_branch_by_device():
    """The meta trace and a run on the card agree only where the code
    takes one branch on both devices.  The only device tests on the LM
    step's path are ``models/api.py::_generator`` (no generator on
    ``"meta"``, where nothing is drawn: it chooses no compute) and the
    checkpoint's host snapshot (not on the step's path); no attention,
    MoE, SSM or optimizer path is chosen by device."""
    pat = re.compile(r"device\.type|is_cuda|\.is_meta|torch\.cuda\.")
    found = []
    for sub in ("models", "train"):
        for path in sorted((SRC / "repro_torch" / sub).glob("*.py")):
            for i, line in enumerate(path.read_text().splitlines(), 1):
                if pat.search(line) and not line.lstrip().startswith("#"):
                    found.append(f"{sub}/{path.name}")
    assert sorted(set(found)) == ["models/api.py", "train/checkpoint.py"]


# ---------------------------------------------------------------------------
# The S2RDF cell at two ranks against the reference's compiled program
# ---------------------------------------------------------------------------

_REF_S2RDF = textwrap.dedent("""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax
    assert len(jax.devices()) == 2
    from repro.engine import Dataset
    from repro.engine.backends import DistributedBackend
    from repro.launch.dryrun import build_s2rdf_cell
    from repro.launch.hlo import collective_bytes
    from repro.launch.mesh import make_query_mesh
    import ast, inspect
    # the query, read from the reference's build_s2rdf_cell
    query = next(ast.literal_eval(n.args[0]) for n in ast.walk(ast.parse(
        inspect.getsource(build_s2rdf_cell))) if isinstance(n, ast.Call)
        and getattr(n.func, "attr", "") == "prepare")
    ds = Dataset.watdiv(scale=2.0, seed=0)
    mesh = make_query_mesh(n_shards=2)
    out = {"query": query}
    for layout in ("extvp", "vp"):
        eng = ds.engine(DistributedBackend(), layout=layout, mesh=mesh)
        p = eng.prepare(query)
        caps = list(p.executor.caps)
        coll = collective_bytes(p.lower().compile().as_text())
        rows = eng.query(query)
        out[layout] = {"caps": caps, "coll": dict(coll),
                       "rows": rows.data, "cols": rows.cols}
    with open(sys.argv[1], "wb") as f:
        pickle.dump(out, f)
""")

_PORT_S2RDF = textwrap.dedent("""
    import pickle, sys
    import torch.distributed as dist
    rank, world, rdv, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \\
        sys.argv[4]
    dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank,
                            world_size=world)
    from repro_torch import Dataset
    from repro_torch.launch import dryrun as D
    ds = Dataset.watdiv(scale=2.0, seed=0, device="cpu")
    res = {"query": D.S2RDF_QUERY}
    for layout in ("extvp", "vp"):
        prepared, _ = D.build_s2rdf_cell("auto", layout=layout,
                                         device="cpu", dataset=ds)
        caps = list(prepared.executor.caps)
        rec = D.s2rdf_record(prepared)
        rows = prepared.run()
        res[layout] = {"caps": caps, "rec": rec, "rows": rows.data,
                       "cols": rows.cols}
    with open(out, "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()
""")


@pytest.fixture(scope="module")
def s2rdf(tmp_path_factory):
    """The reference's S2RDF cell rebuilt at 2 forced host devices (its
    ``build_s2rdf_cell`` fixes 256) and compiled, beside the port's cell
    on 2 gloo ranks, run side by side."""
    tmp = tmp_path_factory.mktemp("s2rdf")
    ref = subprocess.Popen([sys.executable, "-c", _REF_S2RDF,
                            str(tmp / "ref.pkl")], env=_env(),
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True)
    ranks = [subprocess.Popen(
        [sys.executable, "-c", _PORT_S2RDF, str(r), "2", str(tmp / "rdv"),
         str(tmp / f"r{r}.pkl")], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    procs = [ref] + ranks
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=GROUP_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    with open(tmp / "ref.pkl", "rb") as f:
        reference = pickle.load(f)
    port = []
    for r in range(2):
        with open(tmp / f"r{r}.pkl", "rb") as f:
            port.append(pickle.load(f))
    return reference, port


LAYOUTS = ("extvp", "vp")


def test_s2rdf_query_is_the_reference_cell(s2rdf):
    reference, port = s2rdf
    assert all(p["query"] == reference["query"] for p in port)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_s2rdf_initial_caps_equal(s2rdf, layout):
    reference, port = s2rdf
    for rank in port:
        assert rank[layout]["caps"] == reference[layout]["caps"]
        assert rank[layout]["rec"]["caps"] == reference[layout]["caps"]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_s2rdf_all_to_all_bytes_equal(s2rdf, layout):
    """A rank's all-to-all operand bytes (every shuffle's send buffer,
    its own bucket included) equal the compiled program's, per rank."""
    reference, port = s2rdf
    want = reference[layout]["coll"]["all-to-all"]
    for rank in port:
        assert rank[layout]["rec"]["collectives"]["all-to-all"] == want


@pytest.mark.parametrize("layout", LAYOUTS)
def test_s2rdf_other_kinds_stated(s2rdf, layout):
    """Where the two programs differ by design, with the figures:

    * all-reduce: the reference reduces each shuffle's overflow flag
      (``pmax``, 1 byte each), the step flags (``pmax``, one byte a
      slot) and the row count (``psum``, int32): 14 bytes here.  The
      port reduces one int64 head a launch, ``(B, slots + 2 S)``: the
      flags, every rank's count and rows sent, 72 bytes at 5 slots and
      2 ranks;
    * all-gather: the reference's program returns sharded rows, which
      the host reads; the port gathers a launch's rows in one
      all-gather sized by the synced counts, after a launch with no
      overflow.  At the initial caps this query overflows on both
      packages (the reference's caps grow too), so neither gathers;
    * no other kind occurs in either."""
    reference, port = s2rdf
    ref = reference[layout]["coll"]
    assert set(ref) == {"all-to-all", "all-reduce", "total", "weighted"}
    assert ref["all-reduce"] == 5 + 5 + 4
    slots = len(reference[layout]["caps"])
    for rank in port:
        rec = rank[layout]["rec"]
        assert rec["overflowed"] is True
        assert set(rec["collectives"]) == {"all-to-all", "all-reduce"}
        assert rec["collectives"]["all-reduce"] == 8 * (slots + 2 * 2)
        calls = [c for c in rec["collective_calls"]
                 if c["kind"] == "all-reduce"]
        assert len(calls) == 1 and calls[0]["dtype"] == "int64"
        assert rec["collective_bytes_per_chip"] == \
            rec["collectives"]["all-to-all"] + rec["collectives"]["all-reduce"]


def test_s2rdf_vp_over_extvp_points_the_same_way(s2rdf):
    """The paper's claim: ExtVP's semi-join reduction shrinks the
    shuffles.  vp / extvp of total collective bytes is above 1 on both
    packages."""
    reference, port = s2rdf
    ref_ratio = reference["vp"]["coll"]["total"] / \
        reference["extvp"]["coll"]["total"]
    assert ref_ratio > 1
    for rank in port:
        ratio = rank["vp"]["rec"]["collective_bytes_per_chip"] / \
            rank["extvp"]["rec"]["collective_bytes_per_chip"]
        assert ratio > 1


@pytest.mark.parametrize("layout", LAYOUTS)
def test_s2rdf_answers_equal_reference(s2rdf, layout):
    """A full run (with retries) of the cell's query: every rank's rows
    equal the reference's, row for row, on both layouts."""
    reference, port = s2rdf
    want = reference[layout]
    for rank in port:
        assert rank[layout]["cols"] == want["cols"]
        np.testing.assert_array_equal(rank[layout]["rows"], want["rows"])


def test_s2rdf_record_sums_ranks_bytes(s2rdf):
    """``traced_bytes_total`` is the ranks' traced bytes summed; per
    chip divides it by the two ranks."""
    _, port = s2rdf
    for layout in LAYOUTS:
        mine = [r[layout]["rec"]["rank_traced_bytes"] for r in port]
        for r in port:
            rec = r[layout]["rec"]
            assert rec["n_chips"] == 2
            assert rec["traced_bytes_total"] == sum(mine)
            assert rec["traced_bytes_per_chip"] == sum(mine) / 2
            assert rec["traced_flops_total"] == 0.0
            assert rec["argument_bytes"] > 0 and rec["temp_bytes"] > 0


# ---------------------------------------------------------------------------
# The command line
# ---------------------------------------------------------------------------

def test_cli_full_width_prefill_on_meta():
    """Full width, on ``"meta"``: two ok lines (single, multi) and the
    summary, exit 0."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen1.5-0.5b", "--shape", "prefill_32k", "--mesh", "both"],
        env=_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "# dry-run: 2 ok, 0 skipped, 0 errors"
    recs = [json.loads(ln) for ln in lines[:-1]]
    assert [(r["mesh"], r["status"]) for r in recs] == \
        [("single", "ok"), ("multi", "ok")]


def test_cli_s2rdf_production_mesh_refused():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "s2rdf", "--mesh", "single", "--device", "cpu"],
        env=_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode == 1, out.stderr[-4000:]
    rec = json.loads(out.stdout.splitlines()[0])
    assert rec["status"] == "error"
    assert "mesh {'data': 256} needs 256 ranks; this run has 1" in \
        rec["error"]
    assert out.stdout.splitlines()[-1] == \
        "# dry-run: 0 ok, 0 skipped, 1 errors"


def test_cli_s2rdf_auto_on_the_cpu(tmp_path):
    """``--mesh auto`` in a plain process opens a world of one (gloo on
    the CPU) and writes the record."""
    path = tmp_path / "s2rdf.jsonl"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "s2rdf", "--mesh", "auto", "--device", "cpu", "--out",
         str(path)], env=_env(), capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    rec = json.loads(path.read_text())
    assert rec["status"] == "ok" and rec["n_chips"] == 1
    assert rec["collectives"]["all-to-all"] > 0
    assert rec["collective_s"] == \
        rec["collective_bytes_per_chip"] / HW.NVLINK_BW


def test_cli_s2rdf_needs_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "s2rdf", "--mesh", "auto"], env=_env(), capture_output=True,
        text=True, timeout=300)
    assert out.returncode != 0
    assert "no CUDA device is available" in out.stderr
