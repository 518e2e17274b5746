"""The port's collective accounting (``repro_torch.launch.collectives``),
held against the JAX package's HLO parser (``repro.launch.hlo``): the
same dict from entries equivalent to an HLO program's collectives, and
every collective call site of the port reporting to it."""

import importlib.util
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro.launch.hlo import COLLECTIVE_OPS as REF_OPS
from repro.launch.hlo import collective_bytes as ref_collective_bytes
from repro_torch.launch import collectives
from repro_torch.launch.collectives import (
    COLLECTIVE_OPS, WEIGHTS, collective_bytes, note, record,
)
from repro_torch.obs import counters

ROOT = Path(__file__).resolve().parents[1]


def _hlo_sample() -> str:
    """``tests/test_launch.py``'s ``HLO_SAMPLE``, read from that file."""
    spec = importlib.util.spec_from_file_location(
        "_ref_test_launch", ROOT / "tests" / "test_launch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.HLO_SAMPLE


def _entry(kind, shape, dtype=torch.bfloat16):
    t = torch.empty(shape, dtype=dtype, device="meta")
    with record() as entries:
        note(kind, t)
    return entries[0]


def test_collective_ops_are_the_reference_kinds():
    assert COLLECTIVE_OPS == REF_OPS


def test_record_and_note_live_below_the_launcher():
    """The executors report to ``obs.counters``; the launcher's module
    re-exports the same functions, and neither the executors nor the
    engine import the launcher."""
    assert collectives.record is counters.record
    assert collectives.note is counters.note
    from repro_torch.launch import dryrun
    assert dryrun.OpCounter is counters.OpCounter
    for rel in ("core/distributed.py", "engine/engine.py"):
        text = (ROOT / "src" / "repro_torch" / rel).read_text()
        assert "repro_torch.launch" not in text, rel


def test_collective_bytes_matches_hlo_sample():
    """Entries equivalent to ``HLO_SAMPLE``: each instruction one eager
    call on its operands (the tuple all-to-all's three bf16[16,128]
    operands are one call on a (3, 16, 128) buffer)."""
    entries = [_entry("all-reduce", (16, 128)),
               _entry("all-gather", (16, 128)),
               _entry("all-to-all", (3, 16, 128)),
               _entry("reduce-scatter", (16, 128)),
               _entry("collective-permute", (16, 128))]
    want = ref_collective_bytes(_hlo_sample())
    assert collective_bytes(entries) == dict(want)


def test_async_pair_is_one_entry():
    """The reference counts an async ``-start`` / ``-done`` pair once, at
    its start; an eager call is one entry, so both give the operand's
    bytes once."""
    hlo = """
  %ars = bf16[16,128]{1,0} all-reduce-start(%p0), to_apply=%add
  %ard = bf16[16,128]{1,0} all-reduce-done(%ars)
  %p0 = bf16[16,128]{1,0} parameter(0)
"""
    got = collective_bytes([_entry("all-reduce", (16, 128))])
    assert got == dict(ref_collective_bytes(hlo))


def test_weighted_doubles_all_reduce_only():
    entries = [_entry(k, (4, 8), torch.int32) for k in COLLECTIVE_OPS]
    out = collective_bytes(entries)
    assert out["total"] == 5 * 4 * 8 * 4
    assert out["weighted"] == out["total"] + out["all-reduce"]
    assert WEIGHTS == {"all-reduce": 2.0, "all-gather": 1.0,
                       "reduce-scatter": 1.0, "all-to-all": 1.0,
                       "collective-permute": 1.0}


def test_no_collectives_is_the_reference_empty_dict():
    assert collective_bytes([]) == dict(ref_collective_bytes(""))


def test_entry_fields():
    e = _entry("all-to-all", (2, 4096, 3), torch.int32)
    assert e == {"kind": "all-to-all", "dtype": "int32",
                 "shape": (2, 4096, 3), "bytes": 2 * 4096 * 3 * 4}


def test_unknown_kind_refused():
    with pytest.raises(ValueError, match="unknown collective kind"):
        collective_bytes([{"kind": "broadcast", "bytes": 4}])


def test_note_outside_record_keeps_nothing():
    t = torch.zeros(4)
    assert counters._sink is None
    note("all-reduce", t)
    with record() as entries:
        pass
    assert entries == []


def test_records_nest():
    t = torch.zeros(4)
    with record() as outer:
        note("all-reduce", t)
        with record() as inner:
            note("all-gather", t)
        note("all-to-all", t)
    assert [e["kind"] for e in outer] == ["all-reduce", "all-to-all"]
    assert [e["kind"] for e in inner] == ["all-gather"]
    assert counters._sink is None


_RANK = textwrap.dedent("""
    import pickle, sys
    import torch.distributed as dist
    rank, world, rdv, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \\
        sys.argv[4]
    dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank,
                            world_size=world)
    from repro_torch import Dataset
    from repro_torch.core import distributed as D
    from repro_torch.launch.collectives import record
    res = {}
    with record() as build:
        ds = Dataset.watdiv(scale=0.1, seed=3, threshold=0.25, device="cpu",
                            build_backend="distributed")
    res["build"] = build
    eng = ds.engine("distributed")
    q = "SELECT * WHERE { ?u wsdbm:follows ?v . ?v wsdbm:likes ?p }"
    eng.query(q)                      # caps grown: the next run fits
    D.reset_exchanges()
    with record() as run:
        rows = eng.query(q)
    res["run"] = run
    res["rows"] = len(rows)
    res["exchanges"] = dict(D.exchanges)
    with record() as ordered:
        eng.query(q + " ORDER BY ?u LIMIT 5")
    res["ordered"] = ordered
    with open(out, "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()
""")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Two gloo ranks on the CPU: a distributed ExtVP build, a warm query
    and a query with global modifiers, each under ``record()``."""
    tmp = tmp_path_factory.mktemp("coll")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), "2", str(tmp / "rdv"),
         str(tmp / f"r{r}.pkl")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    import pickle
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return [pickle.load(open(tmp / f"r{r}.pkl", "rb")) for r in range(2)]


def test_distributed_build_reports_its_gathers(ranks):
    """``extvp_pair_masks_sharded``'s gathers go through
    ``_all_gather_cat``: the match counts (int64) and the rows (int32
    pairs), one all-gather each."""
    for r in ranks:
        kinds = [(e["kind"], e["dtype"]) for e in r["build"]]
        assert kinds[0] == ("all-gather", "int64")
        assert ("all-gather", "int32") in kinds
        assert {k for k, _ in kinds} == {"all-gather"}


def test_query_reports_shuffles_sync_and_gather(ranks):
    """A warm query: one all-to-all a shuffle (its bytes the
    ``exchanges`` counter's buffer bytes), one all-reduce (the launch's
    sync head) and the result gather, the same on both ranks."""
    a, b = ranks
    assert a["run"] == b["run"]
    kinds = [e["kind"] for e in a["run"]]
    a2a = [e for e in a["run"] if e["kind"] == "all-to-all"]
    assert len(a2a) == a["exchanges"]["all_to_all"] > 0
    assert sum(e["bytes"] for e in a2a) == a["exchanges"]["buffer_bytes"]
    assert kinds.count("all-reduce") == 1
    assert kinds[-1] == "all-gather"
    head = [e for e in a["run"] if e["kind"] == "all-reduce"][0]
    assert head["dtype"] == "int64"


def test_global_modifiers_report_relation_gathers(ranks):
    """ORDER BY / LIMIT gather the shard results inside the program
    (``_allgather_relation``: rows, then counts) before the sync."""
    for r in ranks:
        kinds = [e["kind"] for e in r["ordered"]]
        sync = kinds.index("all-reduce")
        assert kinds[sync - 2:sync] == ["all-gather", "all-gather"]
