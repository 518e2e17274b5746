"""The port's distributed engine (``repro_torch.core.distributed``) against
the JAX package's, over gloo on the CPU.

Each group of ranks runs in its own processes (``_torch_dist_jobs.py``),
meeting through a rendezvous file under ``tmp_path``; every group has a
time limit.  At 2 ranks the port must equal ``repro``'s distributed
engine on a mesh of 2 forced host devices (run in a subprocess, as
``tests/test_distributed.py`` runs its mesh) **row for row and capacity
for capacity** on the first instance of each of the 20 WatDiv basic
templates: both concatenate the shards in shard order.  Each
template's instances as one batch (the reference's vmapped ``shard_map``
program; here one launch sequence on every rank) must equal the
reference's ``query_batch`` row for row and cap for cap too, the engine
must pad the distributed seat as the reference's does, and a batch must
make as many kernel calls and exchanges as one request.  Global-modifier
queries, which the reference's distributed engine cannot serve on this
JAX version (ROADMAP queue 3), are held against ``jit`` instead, single
and batched.  Also: ``shard_table`` byte for byte, ``repartition``'s
routing and overflow, one row and a batch, the distributed ExtVP build
byte-identical to the numpy build, and each executor through
``repro.analysis.verifier.verify_executor``.
"""

import collections
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

from repro.analysis.verifier import verify_executor
from repro.core.distributed import shard_table as ref_shard_table
from repro.core.table import Table as RefTable
from repro.engine import Dataset as RDataset

from repro_torch.core.distributed import shard_table
from repro_torch.core.table import Table

from _torch_dist_jobs import GROUP_TIMEOUT_S, post_order_combines, run_group
from test_torch_engine import MODIFIER_QUERIES, UNBOUND_QUERIES
from test_modifiers import TRIPLES as MOD_TRIPLES
from test_unbound import TRIPLES as UNBOUND_TRIPLES

ROOT = Path(__file__).resolve().parents[1]

SCALE, SEED, TAU = 0.1, 0, 0.25
#: templates with an object-keyed probe that ``dual_partition`` serves
#: from the object-partitioned copy
DUAL = ("L4", "F1")
TEMPLATES = ("S1", "S2", "S3", "S4", "S5", "S6", "S7", "L1", "L2", "L3",
             "L4", "L5", "F1", "F2", "F3", "F4", "F5", "C1", "C2", "C3")
TWO_POW_24 = [("ex:a", "ex:p", '"16777217"'), ("ex:b", "ex:p", '"16777216"')]
TWO_POW_24_QUERIES = [
    "SELECT ?s WHERE { ?s ex:p ?x FILTER(?x > 16777216) }",
    "SELECT ?s ?x WHERE { ?s ex:p ?x } ORDER BY ?x",
    "SELECT ?s ?x WHERE { ?s ex:p ?x } ORDER BY DESC(?x)"]


#: the engine's padding on the distributed seat: batches of 5, 7 and 3
#: requests (bucket shapes 8, 8 and 4), the first of L1's with a user the
#: dictionary lacks
PADDING = {"script": [["L1", 5], ["L2", 7], ["S1", 3]], "missing": "L1",
           "pattern": r"wsdbm:User\d+", "absent": "wsdbm:User99999999"}
#: templates whose one request and batch of 8 are counted: stars (no
#: exchange), linear and snowflake shapes (shuffles of bound relations
#: and of bounds-free ones), and C3's OPTIONAL
COUNTED = ("S1", "L1", "L2", "F1", "F3", "C3")


def multiset(data):
    return collections.Counter(map(tuple, np.asarray(data).tolist()))


# ---------------------------------------------------------------------------
# shard_table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", [1, 2, 3, 8])
@pytest.mark.parametrize("by", [0, 1])
def test_shard_table_matches_reference(n_shards, by):
    rng = np.random.default_rng(n_shards * 10 + by)
    rows = rng.integers(0, 500, size=(300, 2)).astype(np.int32)
    tt = rng.integers(0, 500, size=(200, 3)).astype(np.int32)
    for ours, ref in [(shard_table(Table.from_unsorted(rows), n_shards, by),
                       ref_shard_table(RefTable.from_unsorted(rows),
                                       n_shards, by)),
                      (shard_table(tt, n_shards, by),
                       ref_shard_table(tt, n_shards, by)),
                      (shard_table(np.zeros((0, 2), np.int32), n_shards),
                       ref_shard_table(np.zeros((0, 2), np.int32), n_shards))]:
        for a, b in zip(ours, ref):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# repartition
# ---------------------------------------------------------------------------

def test_repartition_routes_every_row_by_uint32_key(tmp_path):
    """Every valid row reaches rank ``uint32(key) % 2`` exactly once, in
    rank-then-row order, and pads stay behind."""
    res = run_group("repartition", 2, tmp_path, cap=512, n=400, skew=False,
                    out_cap=1024)
    sent = np.concatenate([r["sent_rows"] for r in res])
    for rank, r in enumerate(res):
        assert not r["overflow"] and r["exchanges"] == 1
        dest = (sent[:, 0].astype(np.int64) & 0xFFFFFFFF) % 2
        want = sent[dest == rank]
        got = r["recv"][:r["n"]]
        np.testing.assert_array_equal(got, want)
        assert (r["recv"][r["n"]:] == 2**31 - 1).all()
        mine = (r["sent_rows"][:, 0].astype(np.int64) & 0xFFFFFFFF) % 2
        assert r["sent"] == int((mine != rank).sum())
    assert sum(r["n"] for r in res) == len(sent)


def test_repartition_flags_a_short_output(tmp_path):
    """Rows received beyond ``out_cap`` set the overflow flag."""
    res = run_group("repartition", 2, tmp_path, cap=512, n=400, skew=True,
                    out_cap=256)
    assert res[0]["overflow"] and res[0]["n"] == 256
    assert not res[1]["overflow"] and res[1]["n"] == 0


def test_repartition_flags_bucket_overflow_at_8_ranks(tmp_path):
    """With every key bound for rank 0, 512 valid rows overflow the
    static bucket (``round_up_pow2(2 * 512 // 8 + 16)`` = 256 rows) on
    every rank: the flag is set and only a bucket's worth arrives from
    each."""
    res = run_group("repartition", 8, tmp_path, cap=512, n=512, skew=True,
                    out_cap=8 * 512)
    assert all(r["overflow"] for r in res)
    assert res[0]["n"] == 8 * 256
    assert all(r["n"] == 0 for r in res[1:])
    assert all(r["sent"] == 256 for r in res[1:]) and res[0]["sent"] == 0


@pytest.mark.parametrize("world", [2, 3])
def test_batched_repartition_equals_one_row_calls(tmp_path, world):
    """A batch of rows with their own valid counts (a full row, a part,
    none, a few, and a full row bound for rank 0 alone, which overflows
    ``out_cap`` there) is one exchange, and gives each row's rows,
    count, flag and rows sent exactly as a call of that row alone."""
    ns = [256, 100, 0, 17, 256]
    res = run_group("repartition_batch", world, tmp_path, cap=256, ns=ns,
                    skew_row=4, out_cap=300)
    for rank, r in enumerate(res):
        assert r["exchanges"] == 1
        got = r["batch"]
        assert got["rows"].shape == (len(ns), 300, 2)
        for b, one in enumerate(r["single"]):
            np.testing.assert_array_equal(got["rows"][b], one["rows"])
            assert got["n"][b] == one["n"]
            assert got["overflow"][b] == one["overflow"]
            assert got["sent"][b] == one["sent"]
        assert list(got["overflow"]) == [False] * 4 + [rank == 0]
    for b in range(len(ns) - 1):
        assert sum(r["batch"]["n"][b] for r in res) == world * ns[b]


# ---------------------------------------------------------------------------
# The engine against the reference's distributed engine
# ---------------------------------------------------------------------------

_REFERENCE = textwrap.dedent("""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax
    from repro.engine import Dataset
    from repro.engine.backends import DistributedBackend
    from repro.engine.engine import Engine
    from repro.rdf.workloads import basic_queries
    import json, re
    scale, seed, tau, dual, out, padding = sys.argv[1:7]
    assert len(jax.devices()) == 2
    ds = Dataset.watdiv(scale=float(scale), seed=int(seed),
                        threshold=float(tau))
    mesh = jax.make_mesh((2,), ("data",))
    eng = ds.engine("distributed", mesh=mesh)
    dual_eng = Engine(ds, backend=DistributedBackend(dual_partition=True),
                      mesh=mesh)
    res = {"templates": {}, "dual": {}, "batches": {}}
    qs = basic_queries(ds.schema, seed=int(seed))
    for name, insts in qs.items():
        r = eng.query(insts[0])
        p = eng.prepare(insts[0])
        res["templates"][name] = (r.cols, r.data,
                                  list(getattr(p, "executor").caps)
                                  if hasattr(p, "executor") else None)
        rb = eng.query_batch(insts)
        res["batches"][name] = ([(x.cols, x.data) for x in rb],
                                list(p.executor.caps)
                                if hasattr(p, "executor") else None)
    for name in dual.split(","):
        r = dual_eng.query(qs[name][0])
        res["dual"][name] = (r.cols, r.data,
                             list(dual_eng.prepare(qs[name][0]).executor.caps))
    res["fallbacks"] = eng.metrics.device_fallbacks
    padding = json.loads(padding)
    pad_eng = Engine(ds, backend=DistributedBackend(), mesh=mesh)
    q8 = basic_queries(ds.schema, seed=0, n_instances=8)
    rows = []
    for name, count in padding["script"]:
        insts = list(q8[name][:count])
        if name == padding["missing"]:
            insts[0] = re.sub(padding["pattern"], padding["absent"],
                              insts[0], count=1)
        rows += [len(r) for r in pad_eng.query_batch(insts)]
    m = pad_eng.metrics.summary()
    res["padding"] = {"padding_waste": m["padding_waste"],
                      "batch_occupancy": m["batch_occupancy"],
                      "batches": m["batches"], "rows": rows}
    with open(out, "wb") as f:
        pickle.dump(res, f)
""")


@pytest.fixture(scope="module")
def suites(tmp_path_factory):
    """The reference's distributed engine (a subprocess on 2 forced host
    devices) and the port's at 2 ranks, run side by side."""
    tmp = tmp_path_factory.mktemp("suite")
    out = tmp / "reference.pkl"
    ref = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, str(SCALE), str(SEED), str(TAU),
         ",".join(DUAL), str(out), json.dumps(PADDING)], env=dict(os.environ,
                                              PYTHONPATH=str(ROOT / "src")), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        port = run_group("suite", 2, tmp, scale=SCALE, seed=SEED, tau=TAU,
                         dual=list(DUAL))
        log, _ = ref.communicate(timeout=GROUP_TIMEOUT_S)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, log[-4000:]
    with open(out, "rb") as f:
        reference = pickle.load(f)
    return reference, port


@pytest.mark.parametrize("name", TEMPLATES)
def test_basic_template_matches_reference_distributed(suites, name):
    reference, port = suites
    cols, data, caps = reference["templates"][name]
    for rank in port:                       # every rank gets the rows
        got = rank["templates"][name]
        assert got["cols"] == cols
        assert got["data"].dtype == np.int32
        np.testing.assert_array_equal(got["data"], data)
        assert got["info"]["caps"] == caps
        assert got["batch_equal"]


@pytest.mark.parametrize("name", TEMPLATES)
def test_basic_template_batch_matches_reference_distributed(suites, name):
    """Every instance of the template as one batch: each binding's rows
    equal the reference's vmapped program's row for row, and the caps
    after the batch are equal, on every rank."""
    reference, port = suites
    want, caps = reference["batches"][name]
    for rank in port:
        got = rank["templates"][name]
        assert len(got["batch"]) == len(want)
        for g, (cols, data) in zip(got["batch"], want):
            assert g["cols"] == cols
            assert g["data"].dtype == np.int32
            np.testing.assert_array_equal(g["data"], data)
        assert got["batch_info"]["caps"] == caps


def test_distributed_seat_pads_as_the_reference(suites, tmp_path):
    """Batches of 5, 7 and 3 requests are padded to 8, 8 and 4 on every
    rank (padding waste 5/20, occupancy 15/20), as the reference's
    distributed engine pads them, and the request whose constant the
    dictionary lacks keeps its batch's shape."""
    reference, _ = suites
    want = reference["padding"]
    for r in run_group("padding", 2, tmp_path, scale=SCALE, **PADDING):
        assert r["padding_waste"] == want["padding_waste"] == 5 / 20
        assert r["batch_occupancy"] == want["batch_occupancy"] == 15 / 20
        assert r["batches"] == want["batches"] == 3
        assert r["shapes"] == [8, 8, 4]
        assert r["rows"] == want["rows"]
        assert r["rows"][0] == 0


def test_a_batch_makes_the_calls_of_one_request(tmp_path):
    """A batch of 8 is one launch sequence on every rank: as many
    bucket-count and join-probe calls and exchanges as one request, a
    bounds-free relation shuffled once, each in one attempt."""
    res = run_group("launch_counts", 2, tmp_path, scale=SCALE, batch=8,
                    templates=list(COUNTED))
    for r in res:
        for name in COUNTED:
            one, batch = r[name]["single"], r[name]["batch"]
            assert one["attempts"] == batch["attempts"] == 1, name
            assert batch == one, name
        assert r["S1"]["batch"]["all_to_all"] == 0
        assert all(r[n]["batch"]["all_to_all"] > 0 for n in ("L1", "F1"))
    assert res[0] == res[1]


def test_dual_partition_matches_reference_distributed(suites):
    reference, port = suites
    for name in DUAL:
        cols, data, caps = reference["dual"][name]
        got = port[0]["dual"][name]
        assert "o" in got["info"]["scan_copy"]
        assert got["cols"] == cols
        np.testing.assert_array_equal(got["data"], data)
        assert got["info"]["caps"] == caps
        # the object copy spares an exchange of the plain layout
        assert got["exchanges"] < port[0]["templates"][name]["exchanges"]
    assert port[0]["fallbacks"] == 0 and reference["fallbacks"] == 0


def test_star_templates_make_no_exchange(suites):
    _, port = suites
    runs = port[0]["templates"]
    assert all(runs[f"S{i}"]["exchanges"] == 0 for i in range(1, 8))
    assert all(runs[n]["exchanges"] > 0 for n in ("L1", "F1", "C1"))


def _diags(report):
    """A verification report as plain data: its diagnostics and checks."""
    return ([(d.rule, d.severity, d.message, d.location)
             for d in report.diagnostics], tuple(report.checks))


class _CapSlots:
    """The port executor's capacity-slot attributes over the reference's
    compile of the same query, which is what ``verify_executor`` reads
    (it checks segment types of the JAX package)."""

    def __init__(self, ref_ex, info):
        self.core, self.plan = ref_ex.core, ref_ex.plan
        self.spine, self.catalog = ref_ex.spine, ref_ex.catalog
        self.caps = info["caps"]
        self._mod_resize = info["mod_resize"]
        self._n_pipeline = info["n_pipeline"]
        self.gathered = info["gathered"]
        self._comb_index = {
            id(seg): slot for seg, slot in
            zip(post_order_combines(ref_ex.core.root, []), info["comb"])}


def test_executors_pass_verify_executor(suites):
    from repro.rdf.workloads import basic_queries
    _, port = suites
    rds = RDataset.watdiv(scale=SCALE, seed=SEED, threshold=TAU)
    jit = rds.engine("jit")
    checked = 0
    for name, insts in basic_queries(rds.schema, seed=SEED).items():
        info = port[0]["templates"][name].get("info")
        ref_ex = getattr(jit.prepare(insts[0]), "executor", None)
        assert (info is None) == (ref_ex is None), name
        if info is None:
            continue
        assert info["describe"] == ref_ex.core.describe(), name
        report = verify_executor(_CapSlots(ref_ex, info))
        assert report.ok, (name, report)
        # the port's own verifier, run on every rank on the port's
        # executor, reports what the reference's reports
        for rank in port:
            assert rank["templates"][name]["verify"] == \
                _diags(report), name
        checked += 1
    for name in DUAL:
        info = port[0]["dual"][name]["info"]
        ref_ex = jit.prepare(basic_queries(rds.schema, seed=SEED)[name][0]) \
            .executor
        report = verify_executor(_CapSlots(ref_ex, info))
        assert report.ok
        assert port[0]["dual"][name]["verify"] == _diags(report), name
    assert checked == 20


def test_batched_executors_pass_verify_executor(suites):
    """Each executor's slots after its batch (the caps it grew over the
    batch) pass the reference's verifier."""
    from repro.rdf.workloads import basic_queries
    _, port = suites
    rds = RDataset.watdiv(scale=SCALE, seed=SEED, threshold=TAU)
    jit = rds.engine("jit")
    checked = 0
    for name, insts in basic_queries(rds.schema, seed=SEED).items():
        info = port[0]["templates"][name].get("batch_info")
        ref_ex = getattr(jit.prepare(insts[0]), "executor", None)
        assert (info is None) == (ref_ex is None), name
        if info is None:
            continue
        report = verify_executor(_CapSlots(ref_ex, info))
        assert report.ok, (name, report)
        for rank in port:
            assert rank["templates"][name]["batch_verify"] == \
                _diags(report), name
        checked += 1
    assert checked == 20


# ---------------------------------------------------------------------------
# The engine against jit, where the reference's distributed engine fails
# ---------------------------------------------------------------------------

def _order_keys(qtext):
    """The variables of the query's ORDER BY clause."""
    m = re.search(r"ORDER BY (.*?)(LIMIT|OFFSET|$)", qtext)
    return re.findall(r"\?\w+", m.group(1)) if m else []


def _held_against_jit(triples, queries, res):
    """Every rank's single and batched rows against ``jit``'s: the same
    multiset, and, where the query orders them, every projected ORDER BY
    key in the same sequence.  Rows that tie on the keys may come in
    another order: the distributed engine meets them in shard order."""
    rds = RDataset.from_triples(triples)
    jit = rds.engine("jit")
    for rank in res:
        assert rank["terms"] == list(rds.dictionary.id_to_term)
        assert rank["fallbacks"] == 0
        for q, one, batched in zip(queries, rank["single"],
                                   rank["batched"]):
            want = jit.query(q)
            for got in (one, batched):
                assert got["cols"] == want.cols, q
                assert multiset(got["data"]) == multiset(want.data), q
                for key in _order_keys(q):
                    if key in want.cols:
                        j = want.cols.index(key)
                        np.testing.assert_array_equal(
                            got["data"][:, j], want.data[:, j], err_msg=q)
    assert jit.metrics.device_fallbacks == 0


@pytest.mark.parametrize("triples,queries", [
    (MOD_TRIPLES, MODIFIER_QUERIES), (UNBOUND_TRIPLES, UNBOUND_QUERIES),
    (TWO_POW_24, TWO_POW_24_QUERIES),
], ids=["modifiers", "unbound", "two-pow-24"])
def test_modifier_and_unbound_queries_match_jit(tmp_path, triples, queries):
    res = run_group("queries", 2, tmp_path, triples=triples,
                    queries=queries)
    _held_against_jit(triples, queries, res)


#: template instances that batch: a bound user or product (one missing
#: from the dictionary), a filter constant, a cross join whose right
#: side binds no constant, under DISTINCT, ORDER BY and LIMIT
BATCHED_MODIFIER_QUERIES = [
    f"SELECT DISTINCT ?x WHERE {{ ex:u{u} ex:likes ?p . ?p ex:price ?x }} "
    "ORDER BY ?x" for u in (1, 2, 3, 1)] + [
    f"SELECT ?u ?x WHERE {{ ?u ex:likes ?p . ?p ex:price ?x "
    f"FILTER(?u != ex:u{u}) }} ORDER BY DESC(?x)" for u in (1, 2, 2)] + [
    f"SELECT ?u WHERE {{ ?u ex:likes ex:p{k} }} ORDER BY ?u LIMIT 1"
    for k in (1, 2, 3, 4)] + [
    f"SELECT ?p ?q WHERE {{ ex:u{u} ex:likes ?p . ?q ex:price ?x }} "
    "ORDER BY ?p ?q" for u in (1, 2)]
#: unbound-predicate and OPTIONAL / UNION instances that batch, with
#: bounds-free relations beside bound ones
BATCHED_UNBOUND_QUERIES = [
    f"SELECT * WHERE {{ a{i} p0 ?o OPTIONAL {{ ?o p1 ?w }} }} ORDER BY ?w"
    for i in (1, 2, 3)] + [
    f"SELECT * WHERE {{ a{i} ?p ?o }}" for i in (1, 3, 9)] + [
    f"SELECT ?s ?p WHERE {{ ?s ?p b{i} }}" for i in (1, 2)] + [
    f"SELECT * WHERE {{ ?s p0 ?o . ?o p1 c{i} }}" for i in (1, 2)] + [
    f"SELECT * WHERE {{ {{ a{i} p0 ?o }} UNION {{ ?o p1 ?w }} }}"
    for i in (1, 2)] + [
    f"SELECT DISTINCT ?w WHERE {{ a{i} p0 ?o OPTIONAL {{ ?o p1 ?w }} }}"
    for i in (1, 2)]


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("triples,queries", [
    (MOD_TRIPLES, MODIFIER_QUERIES + BATCHED_MODIFIER_QUERIES),
    (UNBOUND_TRIPLES, UNBOUND_QUERIES + BATCHED_UNBOUND_QUERIES),
], ids=["modifiers", "unbound"])
def test_batched_modifier_and_unbound_queries_match_jit(tmp_path, world,
                                                        triples, queries):
    res = run_group("queries", world, tmp_path, triples=triples,
                    queries=queries)
    _held_against_jit(triples, queries, res)


def test_modifier_queries_at_8_ranks_match_jit(tmp_path):
    queries = [MODIFIER_QUERIES[i] for i in (0, 2, 6, 10, 14)] + \
        UNBOUND_QUERIES[2:4]
    triples = MOD_TRIPLES + [t for t in UNBOUND_TRIPLES
                             if t not in MOD_TRIPLES]
    res = run_group("queries", 8, tmp_path, triples=triples,
                    queries=queries)
    _held_against_jit(triples, queries, res)


# ---------------------------------------------------------------------------
# The distributed ExtVP build
# ---------------------------------------------------------------------------

def test_distributed_build_is_byte_identical_to_numpy(tmp_path):
    taus = [0.25, 1.0]
    res = run_group("build", 2, tmp_path, scale=SCALE, seed=SEED, taus=taus)
    for tau in taus:
        ref = RDataset.watdiv(scale=SCALE, seed=SEED, threshold=tau,
                              build_backend="numpy").catalog.extvp
        for rank in res:
            got = rank["catalogs"][tau]
            assert got["backend"] == "distributed"
            assert got["sf"] == ref.sf and got["sizes"] == ref.sizes
            assert got["n_semijoins"] == ref.n_semijoins
            assert sorted(got["tables"]) == sorted(ref.tables)
            for k, t in ref.tables.items():
                assert got["tables"][k].dtype == np.int32
                assert got["tables"][k].tobytes() == \
                    np.asarray(t.rows).tobytes(), k
    for rank in res:
        assert rank["append_equal"]
        assert rank["append_report"]["evaluated"] > 0


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def test_distributed_engine_needs_a_process_group():
    from repro_torch import Dataset
    from repro_torch.core.distributed import DistributedExecutor
    from repro_torch.core.compiler import compile_core
    from repro_torch.core.modifiers import peel_spine
    from repro_torch.core.sparql import parse_sparql
    ds = Dataset.from_triples(MOD_TRIPLES, device="cpu")
    with pytest.raises(ValueError, match="process group"):
        ds.engine("distributed")
    with pytest.raises(ValueError, match="distributed backend only"):
        ds.engine(dual_partition=True)
    q = parse_sparql("SELECT * WHERE { ?u ex:likes ?p }", ds.dictionary)
    core, _ = peel_spine(q)
    cp = compile_core(core, ds.catalog)
    with pytest.raises(RuntimeError, match="process group"):
        DistributedExecutor(cp, ds.catalog, device="cpu")
